"""B3's and B4's tiling as the wrapper owns it (``avsum_torch.ops.attention``
``bwd_layout``), on the CPU: what ``csrc/flash_bwd.cu`` must report through
``avsum_flash_bwd_layout`` (the card-only test
``test_flash_bwd_layout_matches_the_library`` holds the two together), that
it fits a Hopper block's shared memory, that the streamed tile is wgmma's
M, and that the train run's [1, 1024, 4, D] fills the card in one wave."""

import math

import pytest

from avsum_torch.ops import attention as att

H100_SMS = 132


@pytest.mark.parametrize("d", [128, 256])
def test_bwd_layout_fits_a_hopper_block(d):
    layout = att.bwd_layout(d)
    assert layout["smem"] <= att.SMEM_LIMIT == 232_448
    assert layout["blocks_per_sm"] == 1
    # the ring, the two resident tensors' big and small planes and P's
    # and dS's, with 1 KB to align the ring
    rows, tile = layout["block_rows"], layout["tile_rows"]
    assert layout["smem"] == (1024 + 4 * layout["stages"] * tile
                              * att.BWD_CHUNK + 4 * 2 * 2 * rows * d
                              + 4 * 2 * 2 * rows * tile
                              + 16 * layout["stages"])


@pytest.mark.parametrize("d", [128, 256])
def test_streamed_tile_is_wgmma_m(d):
    layout = att.bwd_layout(d)
    assert layout["tile_rows"] % 64 == 0
    # a chunk of D is one 64-row m-tile of the products over the tile, and
    # the two warpgroups take them in pairs
    assert d % att.BWD_CHUNK == 0 and (d // att.BWD_CHUNK) % 2 == 0
    assert layout["block_rows"] % 8 == 0  # wgmma's N


@pytest.mark.parametrize("d", [128, 256])
def test_train_shape_fills_the_card_in_one_wave(d):
    """[1, 1024, 4, D]: 32 resident rows a block make 128 blocks, one wave
    on 132 SMs at one block an SM (64-row blocks would leave half idle)."""
    layout = att.bwd_layout(d)
    blocks = math.ceil(1024 / layout["block_rows"]) * 4
    assert blocks == 128
    assert 0.9 * H100_SMS <= blocks <= H100_SMS * layout["blocks_per_sm"]


@pytest.mark.parametrize("d", [128, 256])
def test_check_bwd_layout_takes_the_wrappers_own(d):
    att.check_bwd_layout(list(att.bwd_layout(d).values()), d)


@pytest.mark.parametrize("field", range(5))
def test_check_bwd_layout_raises_when_the_kernel_drifts(field):
    reported = list(att.bwd_layout(256).values())
    reported[field] += 1
    with pytest.raises(RuntimeError, match="disagree"):
        att.check_bwd_layout(reported, 256)


@pytest.mark.parametrize("d", [64, 192, 512])
def test_bwd_layout_names_the_head_widths(d):
    with pytest.raises(ValueError, match="attention kernels take D"):
        att.bwd_layout(d)
