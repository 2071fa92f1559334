"""The flash kernels' tiling as the wrapper owns it (``avsum_torch.ops.
attention``: K2's ``fwd_layout`` and ``fwd_rows``, B3's and B4's
``bwd_layout``), on the CPU: what ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` must report through ``avsum_flash_fwd_layout`` and
``avsum_flash_bwd_layout`` (the card-only tests
``test_flash_fwd_layout_matches_the_library`` and
``test_flash_bwd_layout_matches_the_library`` hold them together), that
each fits a Hopper block's shared memory, that the streamed tile is
wgmma's M, and the grids the block sizes give at the main path's shapes:
the train run's [1, 1024, 4, D] fills the card in one wave."""

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


# K2: the grid at the main path's shapes, as csrc/flash_fwd.cu's note
# states it: S -> (queries a block owns, blocks)
FWD_GRIDS = {544: (32, 68), 1024: (32, 128), 7168: (64, 448)}


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", [128, 256])
def test_fwd_layout_fits_a_hopper_block(d, rows):
    layout = att.fwd_layout(d, rows)
    assert layout["smem"] <= att.SMEM_LIMIT == 232_448
    assert layout["blocks_per_sm"] == 1
    # 1 KB to align the ring, the queries' big and small planes, P's, the
    # softmax's float a warpgroup, warp and half of the queries, alpha's
    # float a query, and per stage a 16 KB chunk and two mbarriers: as
    # many stages as fit
    fixed = (1024 + 4 * 2 * rows * d + 4 * 2 * rows * layout["tile_rows"]
             + 4 * 5 * rows)
    stage = 4 * layout["tile_rows"] * att.BWD_CHUNK + 16
    assert layout["smem"] == fixed + layout["stages"] * stage
    assert att.SMEM_LIMIT - layout["smem"] < stage
    assert layout["stages"] >= 4


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", [128, 256])
def test_fwd_streamed_tile_is_wgmma_m(d, rows):
    layout = att.fwd_layout(d, rows)
    assert layout["tile_rows"] == 64
    # the block's queries are the N of every product (32 or 64: wgmma's
    # N near its peak rate); the two warpgroups take D's 64-column chunks
    # by turns, one 64-row m-tile of O^T each
    assert rows % 8 == 0 and 32 <= rows <= 64
    assert d % att.BWD_CHUNK == 0 and (d // att.BWD_CHUNK) % 2 == 0


@pytest.mark.parametrize("s", sorted(FWD_GRIDS))
def test_fwd_block_size_gives_the_stated_grid(s):
    """[1, S, 4, D] on a 132-SM H100: 64-query blocks where they cover the
    SMs, else 32-query blocks."""
    rows, blocks = FWD_GRIDS[s]
    assert att.fwd_rows(1, s, 4, H100_SMS) == rows
    assert math.ceil(s / rows) * 4 == blocks


@pytest.mark.parametrize("b,s,rows", [(2, 1024, 32), (3, 1024, 64),
                                      (11, 129, 64), (10, 129, 32)])
def test_fwd_rows_switches_where_64_query_blocks_cover_the_sms(b, s, rows):
    assert att.fwd_rows(b, s, 4, H100_SMS) == rows


@pytest.mark.parametrize("d", [128, 256])
def test_check_fwd_layout_takes_the_wrappers_own(d):
    for rows in att.FWD_ROWS:
        att.check_fwd_layout(list(att.fwd_layout(d, rows).values()), d, rows)


@pytest.mark.parametrize("field", range(5))
def test_check_fwd_layout_raises_when_the_kernel_drifts(field):
    reported = list(att.fwd_layout(256, 64).values())
    reported[field] += 1
    with pytest.raises(RuntimeError, match="disagree"):
        att.check_fwd_layout(reported, 256, 64)


@pytest.mark.parametrize("d,rows", [(64, 64), (192, 32), (256, 16),
                                    (128, 128)])
def test_fwd_layout_names_the_head_widths_and_block_sizes(d, rows):
    with pytest.raises(ValueError, match="attention kernels take D|K2 takes"):
        att.fwd_layout(d, rows)
