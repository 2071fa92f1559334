"""The flash kernels' tiling as the wrapper owns it (``avsum_torch.ops.
attention``: K2's ``fwd_layout`` and ``fwd_rows``, the backward's
``bwd_layout``), on the CPU: what ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` must report through ``avsum_flash_fwd_layout`` and
``avsum_flash_bwd_layout`` (the card-only tests
``test_flash_fwd_layout_matches_the_library`` and
``test_flash_bwd_layout_matches_the_library`` hold them together), that
each fits a Hopper block's shared memory, that the streamed tile is
wgmma's M, that the backward's cluster covers D, and the grids the block
sizes give at the main path's shapes: at the train run's
[1, 1024, 4, 128] the backward fills the card in one wave."""

import math

import pytest

from avsum_torch.ops import attention as att

H100_SMS = 132


@pytest.mark.parametrize("d", [128, 256])
def test_bwd_layout_fits_a_hopper_block(d):
    layout = att.bwd_layout(d)
    assert layout["smem"] <= att.SMEM_LIMIT == 232_448
    assert layout["blocks_per_sm"] == 1
    # 1 KB to align the ring, the ring, ten [64 keys x 64 columns] planes
    # (K, K^T, V, P and dS, big and small), two mbarriers a stage and
    # four a warpgroup for the cluster's exchange: the same at both D
    keys, tile = layout["block_keys"], layout["tile_rows"]
    assert layout["smem"] == (1024 + 4 * layout["stages"] * tile
                              * att.BWD_CHUNK + 4 * 10 * keys * att.BWD_CHUNK
                              + 8 * (2 * layout["stages"] + 8)) == 230_528


@pytest.mark.parametrize("d", [128, 256])
def test_streamed_tile_is_wgmma_m(d):
    layout = att.bwd_layout(d)
    assert layout["tile_rows"] == 64
    # the resident keys are the N of the products over D and over the
    # tile, the streamed queries dQ's: m64n64 both ways
    assert layout["block_keys"] == layout["tile_rows"] == 64
    # the ring holds two tiles' Q and dO chunks
    assert layout["stages"] == 4


@pytest.mark.parametrize("d", [128, 256])
def test_bwd_cluster_covers_d(d):
    """A CTA a 64-column chunk of D (one TMA chunk, one m-tile of dK^T and
    dV^T): 2 CTAs at D = 128, 4 at D = 256, each with the same share."""
    layout = att.bwd_layout(d)
    assert layout["cluster"] * att.BWD_CHUNK == d
    assert layout["cluster"] == {128: 2, 256: 4}[d]


# The backward's grid as csrc/flash_bwd.cu's note states it:
# (S, D) -> (clusters, CTAs)
BWD_GRIDS = {(1024, 128): (64, 128), (1024, 256): (64, 256),
             (7168, 128): (448, 896), (7168, 256): (448, 1792)}


@pytest.mark.parametrize("s,d", sorted(BWD_GRIDS))
def test_bwd_grid_is_what_the_note_states(s, d):
    layout = att.bwd_layout(d)
    clusters = math.ceil(s / layout["block_keys"]) * 4
    assert (clusters, clusters * layout["cluster"]) == BWD_GRIDS[s, d]


def _train_shape_ctas(layout):
    """CTAs of the backward at the train run's [1, 1024, 4, D]."""
    return math.ceil(1024 / layout["block_keys"]) * 4 * layout["cluster"]


@pytest.mark.parametrize("d", [128])
def test_train_shape_fills_the_card_in_one_wave(d):
    """[1, 1024, 4, 128]: 64 clusters of 2, 128 CTAs, one wave on 132 SMs
    at one CTA an SM. (How many clusters the card holds at once,
    ``bwd_max_clusters``, is the card test's to read.)"""
    layout = att.bwd_layout(d)
    ctas = _train_shape_ctas(layout)
    assert ctas == 128
    assert 0.9 * H100_SMS <= ctas <= H100_SMS * layout["blocks_per_sm"]


def test_train_shape_at_d256_takes_more_than_one_wave():
    """[1, 1024, 4, 256]: 64 clusters of 4, 256 CTAs, at least two waves
    on 132 SMs by the SM count alone; the card, holding fewer clusters of
    4 than its SMs would (a cluster's CTAs share a GPC), runs three."""
    layout = att.bwd_layout(256)
    ctas = _train_shape_ctas(layout)
    assert ctas == 256
    assert math.ceil(ctas / (H100_SMS * layout["blocks_per_sm"])) >= 2


@pytest.mark.parametrize("d", [128, 256])
def test_check_bwd_layout_takes_the_wrappers_own(d):
    att.check_bwd_layout(list(att.bwd_layout(d).values()), d)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("field", range(6))
def test_check_bwd_layout_raises_when_the_kernel_drifts(field, d):
    reported = list(att.bwd_layout(d).values())
    reported[field] += 1
    with pytest.raises(RuntimeError, match="disagree"):
        att.check_bwd_layout(reported, d)


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
