"""The flash kernels' tiling as the wrapper owns it (``avsum_torch.ops.
attention``: K2's ``fwd_layout`` and ``fwd_rows``, the backward's
``bwd_layout``), on the CPU: what ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` must report through ``avsum_flash_fwd_layout`` and
``avsum_flash_bwd_layout`` (the card-only tests
``test_flash_fwd_layout_matches_the_library`` and
``test_flash_bwd_layout_matches_the_library`` hold them together), that
each fits a Hopper block's shared memory, that the streamed tile is
wgmma's M, that the backward's cluster covers Dqk, and the grids the
block sizes give at the main path's shapes: at the train run's
[1, 1024, 4, 128] the backward fills the card in one wave. Each holds at
the square widths 128 and 256 and at latent attention's (Dqk, Dv) =
(192, 128)."""

import math

import pytest

from avsum_torch.ops import attention as att

H100_SMS = 132
# the width pairs (Dqk, Dv) the kernels take, named by D where square
WIDTHS = [pytest.param((128, 128), id="128"),
          pytest.param((256, 256), id="256"),
          pytest.param((192, 128), id="192-128")]


@pytest.mark.parametrize("d", WIDTHS)
def test_bwd_layout_fits_a_hopper_block(d):
    layout = att.bwd_layout(*d)
    assert layout["smem"] <= att.SMEM_LIMIT == 232_448
    assert layout["blocks_per_sm"] == 1
    # 1 KB to align the ring, the ring, ten [64 keys x 64 columns] planes
    # (K, K^T, V, P and dS, big and small), two mbarriers a stage and
    # four a warpgroup for the cluster's exchange; a cluster of 3 trades a
    # ring stage for an eleventh plane, its S exchange's second slot
    keys, tile = layout["block_keys"], layout["tile_rows"]
    planes = 10 + (layout["cluster"] == 3)
    assert layout["smem"] == (1024 + 4 * layout["stages"] * tile
                              * att.BWD_CHUNK + 4 * planes * keys
                              * att.BWD_CHUNK + 8 * (2 * layout["stages"] + 8))
    assert layout["smem"] == {128: 230_528, 256: 230_528, 192: 230_512}[d[0]]


@pytest.mark.parametrize("d", WIDTHS)
def test_streamed_tile_is_wgmma_m(d):
    layout = att.bwd_layout(*d)
    assert layout["tile_rows"] == 64
    # the resident keys are the N of the products over D and over the
    # tile, the streamed queries dQ's: m64n64 both ways
    assert layout["block_keys"] == layout["tile_rows"] == 64
    # the ring holds two tiles' Q and dO chunks; three chunks in a cluster
    # of 3
    assert layout["stages"] == (3 if layout["cluster"] == 3 else 4)


@pytest.mark.parametrize("d", WIDTHS)
def test_bwd_cluster_covers_d(d):
    """A CTA a 64-column chunk of Dqk (one TMA chunk, one m-tile of dK^T)
    and, while Dv lasts, of Dv (one m-tile of dV^T): 2 CTAs at D = 128, 4
    at D = 256, each with the same share; 3 at (192, 128), the first two
    with V."""
    dqk, dv = d
    layout = att.bwd_layout(dqk, dv)
    assert layout["cluster"] * att.BWD_CHUNK == dqk
    assert layout["cluster"] == {128: 2, 256: 4, 192: 3}[dqk]
    assert dv % att.BWD_CHUNK == 0 and dv <= dqk


# The backward's grid as csrc/flash_bwd.cu's note states it:
# (S, Dqk, heads) -> (clusters, CTAs)
BWD_GRIDS = {(1024, 128, 4): (64, 128), (1024, 256, 4): (64, 256),
             (7168, 128, 4): (448, 896), (7168, 256, 4): (448, 1792),
             (7168, 192, 16): (1792, 5376)}
DV_OF = {128: 128, 256: 256, 192: 128}


@pytest.mark.parametrize("s,d,h", [
    pytest.param(*key, id="-".join(map(str, key[:2] if key[2] == 4 else key)))
    for key in sorted(BWD_GRIDS)])
def test_bwd_grid_is_what_the_note_states(s, d, h):
    layout = att.bwd_layout(d, DV_OF[d])
    clusters = math.ceil(s / layout["block_keys"]) * h
    assert (clusters, clusters * layout["cluster"]) == BWD_GRIDS[s, d, h]


def _train_shape_ctas(layout):
    """CTAs of the backward at the train run's [1, 1024, 4, D]."""
    return math.ceil(1024 / layout["block_keys"]) * 4 * layout["cluster"]


@pytest.mark.parametrize("d", [128])
def test_train_shape_fills_the_card_in_one_wave(d):
    """[1, 1024, 4, 128]: 64 clusters of 2, 128 CTAs, one wave on 132 SMs
    at one CTA an SM. (How many clusters the card holds at once,
    ``bwd_max_clusters``, is the card test's to read.)"""
    layout = att.bwd_layout(d, d)
    ctas = _train_shape_ctas(layout)
    assert ctas == 128
    assert 0.9 * H100_SMS <= ctas <= H100_SMS * layout["blocks_per_sm"]


def test_train_shape_at_d256_takes_more_than_one_wave():
    """[1, 1024, 4, 256]: 64 clusters of 4, 256 CTAs, at least two waves
    on 132 SMs by the SM count alone; the card, holding fewer clusters of
    4 than its SMs would (a cluster's CTAs share a GPC), runs three."""
    layout = att.bwd_layout(256, 256)
    ctas = _train_shape_ctas(layout)
    assert ctas == 256
    assert math.ceil(ctas / (H100_SMS * layout["blocks_per_sm"])) >= 2


@pytest.mark.parametrize("d", WIDTHS)
def test_check_bwd_layout_takes_the_wrappers_own(d):
    att.check_bwd_layout(list(att.bwd_layout(*d).values()), *d)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("field", range(6))
def test_check_bwd_layout_raises_when_the_kernel_drifts(field, d):
    reported = list(att.bwd_layout(*d).values())
    reported[field] += 1
    with pytest.raises(RuntimeError, match="disagree"):
        att.check_bwd_layout(reported, *d)


# pairs the kernels lack: square widths they do not take, and latent
# attention's widths swapped or with another v
@pytest.mark.parametrize("d", [
    pytest.param((64, 64), id="64"), pytest.param((192, 192), id="192"),
    pytest.param((512, 512), id="512"), pytest.param((128, 192), id="128-192"),
    pytest.param((192, 256), id="192-256"),
    pytest.param((256, 128), id="256-128")])
def test_bwd_layout_names_the_head_widths(d):
    with pytest.raises(ValueError, match="attention kernels take"):
        att.bwd_layout(*d)


# K2: the grid at the main path's shapes, as csrc/flash_fwd.cu's note
# states it: (S, heads) -> (queries a block owns, blocks)
FWD_GRIDS = {(544, 4): (32, 68), (1024, 4): (32, 128), (7168, 4): (64, 448),
             (7168, 16): (64, 1792)}


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", WIDTHS)
def test_fwd_layout_fits_a_hopper_block(d, rows):
    layout = att.fwd_layout(*d, rows)
    assert layout["smem"] <= att.SMEM_LIMIT == 232_448
    assert layout["blocks_per_sm"] == 1
    # 1 KB to align the ring, the queries' big and small planes (Dqk wide),
    # P's, the softmax's float a warpgroup, warp and half of the queries,
    # alpha's float a query, and per stage a 16 KB chunk and two
    # mbarriers: as many stages as fit
    fixed = (1024 + 4 * 2 * rows * d[0] + 4 * 2 * rows * layout["tile_rows"]
             + 4 * 5 * rows)
    stage = 4 * layout["tile_rows"] * att.BWD_CHUNK + 16
    assert layout["smem"] == fixed + layout["stages"] * stage
    assert att.SMEM_LIMIT - layout["smem"] < stage
    assert layout["stages"] >= 4


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", WIDTHS)
def test_fwd_streamed_tile_is_wgmma_m(d, rows):
    dqk, dv = d
    layout = att.fwd_layout(dqk, dv, rows)
    assert layout["tile_rows"] == 64
    # the block's queries are the N of every product (32 or 64: wgmma's
    # N near its peak rate); the two warpgroups take Dqk's 64-column
    # chunks by turns (2 : 1 at 192), and one 64-row m-tile of O^T each
    # at Dv = 128, two at 256
    assert rows % 8 == 0 and 32 <= rows <= 64
    assert dqk % att.BWD_CHUNK == 0 and dqk // att.BWD_CHUNK in (2, 3, 4)
    assert dv % att.BWD_CHUNK == 0 and (dv // att.BWD_CHUNK) % 2 == 0


@pytest.mark.parametrize("s,h", [
    pytest.param(*key, id=str(key[0]) if key[1] == 4 else f"{key[0]}-{key[1]}")
    for key in sorted(FWD_GRIDS)])
def test_fwd_block_size_gives_the_stated_grid(s, h):
    """[1, S, H, D] on a 132-SM H100: 64-query blocks where they cover the
    SMs, else 32-query blocks."""
    rows, blocks = FWD_GRIDS[s, h]
    assert att.fwd_rows(1, s, h, H100_SMS) == rows
    assert math.ceil(s / rows) * h == blocks


@pytest.mark.parametrize("b,s,rows", [(2, 1024, 32), (3, 1024, 64),
                                      (11, 129, 64), (10, 129, 32)])
def test_fwd_rows_switches_where_64_query_blocks_cover_the_sms(b, s, rows):
    assert att.fwd_rows(b, s, 4, H100_SMS) == rows


@pytest.mark.parametrize("d", WIDTHS)
def test_check_fwd_layout_takes_the_wrappers_own(d):
    for rows in att.FWD_ROWS:
        att.check_fwd_layout(list(att.fwd_layout(*d, rows).values()), *d,
                             rows)


@pytest.mark.parametrize("field", range(5))
def test_check_fwd_layout_raises_when_the_kernel_drifts(field):
    for d in ((256, 256), (192, 128)):
        reported = list(att.fwd_layout(*d, 64).values())
        reported[field] += 1
        with pytest.raises(RuntimeError, match="disagree"):
            att.check_fwd_layout(reported, *d, 64)


@pytest.mark.parametrize("d,rows", [
    pytest.param((64, 64), 64, id="64-64"),
    pytest.param((192, 192), 32, id="192-32"),
    pytest.param((256, 256), 16, id="256-16"),
    pytest.param((128, 128), 128, id="128-128"),
    pytest.param((128, 192), 64, id="128-192-64"),
    pytest.param((256, 128), 32, id="256-128-32"),
    pytest.param((192, 128), 16, id="192-128-16")])
def test_fwd_layout_names_the_head_widths_and_block_sizes(d, rows):
    with pytest.raises(ValueError, match="attention kernels take|K2 takes"):
        att.fwd_layout(*d, rows)
