"""The 3xTF32 GEMM (``csrc/gemm_tf32x3.cu``) emulated in NumPy on the CPU:
its shared-memory layouts, its order of work and its arithmetic, which
the card alone can run.

- Layouts: a k-tile of A and B as TMA lands it (the 128-byte swizzle:
  16-byte chunk c of a 128-byte row r at chunk c ^ (r % 8)), the B planes
  the consumers write from it (``split_b``), the A fragments each
  consumer thread gathers (``load_a``), the wgmmas m64n128k8 that read
  both (fragment and core-matrix orders of ``mma_tf32.cuh``) and the
  epilogue's accumulator order, for the three operand layouts the Linear
  products use (forward, dX, dW), inside the matrices and at their
  edges. The address arithmetic mirrors the kernel's line by line.
- The units of work (``unit_at``): every tile and every k-tile of a
  launch once, and the wrapper's count of parts (``plan_splits``).
- The arithmetic: runs of two k-tiles (8 k-steps) summed from zero with
  the tensor cores' rounding toward zero, each added to the float32
  accumulator,
  over the decoder's longest contraction (11,264): within a small factor
  of a float32 product's error against float64, and far below one TF32
  pass's.
"""

import numpy as np
import pytest

from avsum_torch.ops import linear as lin
from avsum_torch.ops.melspec import split_tf32
from tests.test_torch_flash_split import emulate

TM, TN, TK = lin.TILE_M, lin.TILE_N, lin.TILE_K
RUN = 2 * TK // 8  # k-steps a run sums from zero: two k-tiles
KSTEP_BYTES = 4 * 8 * TN


def _swz(row, chunk):
    return row * 128 + ((chunk ^ (row % 8)) << 4)


def _tma_rows(mat, r0, c0, rows):
    """The box [rows][32] at (row r0, column c0) of ``mat``, swizzled, as
    32-bit words (zeros past the matrix)."""
    smem = np.zeros(rows * 32, np.float32)
    r, k = np.meshgrid(np.arange(rows), np.arange(32), indexing="ij")
    gr, gk = r0 + r, c0 + k
    inside = (gr < mat.shape[0]) & (gk < mat.shape[1])
    vals = np.where(inside, mat[np.minimum(gr, mat.shape[0] - 1),
                                np.minimum(gk, mat.shape[1] - 1)], 0)
    smem[(_swz(r, k // 4) + 4 * (k % 4)) // 4] = vals
    return smem


def _tma_cols(stored, c0, k0):
    """Four boxes [32 k][32 columns] at (column c0 + 32b, row k0) of a
    [K, cols] matrix, swizzled."""
    return np.concatenate([_tma_rows(stored, k0, c0 + 32 * b, 32)
                           for b in range(4)])


def _split_bits(x):
    """tf32::split: -> (big, small) as the words the MMA reads."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    big = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    small = (np.asarray(x, np.float32) - big.view(np.float32)).view(
        np.uint32) + np.uint32(0x1000)
    return big, small


def _tf32(words):
    return (words & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)


def _krow(l, perm):
    return (2 * l if l < 4 else 2 * (l - 4) + 1) if perm else l


def _split_b(tile, b_rows, perm):
    """``split_b`` for the 256 consumer threads -> (big, small) planes."""
    big = np.zeros(TN * TK, np.uint32)
    small = np.zeros(TN * TK, np.uint32)
    for ct in range(256):
        n = ct & 127
        dst_n = (n >> 3) * 256 + (n & 7) * 16
        for r in range(4):
            q = (ct >> 7) + 2 * r
            if b_rows:
                at = n * 128 + ((q ^ (n & 7)) << 4)
                v = tile[at // 4:at // 4 + 4]
            else:
                col = (n >> 5) * 4096 + (n & 3) * 4
                cn = (n & 31) >> 2
                v = []
                for i in range(4):
                    kp = 8 * (q >> 1) + _krow(4 * (q & 1) + i, perm)
                    v.append(tile[(col + kp * 128 + ((cn ^ (kp & 7)) << 4))
                                  // 4])
            hi, lo = _split_bits(np.array(v, np.float32))
            at = ((q >> 1) * KSTEP_BYTES + dst_n + (q & 1) * 128) // 4
            big[at:at + 4], small[at:at + 4] = hi, lo
    return big, small


def _load_a(tile, a_rows, grp, w, g, t):
    """``load_a``: -> the thread's [4 k-steps][4] values."""
    out = np.zeros((4, 4), np.float32)
    if a_rows:
        r0 = (64 * grp + 16 * w + g) * 128 + 4 * t
        for s in range(4):
            lo, hi = ((2 * s) ^ g) << 4, ((2 * s + 1) ^ g) << 4
            out[s] = [tile[(r0 + lo) // 4], tile[(r0 + 1024 + lo) // 4],
                      tile[(r0 + hi) // 4], tile[(r0 + 1024 + hi) // 4]]
    else:
        box = (2 * grp + (w >> 1)) * 4096 + 4 * (g & 3)
        cm = 4 * (w & 1) + (g >> 2)
        for s in range(4):
            k0 = 8 * s + 2 * t
            at0, at1 = box + k0 * 128, box + (k0 + 1) * 128
            out[s] = [tile[(at0 + ((cm ^ (2 * t)) << 4)) // 4],
                      tile[(at0 + (((cm + 2) ^ (2 * t)) << 4)) // 4],
                      tile[(at1 + ((cm ^ (2 * t + 1)) << 4)) // 4],
                      tile[(at1 + (((cm + 2) ^ (2 * t + 1)) << 4)) // 4]]
    return out


def _plane_b(plane, s):
    """The 8 x 128 B operand of k-step s as wgmma reads the plane: element
    (n, k) at (n / 8) * 256 + (k / 4) * 128 + (n % 8) * 16 + (k % 4) * 4."""
    n, k = np.meshgrid(np.arange(TN), np.arange(8), indexing="ij")
    at = s * KSTEP_BYTES + (n // 8) * 256 + (k // 4) * 128 + (n % 8) * 16 + (
        k % 4) * 4
    return plane[at // 4]


def emulate_tile(a, a_rows, b, b_rows, m0, n0, k0):
    """One k-tile's product of the tile at (m0, n0) as the kernel computes
    it -> [128, 128] float64 by the epilogue's order (row 64 grp + 16 w + g
    + 8h, column 8i + 2t + e from acc[4i + 2h + e])."""
    a_tile = _tma_rows(a, m0, k0, TM) if a_rows else _tma_cols(a, m0, k0)
    b_tile = _tma_rows(b, n0, k0, TN) if b_rows else _tma_cols(b, n0, k0)
    big, small = _split_b(b_tile, b_rows, perm=not a_rows)
    out = np.zeros((TM, TN))
    for grp in range(2):
        for w in range(4):
            frag = np.zeros((32, 4, 4), np.float32)  # lane, k-step, reg
            for lane in range(32):
                frag[lane] = _load_a(a_tile, a_rows, grp, w, lane >> 2,
                                     lane & 3)
            a_big, a_small = _split_bits(frag)
            d = np.zeros((16, TN))
            for s in range(4):
                # the m16n8k8 A fragment: reg 0 (g, t), 1 (g + 8, t),
                # 2 (g, t + 4), 3 (g + 8, t + 4)
                am = {}
                for name, words in (("big", a_big), ("small", a_small)):
                    mat = np.zeros((16, 8))
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        regs = _tf32(words[lane, s])
                        mat[g, t], mat[g + 8, t] = regs[0], regs[1]
                        mat[g, t + 4], mat[g + 8, t + 4] = regs[2], regs[3]
                    am[name] = mat
                bb, bs = _tf32(_plane_b(big, s)), _tf32(_plane_b(small, s))
                d += am["small"] @ bb.T + am["big"] @ bs.T + am["big"] @ bb.T
            acc = np.zeros((32, 64))
            for lane in range(32):  # the accumulator's fragment order
                g, t = lane >> 2, lane & 3
                for i in range(16):
                    for e in range(4):
                        acc[lane, 4 * i + e] = d[g + 8 * (e >> 1),
                                                 8 * i + 2 * t + (e & 1)]
            for lane in range(32):  # the epilogue's
                g, t = lane >> 2, lane & 3
                for i in range(16):
                    for h in range(2):
                        for e in range(2):
                            out[64 * grp + 16 * w + g + 8 * h,
                                8 * i + 2 * t + e] = acc[lane, 4 * i + 2 * h + e]
    return out


CASES = {  # (a_rows, b_rows): the Linear product it serves
    (True, True): "forward",
    (True, False): "dX",
    (False, False): "dW",
}


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("a_rows,b_rows", list(CASES))
def test_tile_layouts_give_the_product(a_rows, b_rows, edge):
    """A k-tile of C = A B^T through the emulated kernel equals the product
    to 3xTF32's accuracy, inside the matrices and at a tile hanging over
    their ends (M = 200, N = 180, K = 52: TMA's zeros past them)."""
    rng = np.random.default_rng(int(a_rows) * 2 + int(b_rows) + 4 * edge)
    m, n, k = (200, 180, 52) if edge else (384, 384, 96)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    m0, n0, k0 = (128, 128, 32) if edge else (128, 256, 64)
    got = emulate_tile(a if a_rows else np.ascontiguousarray(a.T), a_rows,
                       b if b_rows else np.ascontiguousarray(b.T), b_rows,
                       m0, n0, k0)
    rows, cols = min(TM, m - m0), min(TN, n - n0)
    want = (a[m0:m0 + rows, k0:k0 + TK].astype(np.float64)
            @ b[n0:n0 + cols, k0:k0 + TK].astype(np.float64).T)
    np.testing.assert_allclose(got[:rows, :cols], want, rtol=0, atol=2e-5)
    assert not got[rows:].any() and not got[:, cols:].any()


def _units(tiles_m, tiles_n, k_tiles, splits):
    """``unit_at`` over a launch: -> [(m0, n0, kb, ke)]."""
    out = []
    for u in range(tiles_m * tiles_n * splits):
        tile, s = divmod(u, splits)
        width = 8 * tiles_n
        first = (tile // width) * 8
        rows = min(tiles_m - first, 8)
        within = tile % width
        out.append(((first + within % rows) * TM, (within // rows) * TN,
                    s * k_tiles // splits, (s + 1) * k_tiles // splits))
    return out


@pytest.mark.parametrize("m,n,k", [
    (7168, 2048, 2048), (7168, 576, 2048), (576, 2048, 7168),
    (512, 296, 7168), (672, 2816, 2048), (2048, 1408, 672), (64, 64, 64)])
def test_units_cover_every_tile_and_k_tile_once(m, n, k):
    splits = lin.plan_splits(m, n, k, 132)
    tiles_m, tiles_n, k_tiles = -(-m // TM), -(-n // TN), -(-k // TK)
    assert 1 <= splits <= max(1, k_tiles // lin.MIN_SPLIT_K_TILES)
    seen = {}
    for m0, n0, kb, ke in _units(tiles_m, tiles_n, k_tiles, splits):
        assert kb < ke
        seen.setdefault((m0, n0), []).append((kb, ke))
    assert set(seen) == {(TM * i, TN * j) for i in range(tiles_m)
                         for j in range(tiles_n)}
    for parts in seen.values():
        assert sorted(parts)[0][0] == 0 and sorted(parts)[-1][1] == k_tiles
        assert all(a[1] == b[0] for a, b in zip(sorted(parts),
                                                sorted(parts)[1:]))
    if tiles_m * tiles_n >= 132:
        assert splits == 1
    else:
        assert tiles_m * tiles_n * splits <= lin.COUNTERS * lin.MAX_SPLITS


def test_split_k_fills_the_card_where_tiles_are_few():
    # the hour cell's dW of a 512 x 512 product over 7168 shots: 16 tiles
    assert lin.plan_splits(512, 512, 7168, 132) >= 6
    # the decoder's kv_a dW: 80 tiles
    assert lin.plan_splits(576, 2048, 7168, 132) > 1
    # short contractions keep whole tiles
    assert lin.plan_splits(512, 512, 64, 132) == 1


def _worst(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_runs_of_two_k_tiles_keep_float32_accuracy_over_the_longest_k():
    """The dense down projection's contraction, K = 11,264: runs of two
    k-tiles (8 k-steps) each added to the float32 accumulator stay within 4
    times a float32 product's error against float64, and at least 10 times
    below one TF32 pass's."""
    rng = np.random.default_rng(11264)
    a = rng.standard_normal((11264, 16)).astype(np.float32)
    b = rng.standard_normal((11264, 16)).astype(np.float32)
    want = a.T.astype(np.float64) @ b.astype(np.float64)
    three = _worst(emulate(a, b, a_split="rounded", run=RUN), want)
    f32 = _worst(a.T @ b, want)
    one = _worst(emulate(a, b, a_split="rounded", run=RUN, passes=1), want)
    assert three <= 4 * max(f32, 1e-7)
    assert one >= 10 * three
    parts = split_tf32(a[:4])
    np.testing.assert_array_equal(
        parts[..., 0], _tf32(_split_bits(a[:4])[0]).astype(np.float32))
