"""The 3xTF32 arithmetic of the flash kernels, the forward K2
(``csrc/flash_fwd.cu``) and the fused backward (``csrc/flash_bwd.cu``),
emulated in NumPy on the CPU: can the split the kernels use meet the
card's tolerance on the gradients (``chip_smoke.py``'s ``B34_TOL``, rtol =
atol = 1e-4) and on the forward's output and LSE (``K2_TOL``, rtol = atol
= 1e-5) at the hour step's S = 7168?

The emulation follows the kernels: the A operand, read from every
streamed tile, split in two instructions (``mma_tf32.cuh``'s
``split_trunc``: big = x truncated to TF32, small = x - big, which the MMA
truncates too), or by ``split`` (both parts rounded) for comparison; the B
planes split by ``split``; a product of 8 k-steps summed from zero, each
k-step's three TF32 terms (small x big, big x small, big x big, the small
terms first) added exactly and rounded toward zero into float32, as the
tensor cores accumulate; that run's sum then added to the float32
accumulator rounding to nearest.
Held against float64 on seeded [7168, 256] rows: the contraction over
the sequence (dK^T = Q^T dS, dV^T = dO^T P) and over D (S = Q K^T); the
whole forward, tile by tile with its online softmax, against the
softmax in float64; and the whole fused backward (partial S and dP over
each CTA's 64 columns summed over the cluster, P and dS, dV^T, dK^T over
the query tiles, dQ per key block summed over the key blocks in a
shuffled order) against the same formulas in float64."""

import numpy as np
import pytest

from avsum_torch.ops.melspec import split_tf32

B34_TOL = 1e-4  # chip_smoke.py: rtol = atol on dq, dk, dv
RUN = 8  # k-steps a product sums from zero
S, D, N = 7168, 256, 16  # rows, head width, one warpgroup's resident rows


def _trunc_tf32(a):
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a, how):
    """-> (big, small) float32 as the MMA reads them: ``split`` (rounded)
    or ``split_trunc`` (truncated)."""
    if how == "rounded":
        parts = split_tf32(a)
        return parts[..., 0], parts[..., 1]
    hi = _trunc_tf32(a)
    return hi, _trunc_tf32(a - hi)


def _add_toward_zero(acc, x):
    """float32(acc + x) rounded toward zero (the sum exact in float64)."""
    exact = acc.astype(np.float64) + x
    near = exact.astype(np.float32)
    over = np.abs(near.astype(np.float64)) > np.abs(exact)
    return np.where(over, np.nextafter(near, np.float32(0)), near)


def emulate(a, b, a_split="truncated", run=RUN, passes=3):
    """a [K, M], b [K, N] float32 -> a^T b [M, N] float32 as the kernels'
    wgmmas sum it: a split by ``a_split``, b by ``split``; k-steps of 8 in
    runs of ``run``; ``passes`` 3 is 3xTF32, 1 a single TF32 product."""
    a_hi, a_lo = _split(a, a_split)
    b_hi, b_lo = _split(b, "rounded")
    terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3
             else [(a_hi, b_hi)])
    k = a.shape[0]
    acc = np.zeros((a.shape[1], b.shape[1]), np.float32)
    for r0 in range(0, k, 8 * run):
        part = np.zeros_like(acc)
        for x, y in terms:
            for k0 in range(r0, min(r0 + 8 * run, k), 8):
                step = np.einsum("km,kn->mn", x[k0:k0 + 8].astype(np.float64),
                                 y[k0:k0 + 8].astype(np.float64))
                part = _add_toward_zero(part, step)
        acc = (acc.astype(np.float32) + part).astype(np.float32)
    return acc


def _worst(got, want):
    """max of |got - want| / (atol + rtol |want|): <= 1 within B34_TOL."""
    return float(np.max(np.abs(got - want) / (B34_TOL + B34_TOL * np.abs(want))))


def _sequence_case(seed):
    """Q [S, D] and dS [S, N] at the scale a unit-sized gradient has."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, D)).astype(np.float32)
    ds = (rng.standard_normal((S, N)) / np.sqrt(S)).astype(np.float32)
    return q, ds


@pytest.mark.parametrize("a_split", ["truncated", "rounded"])
def test_split_meets_b34_tol_over_the_sequence(a_split):
    """dK^T = Q^T dS over 7168 rows (896 k-steps, 112 runs)."""
    q, ds = _sequence_case(7168)
    want = q.astype(np.float64).T @ ds.astype(np.float64)
    worst = _worst(emulate(q, ds, a_split), want)
    assert worst < 0.1, worst  # within a tenth of the tolerance


@pytest.mark.parametrize("a_split", ["truncated", "rounded"])
def test_split_meets_b34_tol_over_d(a_split):
    """S = Q K^T over D = 256 (32 k-steps), |S| up to ~60, where a score
    error of 1e-4 moves P by 1e-4 / 16 relative."""
    rng = np.random.default_rng(256)
    q = rng.standard_normal((D, 64)).astype(np.float32)
    k = rng.standard_normal((D, N)).astype(np.float32)
    want = q.astype(np.float64).T @ k.astype(np.float64)
    worst = _worst(emulate(q, k, a_split), want)
    assert worst < 0.1, worst


def test_one_tf32_pass_misses_b34_tol():
    """The emulation has the power to fail: one TF32 product (three
    decimal digits) misses the tolerance on the same rows."""
    q, ds = _sequence_case(7168)
    want = q.astype(np.float64).T @ ds.astype(np.float64)
    assert _worst(emulate(q, ds, passes=1), want) > 1.0


def test_runs_of_8_drift_less_than_one_long_run():
    """Summing each run of 8 k-steps from zero keeps the tensor cores'
    rounding toward zero from piling up over the 896 k-steps."""
    q, ds = _sequence_case(1)
    want = q.astype(np.float64).T @ ds.astype(np.float64)
    short = np.abs(emulate(q, ds) - want).max()
    long = np.abs(emulate(q, ds, run=S // 8) - want).max()
    assert short < long


# K2 (csrc/flash_fwd.cu), the forward: per 64-key tile, S^T = K Q^T over D
# (A the K tile, B the query planes), one run of 8 k-steps a 64-column
# chunk of D, the two warpgroups' chunks (even, odd) summed apart and then
# added; the online softmax over the tile's keys with the running max and
# sum; then O^T = alpha O^T + V^T P^T over the tile (A the V tile, B the P
# planes), one run a 64-row m-tile of D
K2_TOL = 1e-5  # chip_smoke.py: rtol = atol on the output and the LSE
FWD_TILE = 64  # keys a tile: wgmma's M
FWD_N = 64  # queries a block owns at long S: wgmma's N


LOG2E = np.float32(np.log2(np.e))


def emulate_forward(q, k, v, a_split="truncated", passes=3):
    """q [N, D], k and v [S, D] float32 -> (out [N, D], lse [N]) as K2
    computes them: every product by :func:`emulate`, the scores scaled by
    scale * log2(e) in float32, the softmax in base 2 and the running sums
    in float32, the accumulator multiplied by alpha and then the tile's
    product added, each rounded; LSE = m / log2(e) + log(l)."""
    n, d = q.shape
    scale = np.float32(d ** -0.5) * LOG2E
    m_run = np.full(n, -np.inf, np.float32)
    l_run = np.zeros(n, np.float32)
    acc = np.zeros((d, n), np.float32)
    for k0 in range(0, k.shape[0], FWD_TILE):
        kt, vt = k[k0:k0 + FWD_TILE], v[k0:k0 + FWD_TILE]
        runs = [emulate(kt[:, c:c + 64].T, q[:, c:c + 64].T, a_split,
                        passes=passes) for c in range(0, d, 64)]
        s = (np.sum(runs[0::2], 0, dtype=np.float32)
             + np.sum(runs[1::2], 0, dtype=np.float32)) * scale  # [keys, N]
        m_new = np.maximum(m_run, s.max(0))
        alpha = np.exp2(m_run - m_new)
        p = np.exp2(s - m_new).astype(np.float32)
        l_run = (l_run * alpha + p.sum(0, dtype=np.float32)).astype(np.float32)
        m_run = m_new
        part = emulate(vt, p, a_split, passes=passes)  # [D, N]
        acc = (acc * alpha).astype(np.float32) + part
    l_run = np.maximum(l_run, np.float32(1e-30))
    return (acc / l_run).T, m_run / LOG2E + np.log(l_run)


def _forward_case(seed, s=S, d=D, n=FWD_N):
    """Unit-normal queries, keys and values, as chip_smoke.py's K2 cases."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((m, d)).astype(np.float32)
               for m in (n, s, s))
    logits = q.astype(np.float64) @ k.astype(np.float64).T * d ** -0.5
    lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) \
        + logits.max(1)
    out = np.exp(logits - lse[:, None]) @ v.astype(np.float64)
    return (q, k, v), (out, lse)


def _worst_k2(got, want):
    """max over O and LSE of |got - want| / (atol + rtol |want|): <= 1
    within K2_TOL."""
    return max(float(np.max(np.abs(g - w) / (K2_TOL + K2_TOL * np.abs(w))))
               for g, w in zip(got, want))


def test_masked_lse_survives_base_2():
    """A row with every key masked has m = -1e30 log2(e) in base 2, and
    its LSE must come back as -1e30 exactly: B3 and B4 recompute its P as
    exp(-1e30 - LSE), which a LSE below -1e30 by an ulp would make inf."""
    m = np.float32(-1e30) * LOG2E
    lse = m / LOG2E + np.float32(np.log(np.float32(7168)))
    assert lse == np.float32(-1e30)


@pytest.fixture(scope="module")
def forward_case():
    return _forward_case(7168)


@pytest.mark.parametrize("a_split", ["truncated", "rounded"])
def test_forward_meets_k2_tol_at_the_hour_step(forward_case, a_split):
    """O and LSE over S = 7168 keys in 112 tiles at D = 256: the A operand
    (the K and V tiles) split by ``split_trunc`` (the kernel's) or
    ``split``, the query and P planes by ``split``."""
    inputs, want = forward_case
    worst = _worst_k2(emulate_forward(*inputs, a_split), want)
    assert worst < 0.5, worst  # within half the tolerance


def test_forward_one_tf32_pass_misses_k2_tol(forward_case):
    """The forward's emulation has the power to fail: one TF32 product
    misses K2's tolerance on the same inputs."""
    inputs, want = forward_case
    assert _worst_k2(emulate_forward(*inputs, passes=1), want) > 1.0


# The fused backward (csrc/flash_bwd.cu): a cluster of Dqk / 64 CTAs owns
# 64 keys; CTA c forms the partial S_c = Q_c K_c^T and dP_c = dO_c V_c^T
# over its 64 columns of Dqk and of Dv (one run of 8 k-steps, A the
# streamed chunk by row, B the resident planes; at (192, 128) CTA 2's dP_c
# is zero), the cluster sums the partials in float32 as p0 + p1,
# (p0 + p1) + p2 or (p0 + p1) + (p2 + p3) (every CTA the same sum); P = exp(S * scale - LSE), read back by the dS group as big + small
# from its planes; dS = P (dP - delta); dV_c^T += dO_c^T P and dK_c^T +=
# Q_c^T dS one run a 64-query tile (A the chunk by column, B the P and dS
# planes); dQ_c = dS K_c one run a key block (A dS truncated in registers,
# B the transposed K planes), scaled, and added to dQ in float32 by the
# key blocks in whatever order they run.
BWD_KEYS = 64  # keys a cluster owns
BWD_BLOCK_AT = 37  # the key block whose dK and dV are emulated
BWD_TILE_AT = 61  # the query tile whose dQ is emulated


def _readback(p):
    """P as the dS group reads it back from its big and small planes:
    big = tf32(P) rounded, plus the small plane's bits (x - big with half a
    TF32 ulp added for the MMA's truncation), summed in float32."""
    big = _split(p, "rounded")[0]
    bits = (p - big).astype(np.float32).view(np.uint32) + np.uint32(0x1000)
    return (big + bits.view(np.float32)).astype(np.float32)


def _cluster_sum(a_rows, b_rows, passes):
    """The sum over the cluster's CTAs c, in float32 pairs, of the partial
    a_c b_c^T over CTA c's 64 columns: a_rows [M, D], b_rows [N, D]."""
    parts = [emulate(a_rows[:, c:c + 64].T, b_rows[:, c:c + 64].T,
                     passes=passes) for c in range(0, a_rows.shape[1], 64)]
    if len(parts) == 2:
        return parts[0] + parts[1]
    if len(parts) == 3:
        return (parts[0] + parts[1]) + parts[2]
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def emulate_backward(q, k, v, do, lse, delta, passes=3, seed=0):
    """q, k [S, Dqk], v, do [S, Dv] float32, lse and delta [S] -> (dk
    [64, Dqk], dv [64, Dv]) of key block BWD_BLOCK_AT and dq [64, Dqk] of
    query tile BWD_TILE_AT, as the fused kernel computes them."""
    s_len, d = q.shape
    scale = np.float32(d ** -0.5)
    kb = slice(BWD_BLOCK_AT * BWD_KEYS, (BWD_BLOCK_AT + 1) * BWD_KEYS)
    qt = slice(BWD_TILE_AT * FWD_TILE, (BWD_TILE_AT + 1) * FWD_TILE)

    def p_ds(rows, keys):
        x = _cluster_sum(q[rows], k[keys], passes)
        y = _cluster_sum(do[rows], v[keys], passes)
        p = np.exp((x * scale).astype(np.float32)
                   - lse[rows, None]).astype(np.float32)
        ds = (_readback(p) * (y - delta[rows, None])).astype(np.float32)
        return p, ds

    # dV^T and dK^T of the key block over every query tile
    p, ds = p_ds(slice(None), kb)
    dv = np.concatenate([emulate(do[:, c:c + 64], p, passes=passes)
                         for c in range(0, do.shape[1], 64)]).T
    dk = np.concatenate([emulate(q[:, c:c + 64], ds, passes=passes)
                         for c in range(0, d, 64)]).T * scale
    # dQ of the query tile: a [64 x 64] block a key block and CTA, summed
    # over the key blocks in a shuffled order
    _, ds = p_ds(qt, slice(None))
    dq = np.zeros((FWD_TILE, d), np.float32)
    order = np.random.default_rng(seed).permutation(s_len // BWD_KEYS)
    for j in order:
        keys = slice(j * BWD_KEYS, (j + 1) * BWD_KEYS)
        block = np.concatenate(
            [emulate(ds[:, keys].T, k[keys, c:c + 64], passes=passes)
             for c in range(0, d, 64)], axis=1)
        dq = (dq + (block * scale).astype(np.float32)).astype(np.float32)
    return dq, dk.astype(np.float32), dv.astype(np.float32)


def _backward_case(widths, s=S, seed=5):
    """Unit-normal q, k [S, Dqk], v, dO [S, Dv] and the forward's LSE and
    delta = rowsum(dO o O) in float32 (from float32 products, row block by
    row block); -> the inputs and the float64 gradients (dq of the query
    tile, dk and dv of the key block) from the same inputs."""
    d, dv = widths
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((s, w)).astype(np.float32)
                   for w in (d, d, dv, dv))
    scale = d ** -0.5
    lse = np.empty(s, np.float32)
    delta = np.empty(s, np.float32)
    for r in range(0, s, 1024):
        logits = (q[r:r + 1024] @ k.T).astype(np.float64) * scale
        m = logits.max(1, keepdims=True)
        e = np.exp(logits - m)
        lse[r:r + 1024] = (np.log(e.sum(1)) + m[:, 0]).astype(np.float32)
        dp = (do[r:r + 1024] @ v.T).astype(np.float64)
        delta[r:r + 1024] = ((e * dp).sum(1) / e.sum(1)).astype(np.float32)
    q64, k64, v64, do64 = (x.astype(np.float64) for x in (q, k, v, do))
    kb = slice(BWD_BLOCK_AT * BWD_KEYS, (BWD_BLOCK_AT + 1) * BWD_KEYS)
    qt = slice(BWD_TILE_AT * FWD_TILE, (BWD_TILE_AT + 1) * FWD_TILE)

    def p_ds(rows, keys):
        p = np.exp(q64[rows] @ k64[keys].T * scale - lse[rows, None])
        return p, p * (do64[rows] @ v64[keys].T - delta[rows, None])

    p, ds = p_ds(slice(None), kb)
    dv, dk = p.T @ do64, ds.T @ q64 * scale
    _, ds = p_ds(qt, slice(None))
    dq = ds @ k64 * scale
    return (q, k, v, do, lse, delta), (dq, dk, dv)


@pytest.fixture(scope="module", params=[
    pytest.param((128, 128), id="128"), pytest.param((256, 256), id="256"),
    pytest.param((192, 128), id="192-128")])
def backward_case(request):
    return _backward_case(request.param)


def test_fused_backward_meets_b34_tol_at_the_hour_step(backward_case):
    """dq, dk and dv at S = 7168 (112 query tiles, 112 key blocks, the
    cluster's 2, 3 or 4 partial sums), D = 128 and 256 and (Dqk, Dv) =
    (192, 128), the dQ blocks summed in a shuffled order."""
    inputs, want = backward_case
    got = emulate_backward(*inputs)
    worst = [_worst(g, w) for g, w in zip(got, want)]
    assert max(worst) < 0.1, worst  # within a tenth of the tolerance


def test_fused_backward_one_tf32_pass_misses_b34_tol(backward_case):
    """The backward's emulation has the power to fail: one TF32 product
    for each of the five misses the tolerance on the same inputs."""
    inputs, want = backward_case
    got = emulate_backward(*inputs, passes=1)
    assert max(_worst(g, w) for g, w in zip(got, want)) > 1.0
