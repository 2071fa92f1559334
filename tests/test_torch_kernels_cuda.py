"""The CUDA kernels against their plain versions on the card: K1
(log-mel, at 128 and 64 mel bands, and on a quiet waveform), K2
(flash-attention forward, in its 32- and 64-query blocks) and the fused
backward (dQ, dK, dV in one launch) against their plain versions, and
K2 -> the backward through the autograd Function against autograd of the
plain attention; the flash kernels at the square head widths and at
latent attention's q/k 192, v 128; the Linear GEMM's forward, dX and dW
at the main path's shapes against float64.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. The card machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

float32 with TF32 off. Tolerances: K1 rtol = atol = 2e-3 (the JAX
kernel test's), K2 rtol = atol = 1e-5, the backward rtol = atol = 1e-4 on
the gradients, the GEMM within 3 times cuBLAS float32's error against
float64.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from avsum_torch.ops.attention import (
    attention_fwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    flash_bwd,
    flash_bwd_plain,
    fwd_rows,
)
from avsum_torch.ops.melspec import fused_log_mel, log_mel_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_melspec(x, n_mels):
    before = fused_log_mel.launches
    mel, lm = fused_log_mel(x, n_mels=n_mels)
    assert fused_log_mel.launches == before + 1
    mel_p, lm_p = log_mel_plain(x, n_mels=n_mels)
    assert mel.shape == (1 + x.numel() // 200, n_mels)
    torch.testing.assert_close(mel, mel_p, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(lm, lm_p, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_mels", [128, 64])
@pytest.mark.parametrize("n", [1000, 160_000, 48_123])
def test_melspec_kernel_matches_plain(cuda, n, n_mels):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(0.3 * rng.standard_normal(n).astype(np.float32))
    _check_melspec(x.to(cuda), n_mels)


@pytest.mark.parametrize("n_mels", [128, 64])
def test_melspec_kernel_keeps_60_db_of_dynamic_range(cuda, n_mels):
    """A tone at 0.5, then a stretch at 5e-4 (60 dB down), then 1 s of
    exact silence: quiet bands beside loud ones, which one TF32 pass
    (three digits) would not keep within the tolerance of log2(mel + eps)."""
    t = np.arange(16000) / 16000
    rng = np.random.default_rng(7)
    x = np.concatenate([
        0.5 * np.sin(2 * np.pi * 440 * t),
        5e-4 * (np.sin(2 * np.pi * 3000 * t)
                + 0.5 * rng.standard_normal(16000)),
        np.zeros(16000)]).astype(np.float32)
    _check_melspec(torch.from_numpy(x).to(cuda), n_mels)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [512, 545])
def test_flash_kernel_matches_plain(cuda, d, s):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = torch.randn(2, s, 3, 4, d, device=cuda, generator=g).unbind(2)
    mask = torch.ones(2, s, device=cuda)
    mask[0, s // 2:] = 0.0
    mask[1] = 0.0
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out, attention_plain(q, k, v, mask),
                               rtol=1e-5, atol=1e-5)


def _bwd_case(cuda, b, s, d, seed):
    """qkv [B, S, 3, 4, D] (q, k, v are strided views of it), a mask with a
    padded tail in row 0 and no valid key in row 1 (when B > 1), and a
    cotangent zeroed at masked queries."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3, 4, d, device=cuda, generator=g)
    mask = torch.ones(b, s, device=cuda)
    mask[0, s - s // 5:] = 0.0
    if b > 1:
        mask[1] = 0.0
    cot = torch.randn(b, s, 4, d, device=cuda, generator=g)
    return qkv, mask, cot * mask[:, :, None, None]


def _latent_case(cuda, b, s, seed):
    """q, k [B, S, 4, 192] (strided views of one tensor) and v
    [B, S, 4, 128] (the second half of a [.., 256] tensor, as MLA's kv_b
    projection hands it), with _bwd_case's mask and a [B, S, 4, 128]
    cotangent zeroed at masked queries."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qk = torch.randn(b, s, 2, 4, 192, device=cuda, generator=g)
    kv = torch.randn(b, s, 4, 256, device=cuda, generator=g)
    mask = torch.ones(b, s, device=cuda)
    mask[0, s - s // 5:] = 0.0
    if b > 1:
        mask[1] = 0.0
    cot = torch.randn(b, s, 4, 128, device=cuda, generator=g)
    q, k = qk.unbind(2)
    return (q, k, kv[..., 128:]), mask, cot * mask[:, :, None, None]


def _unaligned(t):
    """A copy of ``t`` as a view that is not 16-byte aligned."""
    flat = torch.zeros(t.numel() + 1, device=t.device)
    flat[1:] = t.reshape(-1)
    view = flat[1:].view(t.shape)
    assert view.data_ptr() % 16 != 0
    return view


# K2's cases: (B, S, the queries a block owns on a 132-SM H100)
FWD_CASES = [(2, 40, 32), (1, 544, 32), (2, 544, 32), (1, 1024, 32),
             (2, 1024, 32), (2, 2049, 64),
             # S around the 64-key tile, in 32-query blocks
             (2, 63, 32), (2, 64, 32), (2, 65, 32), (2, 127, 32), (2, 129, 32),
             # and in 64-query blocks
             (17, 127, 64), (11, 129, 64), (4, 1025, 64)]


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b,s,rows", FWD_CASES)
def test_flash_fwd_kernel_matches_plain(cuda, d, b, s, rows):
    """K2's output and LSE against its plain version: a partial tile
    (S = 40), the scorer's S = 544 and 1024 with one batch row and two
    (32-query blocks: 64-query blocks would not cover the SMs), a ragged
    multi-tile S (64-query blocks), S on and beside the 64-key tile's
    edges in both block sizes; a padded tail, and with B = 2 a row with no
    valid key (the uniform average)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert fwd_rows(b, s, 4, sms) == rows
    qkv, mask, _ = _bwd_case(cuda, b, s, d, seed=3 * s + d)
    q, k, v = qkv.unbind(2)
    before = flash_attention.launches
    out, lse = flash_attention_fwd(q, k, v, mask)
    assert flash_attention.launches == before + 1
    ref, ref_lse = attention_fwd_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,rows", FWD_CASES)
def test_flash_fwd_kernel_matches_plain_at_latent_widths(cuda, b, s, rows):
    """K2 at q/k 192, v 128 against its plain version, on K2's cases:
    one launch, counted at (192, 128)."""
    (q, k, v), mask, _ = _latent_case(cuda, b, s, seed=5 * s + b)
    before = (flash_attention.launches, flash_attention.widths[192, 128])
    out, lse = flash_attention_fwd(q, k, v, mask)
    assert (flash_attention.launches,
            flash_attention.widths[192, 128]) == (before[0] + 1, before[1] + 1)
    assert out.shape == (b, s, 4, 128)
    ref, ref_lse = attention_fwd_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_fwd_kernel_reads_unaligned_views(cuda, d):
    """q, k, v as views that are not 16-byte aligned, which the wrapper
    copies for the kernel's TMA and 16-byte loads."""
    qkv, mask, _ = _bwd_case(cuda, 2, 544, d, seed=d)
    q, k, v = (_unaligned(x) for x in qkv.unbind(2))
    out, lse = flash_attention_fwd(q, k, v, mask)
    ref, ref_lse = attention_fwd_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


# S around the backward's tiles: 64 resident keys a cluster, 64 streamed
# queries a tile (ops/attention.py bwd_layout)
BWD_EDGES = [63, 64, 65, 127, 129]


@pytest.mark.parametrize("layout", ["qkv", "unaligned"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [40, 544, 1024, 2049, *BWD_EDGES])
def test_flash_bwd_kernel_matches_plain(cuda, d, s, layout):
    """The backward kernel alone against its plain version on the same
    inputs, dq, dk and dv from one launch: a partial tile (S = 40), the
    scorer's S, a ragged multi-tile S, S on and beside the 64-key block
    and 64-query tile edges, a padded tail and a fully masked row (its P
    recomputed as 1 from LSE = -1e30); q, v and dO also as views that are
    not 16-byte aligned, which the wrapper copies for the kernel's TMA
    and 16-byte loads."""
    qkv, mask, cot = _bwd_case(cuda, 2, s, d, seed=s + 2 * d)
    q, k, v = qkv.unbind(2)
    out, lse = flash_attention_fwd(q, k, v, mask)
    delta = (cot * out).sum(-1).transpose(1, 2).contiguous()
    if layout == "unaligned":
        q, v, cot = _unaligned(q), _unaligned(v), _unaligned(cot)
    before = flash_bwd.launches
    got = flash_bwd(q, k, v, cot, mask, lse, delta)
    assert flash_bwd.launches == before + 1
    want = flash_bwd_plain(q, k, v, cot, mask, lse, delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("layout", ["views", "unaligned"])
@pytest.mark.parametrize("s", [40, 544, 1024, 2049, *BWD_EDGES])
def test_flash_bwd_kernel_matches_plain_at_latent_widths(cuda, s, layout):
    """The backward kernel at q/k 192, v 128 (clusters of 3 CTAs, the third
    without V) against its plain version: dq, dk [.., 192], dv [.., 128]
    from one launch, on the square widths' cases."""
    (q, k, v), mask, cot = _latent_case(cuda, 2, s, seed=7 * s)
    out, lse = flash_attention_fwd(q, k, v, mask)
    delta = (cot * out).sum(-1).transpose(1, 2).contiguous()
    if layout == "unaligned":
        q, v, cot = _unaligned(q), _unaligned(v), _unaligned(cot)
    before = flash_bwd.launches
    got = flash_bwd(q, k, v, cot, mask, lse, delta)
    assert flash_bwd.launches == before + 1
    want = flash_bwd_plain(q, k, v, cot, mask, lse, delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


def test_flash_bwd_wgmmas_are_not_serialized(cuda):
    """ptxas runs K2's and the backward's wgmmas back to back: it
    serializes them (note C7514, each waiting for the one before) when a
    loop keeps a wgmma group in flight across its back edge."""
    from avsum_torch import build
    from avsum_torch.ops import attention

    attention._fwd_lib()
    attention._bwd_lib()
    for name in ("flash_fwd", "flash_bwd"):
        lib = build.library_path(name)
        log = lib.with_name(lib.name + ".log").read_text()
        assert "C7514" not in log, log


# the width pairs (Dqk, Dv) the kernels take, named by D where square
WIDTHS = [pytest.param((128, 128), id="128"),
          pytest.param((256, 256), id="256"),
          pytest.param((192, 128), id="192-128")]


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("d", WIDTHS)
def test_flash_fwd_layout_matches_the_library(cuda, d, rows):
    """The library's K2 tiling is the wrapper's (fwd_layout), at both
    block sizes."""
    from avsum_torch.ops import attention

    lib = attention._fwd_lib()
    out = (ctypes.c_long * 5)()
    assert lib.avsum_flash_fwd_layout(*d, rows, out) == 0
    attention.check_fwd_layout(out, *d, rows)


@pytest.mark.parametrize("d", WIDTHS)
def test_flash_bwd_layout_matches_the_library(cuda, d):
    """The library's backward tiling is the wrapper's (bwd_layout), and
    the card runs its clusters (Dqk / 64 CTAs of one GPC each)."""
    from avsum_torch.ops import attention

    lib = attention._bwd_lib()
    out = (ctypes.c_long * 6)()
    assert lib.avsum_flash_bwd_layout(*d, out) == 0
    attention.check_bwd_layout(out, *d)
    assert attention.bwd_max_clusters(*d) > 0


@pytest.mark.parametrize("d", [128, 256])
def test_flash_bwd_train_shape_waves_on_the_card(cuda, d):
    """The train run's [1, 1024, 4, D] launches 64 clusters; the waves they
    take are set by how many clusters the card holds at once (a cluster's
    D / 64 CTAs need SMs of one GPC), not by its SM count: on a 132-SM
    H100 one wave at D = 128 (66 clusters of 2), three at D = 256 (30 of
    4)."""
    from avsum_torch.ops import attention

    layout = attention.bwd_layout(d, d)
    clusters = math.ceil(1024 / layout["block_keys"]) * 4
    waves = math.ceil(clusters / attention.bwd_max_clusters(d, d))
    assert waves <= {128: 1, 256: 3}[d]


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [512, 545, 40, 544, 1024, 2049, *BWD_EDGES])
def test_flash_backward_kernels_match_plain(cuda, d, s):
    """dq, dk, dv through K2 -> the backward against autograd of the plain
    version; q, k, v are strided views of one qkv tensor, as in the
    scorer; the cotangent is zero at masked queries (a padded tail, and
    batch row 1 with no valid key at all)."""
    qkv, mask, cot = _bwd_case(cuda, 2, s, d, seed=s * d)

    def grads(fn):
        leaf = qkv.clone().requires_grad_()
        out = fn(*leaf.unbind(2), mask)
        (out * cot).sum().backward()
        return leaf.grad.unbind(2)

    counts = (flash_attention.launches, flash_bwd.launches)
    got = grads(flash_attention)
    assert (flash_attention.launches,
            flash_bwd.launches) == tuple(n + 1 for n in counts)
    want = grads(attention_plain)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("s", [512, 545, 40, 544, 1024, 2049, *BWD_EDGES])
def test_flash_backward_kernels_match_plain_at_latent_widths(cuda, s):
    """dq, dk, dv at q/k 192, v 128 through K2 -> the backward against
    autograd of the plain version; v a view of a wider tensor, as MLA's
    kv_b projection hands it; one launch of each."""
    (q, k, v), mask, cot = _latent_case(cuda, 2, s, seed=11 * s)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, mask) * cot).sum().backward()
        return [t.grad for t in leaves]

    counts = (flash_attention.launches, flash_bwd.launches)
    got = grads(flash_attention)
    assert (flash_attention.launches,
            flash_bwd.launches) == tuple(n + 1 for n in counts)
    want = grads(attention_plain)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"d{name}: {m}")


# (M, K, N, bias) of the Linear products on the main path: the decoder's at
# 7168 shots (MLA's q, kv_a, kv_b and o projections, the dense SwiGLU, the
# shared experts, the router), a held expert's rows, the hour cell's
# Linears (with their biases) and a ragged expert
LINEAR_CASES = [
    *[(7168, k, n, False) for k, n in [
        (2048, 3072), (2048, 576), (512, 4096), (2048, 2048), (2048, 22528),
        (11264, 2048), (2048, 5632), (2816, 2048), (2048, 64)]],
    (672, 2048, 2816, False), (672, 1408, 2048, False),
    *[(7168, k, n, True) for k, n in [
        (4096, 512), (296, 512), (512, 1536), (512, 2048), (2048, 512),
        (1024, 3072)]],
    (673, 2048, 2816, False),
]


def _rel_err(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("m,k,n,bias", LINEAR_CASES)
def test_linear_kernel_matches_float64(cuda, m, k, n, bias):
    """Y = X W^T (+ b), dX = dY W and dW = dY^T X, each through the GEMM
    where the route takes it (all three but the router's forward and dW,
    whose C is a half tile wide), against float64. Tolerance: each within
    3 times cuBLAS
    float32's own error against float64 (at least 1e-7 of the largest
    entry: the kernel's runs of 4 k-steps sum more evenly than cuBLAS, so
    it is often the smaller), and at least 10 times below one TF32 pass's
    (3xTF32 is float32-level; one pass is not)."""
    from avsum_torch.ops.linear import linear, route

    g = torch.Generator(device="cuda").manual_seed(m + 3 * k + 7 * n)
    x = torch.randn(m, k, device=cuda, generator=g)
    w = torch.randn(n, k, device=cuda, generator=g) / math.sqrt(k)
    b = torch.randn(n, device=cuda, generator=g) if bias else None
    dy = torch.randn(m, n, device=cuda, generator=g)
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (x, w, b)]
    routes = [route(cuda, torch.float32, *shape) for shape in (
        (m, n, k), (m, k, n, True, False), (n, k, m, False, False))]
    assert routes[1] == "kernel"
    before = linear.launches
    linear(*leaves).backward(dy)
    y = linear(x, w, b)
    assert linear.launches == before + routes.count("kernel") + (
        routes[0] == "kernel")
    got = {"y": y, "dx": leaves[0].grad, "dw": leaves[1].grad}
    x64, w64, dy64 = x.double(), w.double(), dy.double()
    want = {"y": x64 @ w64.T + (b.double() if bias else 0),
            "dx": dy64 @ w64, "dw": dy64.T @ x64}

    def library():
        return {"y": torch.nn.functional.linear(x, w, b), "dx": dy @ w,
                "dw": dy.T @ x}

    f32 = library()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = library()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for key in want:
        err = _rel_err(got[key], want[key])
        assert err <= 3 * max(_rel_err(f32[key], want[key]), 1e-7), (key, err)
        assert _rel_err(tf32[key], want[key]) >= 10 * err, (key, err)
    if bias:
        torch.testing.assert_close(leaves[2].grad.double(), dy64.sum(0),
                                   rtol=1e-5, atol=1e-3)


def test_gemm_wgmmas_are_not_serialized(cuda):
    """ptxas runs the GEMM's wgmmas back to back (no note C7514): a run's
    groups are waited for before the loop's back edge."""
    from avsum_torch import build
    from avsum_torch.ops import linear

    linear._lib()
    lib = build.library_path("gemm_tf32x3")
    log = lib.with_name(lib.name + ".log").read_text()
    assert "C7514" not in log, log


def test_linear_of_no_rows_launches_nothing(cuda):
    """A held expert routed no shot: an empty output, zero dW and db, no
    launch."""
    from avsum_torch.ops.linear import linear

    x = torch.empty(0, 2048, device=cuda, requires_grad=True)
    w = torch.randn(2816, 2048, device=cuda, requires_grad=True)
    b = torch.randn(2816, device=cuda, requires_grad=True)
    before = linear.launches
    y = linear(x, w, b)
    y.sum().backward()
    assert y.shape == (0, 2816) and linear.launches == before
    assert not w.grad.any() and not b.grad.any()


def test_linear_under_tf32_is_left_to_cublas(cuda):
    """Under torch's "high" float32 matmul precision the products are
    cuBLAS's one-pass TF32, counted as bypassed, with no launch."""
    from avsum_torch.ops.linear import linear

    x = torch.randn(7168, 512, device=cuda, requires_grad=True)
    w = torch.randn(512, 512, device=cuda, requires_grad=True)
    launches, bypassed = linear.launches, linear.bypassed
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        linear(x, w).sum().backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert linear.launches == launches and linear.bypassed == bypassed + 3
