"""The CUDA kernels against their plain versions on the card: K1
(log-mel, at 128 and 64 mel bands, and on a quiet waveform), K2
(flash-attention forward), B3 (dK / dV) against its plain version, and
B3 / B4 through the autograd Function against autograd of the plain
attention.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. The card machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

float32 with TF32 off. Tolerances: K1 rtol = atol = 2e-3 (the JAX
kernel test's), K2 rtol = atol = 1e-5, B3 / B4 rtol = atol = 1e-4 on the
gradients.
"""

import numpy as np
import pytest
import torch

from avsum_torch.ops.attention import (
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
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
    padded tail in row 0 and no valid key in row 1, and a cotangent zeroed
    at masked queries."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3, 4, d, device=cuda, generator=g)
    mask = torch.ones(b, s, device=cuda)
    mask[0, s - s // 5:] = 0.0
    mask[1] = 0.0
    cot = torch.randn(b, s, 4, d, device=cuda, generator=g)
    return qkv, mask, cot * mask[:, :, None, None]


@pytest.mark.parametrize("layout", ["qkv", "unaligned_dout"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [40, 2049])
def test_flash_bwd_dkv_kernel_matches_plain(cuda, d, s, layout):
    """B3 alone against its plain version on the same inputs: one partial
    query tile (S = 40) and a ragged multi-tile S, a padded tail and a
    fully masked row; dO also as a view that is not 16-byte aligned,
    which the wrapper copies for the kernel's 16-byte loads."""
    qkv, mask, cot = _bwd_case(cuda, 2, s, d, seed=s + d)
    q, k, v = qkv.unbind(2)
    if layout == "unaligned_dout":
        flat = torch.zeros(cot.numel() + 1, device=cuda)
        flat[1:] = cot.reshape(-1)
        cot = flat[1:].view(cot.shape)
        assert cot.data_ptr() % 16 != 0
    out, lse = flash_attention_fwd(q, k, v, mask)
    delta = (cot * out).sum(-1).transpose(1, 2).contiguous()
    before = flash_bwd_dkv.launches
    dk, dv = flash_bwd_dkv(q, k, v, cot, mask, lse, delta)
    assert flash_bwd_dkv.launches == before + 1
    pk, pv = flash_bwd_dkv_plain(q, k, v, cot, mask, lse, delta)
    torch.testing.assert_close(dk, pk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, pv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [512, 545, 40, 2049])
def test_flash_backward_kernels_match_plain(cuda, d, s):
    """dq, dk, dv through K2 -> B3 -> B4 against autograd of the plain
    version; q, k, v are strided views of one qkv tensor, as in the
    scorer; the cotangent is zero at masked queries (a padded tail, and
    batch row 1 with no valid key at all)."""
    qkv, mask, cot = _bwd_case(cuda, 2, s, d, seed=s * d)

    def grads(fn):
        leaf = qkv.clone().requires_grad_()
        out = fn(*leaf.unbind(2), mask)
        (out * cot).sum().backward()
        return leaf.grad.unbind(2)

    counts = (flash_attention.launches, flash_bwd_dkv.launches,
              flash_bwd_dq.launches)
    got = grads(flash_attention)
    assert (flash_attention.launches, flash_bwd_dkv.launches,
            flash_bwd_dq.launches) == tuple(n + 1 for n in counts)
    want = grads(attention_plain)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"d{name}: {m}")
