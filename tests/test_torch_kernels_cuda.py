"""The two CUDA kernels against their plain versions on the card.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. The card machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

float32 with TF32 off. Tolerances: K1 rtol = atol = 2e-3 (the JAX
kernel test's), K2 rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

from avsum_torch.ops.attention import attention_plain, flash_attention
from avsum_torch.ops.melspec import fused_log_mel, log_mel_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1000, 160_000, 48_123])
def test_melspec_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(0.3 * rng.standard_normal(n).astype(np.float32))
    x = x.to(cuda)
    before = fused_log_mel.launches
    mel, lm = fused_log_mel(x)
    assert fused_log_mel.launches == before + 1
    mel_p, lm_p = log_mel_plain(x)
    torch.testing.assert_close(mel, mel_p, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(lm, lm_p, rtol=2e-3, atol=2e-3)


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


def test_flash_kernel_refuses_grad(cuda):
    q = torch.randn(1, 512, 4, 128, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, q, q)
