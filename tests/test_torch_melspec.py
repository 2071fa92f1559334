"""Kernel K1's module (avsum_torch.ops.melspec) against the JAX package:
the plain version vs the Pallas kernel in interpret mode and vs the XLA
spectral ops, at the JAX test's tolerance (rtol = atol = 2e-3)."""

import jax
import numpy as np
import pytest
import torch

from avsum_tpu.ops.pallas_melspec import fused_log_mel as jax_fused_log_mel
from avsum_tpu.ops.spectral import log_mel_spectrogram, mel_spectrogram
from avsum_torch.ops.melspec import fused_log_mel, log_mel_plain

TOL = dict(rtol=2e-3, atol=2e-3)


def _tone():
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 2) / 16000
    x = 0.4 * np.sin(2 * np.pi * 523 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    return (x + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


WAVES = {
    "tone_2s": _tone,
    "clip_1000": lambda: np.random.default_rng(1).standard_normal(1000)
    .astype(np.float32),
    "t_not_hop_multiple": lambda: np.random.default_rng(2).standard_normal(
        16000 + 123).astype(np.float32) * 0.3,
}


@pytest.mark.parametrize("name", sorted(WAVES))
def test_plain_matches_jax_kernel_and_spectral_ops(name):
    wave = WAVES[name]()
    with jax.default_matmul_precision("highest"):
        mel_k, lm_k = jax_fused_log_mel(wave, interpret=True)
        mel_x = np.asarray(mel_spectrogram(wave))
        lm_x = np.asarray(log_mel_spectrogram(wave))
    mel, lm = log_mel_plain(torch.from_numpy(wave))
    assert mel.shape == mel_k.shape == (1 + len(wave) // 200, 128)
    for ours, ref in ((mel, mel_k), (lm, lm_k), (mel, mel_x), (lm, lm_x)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_wrapper_runs_plain_version_for_cpu_tensor():
    wave = torch.from_numpy(_tone())
    before = fused_log_mel.launches
    mel, lm = fused_log_mel(wave)
    mel_p, lm_p = log_mel_plain(wave)
    assert fused_log_mel.launches == before == 0
    assert torch.equal(mel, mel_p) and torch.equal(lm, lm_p)


def test_rejects_n_fft_not_twice_hop():
    with pytest.raises(ValueError, match="n_fft == 2"):
        fused_log_mel(torch.zeros(1000), n_fft=512, hop_length=160)
