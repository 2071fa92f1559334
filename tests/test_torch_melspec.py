"""Kernel K1's module (avsum_torch.ops.melspec) against the JAX package:
the plain version vs the Pallas kernel in interpret mode and vs the XLA
spectral ops, at the JAX test's tolerance (rtol = atol = 2e-3)."""

import jax
import numpy as np
import pytest
import torch

from avsum_tpu.ops.pallas_melspec import fused_log_mel as jax_fused_log_mel
from avsum_tpu.ops.spectral import log_mel_spectrogram, mel_spectrogram
from avsum_torch.ops.melspec import (
    BLOCK_FRAMES,
    CHUNK_BINS,
    MAX_HOP,
    MAX_MELS,
    MEL_WIDTH,
    STAGE_FLOATS,
    STAGE_STEPS,
    check_layout,
    fused_log_mel,
    kernel_bases,
    kernel_layout,
    log_mel_plain,
    mel_passes,
    split_tf32,
)

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


def test_fused_log_mel_takes_64_mels_like_the_jax_kernel():
    wave = _tone()
    with jax.default_matmul_precision("highest"):
        mel_k, lm_k = jax_fused_log_mel(wave, n_mels=64, interpret=True)
    mel, lm = fused_log_mel(torch.from_numpy(wave), n_mels=64)
    assert mel.shape == lm.shape == mel_k.shape == (1 + len(wave) // 200, 64)
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_k), **TOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(lm_k), **TOL)


@pytest.mark.parametrize("n_mels,passes", [(1, 1), (32, 1), (33, 1),
                                           (64, 1), (65, 1), (128, 1),
                                           (129, 2), (256, 2)])
def test_mel_passes(n_mels, passes):
    assert mel_passes(n_mels) == passes
    assert kernel_bases(16000, 400, n_mels).shape[0] == passes


@pytest.mark.parametrize("n_mels", [0, 257, 512])
def test_kernel_shape_check_names_the_mel_limit(n_mels):
    with pytest.raises(ValueError, match=f"1 to {MAX_MELS} mel bands"):
        mel_passes(n_mels)


@pytest.mark.parametrize("hop", [1, 200, MAX_HOP])
def test_check_layout_takes_the_wrappers_own(hop):
    check_layout(list(kernel_layout(hop).values()), hop)


@pytest.mark.parametrize("field", ["frames", "stage_floats", "mel_width",
                                   "pitch", "dft_stages"])
def test_check_layout_raises_when_the_kernel_drifts(field):
    layout = kernel_layout(200)
    layout[field] += 1
    with pytest.raises(RuntimeError, match="disagree"):
        check_layout(list(layout.values()), 200)


@pytest.mark.parametrize("hop", [1, 160, 200, MAX_HOP])
def test_kernel_bases_fit_shared_memory_up_to_max_hop(hop):
    stream = kernel_bases(16000, 2 * hop, 64)
    assert stream.shape[-1] == STAGE_FLOATS


@pytest.mark.parametrize("hop", [0, MAX_HOP + 1])
def test_kernel_shape_check_names_the_hop_limit(hop):
    with pytest.raises(ValueError, match=f"hop_length 1 to {MAX_HOP}"):
        kernel_bases(16000, 2 * hop, 64)


def _emulate_kernel(wave, sample_rate, hop, n_mels):
    """csrc/melspec.cu's data flow in float64 from the stage stream: the
    block's runs of samples at pitch hop_pad + 4 read as A rows, each
    stage's B planes (TF32 big + small) read back to (k, n) by wgmma's
    K-major core-matrix order (element (n, k) of a plane at (n // 8) * 64 +
    (k // 4) * 32 + (n % 8) * 4 + k % 4), cos / sin of a bin in columns
    2b / 2b + 1, power into the mel product, MEL_WIDTH columns a pass."""
    stream = kernel_bases(sample_rate, 2 * hop, n_mels)
    width = MEL_WIDTH
    geo = kernel_layout(hop)
    hop_pad, pitch, n_chunks = geo["hop_pad"], geo["pitch"], geo["n_chunks"]
    spc = geo["dft_stages"] + 1
    x = np.pad(wave, (hop, hop), mode="reflect").astype(np.float64)
    n_frames = 1 + (len(x) - 2 * hop) // hop

    def read(stage, steps, n):
        """A stage's first `steps` k-steps of [8 x n] B, big + small."""
        b = np.zeros((8 * steps, n))
        planes = stage[:steps * 16 * n].reshape(steps, 2, 8 * n)
        assert not (planes.view(np.uint32) & 0x1FFF).any()  # TF32 values
        planes = planes.astype(np.float64).sum(1)
        kk, nn = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
        at = (nn // 8) * 64 + (kk // 4) * 32 + (nn % 8) * 4 + kk % 4
        for j in range(steps):
            b[8 * j:8 * j + 8] = planes[j][at]
        return b

    mel = np.zeros((n_frames, n_mels))
    for f0 in range(0, n_frames, BLOCK_FRAMES):
        seg = np.zeros((BLOCK_FRAMES + 1, pitch))
        for r in range(BLOCK_FRAMES + 1):
            run = x[(f0 + r) * hop:(f0 + r + 1) * hop]
            seg[r, :len(run)] = run
        seg = seg.reshape(-1)
        k = np.arange(2 * hop_pad)
        addr = (np.arange(BLOCK_FRAMES)[:, None] * pitch + k
                + 4 * (k >= hop_pad))
        a = seg[addr]
        rows = slice(f0, min(f0 + BLOCK_FRAMES, n_frames))
        for p in range(len(stream)):
            acc = np.zeros((BLOCK_FRAMES, width))
            for c in range(n_chunks):
                stages = stream[p, c * spc:(c + 1) * spc]
                basis = np.concatenate(
                    [read(s, STAGE_STEPS, 2 * CHUNK_BINS)
                     for s in stages[:-1]])[:2 * hop_pad]
                re_im = a @ basis
                power = re_im[:, 0::2] ** 2 + re_im[:, 1::2] ** 2
                acc += power @ read(stages[-1], CHUNK_BINS // 8, width)
            cols = slice(p * width, min((p + 1) * width, n_mels))
            mel[rows, cols] = acc[:rows.stop - f0, :cols.stop - cols.start]
    return mel


@pytest.mark.parametrize("hop,n_mels", [(200, 128), (200, 64), (200, 200),
                                        (100, 40), (36, 8)])
def test_kernel_bases_follow_the_kernel_layout(hop, n_mels):
    """The stage stream the wrapper lays out, read back the way the CUDA
    kernel reads it, gives the plain version's mel spectrogram."""
    wave = np.random.default_rng(hop + n_mels).standard_normal(
        7 * hop * 20 + 13).astype(np.float32)
    got = _emulate_kernel(wave, 16000, hop, n_mels)
    mel, _ = log_mel_plain(torch.from_numpy(wave), n_fft=2 * hop,
                           hop_length=hop, n_mels=n_mels)
    np.testing.assert_allclose(got, mel.numpy().astype(np.float64),
                               rtol=1e-4, atol=1e-6 * float(mel.max()))


def test_split_tf32_keeps_float32_accuracy():
    x = np.random.default_rng(3).standard_normal(10_000).astype(np.float32)
    x *= np.float32(10.0) ** np.random.default_rng(4).integers(-8, 8, x.size)
    big, small = np.moveaxis(split_tf32(x), -1, 0)
    for part in (big, small):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(big - x) <= np.abs(x) * 2.0 ** -11).all()
    err = np.abs(big.astype(np.float64) + small - x)
    assert (err <= np.abs(x).astype(np.float64) * 2.0 ** -21).all()
