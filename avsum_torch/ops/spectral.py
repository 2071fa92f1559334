"""Spectral ops on torch tensors: framing, power spectrum, mel, dB, MFCC.

Counterpart of ``avsum_tpu/ops/spectral.py`` (torchaudio semantics:
periodic Hann, center=True reflect padding, power 2, HTK mel with
norm=None, ortho DCT-II). The DFT is two real matmuls against cos/sin
bases, as in the JAX package; XLA ran these outside any Pallas kernel,
so here they are plain ``torch.matmul``. The host-side basis builders
(``_dft_bases``, ``_mel_fbank_np``, ``_dct_matrix_np``) are numpy copies
of the JAX module's, which cannot be imported without jax.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window's default)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def frame_signal(
    waveform: torch.Tensor, n_fft: int, hop_length: int, center: bool = True
) -> torch.Tensor:
    """[T] -> [n_frames, n_fft] overlapping frames (reflect-padded by
    n_fft // 2 when ``center``)."""
    x = waveform.reshape(-1).to(torch.float32)
    if center:
        pad = n_fft // 2
        x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    return x.unfold(0, n_fft, hop_length)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> tuple:
    """Real/imag DFT bases [n_fft, n_fft//2+1] (numpy, host-cached)."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    return (
        np.cos(angle).astype(np.float32),
        np.sin(angle).astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _dft_bases_on(n_fft: int, device) -> tuple:
    """:func:`_dft_bases` on ``device``, uploaded once per device (an
    upload on every call would wait for the device's queue)."""
    return tuple(torch.from_numpy(b).to(device) for b in _dft_bases(n_fft))


def power_spectrogram(
    waveform: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 200,
    win_length: Optional[int] = None,
    center: bool = True,
) -> torch.Tensor:
    """[T] -> [n_frames, n_fft//2+1] power spectrum |STFT|^2."""
    win_length = win_length or n_fft
    frames = frame_signal(waveform, n_fft, hop_length, center)
    window = hann_window(win_length, frames.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    frames = frames * window
    cos_b, sin_b = _dft_bases_on(n_fft, frames.device)
    real = frames @ cos_b
    imag = frames @ sin_b
    return real * real + imag * imag


@functools.lru_cache(maxsize=16)
def _mel_fbank_np(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """HTK triangular mel filterbank [n_freqs, n_mels], norm=None
    (torchaudio.functional.melscale_fbanks)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    n_freqs: int,
    n_mels: int = 128,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    f_max = f_max if f_max is not None else sample_rate / 2.0
    return torch.from_numpy(
        _mel_fbank_np(n_freqs, f_min, f_max, n_mels, sample_rate)
    ).to(device)


def mel_spectrogram(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop_length: int = 200,
    win_length: Optional[int] = None,
    n_mels: int = 128,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> torch.Tensor:
    """[T] -> [n_frames, n_mels] mel power spectrogram."""
    spec = power_spectrogram(waveform, n_fft, hop_length, win_length)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max,
                        spec.device)
    return spec @ fb


@functools.lru_cache(maxsize=8)
def _dct_matrix_np(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Ortho DCT-II [n_mels, n_mfcc] (torchaudio.functional.create_dct)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k)
    dct *= np.sqrt(2.0 / n_mels)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


@functools.lru_cache(maxsize=16)
def dct_matrix(n_mfcc: int, n_mels: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_dct_matrix_np(n_mfcc, n_mels)).to(device)


def amplitude_to_db(
    power: torch.Tensor, top_db: Optional[float] = 80.0, amin: float = 1e-10
) -> torch.Tensor:
    """10*log10(max(x, amin)), clamped to (max - top_db) over the WHOLE
    tensor (torchaudio AmplitudeToDB('power'))."""
    db = 10.0 * torch.log10(torch.clamp(power, min=amin))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def mfcc(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_mfcc: int = 40,
    n_mels: int = 128,
    top_db: Optional[float] = 80.0,
    **kwargs,
) -> torch.Tensor:
    """[T] -> [n_frames, n_mfcc]: dB-scaled mel -> ortho DCT-II."""
    mel = mel_spectrogram(waveform, sample_rate, n_mels=n_mels, **kwargs)
    return amplitude_to_db(mel, top_db) @ dct_matrix(n_mfcc, n_mels, mel.device)
