"""Kernel K1: fused log-mel (``csrc/melspec.cu``) and its plain version.

Counterpart of ``avsum_tpu/ops/pallas_melspec.py::fused_log_mel``: a [T]
float32 waveform -> (mel [N, 128], log2(mel + eps) [N, 128]) with
N = 1 + T // hop, center=True reflect padding and torchaudio
MelSpectrogram semantics. Requires n_fft == 2 * hop_length (the audio
defaults, 400 / 200), the shape that lets a block of frames share one
contiguous run of samples.

:func:`fused_log_mel` launches the CUDA kernel for a CUDA tensor and runs
:func:`log_mel_plain` for a CPU tensor; it never falls back from one to
the other. ``fused_log_mel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avsum_torch.build import load_kernel
from avsum_torch.ops.spectral import _dft_bases, _mel_fbank_np, mel_spectrogram

KERNEL_MELS = 128  # the kernel's compiled mel width


def log_mel_plain(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop_length: int = 200,
    n_mels: int = 128,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: framing + windowed DFT matmuls + fbank
    (:func:`avsum_torch.ops.spectral.mel_spectrogram`), then log2."""
    mel = mel_spectrogram(waveform, sample_rate, n_fft, hop_length,
                          n_mels=n_mels)
    return mel, torch.log2(mel + eps)


@functools.lru_cache(maxsize=8)
def _kernel_bases(sample_rate: int, n_fft: int, n_mels: int, device):
    """Window-folded cos/sin bases [n_fft, n_fft//2+1] and the fbank
    [n_fft//2+1, n_mels], on ``device``."""
    cos_b, sin_b = _dft_bases(n_fft)
    n = np.arange(n_fft)
    window = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)
    fbank = _mel_fbank_np(n_fft // 2 + 1, 0.0, sample_rate / 2.0, n_mels,
                          sample_rate)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (window[:, None] * cos_b, window[:, None] * sin_b, fbank)
    )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernel("melspec")
    p = ctypes.c_void_p
    lib.avsum_melspec.restype = ctypes.c_int
    lib.avsum_melspec.argtypes = [
        p, ctypes.c_long, p, p, p, p, p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, p,
    ]
    return lib


def fused_log_mel(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 400,
    hop_length: int = 200,
    n_mels: int = 128,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T] waveform -> (mel [N, n_mels], log2-mel [N, n_mels]) float32."""
    if n_fft != 2 * hop_length:
        raise ValueError("fused kernel requires n_fft == 2*hop_length")
    if waveform.device.type == "cpu":
        return log_mel_plain(waveform, sample_rate, n_fft, hop_length,
                             n_mels, eps)
    if waveform.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {waveform.device}")
    if waveform.dtype != torch.float32 or waveform.dim() != 1:
        raise ValueError(
            f"log-mel kernel takes a 1-D float32 waveform, got "
            f"{tuple(waveform.shape)} {waveform.dtype}")
    if n_mels != KERNEL_MELS:
        raise ValueError(f"log-mel kernel is built for {KERNEL_MELS} mels")
    pad = n_fft // 2
    if waveform.numel() <= pad:
        raise ValueError(f"waveform of {waveform.numel()} samples is too "
                         f"short to reflect-pad by {pad}")
    x = F.pad(waveform[None, None], (pad, pad), mode="reflect")[0, 0]
    x = x.contiguous()
    n_frames = 1 + (x.numel() - n_fft) // hop_length
    cos_w, sin_w, fbank = _kernel_bases(sample_rate, n_fft, n_mels, x.device)
    mel = torch.empty(n_frames, n_mels, device=x.device, dtype=torch.float32)
    logmel = torch.empty_like(mel)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.avsum_melspec(
            x.data_ptr(), x.numel(), cos_w.data_ptr(), sin_w.data_ptr(),
            fbank.data_ptr(), mel.data_ptr(), logmel.data_ptr(), n_frames,
            hop_length, n_fft // 2 + 1, eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    fused_log_mel.launches += 1
    return mel, logmel


fused_log_mel.launches = 0
