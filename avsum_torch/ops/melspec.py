"""Kernel K1: fused log-mel (``csrc/melspec.cu``) and its plain version.

Counterpart of ``avsum_tpu/ops/pallas_melspec.py::fused_log_mel``: a [T]
float32 waveform -> (mel [N, n_mels], log2(mel + eps) [N, n_mels]) with
N = 1 + T // hop, center=True reflect padding and torchaudio
MelSpectrogram semantics. Requires n_fft == 2 * hop_length (the audio
defaults, 400 / 200), the shape that lets a block of frames share one
contiguous run of samples.

:func:`fused_log_mel` launches the CUDA kernel for a CUDA tensor and runs
:func:`log_mel_plain` for a CPU tensor; it never falls back from one to
the other. ``fused_log_mel.launches`` counts kernel launches.

The kernel runs its DFT and mel products on the tensor cores (wgmma)
and streams its bases in stages laid out here, once per shape, in the
order the wgmma reads them (:func:`kernel_bases`). It takes 1 to
:data:`MAX_MELS` mel bands, in passes of :data:`MEL_WIDTH` columns
(:func:`mel_passes`), and hop lengths up to :data:`MAX_HOP`. This module
owns the kernel's tiling: the library reports its own
(``avsum_melspec_layout``), and :func:`fused_log_mel` checks the two agree
before its first launch at a hop length.
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

BLOCK_FRAMES = 128  # frames per block
CHUNK_BINS = 32  # DFT bins per chunk: 64 (cos, sin) columns
STAGE_STEPS = 10  # k-steps of 8 per streamed stage
STAGE_FLOATS = STAGE_STEPS * 2 * 8 * 2 * CHUNK_BINS  # big + small planes
MEL_WIDTH = 128  # mel columns per pass
SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may opt into
MAX_MELS = 256
MAX_HOP = 280  # the largest hop whose (BLOCK_FRAMES + 1) runs fit


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


def mel_passes(n_mels: int) -> int:
    """The kernel's passes of MEL_WIDTH columns for ``n_mels`` bands: 1 or
    2. Raises outside 1..MAX_MELS."""
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"log-mel kernel takes 1 to {MAX_MELS} mel bands, "
                         f"got {n_mels}")
    return -(-n_mels // MEL_WIDTH)


def kernel_layout(hop: int) -> dict:
    """The kernel's tiling of one hop, in the order ``avsum_melspec_layout``
    reports it: rows of hop_pad samples (hop rounded up to 8) at ``pitch``
    floats, ``n_chunks`` chunks of CHUNK_BINS bins, each ``dft_stages``
    DFT stages and one fbank stage, and the shared memory in bytes."""
    if not 1 <= hop <= MAX_HOP:
        raise ValueError(f"log-mel kernel takes hop_length 1 to {MAX_HOP}, "
                         f"got {hop}")
    hop_pad = -(-hop // 8) * 8
    pitch = hop_pad + 4
    layout = dict(frames=BLOCK_FRAMES, chunk_bins=CHUNK_BINS,
                  stage_steps=STAGE_STEPS, stage_floats=STAGE_FLOATS,
                  mel_width=MEL_WIDTH, hop_pad=hop_pad, pitch=pitch,
                  n_chunks=-(-(hop + 1) // CHUNK_BINS),
                  dft_stages=-(-(hop_pad // 4) // STAGE_STEPS),
                  smem=4 * (2 * STAGE_FLOATS + (BLOCK_FRAMES + 1) * pitch))
    assert layout["smem"] <= SMEM_LIMIT, layout
    return layout


def check_layout(reported, hop: int) -> None:
    """Raises unless the library's tiling for ``hop`` (the 10 numbers of
    ``avsum_melspec_layout``) is :func:`kernel_layout`'s."""
    ours = kernel_layout(hop)
    if list(reported) != list(ours.values()):
        raise RuntimeError(
            f"log-mel kernel's layout {list(reported)} is not the wrapper's "
            f"{ours} at hop {hop}: csrc/melspec.cu and ops/melspec.py "
            f"disagree")


def _round_tf32(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value, ties away from zero (PTX
    ``cvt.rna.tf32.f32``): the low 13 mantissa bits rounded off."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(a: np.ndarray) -> np.ndarray:
    """float32 [...] -> [..., 2]: (big, small) with big = tf32(a) and
    small = tf32(a - big), the 3xTF32 split the kernel makes of its other
    operand (csrc/mma_tf32.cuh)."""
    big = _round_tf32(a)
    return np.stack([big, _round_tf32(a - big)], axis=-1)


def _planes(b: np.ndarray) -> np.ndarray:
    """B operands [..., 8 (k), N (n)] -> [..., 2, 8 N]: each split into
    TF32 (big, small) planes (:func:`split_tf32`), a plane in wgmma's
    K-major core-matrix order without swizzle, element (n, k) at
    (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
    (csrc/mma_tf32.cuh ``wgmma_desc``)."""
    lead, n = b.shape[:-2], b.shape[-1]
    core = b.reshape(*lead, 2, 4, n // 8, 8)  # k // 4, k % 4, n // 8, n % 8
    m = len(lead)
    core = core.transpose(*range(m), m + 2, m, m + 3, m + 1)
    return np.moveaxis(split_tf32(core), -1, m).reshape(*lead, 2, 8 * n)


@functools.lru_cache(maxsize=8)
def kernel_bases(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """The kernel's stage stream [passes, stages, STAGE_FLOATS] float32.

    Per pass of MEL_WIDTH mel columns and per chunk of
    CHUNK_BINS bins: ``dft_stages`` stages of the window-folded DFT bases,
    then one stage of fbank rows. The DFT's B matrix has rows K = run *
    hop_pad + o (sample run * hop + o of the frame; zero for o >= hop) and
    columns 2 * bin + (0 for cos, 1 for sin); the fbank's, rows bin and
    columns mel, zero past n_freqs and n_mels. A stage holds, for each
    k-step of 8 rows, the chunk's [8 x N] block of B as a big and a small
    plane (:func:`_planes`): N = 2 * CHUNK_BINS DFT columns, or the pass's
    mel columns."""
    hop = n_fft // 2
    geo = kernel_layout(hop)
    hop_pad, n_chunks, dft_stages = (geo["hop_pad"], geo["n_chunks"],
                                     geo["dft_stages"])
    width = MEL_WIDTH
    passes = mel_passes(n_mels)
    n_freqs = hop + 1

    cos_b, sin_b = _dft_bases(n_fft)
    n = np.arange(n_fft)
    window = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)
    k = np.arange(2 * hop_pad)
    o = k % hop_pad
    valid = o < hop
    sample = (k // hop_pad) * hop + o
    steps = dft_stages * STAGE_STEPS
    dft = np.zeros((8 * steps, n_chunks * CHUNK_BINS, 2), np.float32)
    dft[k[valid], :n_freqs, 0] = (window[:, None] * cos_b)[sample[valid]]
    dft[k[valid], :n_freqs, 1] = (window[:, None] * sin_b)[sample[valid]]
    dft = dft.reshape(steps, 8, n_chunks, 2 * CHUNK_BINS).transpose(2, 0, 1, 3)
    dft_stream = _planes(dft).reshape(n_chunks, dft_stages, STAGE_FLOATS)

    fbank = np.zeros((n_chunks * CHUNK_BINS, passes * width), np.float32)
    fbank[:n_freqs, :n_mels] = _mel_fbank_np(n_freqs, 0.0, sample_rate / 2.0,
                                             n_mels, sample_rate)
    fbank = fbank.reshape(n_chunks, CHUNK_BINS // 8, 8, passes, width)
    fb_stream = _planes(fbank.transpose(3, 0, 1, 2, 4))
    fb_stream = fb_stream.reshape(passes, n_chunks, 1, -1)
    fb_stream = np.pad(fb_stream, ((0, 0), (0, 0), (0, 0),
                                   (0, STAGE_FLOATS - fb_stream.shape[-1])))
    stream = np.concatenate(
        [np.broadcast_to(dft_stream, (passes, *dft_stream.shape)), fb_stream],
        axis=2)
    return np.ascontiguousarray(stream.reshape(passes, -1, STAGE_FLOATS))


@functools.lru_cache(maxsize=8)
def _device_bases(sample_rate: int, n_fft: int, n_mels: int, device):
    return torch.from_numpy(kernel_bases(sample_rate, n_fft, n_mels)).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernel("melspec")
    p = ctypes.c_void_p
    lib.avsum_melspec.restype = ctypes.c_int
    lib.avsum_melspec.argtypes = [
        p, ctypes.c_long, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, p,
    ]
    lib.avsum_melspec_layout.restype = None
    lib.avsum_melspec_layout.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_long)]
    return lib


@functools.lru_cache(maxsize=None)
def _checked_lib(hop: int) -> ctypes.CDLL:
    """The library, once its tiling for ``hop`` is checked against ours."""
    lib = _lib()
    out = (ctypes.c_long * 10)()
    lib.avsum_melspec_layout(hop, out)
    check_layout(out, hop)
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
    mel_passes(n_mels)
    pad = n_fft // 2
    if waveform.numel() <= pad:
        raise ValueError(f"waveform of {waveform.numel()} samples is too "
                         f"short to reflect-pad by {pad}")
    x = F.pad(waveform[None, None], (pad, pad), mode="reflect")[0, 0]
    x = x.contiguous()
    n_frames = 1 + (x.numel() - n_fft) // hop_length
    bases = _device_bases(sample_rate, n_fft, n_mels, x.device)
    mel = torch.empty(n_frames, n_mels, device=x.device, dtype=torch.float32)
    logmel = torch.empty_like(mel)
    lib = _checked_lib(hop_length)
    with torch.cuda.device(x.device):
        err = lib.avsum_melspec(
            x.data_ptr(), x.numel(), bases.data_ptr(), mel.data_ptr(),
            logmel.data_ptr(), n_frames, hop_length, n_mels, eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    fused_log_mel.launches += 1
    return mel, logmel


fused_log_mel.launches = 0
