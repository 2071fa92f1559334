"""Pure-NumPy WAV codec + audio utilities.

Replaces the reference's audio path (pydub -> ffmpeg subprocess -> temp
wav -> torchaudio.load, reference/features/extractors.py:364-386,
326-328) with an in-process reader: RIFF parse, downmix to mono, resample
to the 16 kHz the audio front-end expects.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (samples [T, C] float32 in [-1,1], rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            (audio_format, channels, rate, _, block_align, bits) = struct.unpack(
                "<HHIIHH", body[:16]
            )
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack("<H", body[24:26])
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, bits = fmt

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8).reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(samples, dt).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    usable = (len(x) // channels) * channels
    return x[:usable].reshape(-1, channels), rate


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write float32 [-1,1] samples ([T] or [T, C]) as PCM16 WAV."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    channels = x.shape[1]
    byte_rate = rate * channels * 2
    data = pcm.tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF")
        fh.write(struct.pack("<I", 36 + len(data)))
        fh.write(b"WAVEfmt ")
        fh.write(struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate,
                             channels * 2, 16))
        fh.write(b"data")
        fh.write(struct.pack("<I", len(data)))
        fh.write(data)


def to_mono(samples: np.ndarray) -> np.ndarray:
    """[T, C] -> [T] channel mean (the reference's downmix,
    extractors.py:328)."""
    x = np.asarray(samples, np.float32)
    return x if x.ndim == 1 else x.mean(axis=1)


def resample_linear(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resampling [T] -> [T'].

    Quality note: linear interp aliases above ~dst_rate/2 for downsampling
    ratios > 2; fine for the 44.1k/48k -> 16k speech/music path the
    pipeline uses (pydub's ffmpeg resampler was the reference's choice;
    parity is at the feature level, not sample level).
    """
    x = np.asarray(samples, np.float32).reshape(-1)
    if src_rate == dst_rate or len(x) == 0:
        return x
    duration = len(x) / src_rate
    n_out = int(round(duration * dst_rate))
    t_out = np.arange(n_out, dtype=np.float64) / dst_rate
    t_in = np.arange(len(x), dtype=np.float64) / src_rate
    return np.interp(t_out, t_in, x).astype(np.float32)


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Band-limited polyphase resampling (Kaiser-windowed sinc via
    scipy.signal.resample_poly — the same class of filter ffmpeg's swr
    applied in the reference's pydub chain, extractors.py:364-386);
    falls back to linear interpolation if scipy is unavailable.

    The distinction matters for real datasets: 44.1/48 kHz -> 16 kHz is a
    >2x downsample, where linear interpolation aliases everything above
    ~8 kHz back into the band the mel filters integrate.
    """
    x = np.asarray(samples, np.float32).reshape(-1)
    if src_rate == dst_rate or len(x) == 0:
        return x
    try:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(src_rate), int(dst_rate))
        up, down = int(dst_rate) // g, int(src_rate) // g
        return resample_poly(x.astype(np.float64), up, down).astype(np.float32)
    except ImportError:
        return resample_linear(x, src_rate, dst_rate)


def load_audio_mono_16k(path: str) -> np.ndarray:
    """One-call equivalent of the reference's extract->mono->16k chain."""
    samples, rate = read_wav(path)
    return resample(to_mono(samples), rate, 16000)


def load_audio_mono_16k_ship(path: str) -> np.ndarray:
    """Like :func:`load_audio_mono_16k` but keeps mono 16 kHz PCM16 files in
    their native int16 — half the bytes over the host->device link, with the
    /32768 normalization done on device (bit-identical to the float path;
    the device converts with exactly the same constant read_wav uses).
    Anything needing downmix/resample falls back to the float32 chain.
    """
    with open(path, "rb") as fh:
        head = fh.read(128)
    # fast header sniff: RIFF/WAVE, fmt chunk first (the layout every
    # encoder emits), PCM16 mono 16 kHz
    if (
        len(head) >= 44
        and head[:4] == b"RIFF"
        and head[8:12] == b"WAVE"
        and head[12:16] == b"fmt "
    ):
        audio_format, channels, rate, _, _, bits = struct.unpack(
            "<HHIIHH", head[20:36]
        )
        if audio_format == 1 and channels == 1 and rate == 16000 and bits == 16:
            with open(path, "rb") as fh:
                data = fh.read()
            pos = 12
            while pos + 8 <= len(data):
                chunk_id = data[pos : pos + 4]
                (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
                if chunk_id == b"data":
                    body = data[pos + 8 : pos + 8 + size]
                    return np.frombuffer(body[: len(body) // 2 * 2], "<i2")
                pos += 8 + size + (size & 1)
    return load_audio_mono_16k(path)
