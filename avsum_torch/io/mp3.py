"""MPEG audio (MP3) bitstream framing.

Not a decoder — decode goes through :mod:`avsum_torch.io.ffaudio` (the
ffmpeg libraries bundled with OpenCV). This module parses an MP3
elementary stream into its frame boundaries so the mp4 muxer can carry
compressed audio as a proper ``mp4a``/esds track (one MP3 frame per
sample, as the reference's real-dataset mp4s did for AAC,
reference/features/extractors.py:364-386).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

# index -> Hz; by MPEG version id (2.5, reserved, 2, 1)
_RATES = {
    0: (11025, 12000, 8000),   # MPEG 2.5
    2: (22050, 24000, 16000),  # MPEG 2
    3: (44100, 48000, 32000),  # MPEG 1
}
# Layer III bitrates (kbps), MPEG-1 vs MPEG-2/2.5
_BITRATES_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
_BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)


@dataclass
class Mp3Stream:
    frames: List[bytes]          # one MPEG audio frame each
    sample_rate: int
    channels: int
    samples_per_frame: int       # 1152 (MPEG-1 L3) or 576 (MPEG-2/2.5 L3)

    @property
    def n_samples(self) -> int:
        return len(self.frames) * self.samples_per_frame


def _skip_id3(data: bytes) -> int:
    if data[:3] != b"ID3" or len(data) < 10:
        return 0
    size = 0
    for b in data[6:10]:  # synchsafe 28-bit
        size = (size << 7) | (b & 0x7F)
    return 10 + size


def parse_mp3(data: bytes) -> Mp3Stream:
    """Split an MP3 file/stream into frames. Raises ValueError when no
    valid Layer-III frame sequence is found."""
    pos = _skip_id3(data)
    frames: List[bytes] = []
    rate = channels = spf = None
    while pos + 4 <= len(data):
        b0, b1, b2, b3 = data[pos : pos + 4]
        if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
            if frames:
                break  # trailing tag/garbage after a valid run
            pos += 1
            continue
        version = (b1 >> 3) & 0x3     # 0=2.5, 1=reserved, 2=2, 3=1
        layer = (b1 >> 1) & 0x3       # 1 = Layer III
        if version == 1 or layer != 1:
            if frames:
                break
            pos += 1
            continue
        bitrate_idx = (b2 >> 4) & 0xF
        rate_idx = (b2 >> 2) & 0x3
        padding = (b2 >> 1) & 0x1
        if bitrate_idx in (0, 15) or rate_idx == 3:
            if frames:
                break
            pos += 1
            continue
        f_rate = _RATES[version][rate_idx]
        kbps = (_BITRATES_V1 if version == 3 else _BITRATES_V2)[bitrate_idx]
        f_spf = 1152 if version == 3 else 576
        length = f_spf // 8 * kbps * 1000 // f_rate + padding
        if length < 4 or pos + length > len(data):
            break
        if rate is None:
            rate, spf = f_rate, f_spf
            channels = 1 if ((b3 >> 6) & 0x3) == 3 else 2
        elif f_rate != rate:
            break  # rate change mid-stream: keep the leading run
        frames.append(data[pos : pos + length])
        pos += length
    if not frames:
        raise ValueError("no MPEG Layer-III frames found")
    return Mp3Stream(frames, rate, channels, spf)
