"""A synthetic scene clip with its soundtrack: ``<stem>.y4m`` (C420) and
``<stem>.wav`` (16 kHz mono PCM16).

The scene model of the port's bench clip (``io/synthetic.py``): scenes
each a colour that differs from its neighbours' by 80 or more on average,
greys and pale colours among them as the draw gives them, shaded by a
diagonal gradient, drifting by 10 sin(2 pi f / length), with normal
noise of ``noise`` on every pixel; a tone a scene (220 Hz times 2 to the
square root of a step in 0..11) plus 5% noise.

Unlike there, every seed gets the same work in another order: the
scenes are one fixed ring (``scenes`` lengths spread evenly over
``scene_frames``, and colours and tones drawn once), and the seed draws
the scene the clip starts at, the pixels' noise and the soundtrack's.
So every clip has the same frames, shot lengths and cuts between the
same colours but one. The noise is drawn on ``device`` and the frames
are shaded and converted to YUV420 there, in blocks, so a two-minute
clip is written in seconds; the files are synced to the disk before
``write`` returns, so that no write-back of them runs later.

Parameters (a traffic file's ``clip``): ``scenes``, ``scene_frames``
``[low, high]``, ``width``, ``height``, ``fps``, ``noise``.
"""

from __future__ import annotations

import math
import os
import struct
from typing import List, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
BLOCK = 64  # frames shaded and converted at once


def layout(clip: dict, seed: int):
    """(scene lengths, colours, tones, a numpy generator from the seed):
    one fixed ring of scenes, started at a scene drawn from the seed."""
    n = clip["scenes"]
    low, high = clip["scene_frames"]
    ring = np.random.default_rng(0)
    lengths = np.rint(np.linspace(low, high, n)).astype(np.int64)[
        ring.permutation(n)]
    colors = ring.integers(0, 256, (n, 3))

    def unfit(i, j):
        """Too like its neighbour."""
        return np.abs(colors[i] - colors[j]).mean() < 80

    for i in range(1, n):
        while unfit(i, i - 1):
            colors[i] = ring.integers(0, 256, 3)
    while unfit(0, n - 1) or unfit(0, 1):  # a ring: the first follows the last
        colors[0] = ring.integers(0, 256, 3)
    tones = 220.0 * (2.0 ** ring.integers(0, 12, n).astype(np.float64) ** 0.5)
    rng = np.random.default_rng(seed % 2 ** 63)
    order = np.roll(np.arange(n), -int(rng.integers(n)))
    return lengths[order], colors[order], tones[order], rng


def _to_yuv420(rgb: torch.Tensor) -> torch.Tensor:
    """[F, H, W, 3] uint8 -> [F, H*W + 2*(H/2)*(W/2)] uint8 planes
    (BT.601 full range, chroma averaged over 2x2, rounded)."""
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = (b - y) / (2.0 * (1.0 - 0.114)) + 128.0
    v = (r - y) / (2.0 * (1.0 - 0.299)) + 128.0
    f, h, w = y.shape

    def sub(c):
        return c.reshape(f, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    planes = [y, sub(u), sub(v)]
    return torch.cat([p.round().clamp(0, 255).to(torch.uint8).reshape(f, -1)
                      for p in planes], dim=1)


def write(stem: str, clip: dict, seed: int, device) -> List[Tuple[int, int]]:
    """Write ``<stem>.y4m`` and ``<stem>.wav`` -> the scenes' frame
    ranges."""
    lengths, colors, tones, rng = layout(clip, seed)
    h, w, fps = clip["height"], clip["width"], clip["fps"]
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    shade = (0.6 + 0.4 * (yy + xx) / 2.0)[..., None]  # [H, W, 1]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    scenes, start = [], 0
    with open(stem + ".y4m", "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 C420\n".encode())
        for length, color in zip(lengths.tolist(), colors):
            base = torch.as_tensor(color, device=device,
                                   dtype=torch.float32) * shade
            for f0 in range(0, length, BLOCK):
                f = torch.arange(f0, min(f0 + BLOCK, length), device=device,
                                 dtype=torch.float32)
                drift = 10.0 * torch.sin(2 * math.pi * f / max(length, 1))
                noise = torch.randn((len(f), h, w, 3), generator=gen,
                                    device=device) * clip["noise"]
                img = base[None] + drift[:, None, None, None] + noise
                frames = _to_yuv420(img.clamp(0, 255).to(torch.uint8))
                for row in frames.cpu().numpy():
                    fh.write(b"FRAME\n")
                    fh.write(row.tobytes())
            scenes.append((start, start + length))
            start += length
        fh.flush()
        os.fsync(fh.fileno())
    n_samples = int(start / fps * SAMPLE_RATE)
    audio = np.zeros(n_samples, np.float32)
    for tone, (s_f, e_f) in zip(tones, scenes):
        s0 = int(s_f / fps * SAMPLE_RATE)
        s1 = min(int(e_f / fps * SAMPLE_RATE), n_samples)
        t = np.arange(s1 - s0) / SAMPLE_RATE
        audio[s0:s1] = (0.4 * np.sin(2 * np.pi * tone * t)
                        + 0.05 * rng.standard_normal(s1 - s0))
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    with open(stem + ".wav", "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt ")
        fh.write(struct.pack("<IHHIIHH", 16, 1, 1, SAMPLE_RATE,
                             2 * SAMPLE_RATE, 2, 16))
        fh.write(b"data" + struct.pack("<I", len(data)) + data)
        fh.flush()
        os.fsync(fh.fileno())
    return scenes
