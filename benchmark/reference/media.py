"""Reading the clip and finding its shots, written out plainly.

- Y4M (C420): a text header, then each frame's ``FRAME`` line and its
  Y, U and V planes; WAV: 16 kHz mono PCM16.
- Shots follow PySceneDetect's ContentDetector at its defaults
  (threshold 27, minimum scene length 15) over frames subsampled by
  width // 256 (nearest): each frame in integer BT.601 to RGB, then
  OpenCV's 8-bit HSV in floats (H halved into [0, 180)); a frame scores
  the mean absolute difference from the frame before, averaged over H, S
  and V; a cut falls where a score reaches the threshold at least the
  minimum length after the last cut.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

THRESHOLD, MIN_SCENE_LEN = 27.0, 15


def read_y4m(path: str):
    """-> (y [T, H, W], u [T, H/2, W/2], v, fps) uint8 views of the file."""
    with open(path, "rb") as fh:
        header = fh.readline()
    fields = header.decode().split()
    if fields[0] != "YUV4MPEG2":
        raise ValueError(f"{path}: not a Y4M file")
    info = {f[0]: f[1:] for f in fields[1:]}
    w, h = int(info["W"]), int(info["H"])
    num, den = (int(x) for x in info["F"].split(":"))
    if not info.get("C", "420").startswith("420"):
        raise ValueError(f"{path}: only C420 is read")
    ny, nc = w * h, (w // 2) * (h // 2)
    raw = np.memmap(path, np.uint8, mode="r")
    start = len(header)
    tag = len(b"FRAME\n")
    per = tag + ny + 2 * nc
    t = (len(raw) - start) // per
    frames = raw[start:start + t * per].reshape(t, per)
    y = frames[:, tag:tag + ny].reshape(t, h, w)
    u = frames[:, tag + ny:tag + ny + nc].reshape(t, h // 2, w // 2)
    v = frames[:, tag + ny + nc:].reshape(t, h // 2, w // 2)
    return y, u, v, num / den


def read_wav(path: str) -> np.ndarray:
    """16 kHz mono PCM16 -> int16 [T]."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 12
    while pos + 8 <= len(data):
        chunk, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if chunk == b"data":
            body = data[pos + 8:pos + 8 + size]
            return np.frombuffer(body[:len(body) // 2 * 2], "<i2")
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")


def _hsv(rgb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn
    s = delta * (255.0 / torch.where(mx > 0, mx, 1.0))
    inv = 60.0 / torch.where(delta > 0, delta, 1.0)
    hue = torch.where(mx == r, (g - b) * inv,
                      torch.where(mx == g, 120.0 + (b - r) * inv,
                                  240.0 + (r - g) * inv))
    hue = torch.where(hue < 0, hue + 360.0, hue)
    return torch.where(delta > 0, hue * 0.5, 0.0), s, mx


def content_scores(y: np.ndarray, u: np.ndarray, v: np.ndarray, device,
                   block: int = 256) -> np.ndarray:
    """[T] float32 scores, score[0] = 0."""
    t, h, w = y.shape
    scale = max(1, w // 256)
    oh, ow = h // scale, w // scale
    rows = np.arange(oh) * scale
    cols = np.arange(ow) * scale
    scores = np.zeros(t, np.float32)
    prev = None
    for a in range(0, t, block):
        yy = torch.as_tensor(np.asarray(y[a:a + block][:, rows][:, :, cols]),
                             device=device).int()
        uu = torch.as_tensor(np.asarray(u[a:a + block][:, rows // 2][:, :, cols // 2]),
                             device=device).int() - 128
        vv = torch.as_tensor(np.asarray(v[a:a + block][:, rows // 2][:, :, cols // 2]),
                             device=device).int() - 128
        rgb = torch.stack([yy + ((91881 * vv) >> 16),
                           yy - ((22554 * uu + 46802 * vv) >> 16),
                           yy + ((116130 * uu) >> 16)], dim=-1)
        hsv = torch.stack(_hsv(rgb.clamp(0, 255).float()))  # [3, n, oh, ow]
        if prev is not None:
            hsv = torch.cat([prev, hsv], dim=1)
        diff = (hsv[:, 1:] - hsv[:, :-1]).abs().double().sum(dim=(0, 2, 3))
        got = (diff / (3.0 * oh * ow)).float().cpu().numpy()
        first = a if prev is not None else a + 1  # the frame the first diff scores
        scores[first:first + len(got)] = got
        prev = hsv[:, -1:]
    return scores


def boundaries(scores: np.ndarray) -> np.ndarray:
    """[S, 2] frame ranges from the cuts."""
    cuts: List[int] = []
    last = 0
    for t in range(1, len(scores)):
        if scores[t] >= THRESHOLD and t - last >= MIN_SCENE_LEN:
            cuts.append(t)
            last = t
    edges = [0] + cuts + [len(scores)]
    return np.array(list(zip(edges[:-1], edges[1:])), np.int64)
