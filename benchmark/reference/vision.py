"""The visual features of a summarize, written out plainly: frames
sampled at ``sample_fps``, their YUV420 planes resized on the host to the
shipped square (bilinear, half-pixel centres, 8.8 fixed-point weights),
converted to RGB (BT.601 full range, nearest chroma), divided by 255 and
normalized by ImageNet's mean and standard deviation, resized to 224 and
299 (bilinear, antialiased when shrinking: a triangle widened by the
scale, normalized, as ``jax.image.resize`` computes it), embedded by
ResNet-50 and Inception-V3, the two 2048-d features concatenated, and
mean-pooled over the first ``max_frames_per_shot`` samples of each shot.
Everything on the device is float32 unless ``dtype`` says otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from benchmark.reference.inception import InceptionV3
from benchmark.reference.resnet import ResNet50

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class DualBackbone(nn.Module):
    """[B, 3, 224 | 299] -> [B, 4096]: ResNet-50 || Inception-V3."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet50()
        self.inception = InceptionV3()


def _lut(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    x = np.arange(dst, dtype=np.float32)
    sx = np.maximum((x + np.float32(0.5)) * np.float32(src) / np.float32(dst)
                    - np.float32(0.5), np.float32(0))
    a = np.minimum(sx.astype(np.int64), src - 1)
    b = np.minimum(a + 1, src - 1)
    w = ((sx - a.astype(np.float32)) * np.float32(256) + np.float32(0.5)
         ).astype(np.int64)
    return a, b, w


def host_resize(planes: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[N, H, W] uint8 -> [N, out_h, out_w] uint8, bilinear with 8-bit
    fixed-point weights, rounded."""
    n, h, w = planes.shape
    x0, x1, xw = _lut(w, out_w)
    y0, y1, yw = _lut(h, out_h)
    p = planes.astype(np.int64)
    top = p[:, y0][:, :, x0] * (256 - xw) + p[:, y0][:, :, x1] * xw
    bot = p[:, y1][:, :, x0] * (256 - xw) + p[:, y1][:, :, x1] * xw
    out = (top * (256 - yw)[None, :, None] + bot * yw[None, :, None]
           + 32768) >> 16
    return out.astype(np.uint8)


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """[N, H, W] and [N, H/2, W/2] uint8 -> [N, H, W, 3] float32 in
    [0, 255]."""
    yf = y.float()
    up = (u.float() - 128.0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    vp = (v.float() - 128.0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    r = yf + 1.4020 * vp
    b = yf + 1.7720 * up
    g = (yf - 0.299 * r - 0.114 * b) / 0.587
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] bilinear weights, antialiased when shrinking."""
    scale = n_out / n_in
    inv = 1.0 / scale
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = np.maximum(0.0, 1.0 - dist / max(inv, 1.0))
    w = w / w.sum(axis=0, keepdims=True)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def embed(model: DualBackbone, rgb: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] RGB in [0, 255] -> [N, 4096] float32."""
    mean = torch.tensor(MEAN, device=rgb.device)
    std = torch.tensor(STD, device=rgb.device)
    x = ((rgb / 255.0 - mean) / std).permute(0, 3, 1, 2)
    dtype = next(model.parameters()).dtype
    h, w = x.shape[-2:]
    out = []
    for size, net in ((224, model.resnet), (299, model.inception)):
        wh = resize_weights(h, size, x.device)
        ww = resize_weights(w, size, x.device)
        out.append(net((wh.T @ (x @ ww)).to(dtype)).float())
    return torch.cat(out, dim=-1)


def shot_features(model: DualBackbone, y: np.ndarray, u: np.ndarray,
                  v: np.ndarray, boundaries: np.ndarray, stride: int,
                  ship: int, cap: int, device, batch: int = 64
                  ) -> torch.Tensor:
    """The video's planes ([T, H, W] / [T, H/2, W/2] uint8) -> [S, 4096]
    pooled features: every ``stride``-th frame from the first, each
    joining the shot that holds it, at most ``cap`` a shot."""
    n_frames = y.shape[0]
    idx = np.arange(0, n_frames, stride)
    shot = np.searchsorted(boundaries[:, 0], idx, side="right") - 1
    first = np.searchsorted(shot, np.arange(len(boundaries)))
    keep = (np.arange(len(idx)) - first[shot]) < cap
    big = y.shape[1] * y.shape[2] > ship * ship
    feats = []
    with torch.no_grad():
        for i in range(0, len(idx), batch):
            sel = idx[i:i + batch]
            planes = [np.asarray(p[sel]) for p in (y, u, v)]
            if big:
                planes = [host_resize(planes[0], ship, ship),
                          host_resize(planes[1], ship // 2, ship // 2),
                          host_resize(planes[2], ship // 2, ship // 2)]
            rgb = yuv420_to_rgb(*(torch.as_tensor(p, device=device)
                                  for p in planes))
            feats.append(embed(model, rgb))
    feats = torch.cat(feats)
    out = torch.zeros(len(boundaries), feats.shape[1], device=device)
    count = torch.zeros(len(boundaries), device=device)
    k = torch.as_tensor(keep, device=device)
    s = torch.as_tensor(shot, device=device)
    out.index_add_(0, s[k], feats[k])
    count.index_add_(0, s[k], torch.ones(int(k.sum()), device=device))
    return out / count.clamp(min=1.0)[:, None]
