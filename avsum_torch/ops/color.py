"""Colour conversions on the device (``avsum_tpu/ops/color.py``): YUV420
-> RGB for the backbones, RGB -> OpenCV HSV for the shot detector."""

from __future__ import annotations

from typing import Tuple

import torch


def yuv420_to_rgb(
    y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Planar 4:2:0 (BT.601 full range) -> (r, g, b) float32 channels.

    y: [..., H, W] uint8; u, v: [..., H/2, W/2] uint8. Nearest chroma
    upsample, each channel clipped to [0, 255].
    """
    yf = y.to(torch.float32)
    uf = u.to(torch.float32) - 128.0
    vf = v.to(torch.float32) - 128.0
    h, w = y.shape[-2], y.shape[-1]
    uf = uf.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :h, :w]
    vf = vf.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :h, :w]
    r = yf + 1.4020 * vf
    b = yf + 1.7720 * uf
    g = (yf - 0.299 * r - 0.114 * b) / 0.587
    return r.clamp(0.0, 255.0), g.clamp(0.0, 255.0), b.clamp(0.0, 255.0)


def rgb_to_hsv_channels(
    rgb: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., 3] RGB in [0, 255] -> (H, S, V) float32 channels in OpenCV's
    8-bit ranges: H in [0, 180), S and V in [0, 255], with no uint8
    rounding (``avsum_tpu/ops/color.py:38-69``). Hue is ill-conditioned
    near gray, so the operations keep the JAX version's order."""
    r = rgb[..., 0].to(torch.float32)
    g = rgb[..., 1].to(torch.float32)
    b = rgb[..., 2].to(torch.float32)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    safe = torch.where(delta > 0, delta, 1.0)
    h = torch.where(
        v == r,
        60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe),
    )
    h = torch.where(delta > 0, h, 0.0)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # OpenCV halves H to fit 8 bits
    s = torch.where(v > 0, 255.0 * delta / torch.where(v > 0, v, 1.0), 0.0)
    return h, s, v
