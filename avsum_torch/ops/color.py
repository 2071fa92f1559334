"""YUV420 -> RGB on the device (``avsum_tpu/ops/color.py:15-35``)."""

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
