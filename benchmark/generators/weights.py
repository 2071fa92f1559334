"""Seeded weights for a module, made on the device: every convolution's
and dense layer's weight normal over the square root of its fan-in,
drawn in one call for the whole module and cast to ``dtype``, the type
it is served in; biases 0; BatchNorm scale 1, shift 0, running mean 0,
running variance 1 (the port's own initialization rule)."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def fill(module: nn.Module, seed: int, dtype=torch.float32) -> nn.Module:
    """Fill ``module`` (on its device) in place -> ``module``."""
    layers = [m for m in module.modules()
              if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear))]
    device = layers[0].weight.device
    total = sum(m.weight.numel() for m in layers)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    at = 0
    for m in layers:
        n = m.weight.numel()
        fan_in = math.prod(m.weight.shape[1:])
        w = (flat[at:at + n] / math.sqrt(fan_in)).view_as(m.weight)
        m.weight.copy_(w.to(dtype).to(m.weight.dtype))
        at += n
        if m.bias is not None:
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module
