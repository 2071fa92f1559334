"""Seeded random initialization of the port's modules.

The rule of ``avsum_tpu/vision/backbone.py::fast_init``: fan-in-scaled
normals for weights, zeros for biases, BatchNorm scale 1 / bias 0 /
mean 0 / var 1. Numbers come from a ``torch.Generator`` seeded with
``seed``, so they differ from JAX's for the same seed; parity tests load
JAX's weights through :mod:`avsum_torch.convert` instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def fast_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``module``'s parameters and BatchNorm statistics in place."""
    gen = torch.Generator().manual_seed(seed)

    def normal_(p: torch.Tensor, fan_in: int) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(max(fan_in, 1)))

    for sub in module.modules():
        if isinstance(sub, nn.modules.batchnorm._BatchNorm):
            sub.reset_parameters()
        elif isinstance(sub, (nn.Conv2d, nn.Linear)):
            normal_(sub.weight, math.prod(sub.weight.shape[1:]))
            if sub.bias is not None:
                sub.bias.zero_()
        else:
            # weights kept in the JAX layout [in, out] (the LSTM's wi / wh)
            for p in sub.parameters(recurse=False):
                if p.dim() >= 2:
                    normal_(p, p.shape[0])
                else:
                    p.zero_()
    return module
