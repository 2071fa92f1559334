"""Seeded random initialization of the port's modules.

The rule of ``avsum_tpu/vision/backbone.py::fast_init``: fan-in-scaled
normals for weights, zeros for biases, BatchNorm scale 1 / bias 0 /
mean 0 / var 1, LayerNorm scale 1 / bias 0, RMSNorm scale 1; a module
with ``init_gates_`` (Kimi Delta Attention's decay gates) fills its own
direct parameters from the same generator. Numbers
come from a ``torch.Generator`` seeded with ``seed``, so they differ
from JAX's for the same seed; parity tests load JAX's weights through
:mod:`avsum_torch.convert` instead.
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
        if isinstance(sub, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm,
                            nn.RMSNorm)):
            sub.reset_parameters()
        elif getattr(sub, "stacked_linear", False):
            # stacked Linear weights [..., out, in] (the decoder's held
            # experts): the fan-in is the last axis
            for p in sub.parameters(recurse=False):
                normal_(p, p.shape[-1])
        elif hasattr(sub, "init_gates_"):
            # Kimi Delta Attention's A_log and dt_bias: their source's rule
            sub.init_gates_(gen)
        elif isinstance(sub, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            normal_(sub.weight, math.prod(sub.weight.shape[1:]))
            if sub.bias is not None:
                sub.bias.zero_()
        else:
            # weights kept in the JAX layout [..., in, out] (the LSTM's
            # wi / wh, the experts' w1 / w2, the ViT's cls and pos_embed):
            # the fan-in is every axis but the last, as in JAX's fast_init
            for p in sub.parameters(recurse=False):
                if p.dim() >= 2:
                    normal_(p, math.prod(p.shape[:-1]))
                else:
                    p.zero_()
    return module
