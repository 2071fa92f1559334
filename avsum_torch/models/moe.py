"""Mixture-of-experts temporal encoder (``avsum_tpu/models/moe.py``,
``temporal_encoder: moe``): attention blocks whose dense FFN is a top-k
gated mixture of expert FFNs.

Dispatch is dense, as in the JAX package: every expert runs on every
token (einsums over the expert axis, products summed in float32 and
cast to the block dtype) and the gate zeroes the combine weights of the
experts it did not pick. The gate is a float32 Linear named ``gate``
over the float32 tokens; its softmax is cut to the top k by a threshold,
not by ``torch.topk``: every expert whose probability is at least the
k-th largest is kept, so a tie keeps more than k, and the kept weights
are renormalized with a 1e-9 floor. The expert FFN uses the tanh GELU
(Flax's default). Parameters ``w1`` [E, F, 4F], ``b1`` [E, 4F], ``w2``
[E, 4F, F], ``b2`` [E, F] in the block dtype. The block's attention is
materialized at every S, as the JAX block's (it takes no kernel).
Sharding the expert axis over devices (expert parallelism) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.models.attention import MultiHeadSelfAttention
from avsum_torch.models.temporal import (
    LAYER_NORM_EPS,
    dropout,
    next_seed,
    sinusoidal_positions,
)


class MoEFFN(nn.Module):
    """Top-k gated expert FFN: [B, S, F] -> [B, S, F]."""

    def __init__(self, dim: int, n_experts: int = 4, top_k: int = 2,
                 expansion: int = 4, dtype=torch.float32):
        super().__init__()
        self.top_k = top_k
        e, g = n_experts, expansion * dim
        self.w1 = nn.Parameter(torch.zeros(e, dim, g, dtype=dtype))
        self.b1 = nn.Parameter(torch.zeros(e, g, dtype=dtype))
        self.w2 = nn.Parameter(torch.zeros(e, g, dim, dtype=dtype))
        self.b2 = nn.Parameter(torch.zeros(e, dim, dtype=dtype))
        self.gate = nn.Linear(dim, n_experts)  # float32 whatever the dtype

    def combine_weights(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, F] -> [B, S, E] float32 gate weights: softmax, the
        threshold top-k, renormalized."""
        probs = torch.softmax(self.gate(x.float()), dim=-1)
        e = probs.shape[-1]
        if self.top_k < e:
            kth = torch.sort(probs, dim=-1).values[..., e - self.top_k, None]
            probs = torch.where(probs >= kth, probs, 0.0)
            probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
        return probs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.w1.dtype
        weights = self.combine_weights(x)
        x = x.to(dtype)
        h = torch.einsum("bsf,efg->besg", x.float(), self.w1.float())
        h = F.gelu(h.to(dtype) + self.b1[None, :, None, :], approximate="tanh")
        y = torch.einsum("besg,egf->besf", h.float(), self.w2.float())
        y = y.to(dtype) + self.b2[None, :, None, :]
        return torch.einsum("besf,bse->bsf", y, weights.to(dtype))


class MoEBlock(nn.Module):
    """Pre-norm attention block whose FFN is :class:`MoEFFN`."""

    def __init__(self, dim: int, num_heads: int, n_experts: int = 4,
                 top_k: int = 2, dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.rate = dropout
        self.norm_0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS).to(dtype)
        self.attention = MultiHeadSelfAttention(dim, num_heads, dtype,
                                                use_kernel=False).to(dtype)
        self.norm_1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS).to(dtype)
        self.moe_ffn = MoEFFN(dim, n_experts, top_k, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seeds=(None, None)) -> torch.Tensor:
        x = x + dropout(self.attention(self.norm_0(x), mask), self.rate,
                        seeds[0])
        x = x + dropout(self.moe_ffn(self.norm_1(x)), self.rate, seeds[1])
        if mask is not None:
            x = x * mask.to(x.dtype)[..., None]
        return x


class MoEEncoder(nn.Module):
    """Sinusoidal positions + ``num_layers`` MoE blocks."""

    def __init__(self, hidden: int, num_layers: int = 2, num_heads: int = 4,
                 n_experts: int = 4, top_k: int = 2, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            MoEBlock(hidden, num_heads, n_experts, top_k, dropout, dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen``: the CPU generator dropout seeds are drawn from (None:
        no dropout)."""
        _, s, f = x.shape
        x = x + sinusoidal_positions(s, f, x.dtype, x.device)[None]
        for block in self.blocks:
            x = block(x, mask, (next_seed(gen), next_seed(gen)))
        return x
