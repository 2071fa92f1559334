"""Mask-aware multi-head self-attention (``avsum_tpu/models/attention.py``).

Same dispatch rule as the JAX module: a sequence of at least
``FLASH_MIN_SEQ`` positions goes through :func:`avsum_torch.ops.attention.flash_attention`
(kernel K2 on a CUDA tensor; its plain version on a CPU tensor), shorter
ones through the inline materialized softmax. Logits and softmax are
float32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avsum_torch.ops.attention import NEG_INF, flash_attention

FLASH_MIN_SEQ = 512


def attention_bias(mask: Optional[torch.Tensor], dtype=torch.float32):
    """[B, S] validity mask -> [B, 1, 1, S] additive key bias."""
    if mask is None:
        return None
    return torch.where(mask.bool(), 0.0, NEG_INF).to(dtype)[:, None, None, :]


class MultiHeadSelfAttention(nn.Module):
    """Bidirectional MHSA over the sequence axis of [B, S, E].

    ``qkv`` is the Flax DenseGeneral (E -> 3, H, D) as one Linear(E, 3E);
    ``out`` is the DenseGeneral (H, D -> E) as Linear(E, E)."""

    def __init__(self, embed_dim: int, num_heads: int = 4,
                 dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, e = x.shape
        h = self.num_heads
        d = e // h
        qkv = self.qkv(x.to(self.dtype)).view(b, s, 3, h, d)
        q, k, v = qkv.unbind(2)  # [B, S, H, D] strided views
        if s >= FLASH_MIN_SEQ:
            ctx = flash_attention(q, k, v, mask)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            logits = logits * d ** -0.5
            bias = attention_bias(mask)
            if bias is not None:
                logits = logits + bias
            probs = torch.softmax(logits, dim=-1).to(self.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        out = self.out(ctx.to(self.dtype).reshape(b, s, e))
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return out
