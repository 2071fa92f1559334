"""Mask-aware multi-head self- and cross-attention
(``avsum_tpu/models/attention.py``).

Self-attention takes the JAX module's dispatch, in its order:
0. with ``ring_mesh`` (a mesh whose ``seq`` axis is > 1; x is this
   rank's block of the shot axis), ring attention over that axis
   (:func:`avsum_torch.parallel.ring.ring_attention`), in place of the
   kernels;
1. with the kernel enabled (``use_kernel``, resolved from
   ``model.use_pallas`` by :func:`kernel_enabled`), a sequence of a
   concrete length of at least ``FLASH_MIN_SEQ`` positions goes through
   :func:`avsum_torch.ops.attention.flash_attention` (kernels K2, B3 and
   B4 on a CUDA tensor; its plain version on a CPU tensor);
2. else, with ``chunk_size`` > 0, :func:`avsum_torch.ops.chunked.chunked_attention`
   (float32 q, k, v and probabilities; the scorer gives a chunk size to
   its fusion attention only, as the JAX scorer does);
3. else the inline materialized softmax, whose probabilities are rounded
   to the compute dtype before the product with V. With bfloat16 that is
   not the chunked path's math.
Logits and softmax are float32 whatever the compute dtype.
:class:`MultiHeadCrossAttention` always takes the inline softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from avsum_torch.ops.attention import NEG_INF, flash_attention
from avsum_torch.ops.chunked import chunked_attention
from avsum_torch.parallel.ring import ring_attention

FLASH_MIN_SEQ = 512


def kernel_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve a tri-state ``use_pallas`` (``model.use_pallas`` for the
    attention kernels, ``audio.use_pallas`` for the log-mel one): ``None``
    (auto) and ``True`` enable the kernels, ``False`` disables them on
    every device. The JAX package's ``pallas_enabled`` resolves ``None`` by
    its backend; here the tensor's device decides inside each wrapper."""
    return flag is not False


def attention_bias(mask: Optional[torch.Tensor], dtype=torch.float32):
    """[B, S] validity mask -> [B, 1, 1, S] additive key bias."""
    if mask is None:
        return None
    return torch.where(mask.bool(), 0.0, NEG_INF).to(dtype)[:, None, None, :]


def inline_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """[B, S, H, D] q and [B, T, H, D] k, v -> [B, S, H, D] float32: float32
    logits and softmax, the probabilities rounded to ``dtype``, their
    product with V summed in float32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * q.shape[-1] ** -0.5
    bias = attention_bias(mask)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())


class MultiHeadCrossAttention(nn.Module):
    """Queries from ``x``, keys and values from ``y`` ([B, S, E] each):
    the co-attention of cross fusion. ``q`` is the Flax DenseGeneral
    (E -> H, D) as Linear(E, E), ``kv`` the DenseGeneral (E -> 2, H, D) as
    Linear(E, 2E), ``out`` (H, D -> E) as Linear(E, E)."""

    def __init__(self, embed_dim: int, num_heads: int = 4,
                 dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = nn.Linear(embed_dim, embed_dim)
        self.kv = nn.Linear(embed_dim, 2 * embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, e = x.shape
        h = self.num_heads
        q = self.q(x.to(self.dtype)).view(b, s, h, e // h)
        k, v = self.kv(y.to(self.dtype)).view(b, y.shape[1], 2, h,
                                              e // h).unbind(2)
        ctx = inline_attention(q, k, v, mask, self.dtype)
        out = self.out(ctx.to(self.dtype).reshape(b, s, e))
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return out


class MultiHeadSelfAttention(nn.Module):
    """Bidirectional MHSA over the sequence axis of [B, S, E].

    ``qkv`` is the Flax DenseGeneral (E -> 3, H, D) as one Linear(E, 3E);
    ``out`` is the DenseGeneral (H, D -> E) as Linear(E, E)."""

    def __init__(self, embed_dim: int, num_heads: int = 4,
                 dtype=torch.float32, use_kernel: bool = True,
                 chunk_size: int = 0, ring_mesh=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.chunk_size = chunk_size
        self.ring_mesh = ring_mesh
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, e = x.shape
        h = self.num_heads
        d = e // h
        qkv = self.qkv(x.to(self.dtype)).view(b, s, 3, h, d)
        q, k, v = qkv.unbind(2)  # [B, S, H, D] strided views
        # a symbolic S (torch.export) takes the materialized softmax, as
        # the JAX package's exported artifact does
        if self.ring_mesh is not None:
            ctx = ring_attention(q, k, v, self.ring_mesh, mask)
        elif self.use_kernel and isinstance(s, int) and s >= FLASH_MIN_SEQ:
            ctx = flash_attention(q, k, v, mask)
        elif self.chunk_size > 0:
            ctx = chunked_attention(q, k, v, mask, self.chunk_size)
        else:
            ctx = inline_attention(q, k, v, mask, self.dtype)
        out = self.out(ctx.to(self.dtype).reshape(b, s, e))
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return out
