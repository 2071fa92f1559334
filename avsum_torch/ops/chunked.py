"""Chunked (blockwise) exact attention (``avsum_tpu/ops/chunked.py``).

Full global attention whose QUERY axis is walked in chunks, so the largest
live score block is [B, H, chunk, S] instead of [B, H, S, S]. q, k, v and
the probabilities are float32 whatever the inputs' dtype, as in the JAX
function: with bfloat16 inputs this is not the inline attention of
:class:`avsum_torch.models.attention.MultiHeadSelfAttention`, which
rounds the probabilities to bfloat16 before the product with V.

A symbolic S (``torch.export``) cannot be cut into a Python count of
chunks; it is then taken as one chunk (the same float32 math, the
[B, H, S, S] block materialized).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from avsum_torch.ops.attention import NEG_INF


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      chunk_size: int = 512) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D) + key bias) V over query chunks.

    q, k, v: [B, S, H, D]; mask: optional [B, S] key validity. -> [B, S,
    H, D] float32. S is padded up to a multiple of ``chunk_size`` and the
    pad sliced off again; the real rows are exact."""
    b, s, h, d = q.shape
    kf, vf = k.float(), v.float()
    bias = (None if mask is None
            else torch.where(mask.bool(), 0.0, NEG_INF).float()[:, None, None, :])

    def one_chunk(qc: torch.Tensor) -> torch.Tensor:  # [B, C, H, D]
        logits = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * d ** -0.5
        if bias is not None:
            logits = logits + bias
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, vf)

    if not isinstance(s, int):
        return one_chunk(q.float())
    pad = (-s) % chunk_size
    qp = F.pad(q.float(), (0, 0, 0, 0, 0, pad))
    out = torch.cat([one_chunk(qc) for qc in qp.split(chunk_size, dim=1)],
                    dim=1)
    return out[:, :s]
