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

Expert parallelism: with ``ep_mesh`` (a mesh whose ``model`` axis n is
> 1 and divides E) a rank holds its E / n experts (``w1``, ``b1``,
``w2``, ``b2`` are [E / n, ...], the names of the one-device layout) and
the gate whole, computes its experts' weighted output for its tokens, and
one sum over ``model`` combines them (:func:`avsum_torch.parallel.comm.
reduce_from`: its backward is the identity, as every ``model`` rank
computes the same loss). The tokens and the combine weights enter the
experts through :func:`~avsum_torch.parallel.comm.copy_to`, whose backward
sums each rank's share of their cotangents. With ``seq`` > 1 the encoder
gathers the shot axis (its blocks' attention has no ring, as in JAX),
runs on the whole axis and keeps the rank's block.

Tensor parallelism with an expert count that does not divide by
``model`` (:func:`avsum_torch.parallel.tensor.parallelize` sets
``tp_mesh``): a rank holds the block of the last axis of each expert leaf
JAX's placement gives it (``tp_split`` names them) and gathers the
blocks before the products with :func:`~avsum_torch.parallel.comm.
gather_from`, whose backward keeps the rank's block of the gradient and
sums nothing; every rank then computes the whole FFN.
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
    gather_shots,
    next_seed,
    sinusoidal_positions,
)
from avsum_torch.parallel.comm import (
    copy_to,
    gather_from,
    local_block,
    reduce_from,
)
from avsum_torch.parallel.mesh import AXIS_MODEL, AXIS_SEQ

EXPERT_PARAMS = ("w1", "b1", "w2", "b2")  # split over model under EP


class MoEFFN(nn.Module):
    """Top-k gated expert FFN: [B, S, F] -> [B, S, F]."""

    def __init__(self, dim: int, n_experts: int = 4, top_k: int = 2,
                 expansion: int = 4, dtype=torch.float32, ep_mesh=None):
        super().__init__()
        self.top_k = top_k
        n = 1 if ep_mesh is None else ep_mesh.size(AXIS_MODEL)
        self.ep_mesh = ep_mesh if n > 1 and n_experts % n == 0 else None
        e, g = n_experts // (n if self.ep_mesh else 1), expansion * dim
        self.w1 = nn.Parameter(torch.zeros(e, dim, g, dtype=dtype))
        self.b1 = nn.Parameter(torch.zeros(e, g, dtype=dtype))
        self.w2 = nn.Parameter(torch.zeros(e, g, dim, dtype=dtype))
        self.b2 = nn.Parameter(torch.zeros(e, dim, dtype=dtype))
        self.gate = nn.Linear(dim, n_experts)  # float32 whatever the dtype
        self.tp_mesh, self.tp_split = None, set()  # set by parallelize

    def experts(self):
        """(w1, b1, w2, b2), each split leaf gathered over ``model``."""
        return tuple(
            gather_from(getattr(self, name), self.tp_mesh, AXIS_MODEL, -1)
            if name in self.tp_split else getattr(self, name)
            for name in EXPERT_PARAMS)

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
        mesh = self.ep_mesh
        if mesh is not None:  # this rank's experts
            x, weights = copy_to(x, mesh, AXIS_MODEL), copy_to(
                weights, mesh, AXIS_MODEL)
            e = self.w1.shape[0]
            weights = weights[..., mesh.index(AXIS_MODEL) * e:][..., :e]
        w1, b1, w2, b2 = self.experts()
        x = x.to(dtype)
        h = torch.einsum("bsf,efg->besg", x.float(), w1.float())
        h = F.gelu(h.to(dtype) + b1[None, :, None, :], approximate="tanh")
        y = torch.einsum("besg,egf->besf", h.float(), w2.float())
        y = y.to(dtype) + b2[None, :, None, :]
        y = torch.einsum("besf,bse->bsf", y, weights.to(dtype))
        return y if mesh is None else reduce_from(y, mesh, AXIS_MODEL)


class MoEBlock(nn.Module):
    """Pre-norm attention block whose FFN is :class:`MoEFFN`."""

    def __init__(self, dim: int, num_heads: int, n_experts: int = 4,
                 top_k: int = 2, dropout: float = 0.0, dtype=torch.float32,
                 mesh=None):
        super().__init__()
        self.rate = dropout
        self.mesh = mesh
        self.norm_0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS).to(dtype)
        self.attention = MultiHeadSelfAttention(dim, num_heads, dtype,
                                                use_kernel=False).to(dtype)
        self.norm_1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS).to(dtype)
        self.moe_ffn = MoEFFN(dim, n_experts, top_k, dtype=dtype,
                              ep_mesh=mesh)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seeds=(None, None)) -> torch.Tensor:
        """x: the whole shot axis of this rank's batch rows."""
        x = x + dropout(self.attention(self.norm_0(x), mask), self.rate,
                        seeds[0], self.mesh, seq_sharded=False)
        x = x + dropout(self.moe_ffn(self.norm_1(x)), self.rate, seeds[1],
                        self.mesh, seq_sharded=False)
        if mask is not None:
            x = x * mask.to(x.dtype)[..., None]
        return x


class MoEEncoder(nn.Module):
    """Sinusoidal positions + ``num_layers`` MoE blocks."""

    def __init__(self, hidden: int, num_layers: int = 2, num_heads: int = 4,
                 n_experts: int = 4, top_k: int = 2, dropout: float = 0.0,
                 dtype=torch.float32, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.blocks = nn.ModuleList(
            MoEBlock(hidden, num_heads, n_experts, top_k, dropout, dtype,
                     mesh)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen``: the CPU generator dropout seeds are drawn from (None:
        no dropout)."""
        x, mask = gather_shots(x, mask, self.mesh)
        _, s, f = x.shape
        x = x + sinusoidal_positions(s, f, x.dtype, x.device)[None]
        for block in self.blocks:
            x = block(x, mask, (next_seed(gen), next_seed(gen)))
        return local_block(x, self.mesh, AXIS_SEQ)
