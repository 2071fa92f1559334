"""Temporal encoders (``avsum_tpu/models/temporal.py``): the BiLSTM
(``:31-104``), the attention encoder (``:107-170,309-318``), the dilated
temporal convolutions (``:173-201``) and the deep staged attention
encoder (``:204-306``).

BiLSTM: the recurrence is a Python loop over time steps (the JAX
package's ``lax.scan``); while ``torch.export`` traces it with a symbolic
shot axis it is ``torch._higher_order_ops.scan`` over the same step. Gate
order i, f, g, o; one bias; state frozen across masked steps; the reverse
direction walks from the last step.
Parameters keep the JAX layout: ``wi`` [F, 4H], ``wh`` [H, 4H], ``b`` [4H].

Attention encoder: sinusoidal positions ([sin | cos], an odd width
zero-padded), then pre-norm blocks: LayerNorm (epsilon 1e-6, Flax's
default) -> self-attention -> dropout -> residual, LayerNorm -> Linear
4x -> exact (erf) GELU -> Linear -> dropout -> residual, output times the
mask. ``remat`` re-runs each block's forward in the backward pass
(``torch.utils.checkpoint``), as ``nn.remat`` does in JAX.

Temporal convolutions: per layer i, LayerNorm (epsilon 1e-6), times the
mask, a 1-D convolution of kernel 5 and dilation 2^i with "SAME"
padding, the tanh GELU (Flax's default), dropout and a residual; the
output times the mask.

Staged encoder: ``num_layers`` dropout-free attention blocks in
``n_stages`` equal stages, run one after another (the JAX module's
``lax.scan`` over its stacked stage parameters without a mesh); with
``remat`` each stage is checkpointed. Its blocks, like the JAX ones, never
take the flash kernel.

On a mesh (``mesh``, :mod:`avsum_torch.parallel.mesh`; x is this rank's
block [B / data, S / seq, F]): the attention encoder runs ring attention
over ``seq`` when it is > 1, its positions those of the rank's global
shots; the staged encoder runs its stages as a GPipe schedule over
``model`` when that is > 1 (the rank holds ``stages.{m}`` only,
:func:`avsum_torch.parallel.pipeline.pipeline_apply`). The BiLSTM, the
convolutions and the staged encoder mix the shot axis without a ring, as
in JAX, so with ``seq`` > 1 they gather it, run on the whole axis and
keep the rank's block (the gather's backward sums the cotangents over
``seq``).

Dropout follows Flax's ``nn.Dropout`` (keep with probability 1 - rate,
scale kept values by 1 / (1 - rate)). Its masks come from explicit seeds:
each dropout site draws one integer from the CPU ``torch.Generator`` the
caller passes and seeds a generator on the tensor's device with it, so a
checkpointed block draws the same masks when it is run again. On a mesh
the mask is drawn at the global shape and the rank keeps its block, so
the masks are those of the one-device run of the same padded batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from avsum_torch.models.attention import MultiHeadSelfAttention
from avsum_torch.parallel.comm import (
    copy_to,
    gather,
    gather_from,
    local_block,
)
from avsum_torch.parallel.mesh import (
    AXIS_MODEL,
    AXIS_SEQ,
    global_block,
    seq_offset,
)
from avsum_torch.parallel.pipeline import pipeline_apply

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def next_seed(gen: Optional[torch.Generator]) -> Optional[int]:
    """The seed of one dropout site: an integer drawn from ``gen``, or
    None (no dropout) when ``gen`` is None."""
    if gen is None:
        return None
    return int(torch.randint(0, 2 ** 62, (), generator=gen))


def dropout(x: torch.Tensor, rate: float, seed: Optional[int], mesh=None,
            seq_sharded: bool = True) -> torch.Tensor:
    """Flax's dropout with the mask drawn from ``seed``; identity when
    ``seed`` is None or ``rate`` is 0. On ``mesh`` the mask is drawn at
    the global shape of the [B, S, ...] block ``x`` (its shot axis split
    over ``seq`` when ``seq_sharded``) and sliced."""
    if seed is None or rate == 0.0:
        return x
    shape, index = global_block(mesh, x.shape, seq_sharded)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = (torch.rand(shape, generator=gen, device=x.device) >= rate)[index]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def seq_split(mesh) -> bool:
    """True when ``mesh`` splits the shot axis."""
    return mesh is not None and mesh.size(AXIS_SEQ) > 1


def gather_shots(x: torch.Tensor, mask: Optional[torch.Tensor], mesh):
    """(x, mask) with the whole shot axis, for a module that mixes it
    without a ring."""
    if not seq_split(mesh):
        return x, mask
    return (gather(x, mesh, AXIS_SEQ),
            None if mask is None else gather(mask, mesh, AXIS_SEQ))


class LSTMCellScan(nn.Module):
    """One LSTM direction over [B, S, F] -> [B, S, H]. Under tensor
    parallelism (``tp_mesh``, :mod:`avsum_torch.parallel.tensor`) ``wi``
    and ``wh`` hold this rank's columns: the input projection runs
    column-parallel and ``wh`` is gathered once before the loop."""

    tp_mesh = None

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32,
                 reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.reverse = reverse
        self.wi = nn.Parameter(torch.zeros(in_features, 4 * hidden, dtype=dtype))
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(4 * hidden, dtype=dtype))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        # input projections for all steps at once; only h @ wh stays inside
        wh, mesh = self.wh, self.tp_mesh
        if mesh is None:
            xw = torch.matmul(x, self.wi)
        else:
            xw = gather_from(torch.matmul(copy_to(x, mesh, AXIS_MODEL),
                                          self.wi), mesh, AXIS_MODEL)
            wh = gather_from(wh, mesh, AXIS_MODEL)
        xw = (xw.float() + self.b).to(self.dtype)
        m = (torch.ones(b, s, 1, dtype=self.dtype, device=x.device)
             if mask is None else mask.to(self.dtype)[..., None])
        h = torch.zeros(b, self.hidden, dtype=self.dtype, device=x.device)
        c = torch.zeros_like(h)
        if torch.compiler.is_exporting():
            # a symbolic S cannot unroll the loop: the scan operator walks
            # it inside the exported program
            from torch._higher_order_ops import scan

            def step(carry, inputs):  # scan's outputs may not alias
                carry, h_t = self._step(carry, inputs, wh)
                return carry, h_t.clone()

            _, hs = scan(step, (h, c),
                         (xw.transpose(0, 1), m.transpose(0, 1)),
                         reverse=self.reverse)
            return hs.transpose(0, 1)
        hs = [None] * s
        for t in (range(s - 1, -1, -1) if self.reverse else range(s)):
            (h, c), hs[t] = self._step((h, c), (xw[:, t], m[:, t]), wh)
        return torch.stack(hs, dim=1)

    def _step(self, carry, inputs, wh):
        """One time step: ((h, c), (x @ wi + b, mask)) -> ((h, c), h);
        the state stays frozen across a masked step."""
        h, c = carry
        xw_t, m_t = inputs
        gates = xw_t + (h @ wh).to(self.dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = m_t * h_new + (1 - m_t) * h
        c = m_t * c_new + (1 - m_t) * c
        return (h, c), h


class BiLSTM(nn.Module):
    """Forward and backward halves concatenated: [B, S, F] -> [B, S, hidden]."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32,
                 mesh=None):
        super().__init__()
        half = hidden // 2
        self.mesh = mesh
        self.fwd = LSTMCellScan(in_features, half, dtype, reverse=False)
        self.bwd = LSTMCellScan(in_features, half, dtype, reverse=True)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen`` is accepted for the encoders' common call and unused:
        the BiLSTM has no dropout."""
        del gen
        x, mask = gather_shots(x, mask, self.mesh)
        out = torch.cat([self.fwd(x, mask), self.bwd(x, mask)], dim=-1)
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return local_block(out, self.mesh, AXIS_SEQ)


def sinusoidal_positions(seq_len: int, dim: int, dtype=torch.float32,
                         device=None, offset: int = 0) -> torch.Tensor:
    """Sinusoidal position table [S, dim]: [sin | cos] halves, computed in
    float32 as the JAX function does; an odd ``dim`` gets a zero column.
    ``offset``: the rows from that position on (a block of a longer
    table)."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)[:, None]
    half = dim // 2
    log_base = torch.tensor(math.log(10000.0), dtype=torch.float32,
                            device=device)
    freqs = torch.exp(-log_base
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / half)
    angles = pos * freqs[None, :]
    emb = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    if emb.shape[-1] < dim:
        emb = F.pad(emb, (0, dim - emb.shape[-1]))
    return emb.to(dtype)


class AttentionBlock(nn.Module):
    """Pre-norm bidirectional attention block ([B, S, dim] -> same)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype=torch.float32, use_kernel: bool = True, mesh=None):
        super().__init__()
        self.rate = dropout
        self.mesh = mesh
        self.norm_0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attention = MultiHeadSelfAttention(
            dim, num_heads, dtype, use_kernel,
            ring_mesh=mesh if seq_split(mesh) else None)
        self.norm_1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.dense_0 = nn.Linear(dim, 4 * dim)
        self.dense_1 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seeds: Tuple[Optional[int], Optional[int]] = (None, None)
                ) -> torch.Tensor:
        y = self.attention(self.norm_0(x), mask)
        x = x + dropout(y, self.rate, seeds[0], self.mesh)
        y = self.dense_1(F.gelu(self.dense_0(self.norm_1(x))))
        x = x + dropout(y, self.rate, seeds[1], self.mesh)
        if mask is not None:
            x = x * mask.to(x.dtype)[..., None]
        return x


class TemporalConvEncoder(nn.Module):
    """Dilated temporal convolutions over [B, S, hidden] (O(S) work)."""

    def __init__(self, hidden: int, num_layers: int = 2, kernel: int = 5,
                 dropout: float = 0.0, dtype=torch.float32, mesh=None):
        super().__init__()
        self.rate = dropout
        self.mesh = mesh
        self.norms = nn.ModuleList(
            nn.LayerNorm(hidden, eps=LAYER_NORM_EPS) for _ in range(num_layers))
        self.convs = nn.ModuleList(
            nn.Conv1d(hidden, hidden, kernel, dilation=2 ** i, padding="same")
            for i in range(num_layers))
        self.to(dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen``: the CPU generator dropout seeds are drawn from (None:
        no dropout)."""
        x, mask = gather_shots(x, mask, self.mesh)
        m = None if mask is None else mask.to(x.dtype)[..., None]
        for norm, conv in zip(self.norms, self.convs):
            y = norm(x)
            if m is not None:
                y = y * m  # padding stays out of the convolution's window
            y = conv(y.transpose(1, 2)).transpose(1, 2)
            x = x + dropout(F.gelu(y, approximate="tanh"), self.rate,
                            next_seed(gen), self.mesh, seq_sharded=False)
        if m is not None:
            x = x * m
        return local_block(x, self.mesh, AXIS_SEQ)


class StageBlocks(nn.Module):
    """``layers`` dropout-free attention blocks: one stage of the staged
    encoder."""

    def __init__(self, dim: int, num_heads: int, layers: int,
                 dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            AttentionBlock(dim, num_heads, 0.0, dtype, use_kernel=False)
            for _ in range(layers))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class PipelinedAttentionEncoder(nn.Module):
    """Sinusoidal positions + ``n_stages`` stages of ``num_layers /
    n_stages`` attention blocks each, in order; the output times the
    mask. With a mesh whose ``model`` axis is > 1 (it must equal
    ``n_stages``) the stages run as a GPipe schedule, one per rank, and
    ``stages`` holds only this rank's (the others are empty modules, so
    the state_dict's names are those of the one-device layout)."""

    def __init__(self, hidden: int, num_layers: int = 12, n_stages: int = 4,
                 num_heads: int = 4, dtype=torch.float32,
                 remat: bool = False, mesh=None):
        super().__init__()
        if num_layers % n_stages != 0:
            raise ValueError(
                f"temporal_layers={num_layers} must divide into "
                f"pp_stages={n_stages} equal stages")
        self.remat = remat
        self.n_stages = n_stages
        self.mesh = mesh
        self.pp = mesh is not None and mesh.size(AXIS_MODEL) > 1
        if self.pp and mesh.size(AXIS_MODEL) != n_stages:
            raise ValueError(
                f"model.pp_stages={n_stages} must equal the mesh's model "
                f"axis size {mesh.size(AXIS_MODEL)} (one stage per device)")
        mine = mesh.index(AXIS_MODEL) if self.pp else None
        self.stages = nn.ModuleList(
            StageBlocks(hidden, num_heads, num_layers // n_stages, dtype)
            if mine in (None, i) else nn.Module() for i in range(n_stages))
        self.to(dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen`` is accepted for the encoders' common call and unused:
        the stages are dropout-free."""
        del gen
        x, mask = gather_shots(x, mask, self.mesh)
        b, s, f = x.shape
        x = x + sinusoidal_positions(s, f, x.dtype, x.device)[None]
        if self.pp:
            n_micro = b if b % self.n_stages == 0 else math.gcd(b,
                                                                self.n_stages)
            x = pipeline_apply(self.stages[self.mesh.index(AXIS_MODEL)], x,
                               self.mesh, mask, n_stages=self.n_stages,
                               num_microbatches=min(n_micro, b),
                               remat=self.remat)
        else:
            for stage in self.stages:
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(stage, x, mask, use_reentrant=False)
                else:
                    x = stage(x, mask)
        if mask is not None:
            x = x * mask.to(x.dtype)[..., None]
        return local_block(x, self.mesh, AXIS_SEQ)


class AttentionEncoder(nn.Module):
    """Sinusoidal positions + ``num_layers`` attention blocks."""

    def __init__(self, hidden: int, num_layers: int = 2, num_heads: int = 4,
                 dropout: float = 0.0, dtype=torch.float32,
                 use_kernel: bool = True, remat: bool = False, mesh=None):
        super().__init__()
        self.remat = remat
        self.mesh = mesh
        self.blocks = nn.ModuleList(
            AttentionBlock(hidden, num_heads, dropout, dtype, use_kernel,
                           mesh)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen``: the CPU generator dropout seeds are drawn from (None:
        no dropout)."""
        _, s, f = x.shape
        x = x + sinusoidal_positions(s, f, x.dtype, x.device,
                                     seq_offset(self.mesh, s))[None]
        for block in self.blocks:
            seeds = (next_seed(gen), next_seed(gen))
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, mask, seeds, use_reentrant=False)
            else:
                x = block(x, mask, seeds)
        return x
