"""Ring attention: context parallelism over the shot axis
(``avsum_tpu/parallel/ring.py``).

Each rank of the ``seq`` axis holds its block of Q, K, V [B, S/n, H, D]
and of the key bias. K, V and the bias go round the ring (n - 1 passes to
the next rank) while an online softmax in float32 folds each visiting
block into the accumulator of the rank's queries: exact attention, and
no rank holds [S, S] or all of K and V.

The backward is written out (JAX differentiates through its
``fori_loop``): K, V and the bias go round the ring again, each visiting
block's dK and dV ride along with it, and one last pass takes them home.
Only the output and the softmax's running max and sum are saved. A query
row whose keys are all masked is the uniform average of every key's
value, as in JAX (its scores all equal the -1e30 bias; the sum is
floored at 1e-30 as ``ring.py:87`` does), in both directions.
"""

from __future__ import annotations

from typing import Optional

import torch

from avsum_torch.ops.attention import NEG_INF
from avsum_torch.parallel.comm import ring_pass
from avsum_torch.parallel.mesh import AXIS_SEQ


def _scores(q, k, bias, scale):
    """[B, Sq, H, D] x [B, Sk, H, D] + [B, Sk] -> [B, H, Sq, Sk] float32."""
    return (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            + bias[:, None, None, :])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mesh, axis):
        n = mesh.size(axis)
        qf, kc, vc, bc = q.float(), k.float(), v.float(), bias
        scale = q.shape[-1] ** -0.5
        b, sl, h, d = q.shape
        m = torch.full((b, h, sl, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, sl, 1), device=q.device)
        acc = torch.zeros((b, h, sl, d), device=q.device)
        for i in range(n):
            s = _scores(qf, kc, bc, scale)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, vc)
            m = m_new
            if i < n - 1:
                kc, vc, bc = ring_pass((kc, vc, bc), mesh, axis)
        l = l.clamp_min(1e-30)
        out = (acc / l).transpose(1, 2).contiguous()  # [B, Sl, H, D]
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n = mesh.size(axis)
        scale = q.shape[-1] ** -0.5
        qf, kc, vc, bc = q.float(), k.float(), v.float(), bias
        do = dout.float()
        delta = (do * out).sum(-1).transpose(1, 2)[..., None]  # [B,H,Sl,1]
        dq = torch.zeros_like(qf)
        dk, dv = torch.zeros_like(kc), torch.zeros_like(vc)
        for i in range(n):
            p = torch.exp(_scores(qf, kc, bc, scale) - m) / l
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vc)
            ds = p * (dp - delta)
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            if i < n - 1:
                kc, vc, bc, dk, dv = ring_pass((kc, vc, bc, dk, dv), mesh,
                                               axis)
        dk, dv = ring_pass((dk, dv), mesh, axis)  # home to their own rank
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   mask: Optional[torch.Tensor] = None,
                   axis: str = AXIS_SEQ) -> torch.Tensor:
    """Exact attention with the shot axis split over ``axis``.

    q, k, v: this rank's [B, S/n, H, D] blocks; ``mask``: its [B, S/n]
    key-validity block. -> [B, S/n, H, D] float32, this rank's block."""
    b, s = q.shape[:2]
    bias = (torch.zeros((b, s), device=q.device) if mask is None
            else torch.where(mask.bool(), 0.0, NEG_INF).float())
    return _RingAttention.apply(q, k, v, bias, mesh, axis)
