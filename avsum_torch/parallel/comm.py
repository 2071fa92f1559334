"""Collectives over one axis of the mesh, and their autograd forms (the
counterparts of ``jax.lax.ppermute``, ``psum`` and the gathers XLA puts
in for a sharded axis).

Transport: NCCL takes device tensors as they are. gloo takes CPU
tensors; for ranks that share a card over gloo (:attr:`Mesh.staged`)
each payload goes through a pinned host buffer here, and nowhere else.

Autograd forms (each the identity on an axis of size 1):

- :func:`copy_to`: identity forward, sum over the axis backward: the
  entry of a region whose ranks each compute a part of a replicated
  consumer's input (the experts of one rank, the first stage);
- :func:`reduce_from`: sum over the axis forward, identity backward: the
  exit of that region. Every rank then computes the same loss, so the
  gradient of the sum is each rank's own cotangent, not their sum;
- :func:`gather`: the shot blocks of the axis concatenated forward; the
  backward sums the cotangents over the axis and keeps this rank's block
  (a reduce-scatter): each rank's consumers of the gathered axis compute
  a part of the loss;
- :func:`gather_from`: the blocks of a split quantity (a column-parallel
  product's features, a split weight) concatenated forward; the backward
  keeps this rank's block of the cotangent and sums nothing, since every
  rank of the axis computes the same loss from the gathered whole, so
  its cotangent is already the whole gradient (a sum would be m times
  it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _host(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """``x`` in a pinned host buffer when ``staged``, else ``x``."""
    if not staged:
        return x
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x)


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (``x`` itself on an axis of size 1)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    buf = (_host(x, True) if mesh.staged
           else x.clone(memory_format=torch.contiguous_format))
    dist.all_reduce(buf, group=mesh.groups[axis])
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis`` concatenated along ``dim``, in rank order."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    src = _host(x.contiguous(), mesh.staged)
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=mesh.groups[axis])
    return torch.cat(parts, dim).to(x.device)


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             recv: Optional[torch.Tensor], src: Optional[int], mesh
             ) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive into a tensor like
    ``recv`` from ``src`` at once (either may be None); -> the received
    tensor on ``recv``'s device."""
    ops, staged = [], mesh.staged
    if send is not None:
        ops.append(dist.P2POp(dist.isend, _host(send.contiguous(), staged),
                              dst))
    buf = None
    if recv is not None:
        buf = (torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
               if staged else torch.empty_like(recv))
        ops.append(dist.P2POp(dist.irecv, buf, src))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if buf is None else buf.to(recv.device)


def ring_pass(tensors: Sequence[torch.Tensor], mesh, axis: str,
              ) -> List[torch.Tensor]:
    """Each rank sends ``tensors`` to the next rank of ``axis`` and gets
    the previous rank's (``ppermute`` with ``i -> i + 1``). One message:
    the tensors share a dtype and travel flattened into one buffer."""
    ranks, i = mesh.ranks[axis], mesh.index(axis)
    n = len(ranks)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    got = exchange(flat, ranks[(i + 1) % n], flat, ranks[(i - 1) % n], mesh)
    out, at = [], 0
    for t in tensors:
        out.append(got[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.contiguous(), ctx.mesh, ctx.axis)
        start = ctx.mesh.index(ctx.axis) * ctx.n
        return total.narrow(ctx.dim, start, ctx.n), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.start = mesh.index(axis) * x.shape[dim]
        ctx.dim, ctx.n = dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


def _trivial(mesh, axis: str) -> bool:
    return mesh is None or mesh.size(axis) == 1


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 1) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _Gather.apply(x, mesh, axis, dim)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int = -1
                ) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _GatherFrom.apply(x, mesh, axis,
                                                            dim)


def local_block(x: torch.Tensor, mesh, axis: str, dim: int = 1
                ) -> torch.Tensor:
    """This rank's block of a tensor gathered along ``dim`` over ``axis``."""
    if _trivial(mesh, axis):
        return x
    n = x.shape[dim] // mesh.size(axis)
    return x.narrow(dim, mesh.index(axis) * n, n)
