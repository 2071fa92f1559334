"""Pipeline parallelism: the GPipe schedule over the ``model`` axis
(``avsum_tpu/parallel/pipeline.py``).

Rank k of the axis holds stage k. With M microbatches and K stages the
schedule has M + K - 1 ticks: at tick t stage k runs microbatch t - k
(stage 0 takes it from the input, the others from what the previous
stage sent at tick t - 1), the mask goes with the schedule index, and
the last stage banks its output, which a sum over the axis then hands to
every rank (JAX's ``psum`` of the masked buffer). Activations move by
send/recv between neighbours (:func:`avsum_torch.parallel.comm.exchange`).

The backward is the schedule in reverse, written out so that every rank
sends and receives in one fixed order: stage k takes the cotangent of
its microbatch's output (the last stage from the replicated output's own
cotangent, the others from stage k + 1), backpropagates through its
stage, sums its parameters' gradients and sends the input's cotangent to
stage k - 1. Stage 0's input cotangents are summed over the axis, as the
input is replicated. With ``remat`` a stage keeps only its inputs and
runs again in the backward (``jax.checkpoint`` of the stage).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from avsum_torch.parallel.comm import all_reduce, exchange
from avsum_torch.parallel.mesh import AXIS_MODEL


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, stage, mesh, axis, n_micro, remat, grad,
                *params):
        n, k = mesh.size(axis), mesh.index(axis)
        ranks = mesh.ranks[axis]
        first, last = k == 0, k == n - 1
        b = x.shape[0]
        mb = b // n_micro
        xm = x.detach().reshape((n_micro, mb) + x.shape[1:])
        mm = None if mask is None else mask.reshape((n_micro, mb)
                                                    + mask.shape[1:])
        out = torch.zeros_like(xm)
        inputs, outputs = {}, {}
        recv = None
        for t in range(n_micro + n - 1):
            j = t - k
            y = None
            if 0 <= j < n_micro:
                cur = (xm[j] if first else recv).detach().requires_grad_(grad)
                with torch.set_grad_enabled(grad and not remat):
                    y = stage(cur, None if mm is None else mm[j])
                inputs[j], outputs[j] = cur, y
                if last:
                    out[j] = y.detach()
            # stage k - 1 ran microbatch t - k + 1 this tick
            gets = not first and 0 <= j + 1 < n_micro
            recv = exchange(None if y is None or last else y.detach(),
                            None if last else ranks[k + 1],
                            xm[0] if gets else None,
                            None if first else ranks[k - 1], mesh)
        ctx.stage, ctx.mesh, ctx.axis, ctx.remat = stage, mesh, axis, remat
        ctx.n_micro, ctx.masks = n_micro, mm
        ctx.inputs, ctx.outputs = inputs, outputs
        ctx.x_shape, ctx.x_needs = x.shape, x.requires_grad
        return all_reduce(out, mesh, axis).reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        mesh, axis, n_micro = ctx.mesh, ctx.axis, ctx.n_micro
        n, k = mesh.size(axis), mesh.index(axis)
        ranks = mesh.ranks[axis]
        first, last = k == 0, k == n - 1
        params = [p for p in ctx.stage.parameters()]
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        gm = dout.reshape((n_micro, -1) + dout.shape[1:])
        dx = torch.zeros_like(gm)
        recv = None
        for t in reversed(range(n_micro + n - 1)):
            j = t - k
            gx = None
            if 0 <= j < n_micro:
                cur = ctx.inputs.pop(j)
                y = ctx.outputs.pop(j)
                if ctx.remat:
                    with torch.enable_grad():
                        y = ctx.stage(cur, None if ctx.masks is None
                                      else ctx.masks[j])
                gy = gm[j] if last else recv
                gx, *gp = torch.autograd.grad(y, [cur, *params], gy,
                                              allow_unused=True)
                grads = [a if b is None else b if a is None else a + b
                         for a, b in zip(grads, gp)]
                if first:
                    dx[j] = gx
            # stage k + 1 ran microbatch t - k - 1 this tick
            gets = not last and 0 <= j - 1 < n_micro
            recv = exchange(None if gx is None or first else gx,
                            None if first else ranks[k - 1],
                            gm[0] if gets else None,
                            None if last else ranks[k + 1], mesh)
        dx = all_reduce(dx, mesh, axis).reshape(ctx.x_shape)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return (dx if ctx.x_needs else None, None, None, None, None, None,
                None, None, *grads)


def pipeline_apply(stage: Callable, x: torch.Tensor, mesh,
                   mask: Optional[torch.Tensor] = None, *, n_stages: int,
                   axis: str = AXIS_MODEL,
                   num_microbatches: Optional[int] = None,
                   remat: bool = False) -> torch.Tensor:
    """Run [B, S, F] ``x`` through the ``n_stages`` stages of the
    ``axis`` ranks, each rank calling ``stage(x_mb, mask_mb)`` (an
    ``nn.Module``: its parameters get their gradients) on its own stage.

    ``n_stages`` must equal the axis size (one stage per rank), and B must
    divide by ``num_microbatches`` (default: the number of stages).
    -> [B, S, F] on every rank: the stages applied in turn."""
    n = 1 if mesh is None else mesh.size(axis)
    if n_stages != n:
        raise ValueError(f"{n_stages} stages must equal the '{axis}' mesh "
                         f"axis size {n}")
    if n == 1:
        return stage(x, mask)
    n_micro = num_microbatches or n
    if x.shape[0] % n_micro != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_micro} "
                         "microbatches")
    # without autograd (eval) the stages keep no graph
    return _GPipe.apply(x, mask, stage, mesh, axis, n_micro, remat,
                        torch.is_grad_enabled(), *stage.parameters())
