"""The yardstick's arithmetic for the scorer whose temporal encoder is
Moonlight-16B-A3B's decoder: a train step's FLOPs, and the operations and
bytes of each attention the flash kernels run, at the attention's true
head widths.

A step's FLOPs are three parts, each counted once in float32 (``counts.py``):
the dense parts (every product but the MLA's attention core and the
routed experts: the modality Linears, MLA's projections, the dense and
shared SwiGLUs, the routers, the fusion attention and the head) by
``FlopCounterMode`` over the reference on the meta device; the MLA's
attention from its shapes, Q K^T at the q/k width and P V at the v
width, its backward twice its forward, as the materialized reference's
products count; and the routed experts from the token-expert pairs the
port computed (the counter ``moe.routed_held``): a SwiGLU's three
products over a pair's row, forward and both gradients.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, List, Optional, Tuple

import torch

from benchmark import counts

F32 = counts.F32


def mla_calls(model: dict, batch: int, shots: int
              ) -> List[Tuple[int, int, int, int, int]]:
    """[(B, S, H, Dqk, Dv)] of each self-attention of one forward pass
    that the flash kernels run, at its true widths: the decoder's MLA in
    every layer of both modalities, then the fusion attention, where S
    reaches ``counts.FLASH_MIN_SEQ`` and the configuration leaves the
    kernels on."""
    if shots < counts.FLASH_MIN_SEQ or model.get("use_pallas") is False:
        return []
    heads = model["num_heads"]
    dqk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    fusion = 2 * model["hidden_dim"] // heads
    return ([(batch, shots, heads, dqk, model["v_head_dim"])]
            * (2 * model["temporal_layers"])
            + [(batch, shots, heads, fusion, fusion)])


def attention_fwd_counts(b: int, s: int, h: int, dqk: int, dv: int
                         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention forward: Q K^T (2 S^2 Dqk a head)
    and P V (2 S^2 Dv); q, k, v and the mask read once, the output and
    the log-sum-exp written once."""
    flops = 2.0 * b * h * s * s * (dqk + dv)
    nbytes = F32 * (b * s * h * (2 * dqk + 2 * dv) + b * s + b * h * s)
    return flops, nbytes


def attention_bwd_counts(b: int, s: int, h: int, dqk: int, dv: int
                         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention backward as the fused kernel runs
    it: Q K^T again, dS^T Q and dS K at Dqk, dO V^T and P^T dO at Dv;
    q, k, v, dO, the mask, the log-sum-exp and delta read once, dq, dk,
    dv written once."""
    flops = 2.0 * b * h * s * s * (3 * dqk + 2 * dv)
    nbytes = F32 * (b * s * h * (4 * dqk + 3 * dv) + b * s + 2 * b * h * s)
    return flops, nbytes


def mla_step_flops(model: dict, batch: int, shots: int) -> float:
    """The MLA attention cores of one step: forward, and a backward of
    twice its products."""
    heads = model["num_heads"]
    dqk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    one = attention_fwd_counts(batch, shots, heads, dqk,
                               model["v_head_dim"])[0]
    return 3 * one * 2 * model["temporal_layers"]


def routed_flops(model: dict, pairs: int) -> float:
    """The routed experts' products of a step over ``pairs`` token-expert
    pairs: gate, up and down (2 H F each a row), forward and both
    gradients."""
    return 3 * 3 * 2.0 * pairs * model["hidden_dim"] * model[
        "moe_intermediate_size"]


def dense_step_flops(model: dict, batch: int, shots: int) -> float:
    """The dense parts of one step at [batch, shots] (``FlopCounterMode``
    on the meta device, the reference's ``dense_only`` forward)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import decoder

    leaves = {name: torch.zeros(shape, device="meta", requires_grad=True)
              for name, shape, _ in decoder.leaf_specs(model)}
    visual = torch.zeros((batch, shots, model["visual_dim"]), device="meta")
    audio = torch.zeros((batch, shots, model["audio_dim"]), device="meta")
    mask = torch.ones((batch, shots), device="meta")
    with FlopCounterMode(display=False) as counter:
        preds = decoder.forward(leaves, model, visual, audio, mask,
                                dense_only=True)
        loss = decoder.masked_mse(preds, torch.zeros_like(preds), mask)
        # the routed experts' leaves take no part
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(counter.get_total_flops())


def video_dense_flops(model: dict) -> Callable[[int], float]:
    """-> flops(n): :func:`dense_step_flops` of one video of ``n`` shots,
    a polynomial of degree two in n (the fusion attention grows with its
    square), fitted exactly through three counts."""
    xs = (16, 32, 48)
    ys = [Fraction(int(dense_step_flops(model, 1, x))) for x in xs]

    def flops(n: int) -> float:
        total = Fraction(0)
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            term = yi
            for j, xj in enumerate(xs):
                if j != i:
                    term *= Fraction(n - xj, xi - xj)
            total += term
        return float(total)

    return flops


def window_flops(model: dict, video_shots: List[int],
                 routed_pairs: int) -> float:
    """The model FLOPs of a window that stepped videos of
    ``video_shots`` real shots (one a step) and computed ``routed_pairs``
    token-expert pairs."""
    dense = video_dense_flops(model)
    return (sum(dense(n) + mla_step_flops(model, 1, n) for n in video_shots)
            + routed_flops(model, routed_pairs))


def flash_roofline_pct(run, kernel: str,
                       count: Callable[..., Tuple[float, float]]
                       ) -> Optional[float]:
    """Sum of the launches' bounds, at the attentions' true widths, over
    the sum of their device time, for the kernel whose name holds
    ``kernel``; each window step launches it once for each of
    :func:`mla_calls`. None where the trace holds other launches."""
    from benchmark.harness import log

    launches = run.trace.kernels(kernel) if run.trace is not None else []
    batches = run.cell.traffic.get("batches")
    if not launches or batches is None:
        return None
    calls = mla_calls(run.cell.config["program"]["model"], batches["videos"],
                      batches["bucket"])
    steps = run.window_result.counts["steps"]
    if len(launches) != len(calls) * steps:
        log(f"{kernel}: {len(launches)} launches, not {len(calls)} in each "
            f"of {steps} steps: no roofline")
        return None
    bound = steps * sum(counts.bound_s(*count(*c), counts.PEAKS["tf32_flops"])
                        for c in calls)
    busy = sum(op.end - op.start for op in launches) / 1e9
    return 100.0 * bound / busy
