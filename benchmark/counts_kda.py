"""The yardstick's arithmetic for the scorer whose temporal encoder is
Kimi-Linear-48B-A3B's hybrid decoder: a train step's FLOPs, and the
operations and bytes of each launch of the KDA kernel's passes over
chunks (``csrc/kda.cu``), from the layer's shapes at a chunk of ``CHUNK``
shots fixed here, not read from the kernel's tiling.

A step's FLOPs, each counted once in float32 (``counts.py``): the dense
parts (every product but the KDA recurrence, latent attention's core
and the routed experts) by ``FlopCounterMode`` over the reference on the
meta device; KDA's chunked core from its shapes (:func:`kda_core_flops`,
its backward twice its forward); latent attention's core at q/k 192 and
v 128 as ``counts_decoder.py`` counts it, in the layers that are not
KDA; the routed experts over the token-expert pairs the port computed
(``moe.routed_held``).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, List, Optional, Tuple

import torch

from benchmark import counts, counts_decoder

F32 = counts.F32
CHUNK = 64  # the chunk the counts assume, whatever the kernel's


def kda_layers(model: dict) -> int:
    return sum(1 for i in range(model["temporal_layers"])
               if i + 1 in model["kda_layers"])


def kda_calls(model: dict, batch: int, shots: int
              ) -> List[Tuple[int, int, int, int, int]]:
    """[(B, S, H, K, V)] of each KDA layer of one forward pass, both
    modalities: each launches the forward pass over chunks once, and its
    backward the backward pass once."""
    h, d = model["kda_num_heads"], model["kda_head_dim"]
    return [(batch, shots, h, d, d)] * (2 * kda_layers(model))


def _chunks(b: int, s: int, h: int) -> int:
    """Chunks of every head: ceil(S / CHUNK) a head."""
    return b * h * -(-s // CHUNK)


def pass_fwd_counts(b: int, s: int, h: int, dk: int, dv: int
                    ) -> Tuple[float, float]:
    """(FLOPs, bytes) of the forward pass over chunks: a chunk's W S_c and
    K~^T U_c, 2 C K V each; W, K~ (C x K each), U' (C x V) and gamma (K)
    read once, the state entering it (K x V) and U_c (C x V) written
    once."""
    n = _chunks(b, s, h)
    flops = n * 4.0 * CHUNK * dk * dv
    nbytes = F32 * n * (2 * CHUNK * dk + CHUNK * dv + dk
                        + dk * dv + CHUNK * dv)
    return flops, nbytes


def pass_bwd_counts(b: int, s: int, h: int, dk: int, dv: int
                    ) -> Tuple[float, float]:
    """(FLOPs, bytes) of the backward pass over chunks: a chunk's K~ dS and
    W^T dU, 2 C K V each; K~, W, dU from the outputs, gamma and dS_c from
    the outputs read once, dS_{c+1} and the total dU_c written once."""
    n = _chunks(b, s, h)
    flops = n * 4.0 * CHUNK * dk * dv
    nbytes = F32 * n * (2 * CHUNK * dk + CHUNK * dv + dk + dk * dv
                        + dk * dv + CHUNK * dv)
    return flops, nbytes


def kda_core_flops(b: int, s: int, h: int, dk: int, dv: int) -> float:
    """The chunked core's products in one forward pass, a chunk of a head:
    A_qk and A_kk (C x C over K, 2 C^2 K each), the forward substitution
    over K + V columns (C^2 (K + V)), W S_c, K~^T U_c and Q S_c (2 C K V
    each) and A_qk U_c (2 C^2 V)."""
    c = CHUNK
    per = (4 * c * c * dk + c * c * (dk + dv) + 6 * c * dk * dv
           + 2 * c * c * dv)
    return float(_chunks(b, s, h) * per)


def mla_layers(model: dict) -> int:
    return model["temporal_layers"] - kda_layers(model)


def core_step_flops(model: dict, batch: int, shots: int) -> float:
    """KDA's chunked cores and latent attention's cores of one step, both
    modalities: forward, and a backward of twice its products."""
    h, d = model["kda_num_heads"], model["kda_head_dim"]
    kda = kda_core_flops(batch, shots, h, d, d) * 2 * kda_layers(model)
    dqk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    mla = counts_decoder.attention_fwd_counts(
        batch, shots, model["num_heads"], dqk, model["v_head_dim"])[0]
    return 3 * (kda + mla * 2 * mla_layers(model))


def dense_step_flops(model: dict, batch: int, shots: int) -> float:
    """The dense parts of one step at [batch, shots] (``FlopCounterMode``
    on the meta device, the reference's ``dense_only`` forward)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import kimi_linear

    leaves = {name: torch.zeros(shape, device="meta", requires_grad=True)
              for name, shape, _ in kimi_linear.leaf_specs(model)}
    visual = torch.zeros((batch, shots, model["visual_dim"]), device="meta")
    audio = torch.zeros((batch, shots, model["audio_dim"]), device="meta")
    mask = torch.ones((batch, shots), device="meta")
    with FlopCounterMode(display=False) as counter:
        preds = kimi_linear.forward(leaves, model, visual, audio, mask,
                                    dense_only=True)
        loss = kimi_linear.masked_mse(preds, torch.zeros_like(preds), mask)
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
    return (sum(dense(n) + core_step_flops(model, 1, n) for n in video_shots)
            + counts_decoder.routed_flops(model, routed_pairs))


def kda_roofline_pct(run, kernel: str,
                     count: Callable[..., Tuple[float, float]]
                     ) -> Optional[float]:
    """Sum of the launches' bounds (FLOPs counted once at the TF32 rate,
    or bytes at the HBM rate) over the sum of their device time, for the
    kernel whose name holds ``kernel``; each window step launches it once
    for each of :func:`kda_calls`. None where the trace holds none or
    other launches."""
    from benchmark.harness import log

    launches = run.trace.kernels(kernel) if run.trace is not None else []
    batches = run.cell.traffic.get("batches")
    if not launches or batches is None:
        return None
    calls = kda_calls(run.cell.config["program"]["model"], batches["videos"],
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
