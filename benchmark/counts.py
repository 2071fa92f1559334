"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes the measured work needs, counted from its shapes.

Operations are counted once each, in the precision the configuration
states, whatever passes a kernel makes to compute them: a float32
product that a kernel computes in three TF32 passes counts once, against
the TF32 rate.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS: Dict[str, float] = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
F32 = 4
FLASH_MIN_SEQ = 512  # the self-attentions at this many shots or more take the kernels


def attention_calls(model: dict, batch: int, shots: int
                    ) -> List[Tuple[int, int, int, int]]:
    """[(B, S, H, D)] of each self-attention of one forward pass that the
    flash kernels run: the attention encoder's blocks of both modalities
    and the fusion attention, where S reaches ``FLASH_MIN_SEQ`` and the
    configuration leaves the kernels on."""
    if shots < FLASH_MIN_SEQ or model.get("use_pallas") is False:
        return []
    hid, heads = model["hidden_dim"], model["num_heads"]
    calls = []
    if model["temporal_encoder"] == "attention":
        calls += [(batch, shots, heads, hid // heads)] * (
            2 * model["temporal_layers"])
    calls.append((batch, shots, heads, 2 * hid // heads))
    return calls


def flash_fwd_counts(b: int, s: int, h: int, d: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention forward: Q K^T and P V, 2 S^2 D
    each a head; q, k, v and the mask read once, the output and the
    log-sum-exp written once."""
    flops = 2 * 2.0 * b * h * s * s * d
    nbytes = F32 * (4 * b * s * h * d + b * s + b * h * s)
    return flops, nbytes


def flash_bwd_counts(b: int, s: int, h: int, d: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention backward: five S x S x D products
    a head (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K); q, k, v, dO, the
    mask, the log-sum-exp and delta read once, dq, dk, dv written once."""
    flops = 5 * 2.0 * b * h * s * s * d
    nbytes = F32 * (7 * b * s * h * d + b * s + 2 * b * h * s)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over ``peak_flops`` and the bytes over the HBM rate."""
    return max(flops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"])


def step_flops(model: dict, batch: int, shots: int) -> float:
    """FLOPs of one training step of the reference scorer (forward, loss
    and backward) at [batch, shots], counted by ``FlopCounterMode`` on the
    meta device: nothing runs, nothing is recomputed, attention is
    materialized and the LSTM is an explicit loop of products."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import scorer

    leaves = {name: torch.zeros(shape, device="meta", requires_grad=True)
              for name, shape, _ in scorer.leaf_specs(model)}
    visual = torch.zeros((batch, shots, model["visual_dim"]), device="meta")
    audio = torch.zeros((batch, shots, model["audio_dim"]), device="meta")
    mask = torch.ones((batch, shots), device="meta")
    with FlopCounterMode(display=False) as counter:
        preds = scorer.forward(leaves, model, visual, audio, mask)
        loss = scorer.masked_mse(preds, torch.zeros_like(preds), mask)
        torch.autograd.grad(loss, list(leaves.values()))
    return float(counter.get_total_flops())


def video_flops(model: dict):
    """-> flops(n): :func:`step_flops` of one video of ``n`` shots. A
    step's count is a polynomial of degree two in the shots (linear
    layers and the LSTM's loop grow with them, attention with their
    square), so three counts on the meta device give it exactly (at a
    single shot some products degenerate to sums and count nothing)."""
    from fractions import Fraction

    xs = (16, 32, 48)
    ys = [Fraction(int(step_flops(model, 1, x))) for x in xs]

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


def backbone_flops(ship: int) -> float:
    """FLOPs of one ``ship`` x ``ship`` frame through the reference dual
    backbone: both resizes and both networks (``FlopCounterMode`` on the
    meta device)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import vision

    model = vision.DualBackbone().to("meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        vision.embed(model, torch.zeros((1, ship, ship, 3), device="meta"))
    return float(counter.get_total_flops())
