"""Knapsack summary selection (``avsum_tpu/summary/knapsack.py``).

Two exact 0/1 DPs over capacities, as in the JAX package: the NumPy one
(float64 values) for problems below ``MAX_DP_CELLS`` cells, and at or
above it :func:`knapsack_select`, the counterpart of the jitted
``lax.scan`` DP: a loop over shots on a torch device with a float32
``[C + 1]`` value carry, a bool keep table ``[S, C + 1]`` on that device
and the reverse backtrack. The JAX scan had no Pallas kernel, so this is
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
MAX_DP_CELLS = 50_000_000


def knapsack_select(
    values,
    weights,
    capacity: int,
    mask=None,
    device="cuda",
) -> np.ndarray:
    """Exact 0/1 knapsack on ``device`` -> the boolean selection over
    items. Values are float32 in the DP, as the jitted JAX version keeps
    them; ``mask`` marks the valid items (padded shot sequences)."""
    dev = torch.device(device)
    values = np.asarray(values, np.float32).reshape(-1)
    weights = np.asarray(weights, np.int64).reshape(-1)
    valid = (np.ones(len(values), bool) if mask is None
             else np.asarray(mask, bool).reshape(-1))
    dp = torch.zeros(capacity + 1, dtype=torch.float32, device=dev)
    keep = torch.zeros(len(values), capacity + 1, dtype=torch.bool,
                       device=dev)
    for i, (v, w, ok) in enumerate(zip(values, weights, valid)):
        if not ok or w <= 0 or w > capacity:
            continue  # a row of False: never taken
        # capacities below w cannot take the item (JAX's -inf candidate)
        cand = dp[:-w] + float(v)
        take = cand > dp[w:]
        keep[i, w:] = take
        dp[w:] = torch.where(take, cand, dp[w:])
    # the reverse scan walks one capacity per item: on the host
    keep = keep.cpu().numpy()
    selected = np.zeros(len(values), bool)
    c = capacity
    for i in range(len(values) - 1, -1, -1):
        if keep[i, c]:
            selected[i] = True
            c -= int(weights[i])
    return selected


def knapsack_select_np(
    values: np.ndarray,
    weights: np.ndarray,
    capacity: int,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Exact 0/1 knapsack by a vectorized DP over capacities; returns the
    boolean selection over items."""
    values = np.asarray(values, np.float64).reshape(-1)
    weights = np.asarray(weights, np.int64).reshape(-1)
    valid = np.ones(len(values), bool) if mask is None else np.asarray(mask, bool)
    dp = np.zeros(capacity + 1)
    keep = np.zeros((len(values), capacity + 1), bool)
    for i, (v, w, ok) in enumerate(zip(values, weights, valid)):
        if not ok or w <= 0 or w > capacity:
            continue
        cand = np.full(capacity + 1, NEG_INF)
        cand[w:] = dp[:-w] + v
        take = cand > dp
        dp = np.where(take, cand, dp)
        keep[i] = take
    selected = np.zeros(len(values), bool)
    c = capacity
    for i in range(len(values) - 1, -1, -1):
        if keep[i, c]:
            selected[i] = True
            c -= int(weights[i])
    return selected


def select_summary(
    shot_scores: np.ndarray,
    shot_boundaries: np.ndarray,
    total_frames: int,
    budget_fraction: float = 0.15,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Shot scores -> (selected [S] bool, segments [K, 2]) under a budget of
    ``budget_fraction`` of the video's frames; a shot's value is its score
    times its length in frames. At ``MAX_DP_CELLS`` cells or more the DP
    runs on ``device``."""
    bounds = np.asarray(shot_boundaries, np.int64).reshape(-1, 2)
    lengths = np.maximum(bounds[:, 1] - bounds[:, 0], 0)
    scores = np.asarray(shot_scores, np.float32).reshape(-1)
    values = scores * lengths.astype(np.float32)
    capacity = int(budget_fraction * total_frames)
    if len(values) * (capacity + 1) < MAX_DP_CELLS:
        selected = knapsack_select_np(values, lengths, capacity)
    else:
        selected = knapsack_select(values, lengths, capacity, device=device)
    return selected, bounds[selected]


def frame_summary_mask(segments: np.ndarray, total_frames: int) -> np.ndarray:
    """Binary per-frame membership vector for a list of segments."""
    out = np.zeros(total_frames, dtype=bool)
    for start, end in np.asarray(segments, np.int64).reshape(-1, 2):
        out[max(0, start):min(total_frames, end)] = True
    return out
