"""Knapsack summary selection: numpy copies of
``avsum_tpu/summary/knapsack.py:72-149`` (that module imports jax at its
top). Only the NumPy DP is ported; problems of 5e7 cells or more, where
the JAX package switches to its jitted DP, raise here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NEG_INF = -1e30
MAX_DP_CELLS = 50_000_000


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
) -> Tuple[np.ndarray, np.ndarray]:
    """Shot scores -> (selected [S] bool, segments [K, 2]) under a budget of
    ``budget_fraction`` of the video's frames; a shot's value is its score
    times its length in frames."""
    bounds = np.asarray(shot_boundaries, np.int64).reshape(-1, 2)
    lengths = np.maximum(bounds[:, 1] - bounds[:, 0], 0)
    scores = np.asarray(shot_scores, np.float32).reshape(-1)
    values = scores * lengths.astype(np.float32)
    capacity = int(budget_fraction * total_frames)
    if len(values) * (capacity + 1) >= MAX_DP_CELLS:
        raise NotImplementedError(
            f"knapsack of {len(values)} shots x {capacity + 1} capacities "
            f"reaches {MAX_DP_CELLS} cells: the device DP is not ported yet")
    selected = knapsack_select_np(values, lengths, capacity)
    return selected, bounds[selected]


def frame_summary_mask(segments: np.ndarray, total_frames: int) -> np.ndarray:
    """Binary per-frame membership vector for a list of segments."""
    out = np.zeros(total_frames, dtype=bool)
    for start, end in np.asarray(segments, np.int64).reshape(-1, 2):
        out[max(0, start):min(total_frames, end)] = True
    return out
