"""Evaluation metrics in NumPy (``avsum_tpu/summary/metrics.py``, whose
versions are jnp): mean-threshold keyframe F1, Spearman rho on average
ranks, Kendall tau-b (the pairwise form up to ``TAU_PAIRWISE_MAX``
values, Knight's O(n log n) form above), the per-video bundle, and the
segment-overlap temporal F1. float32 like the JAX functions; Knight's
form and the segment metrics in float64 as there.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_EPS = 1e-8
TAU_PAIRWISE_MAX = 2048  # above this, Knight's algorithm (no [n, n] arrays)


def _masked_mean(x: np.ndarray, mask: Optional[np.ndarray]) -> np.float32:
    if mask is None:
        return np.mean(x, dtype=np.float32)
    m = mask.astype(np.float32)
    return np.float32(np.sum(x * m) / max(np.sum(m), np.float32(1.0)))


def keyframe_f1(pred, target, mask=None) -> float:
    """F1 of pred and target each binarized at its own (masked) mean."""
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    valid = None if mask is None else np.asarray(mask, np.float32)
    bp = (pred > _masked_mean(pred, valid)).astype(np.float32)
    bt = (target > _masked_mean(target, valid)).astype(np.float32)
    if valid is not None:
        bp, bt = bp * valid, bt * valid
    tp = np.float32(np.sum(bp * bt))
    precision = tp / max(np.float32(np.sum(bp)), np.float32(_EPS))
    recall = tp / max(np.float32(np.sum(bt)), np.float32(_EPS))
    return float(np.float32(2.0) * precision * recall
                 / (precision + recall + np.float32(_EPS)))


def rankdata(x) -> np.ndarray:
    """Average ranks, 1-based (scipy.stats.rankdata(method="average"))."""
    x = np.asarray(x, np.float32).reshape(-1)
    n = x.shape[0]
    order = np.argsort(x, kind="stable")
    xs = x[order]
    idx = np.arange(n, dtype=np.float32)
    new_group = np.concatenate([[True], xs[1:] != xs[:-1]])
    group_end = np.concatenate([xs[1:] != xs[:-1], [True]])
    start = np.maximum.accumulate(np.where(new_group, idx, -1.0))
    end = np.minimum.accumulate(np.where(group_end, idx, float(n))[::-1])[::-1]
    ranks = np.zeros(n, np.float32)
    ranks[order] = (start + end) / 2.0 + 1.0
    return ranks


def spearman_rho(pred, target) -> float:
    """Pearson correlation of average ranks (scipy.stats.spearmanr)."""
    rp = rankdata(pred)
    rt = rankdata(target)
    rp = rp - rp.mean(dtype=np.float32)
    rt = rt - rt.mean(dtype=np.float32)
    denom = np.sqrt(np.float32(np.sum(rp * rp)) * np.float32(np.sum(rt * rt)))
    return float(np.float32(np.sum(rp * rt)) / max(denom, np.float32(_EPS)))


def _kendall_tau_pairwise(pred, target) -> float:
    x = np.asarray(pred, np.float32).reshape(-1)
    y = np.asarray(target, np.float32).reshape(-1)
    n = x.shape[0]
    dx = np.sign(x[:, None] - x[None, :])
    dy = np.sign(y[:, None] - y[None, :])
    iu = np.triu(np.ones((n, n), bool), k=1)
    c_minus_d = np.float32(np.sum(dx * dy, where=iu, dtype=np.float32))
    n0 = n * (n - 1) / 2.0
    tx = np.float32(np.sum((dx == 0) & iu))
    ty = np.float32(np.sum((dy == 0) & iu))
    denom = np.sqrt(np.float32((n0 - tx) * (n0 - ty)))
    return float(c_minus_d / max(denom, np.float32(_EPS)))


def _count_inversions(a: np.ndarray) -> int:
    """Pairs i < j with a[i] > a[j], by merge sort with vectorized
    cross counting."""
    n = a.shape[0]
    if n <= 1:
        return 0
    mid = n // 2
    left, right = a[:mid], a[mid:]
    inv = _count_inversions(left) + _count_inversions(right)
    left_sorted = np.sort(left)
    inv += int((left_sorted.shape[0]
                - np.searchsorted(left_sorted, right, side="right")).sum())
    return inv


def _tie_pairs(sorted_x: np.ndarray) -> float:
    _, counts = np.unique(sorted_x, return_counts=True)
    c = counts.astype(np.float64)
    return float((c * (c - 1.0) / 2.0).sum())


def _kendall_tau_knight(pred, target) -> float:
    x = np.asarray(pred, np.float64).reshape(-1)
    y = np.asarray(target, np.float64).reshape(-1)
    n = x.shape[0]
    if n < 2:
        return 0.0
    order = np.lexsort((y, x))
    xs, ys = x[order], y[order]
    n0 = n * (n - 1) / 2.0
    tx = _tie_pairs(xs)
    ty = _tie_pairs(np.sort(y))
    both = xs + 1j * ys
    txy = _tie_pairs(both[np.argsort(both)])
    c_minus_d = n0 - tx - ty + txy - 2.0 * _count_inversions(ys)
    return float(c_minus_d / max(np.sqrt((n0 - tx) * (n0 - ty)), _EPS))


def kendall_tau(pred, target) -> float:
    """Kendall tau-b (scipy.stats.kendalltau)."""
    if np.asarray(pred).size > TAU_PAIRWISE_MAX:
        return _kendall_tau_knight(pred, target)
    return _kendall_tau_pairwise(pred, target)


def rank_correlations(pred, target) -> Dict[str, float]:
    return {"spearman": spearman_rho(pred, target),
            "kendall": kendall_tau(pred, target)}


def segment_overlap(pred_segments, gt_segments) -> float:
    """Total pairwise temporal overlap of two [K, 2] segment lists."""
    pred = np.asarray(pred_segments, np.float64).reshape(-1, 2)
    gt = np.asarray(gt_segments, np.float64).reshape(-1, 2)
    if pred.size == 0 or gt.size == 0:
        return 0.0
    lo = np.maximum(pred[:, None, 0], gt[None, :, 0])
    hi = np.minimum(pred[:, None, 1], gt[None, :, 1])
    return float(np.maximum(0.0, hi - lo).sum())


def segment_f1(pred_segments, gt_segments) -> float:
    """Temporal-overlap F1 of two segment lists (0 when either is empty)."""
    pred = np.asarray(pred_segments, np.float64).reshape(-1, 2)
    gt = np.asarray(gt_segments, np.float64).reshape(-1, 2)
    overlap = segment_overlap(pred, gt)
    pred_len = float((pred[:, 1] - pred[:, 0]).sum()) if pred.size else 0.0
    gt_len = float((gt[:, 1] - gt[:, 0]).sum()) if gt.size else 0.0
    if pred_len <= 0 or gt_len <= 0:
        return 0.0
    precision = overlap / pred_len
    recall = overlap / gt_len
    return 2.0 * precision * recall / (precision + recall + _EPS)


def evaluate_scores(pred, target, mask=None) -> Dict[str, float]:
    """Per-video bundle {f1, spearman, kendall} over the valid shots."""
    if mask is not None:
        m = np.asarray(mask, bool)
        pred = np.asarray(pred)[m]
        target = np.asarray(target)[m]
    return {"f1": keyframe_f1(pred, target),
            "spearman": spearman_rho(pred, target),
            "kendall": kendall_tau(pred, target)}
