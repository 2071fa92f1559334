"""Knapsack summary selection, the evaluation metrics and the canonical
per-annotator protocol (numpy); the names ``avsum_tpu.summary`` exports.
``knapsack_select`` is the NumPy DP (the JAX package's is jitted)."""

from avsum_torch.summary.knapsack import knapsack_select_np as knapsack_select
from avsum_torch.summary.knapsack import select_summary
from avsum_torch.summary.metrics import (
    evaluate_scores,
    kendall_tau,
    keyframe_f1,
    rank_correlations,
    segment_f1,
    segment_overlap,
    spearman_rho,
)

__all__ = [
    "keyframe_f1",
    "spearman_rho",
    "kendall_tau",
    "rank_correlations",
    "segment_f1",
    "segment_overlap",
    "evaluate_scores",
    "knapsack_select",
    "select_summary",
]
