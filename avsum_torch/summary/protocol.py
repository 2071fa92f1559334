"""The canonical TVSum / SumMe summary protocol: a NumPy copy of
``avsum_tpu/summary/protocol.py``, which reaches jax through its knapsack
import.

1. the model's shot scores -> a knapsack summary under the budget (15% of
   the frames) -> a frame mask;
2. each annotator's summary: for TVSum the knapsack over the user's
   frame scores on the same shots, for SumMe the user's recorded
   selection;
3. the F1 of the model's mask against each user's, aggregated per video
   by the mean (TVSum) or the max (SumMe), then averaged over videos.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from avsum_torch.summary.knapsack import frame_summary_mask, select_summary
from avsum_torch.temporal.align import frame_scores_to_shot_scores

_EPS = 1e-8


def binary_f1(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    """F1 between binary frame-membership vectors."""
    pred = np.asarray(pred_mask, bool)
    gt = np.asarray(gt_mask, bool)
    tp = float(np.logical_and(pred, gt).sum())
    precision = tp / (pred.sum() + _EPS)
    recall = tp / (gt.sum() + _EPS)
    return 2.0 * precision * recall / (precision + recall + _EPS)


def summary_mask_from_shot_scores(shot_scores: np.ndarray,
                                  boundaries: np.ndarray, n_frames: int,
                                  budget_fraction: float = 0.15,
                                  device="cuda") -> np.ndarray:
    """``device`` runs the knapsack DP of a problem of ``MAX_DP_CELLS``
    cells or more (:func:`select_summary`)."""
    _, segments = select_summary(shot_scores, boundaries, n_frames,
                                 budget_fraction, device)
    return frame_summary_mask(segments, n_frames)


def canonical_f1_tvsum(pred_shot_scores: np.ndarray, boundaries: np.ndarray,
                       n_frames: int, user_frame_scores: np.ndarray,
                       budget_fraction: float = 0.15,
                       aggregate: str = "mean", device="cuda") -> float:
    """One video's F1 against TVSum's annotators; ``user_frame_scores``
    is [n_users, n_frames] (``TVSumVideo.user_scores``)."""
    pred_mask = summary_mask_from_shot_scores(pred_shot_scores, boundaries,
                                              n_frames, budget_fraction,
                                              device)
    f1s = []
    for row in np.asarray(user_frame_scores, np.float32):
        user_shot = frame_scores_to_shot_scores(row[:n_frames], boundaries)
        user_mask = summary_mask_from_shot_scores(user_shot, boundaries,
                                                  n_frames, budget_fraction,
                                                  device)
        f1s.append(binary_f1(pred_mask, user_mask))
    if not f1s:
        return 0.0
    return float(np.mean(f1s) if aggregate == "mean" else np.max(f1s))


def canonical_f1_summe(pred_shot_scores: np.ndarray, boundaries: np.ndarray,
                       n_frames: int, user_masks: np.ndarray,
                       budget_fraction: float = 0.15,
                       aggregate: str = "max", device="cuda") -> float:
    """One video's F1 against SumMe's recorded selections; ``user_masks``
    is [n_frames, n_users] binary (``SumMeVideo.user_score``)."""
    pred_mask = summary_mask_from_shot_scores(pred_shot_scores, boundaries,
                                              n_frames, budget_fraction,
                                              device)
    users = np.asarray(user_masks)
    f1s = [binary_f1(pred_mask, users[:n_frames, u] > 0)
           for u in range(users.shape[1])]
    if not f1s:
        return 0.0
    return float(np.max(f1s) if aggregate == "max" else np.mean(f1s))


def evaluate_canonical(videos: Sequence[Dict], dataset: str = "tvsum",
                       budget_fraction: float = 0.15,
                       device="cuda") -> Dict[str, float]:
    """Dataset-level canonical F1 -> {canonical_f1, n_videos}. Each entry
    holds pred_shot_scores, boundaries, n_frames and user_frame_scores
    (tvsum) or user_masks (summe); ``device`` runs the large knapsacks."""
    per_video = []
    for v in videos:
        if dataset == "tvsum":
            per_video.append(canonical_f1_tvsum(
                v["pred_shot_scores"], v["boundaries"], v["n_frames"],
                v["user_frame_scores"], budget_fraction, device=device))
        elif dataset == "summe":
            per_video.append(canonical_f1_summe(
                v["pred_shot_scores"], v["boundaries"], v["n_frames"],
                v["user_masks"], budget_fraction, device=device))
        else:
            raise ValueError(f"unknown dataset {dataset!r}")
    return {"canonical_f1": float(np.mean(per_video)) if per_video else 0.0,
            "n_videos": len(per_video)}
