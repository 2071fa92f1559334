"""Shot <-> annotation alignment in NumPy (``avsum_tpu/temporal/align.py``,
which imports jax).

Interval annotations (one score per ``interval_seconds``) give a shot the
mean of the intervals it spans:

    start_idx = floor(start_frame / fps / interval)
    end_idx   = floor(end_frame / fps / interval) + 1

computed in float32 as the JAX version does, with segment means from a
cumulative sum; indices clamp into range and an empty segment clamps to
one element.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def shot_segment_means(annotations, start_idx, end_idx) -> np.ndarray:
    """Mean of ``annotations[start:end]`` per row, via cumsum gathers."""
    annotations = np.asarray(annotations, np.float32).reshape(-1)
    n = annotations.shape[0]
    cs = np.concatenate([np.zeros(1, np.float32),
                         np.cumsum(annotations, dtype=np.float32)])
    start = np.clip(np.asarray(start_idx, np.int64), 0, n - 1)
    end = np.clip(np.asarray(end_idx, np.int64), start + 1, n)
    return (cs[end] - cs[start]) / (end - start).astype(np.float32)


def align_shots_to_annotations(shot_boundaries, annotations, fps: float,
                               interval_seconds: float = 2.0,
                               mask: Optional[np.ndarray] = None) -> np.ndarray:
    """[S] float32 per-shot targets from interval-level annotations;
    padded shots (``mask`` 0) score 0."""
    bounds = np.asarray(shot_boundaries, np.float32).reshape(-1, 2)
    fps32, interval32 = np.float32(fps), np.float32(interval_seconds)
    start_idx = np.floor(bounds[:, 0] / fps32 / interval32).astype(np.int64)
    end_idx = np.floor(bounds[:, 1] / fps32 / interval32).astype(np.int64) + 1
    scores = shot_segment_means(annotations, start_idx, end_idx)
    if mask is not None:
        scores = scores * np.asarray(mask, np.float32)
    return scores


def frame_scores_to_shot_scores(frame_scores, shot_boundaries) -> np.ndarray:
    """Mean frame-level score per shot (per-frame annotations)."""
    frame_scores = np.asarray(frame_scores, np.float32).reshape(-1)
    n = len(frame_scores)
    bounds = np.asarray(shot_boundaries, np.int64).reshape(-1, 2)
    cs = np.concatenate([[0.0], np.cumsum(frame_scores)])
    start = np.clip(bounds[:, 0], 0, n - 1)
    end = np.clip(bounds[:, 1], start + 1, n)
    return ((cs[end] - cs[start]) / (end - start)).astype(np.float32)


def expand_shot_scores_to_frames(shot_scores, shot_boundaries,
                                 total_frames: int) -> np.ndarray:
    """Per-shot scores broadcast back to a [total_frames] float32 vector."""
    out = np.zeros(total_frames, np.float32)
    bounds = np.asarray(shot_boundaries, np.int64).reshape(-1, 2)
    for score, (start, end) in zip(np.asarray(shot_scores).reshape(-1), bounds):
        out[max(0, start):min(total_frames, end)] = score
    return out
