"""Host-side shot-boundary helpers: numpy copies of
``avsum_tpu/temporal/shots.py:33-199``, which cannot be imported here
because that module imports jax at its top.

Content scores come from the native decoder (``reader.content_scores``,
C++ in ``native/avsumio.cc``); the device detector of the JAX package
(``content_scores``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

DEFAULT_THRESHOLD = 27.0
DEFAULT_MIN_SCENE_LEN = 15


@dataclasses.dataclass(frozen=True)
class ContentDetectorConfig:
    threshold: float = DEFAULT_THRESHOLD
    min_scene_len: int = DEFAULT_MIN_SCENE_LEN
    weight_hue: float = 1.0
    weight_sat: float = 1.0
    weight_lum: float = 1.0


def cuts_from_scores(
    scores: np.ndarray,
    threshold: float = DEFAULT_THRESHOLD,
    min_scene_len: int = DEFAULT_MIN_SCENE_LEN,
) -> List[int]:
    """A cut fires at frame t when score[t] >= threshold and
    t - last_cut >= min_scene_len (ContentDetector's walk)."""
    cuts = []
    last_cut = 0
    for t in range(1, len(scores)):
        if scores[t] >= threshold and (t - last_cut) >= min_scene_len:
            cuts.append(t)
            last_cut = t
    return cuts


def boundaries_from_cuts(cuts: List[int], total_frames: int) -> np.ndarray:
    """Cut positions -> [(start, end), ...] covering [0, total_frames)."""
    edges = [0] + list(cuts) + [total_frames]
    return np.array(
        [(edges[i], edges[i + 1]) for i in range(len(edges) - 1)], np.int64
    )


def refined_content_scores(
    reader,
    fine_scale: int,
    threshold: float = DEFAULT_THRESHOLD,
    coarse_mult: int = 9,
    margin: float = 8.0,
) -> np.ndarray:
    """Two-pass content scoring over a native reader: score the whole video
    at ``fine_scale * coarse_mult``, then re-score at ``fine_scale`` only the
    frames whose coarse score lands within ``margin`` of the threshold or
    above it. The cut decisions equal a full fine pass (the JAX package
    pins this in tests/test_fast_paths.py::test_refined_scores_cut_exact)."""
    width = getattr(reader, "width", 0)
    if width:
        while coarse_mult > 3 and width // (fine_scale * coarse_mult) < 24:
            coarse_mult -= 3
    coarse = np.asarray(
        reader.content_scores(scale=fine_scale * coarse_mult), np.float32
    ).copy()
    if len(coarse) == 0:
        return coarse
    cand = np.nonzero(coarse >= threshold - margin)[0]
    cand = cand[cand > 0]
    if len(cand) == 0:
        return coarse
    splits = np.nonzero(np.diff(cand) > 1)[0] + 1
    for run in np.split(cand, splits):
        a, b = int(run[0]), int(run[-1])
        w = np.asarray(
            reader.content_scores(start=a - 1, stop=b + 1, scale=fine_scale)
        )
        coarse[a : b + 1] = w[1:]
    return coarse
