"""Shot (scene-cut) detection: the port of ``avsum_tpu/temporal/shots.py``.

PySceneDetect's ContentDetector at its defaults (threshold 27, minimum
scene length 15): frame t scores the mean absolute difference between
frames t and t-1 in OpenCV's 8-bit HSV, averaged over H, S and V.

Two sources of those scores:

- the device detector (:func:`content_scores`, :func:`detect_shots`,
  :func:`detect_shots_streaming`): uint8 RGB chunks go to the device as
  they are and are converted there; chunks overlap by one frame. Plain
  PyTorch: the JAX version is XLA-fused code with no Pallas kernel;
- the native decoder's C++ scores (``reader.content_scores``,
  ``native/avsumio.cc``), refined by :func:`refined_content_scores`.

The thresholding walk runs on the host in both cases.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from avsum_torch.ops.color import rgb_to_hsv_channels

DEFAULT_THRESHOLD = 27.0
DEFAULT_MIN_SCENE_LEN = 15


@dataclasses.dataclass(frozen=True)
class ContentDetectorConfig:
    threshold: float = DEFAULT_THRESHOLD
    min_scene_len: int = DEFAULT_MIN_SCENE_LEN
    weight_hue: float = 1.0
    weight_sat: float = 1.0
    weight_lum: float = 1.0


def content_scores_weighted(frames: torch.Tensor,
                            config: ContentDetectorConfig) -> torch.Tensor:
    """[T, H, W, 3] RGB -> [T] float32 scores with the config's channel
    weights (score[0] = 0)."""
    h, s, v = rgb_to_hsv_channels(frames)
    weights = (config.weight_hue, config.weight_sat, config.weight_lum)
    score = sum(w * (c[1:] - c[:-1]).abs().mean(dim=(1, 2))
                for w, c in zip(weights, (h, s, v))) / sum(weights)
    return torch.cat([score.new_zeros(1), score])


def content_scores(frames: torch.Tensor) -> torch.Tensor:
    """[T, H, W, 3] RGB (uint8 or float, on any device) -> [T] float32
    content-change scores on that device, score[0] = 0: the weighted
    form at ContentDetector's equal weights."""
    return content_scores_weighted(frames, ContentDetectorConfig())


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


def detect_shots(
    frames: np.ndarray,
    config: ContentDetectorConfig = ContentDetectorConfig(),
    chunk_size: int = 512,
    device="cuda",
) -> np.ndarray:
    """[T, H, W, 3] uint8 RGB frames -> [S, 2] shot boundaries, scored on
    ``device`` in chunks of ``chunk_size`` frames that overlap by one
    (frame t needs frame t-1)."""
    t = frames.shape[0]
    if t == 0:
        return np.zeros((0, 2), np.int64)
    scores = np.zeros(t, np.float32)
    start = 0
    while start < t:
        end = min(start + chunk_size, t)
        lo = max(start - 1, 0)
        chunk = torch.from_numpy(np.ascontiguousarray(frames[lo:end]))
        scores[start:end] = content_scores(chunk.to(device)).cpu().numpy()[
            start - lo:]
        start = end
    cuts = cuts_from_scores(scores, config.threshold, config.min_scene_len)
    return boundaries_from_cuts(cuts, t)


def detect_shots_streaming(
    frame_chunks: Iterable[np.ndarray],
    config: ContentDetectorConfig = ContentDetectorConfig(),
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """Streaming :func:`detect_shots` over an iterator of [n, H, W, 3]
    uint8 chunks -> (boundaries, total frames). The last frame of each
    chunk stays on the device as the next chunk's context."""
    all_scores: List[np.ndarray] = []
    carry: Optional[torch.Tensor] = None
    total = 0
    for chunk in frame_chunks:
        if chunk.shape[0] == 0:
            continue
        block = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        if carry is not None:
            block = torch.cat([carry[None], block])
        s = content_scores(block).cpu().numpy()
        all_scores.append(s if carry is None else s[1:])
        carry = block[-1]
        total += chunk.shape[0]
    if total == 0:
        return np.zeros((0, 2), np.int64), 0
    scores = np.concatenate(all_scores)
    cuts = cuts_from_scores(scores, config.threshold, config.min_scene_len)
    return boundaries_from_cuts(cuts, total), total


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
