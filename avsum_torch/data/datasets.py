"""Dataset assembly: feature cache + annotations -> VideoExamples
(``avsum_tpu/data/datasets.py``, which reaches jax through
``temporal/align.py``).

Each shot's target is the mean of the per-frame annotation (TVSum user
mean, SumMe gt_score) over its frame range, rescaled to [0, 1]. The
cache, the parsers and the batching are the JAX package's own modules,
which import no jax.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from avsum_torch.temporal.align import frame_scores_to_shot_scores
from avsum_tpu.data.batching import VideoExample
from avsum_tpu.data.cache import FeatureCache
from avsum_tpu.data.summe import load_summe_dir
from avsum_tpu.data.tvsum import load_tvsum, tvsum_index


def _attach_targets(example: VideoExample, frame_scores: np.ndarray,
                    normalize: bool = True) -> VideoExample:
    scores = np.asarray(frame_scores, np.float32)
    if normalize and scores.size:
        lo, hi = float(scores.min()), float(scores.max())
        scores = ((scores - lo) / (hi - lo) if hi > lo
                  else np.zeros_like(scores))
    example.targets = frame_scores_to_shot_scores(scores,
                                                  example.shot_boundaries)
    return example


def load_tvsum_examples(cache: FeatureCache, mat_path: str,
                        video_ids: Optional[Sequence[str]] = None
                        ) -> List[VideoExample]:
    index = tvsum_index(load_tvsum(mat_path))
    ids = video_ids if video_ids is not None else cache.video_ids()
    return [_attach_targets(cache.get(vid), index[vid].mean_scores())
            for vid in ids if vid in index and cache.has(vid)]


def load_summe_examples(cache: FeatureCache, gt_dir: str,
                        video_ids: Optional[Sequence[str]] = None
                        ) -> List[VideoExample]:
    index = {v.video_id: v for v in load_summe_dir(gt_dir)}
    ids = video_ids if video_ids is not None else cache.video_ids()
    return [_attach_targets(cache.get(vid), index[vid].gt_score)
            for vid in ids if vid in index and cache.has(vid)]


def load_cached_examples(cache: FeatureCache,
                         frame_scores: Optional[Dict[str, np.ndarray]] = None,
                         video_ids: Optional[Sequence[str]] = None
                         ) -> List[VideoExample]:
    """Generic loader: optional {video_id: frame_scores} target map."""
    ids = video_ids if video_ids is not None else cache.video_ids()
    out = []
    for vid in ids:
        if not cache.has(vid):
            continue
        ex = cache.get(vid)
        if frame_scores and vid in frame_scores:
            ex = _attach_targets(ex, frame_scores[vid])
        out.append(ex)
    return out
