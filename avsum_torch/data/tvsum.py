"""TVSum annotation parsing (ydata-tvsum50.mat, MATLAB v7.3 / HDF5).

Reimplements exactly the object-reference decoding of
reference/scripts/train_av_model.py:13-58: titles/videos/categories
are HDF5 object-ref arrays of uint16 char codes; ``user_anno`` is a
(50, 1) ref array whose entries dereference to (20, n_frames) matrices of
per-frame importance scores (1-5) from 20 annotators.

Output is a list of :class:`TVSumVideo` records rather than the
reference's 1000-row pandas DataFrame (one row per user) — same
information, O(1) per-video access, and the per-video mean over users
(dataset.py:41-62) is a method.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class TVSumVideo:
    video_id: str  # e.g. "AwmHb44_ouw"
    title: str
    category: str
    length: float  # seconds
    n_frames: int
    user_scores: np.ndarray  # [20, n_frames] float32

    def mean_scores(self) -> np.ndarray:
        """Average over the 20 annotators (train_av_model.py via
        dataset.py:56-60)."""
        return self.user_scores.mean(axis=0).astype(np.float32)


def _decode_str(h5file, ref) -> str:
    return "".join(chr(c) for c in np.asarray(h5file[ref]).flatten())


def load_tvsum(mat_path: str) -> List[TVSumVideo]:
    import h5py

    videos: List[TVSumVideo] = []
    with h5py.File(mat_path, "r") as f:
        titles_ref = f["tvsum50/title"][:]
        videos_ref = f["tvsum50/video"][:]
        categories_ref = f["tvsum50/category"][:]
        lengths = f["tvsum50/length"][:].flatten()
        nframes = f["tvsum50/nframes"][:].flatten()
        user_anno = f["tvsum50/user_anno"][:]

        n = len(titles_ref.squeeze())
        for i in range(n):
            title = _decode_str(f, titles_ref.squeeze()[i])
            video_id = _decode_str(f, videos_ref.squeeze()[i])
            category = _decode_str(f, categories_ref.squeeze()[i])
            scores = np.asarray(f[user_anno[i, 0]], np.float32)
            # stored as (n_frames, 20) or (20, n_frames) depending on writer;
            # annotators axis is the one of size 20
            if scores.shape[0] != 20 and scores.shape[-1] == 20:
                scores = scores.T
            videos.append(
                TVSumVideo(
                    video_id=video_id,
                    title=title,
                    category=category,
                    length=float(lengths[i]),
                    n_frames=int(nframes[i]),
                    user_scores=scores,
                )
            )
    return videos


def tvsum_index(videos: List[TVSumVideo]) -> Dict[str, TVSumVideo]:
    return {v.video_id: v for v in videos}
