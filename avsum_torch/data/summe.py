"""SumMe ground-truth parsing (per-video MATLAB files).

Reference behavior: ``loadmat(path)["gt_score"].squeeze()``
(reference/data/dataset.py:66-68). SumMe .mat files additionally
carry ``user_score`` [n_frames, n_users], ``nFrames``, ``FPS`` — exposed
here because the canonical SumMe evaluation compares against per-user
summaries, not just the mean gt_score.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SumMeVideo:
    video_id: str
    gt_score: np.ndarray  # [n_frames] mean importance
    user_score: Optional[np.ndarray]  # [n_frames, n_users] binary selections
    n_frames: int
    fps: float


def load_summe_mat(mat_path: str) -> SumMeVideo:
    from scipy.io import loadmat

    data = loadmat(mat_path)
    gt = np.asarray(data["gt_score"]).squeeze().astype(np.float32)
    user = data.get("user_score")
    if user is not None:
        user = np.asarray(user, np.float32)
    n_frames = int(np.asarray(data.get("nFrames", len(gt))).squeeze())
    fps = float(np.asarray(data.get("FPS", 30.0)).squeeze())
    return SumMeVideo(
        video_id=os.path.splitext(os.path.basename(mat_path))[0],
        gt_score=gt,
        user_score=user,
        n_frames=n_frames,
        fps=fps,
    )


def load_summe_dir(gt_dir: str) -> List[SumMeVideo]:
    out = []
    for name in sorted(os.listdir(gt_dir)):
        if name.endswith(".mat"):
            out.append(load_summe_mat(os.path.join(gt_dir, name)))
    return out
