"""Feature cache: the content store between preprocessing and training.

Layout (one directory per video under ``cache_dir``), extending the
reference's ``visual.npy``/``audio.npy`` convention
(reference/scripts/preprocess.py:74-81) with the two artifacts the
reference threw away and then had to fake at train time (SURVEY.md §8.4:
placeholder boundaries ``[(0, num_shots)]``, hardcoded fps):

    <video_id>/visual.npy      [S, 4096] float32
    <video_id>/audio.npy       [S, 296]  float32
    <video_id>/boundaries.npy  [S, 2]    int64 (start_frame, end_frame)
    <video_id>/meta.json       {fps, n_frames, ...}

Skip-if-cached and delete-on-failure semantics are preserved
(preprocess.py:47-54, 83-85).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from avsum_torch.data.batching import VideoExample

_FILES = ("visual.npy", "audio.npy", "boundaries.npy", "meta.json")


class FeatureCache:
    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _vdir(self, video_id: str) -> str:
        return os.path.join(self.cache_dir, video_id)

    def has(self, video_id: str) -> bool:
        vdir = self._vdir(video_id)
        return all(os.path.exists(os.path.join(vdir, f)) for f in _FILES)

    def put(
        self,
        video_id: str,
        visual: np.ndarray,
        audio: np.ndarray,
        boundaries: np.ndarray,
        fps: float,
        n_frames: int,
        extra_meta: Optional[Dict] = None,
        fingerprint: Optional[str] = None,
    ) -> None:
        visual = np.asarray(visual, np.float32)
        audio = np.asarray(audio, np.float32)
        boundaries = np.asarray(boundaries, np.int64).reshape(-1, 2)
        if not (len(visual) == len(audio) == len(boundaries)):
            raise ValueError(
                f"{video_id}: inconsistent shot counts "
                f"v={len(visual)} a={len(audio)} b={len(boundaries)}"
            )
        vdir = self._vdir(video_id)
        os.makedirs(vdir, exist_ok=True)
        try:
            np.save(os.path.join(vdir, "visual.npy"), visual)
            np.save(os.path.join(vdir, "audio.npy"), audio)
            np.save(os.path.join(vdir, "boundaries.npy"), boundaries)
            meta = {"fps": float(fps), "n_frames": int(n_frames)}
            if fingerprint:
                meta["fingerprint"] = fingerprint
            meta.update(extra_meta or {})
            with open(os.path.join(vdir, "meta.json"), "w") as fh:
                json.dump(meta, fh)
        except Exception:
            shutil.rmtree(vdir, ignore_errors=True)  # preprocess.py:83-85
            raise

    def get(self, video_id: str, targets: Optional[np.ndarray] = None) -> VideoExample:
        vdir = self._vdir(video_id)
        visual = np.load(os.path.join(vdir, "visual.npy"))
        audio = np.load(os.path.join(vdir, "audio.npy"))
        boundaries = np.load(os.path.join(vdir, "boundaries.npy"))
        with open(os.path.join(vdir, "meta.json")) as fh:
            meta = json.load(fh)
        if targets is None:
            targets = np.zeros(len(visual), np.float32)
        return VideoExample(
            video_id=video_id,
            visual=visual,
            audio=audio,
            targets=np.asarray(targets, np.float32),
            shot_boundaries=boundaries,
            n_frames=int(meta["n_frames"]),
            fps=float(meta["fps"]),
        )

    def meta(self, video_id: str) -> Dict:
        with open(os.path.join(self._vdir(video_id), "meta.json")) as fh:
            return json.load(fh)

    def video_ids(self) -> List[str]:
        return sorted(
            d
            for d in os.listdir(self.cache_dir)
            if os.path.isdir(self._vdir(d)) and self.has(d)
        )

    def drop(self, video_id: str) -> None:
        shutil.rmtree(self._vdir(video_id), ignore_errors=True)

    def matches(self, video_id: str, fingerprint: Optional[str]) -> bool:
        """True when the cached entry was produced under ``fingerprint``
        (feature-config hash) — guards against serving stale features after
        a feature-extraction config change. Entries without a recorded
        fingerprint are accepted (backward compatibility)."""
        if fingerprint is None or not self.has(video_id):
            return self.has(video_id)
        recorded = self.meta(video_id).get("fingerprint")
        return recorded is None or recorded == fingerprint


def config_fingerprint(*cfgs) -> str:
    """Stable short hash of feature-affecting config dataclasses."""
    import dataclasses
    import hashlib

    blob = json.dumps(
        [dataclasses.asdict(c) for c in cfgs], sort_keys=True, default=str
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
