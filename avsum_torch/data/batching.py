"""Padded-bucket batching with masks.

The reference trains one video per step (collate_fn drops the batch,
reference/scripts/train_av_model.py:64) and its legacy loader pads
with zeros and no mask (reference/scripts/train.py:20-29). Here
variable-shot videos are padded to a fixed bucket length with explicit
validity masks, so a whole batch is one static-shape jit invocation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VideoExample:
    """One video's shot-level features + training target."""

    video_id: str
    visual: np.ndarray  # [S, Dv]
    audio: np.ndarray  # [S, Da]
    targets: np.ndarray  # [S]
    shot_boundaries: Optional[np.ndarray] = None  # [S, 2] frames
    n_frames: int = 0
    fps: float = 30.0

    @property
    def n_shots(self) -> int:
        return int(self.visual.shape[0])


def pad_batch(
    examples: Sequence[VideoExample],
    max_shots: int,
    pad_to_batch: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Stack examples into {visual, audio, targets, mask} padded arrays.

    Videos longer than ``max_shots`` are truncated (with a warning left to
    the caller's discretion); shorter ones are zero-padded and masked out.
    ``pad_to_batch`` pads the batch axis with empty rows so every step has
    an identical shape (one XLA program, no recompiles).
    """
    b = len(examples)
    bb = pad_to_batch or b
    dv = examples[0].visual.shape[-1]
    da = examples[0].audio.shape[-1]
    visual = np.zeros((bb, max_shots, dv), np.float32)
    audio = np.zeros((bb, max_shots, da), np.float32)
    targets = np.zeros((bb, max_shots), np.float32)
    mask = np.zeros((bb, max_shots), np.float32)
    for i, ex in enumerate(examples):
        s = min(ex.n_shots, max_shots)
        visual[i, :s] = ex.visual[:s]
        audio[i, :s] = ex.audio[:s]
        targets[i, :s] = ex.targets[:s]
        mask[i, :s] = 1.0
    return {"visual": visual, "audio": audio, "targets": targets, "mask": mask}


def batch_iterator(
    examples: Sequence[VideoExample],
    batch_size: int,
    max_shots: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled padded batches, final partial batch padded to full size."""
    order = np.arange(len(examples))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        idx = order[i : i + batch_size]
        if len(idx) < batch_size and drop_remainder:
            return
        chunk = [examples[j] for j in idx]
        yield pad_batch(chunk, max_shots, pad_to_batch=batch_size)
