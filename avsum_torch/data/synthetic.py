"""Synthetic dataset generator — learnable toy videos for tests/benchmarks
(the port's copy of ``avsum_tpu/data/synthetic.py``, the same draws).

Targets are a fixed smooth function of the features (a random linear probe
through a sigmoid, temporally smoothed), so a correct model/optimizer must
drive the MSE well below the constant-prediction floor. This is the
media-free end-to-end slice (SURVEY.md §7 order-of-construction step 3 /
BASELINE config 1).
"""

from __future__ import annotations

from typing import List

import numpy as np

from avsum_torch.data.batching import VideoExample


def make_synthetic_videos(
    n_videos: int = 16,
    min_shots: int = 8,
    max_shots: int = 40,
    visual_dim: int = 4096,
    audio_dim: int = 296,
    seed: int = 0,
    fps: float = 30.0,
) -> List[VideoExample]:
    rng = np.random.default_rng(seed)
    # one global probe so the mapping is dataset-wide learnable
    wv = rng.normal(0, 1.0 / np.sqrt(visual_dim), visual_dim).astype(np.float32)
    wa = rng.normal(0, 1.0 / np.sqrt(audio_dim), audio_dim).astype(np.float32)

    examples = []
    for i in range(n_videos):
        s = int(rng.integers(min_shots, max_shots + 1))
        visual = rng.normal(0, 1, (s, visual_dim)).astype(np.float32)
        audio = rng.normal(0, 1, (s, audio_dim)).astype(np.float32)
        logits = visual @ wv + audio @ wa
        # temporal smoothing: moving average over 3 shots
        kernel = np.array([0.25, 0.5, 0.25], np.float32)
        smoothed = np.convolve(logits, kernel, mode="same")
        targets = 1.0 / (1.0 + np.exp(-2.0 * smoothed))
        # plausible shot boundaries
        lengths = rng.integers(30, 300, s)
        ends = np.cumsum(lengths)
        starts = np.concatenate([[0], ends[:-1]])
        examples.append(
            VideoExample(
                video_id=f"synth_{i:03d}",
                visual=visual,
                audio=audio,
                targets=targets.astype(np.float32),
                shot_boundaries=np.stack([starts, ends], 1),
                n_frames=int(ends[-1]),
                fps=fps,
            )
        )
    return examples
