"""Synthetic media generation — the ffmpeg-colorbars-and-tone substitute
for pipeline integration tests and benchmarks (SURVEY.md §4 item 4).

Videos are sequences of distinctly-colored "scenes" (with per-frame noise
and drift so content is non-degenerate) plus matching multi-tone audio
whose tone changes at every scene cut — so shot detection, audio features
and alignment all have real structure to find.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from avsum_torch.io.wav import write_wav
from avsum_torch.io.y4m import write_y4m


def make_scene_video(
    n_scenes: int = 6,
    scene_len_frames: Tuple[int, int] = (24, 90),
    height: int = 144,
    width: int = 192,
    fps: float = 30.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """-> (frames [T,H,W,3] uint8, audio [T_samples] float32 @16k, scenes)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(scene_len_frames[0], scene_len_frames[1] + 1, n_scenes)
    frames = []
    scene_bounds = []
    t0 = 0
    base_colors = rng.integers(0, 256, (n_scenes, 3))
    # ensure consecutive scenes differ strongly (drives the content detector)
    for i in range(1, n_scenes):
        while np.abs(base_colors[i] - base_colors[i - 1]).mean() < 80:
            base_colors[i] = rng.integers(0, 256, 3)

    yy, xx = np.mgrid[0:height, 0:width]
    gradient = ((yy / height + xx / width) / 2.0)[..., None]

    for i, length in enumerate(lengths):
        color = base_colors[i][None, None, :]
        for f in range(length):
            drift = 10.0 * np.sin(2 * np.pi * f / max(length, 1))
            img = color * (0.6 + 0.4 * gradient) + drift
            img = img + rng.normal(0, 4.0, (height, width, 3))
            frames.append(np.clip(img, 0, 255).astype(np.uint8))
        scene_bounds.append((t0, t0 + int(length)))
        t0 += int(length)

    video = np.stack(frames)
    total_frames = video.shape[0]

    sr = 16000
    n_samples = int(total_frames / fps * sr)
    audio = np.zeros(n_samples, np.float32)
    tones = 220.0 * (2.0 ** rng.integers(0, 12, n_scenes).astype(np.float64) ** 0.5)
    for i, (start_f, end_f) in enumerate(scene_bounds):
        s0 = int(start_f / fps * sr)
        s1 = min(int(end_f / fps * sr), n_samples)
        t = np.arange(s1 - s0) / sr
        audio[s0:s1] = 0.4 * np.sin(2 * np.pi * tones[i] * t) + 0.05 * rng.standard_normal(s1 - s0)
    return video, audio.astype(np.float32), scene_bounds


def write_scene_video(
    stem: str,
    n_scenes: int = 6,
    seed: int = 0,
    fps: float = 30.0,
    height: int = 144,
    width: int = 192,
    scene_len_frames: Tuple[int, int] = (24, 90),
) -> List[Tuple[int, int]]:
    """Write <stem>.y4m + <stem>.wav; returns ground-truth scene bounds."""
    video, audio, scenes = make_scene_video(
        n_scenes=n_scenes,
        seed=seed,
        fps=fps,
        height=height,
        width=width,
        scene_len_frames=scene_len_frames,
    )
    write_y4m(stem + ".y4m", video, fps=fps)
    write_wav(stem + ".wav", audio, 16000)
    return scenes


def write_pcm_mp4(
    path: str,
    samples: np.ndarray,
    rate: int = 16000,
    chunk_frames: int = 4096,
    codec: str = "sowt",
) -> None:
    """Audio-only PCM ISO-BMFF writer — delegates to the shared muxer
    (:func:`avsum_torch.io.mp4_mux.write_pcm_mp4`); kept here as the
    synthetic-media entry point."""
    from avsum_torch.io.mp4_mux import write_pcm_mp4 as _impl

    _impl(path, samples, rate=rate, chunk_frames=chunk_frames, codec=codec)
