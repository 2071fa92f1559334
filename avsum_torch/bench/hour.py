"""Hour-scale summarize, the counterpart of the JAX package's
``scripts/bench_hour.py``: ``--seconds`` (default 3600) of 30 fps 640x360
scene video with its 16 kHz soundtrack, written once to
``bench_data/hour_640x360_<seconds>s.{y4m,wav}`` (~37 GB of y4m for the
hour), byte for byte the JAX script's file, then ``--runs`` summarizes of
it with the dual backbone in bfloat16 and the dataclass default scorer
(the attention encoder, which runs K2 once the shots pad past 512).

Prints one JSON line: ``hour_scale_wall_s`` (the best run's seconds per
source hour), ``vs_baseline`` (60 s over it: BASELINE's hour in a
minute), the frames and shots, every run's seconds, the best run's stage
seconds, K1 and K2 launches per run and the peak device memory.
"""

from __future__ import annotations

import concurrent.futures
import os
import time

import numpy as np
import torch

from avsum_torch.bench import (
    BENCH_DIR,
    card,
    emit,
    log,
    on_card,
    require_device,
    timed_summarizes,
    write_once,
)

FPS = 30.0
W, H = 640, 360
BENCH_SETS = ["visual.dtype=bfloat16", "visual.backbone=dual"]
CHUNK = 32  # frames drawn at once, as the JAX script draws them
FRAME_BYTES = len(b"FRAME\n") + W * H + 2 * (W // 2) * (H // 2)


def add_arguments(ap) -> None:
    ap.add_argument("--seconds", type=int, default=3600,
                    help="length of the source video")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--media-dir", default=BENCH_DIR,
                    help="where the video is written once and reused")


def _frames(noise: np.ndarray, base: np.ndarray, c0: int,
            length: int) -> bytes:
    """One chunk of a scene's frames as y4m FRAME records: the JAX
    script's composition, color * (0.6 + 0.4 * gradient) + drift +
    noise * 4, in float32 and in its order of operations."""
    from avsum_torch.io.y4m import rgb_to_yuv420

    n = noise.shape[0]
    f_idx = np.arange(c0, c0 + n, dtype=np.float32)
    drift = 10.0 * np.sin(2 * np.pi * f_idx / max(length, 1))
    ab = base[None] + drift[:, None, None, None]
    noise *= 4.0
    np.add(noise, ab, out=noise)
    np.clip(noise, 0, 255, out=noise)
    block = noise.astype(np.uint8)
    out = []
    for i in range(n):
        out.append(b"FRAME\n")
        out.extend(p.tobytes() for p in rgb_to_yuv420(block[i]))
    return b"".join(out)


def generate(stem: str, seconds: int, seed: int = 7) -> None:
    """Write ``stem``.y4m and .wav: ``scripts/bench_hour.py``'s video,
    byte for byte. This thread draws every random number in the script's
    order; a pool of threads turns each chunk of noise into frames and
    writes them at their offsets in the file, so memory stays bounded."""
    from avsum_torch.io.wav import write_wav

    total = int(seconds * FPS)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    gradient = ((yy / H + xx / W) / 2.0)[..., None].astype(np.float32)
    grad_term = 0.6 + 0.4 * gradient
    sr = 16000
    audio = np.zeros(int(seconds * sr), np.float32)
    header = f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420\n".encode()
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    t0 = time.perf_counter()
    written, prev_color, scene_id = 0, None, 0
    fd = os.open(stem + ".y4m", os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, header)
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            pending = []

            def write(noise, base, c0, length, frame):
                os.pwrite(fd, _frames(noise, base, c0, length),
                          len(header) + frame * FRAME_BYTES)

            while written < total:
                length = min(int(rng.integers(90, 211)), total - written)
                color = rng.integers(0, 256, 3).astype(np.float32)
                while (prev_color is not None
                       and np.abs(color - prev_color).mean() < 80):
                    color = rng.integers(0, 256, 3).astype(np.float32)
                prev_color = color
                s0 = int(written / FPS * sr)
                s1 = min(int((written + length) / FPS * sr), len(audio))
                tone = 220.0 * 2.0 ** (float(rng.integers(0, 12)) / 12.0)
                tt = np.arange(s1 - s0, dtype=np.float32) / sr
                audio[s0:s1] = 0.4 * np.sin(2 * np.pi * tone * tt)
                audio[s0:s1] += 0.05 * rng.standard_normal(s1 - s0,
                                                           dtype=np.float32)
                base = color[None, None, :] * grad_term
                for c0 in range(0, length, CHUNK):
                    n = min(CHUNK, length - c0)
                    noise = rng.standard_normal((n, H, W, 3),
                                                dtype=np.float32)
                    pending.append(pool.submit(write, noise, base, c0, length,
                                               written + c0))
                    while len(pending) > 2 * workers:
                        pending.pop(0).result()
                written += length
                scene_id += 1
                if scene_id % 50 == 0:
                    log(f"  gen: {written}/{total} frames "
                        f"({time.perf_counter() - t0:.0f} s)")
            for f in pending:
                f.result()
    finally:
        os.close(fd)
    write_wav(stem + ".wav", np.clip(audio, -1, 1), sr)
    log(f"generated {written} frames / {scene_id} scenes in "
        f"{time.perf_counter() - t0:.0f} s")


def run(args) -> int:
    from avsum_torch.cli.main import _media_setup, build_pipeline
    from avsum_torch.train.config import load_config

    require_device(args.device)
    stem = os.path.join(args.media_dir, f"hour_640x360_{args.seconds}s")
    write_once(stem, lambda tmp: generate(tmp, args.seconds))
    weights = _media_setup(args)
    device = card(args.device)
    log(f"device: {device or args.device}")
    cfg = load_config(args.config, BENCH_SETS + list(args.overrides))
    pipeline, model = build_pipeline(cfg, args.device, args.seed, weights)
    if on_card(args.device):
        torch.cuda.reset_peak_memory_stats()
    runs, stages, kernels, result = timed_summarizes(
        pipeline, model, stem + ".y4m", args.runs)
    best_i = int(np.argmin(runs))
    n = int(result["n_frames"])
    per_hour = runs[best_i] / (n / FPS) * 3600
    emit({
        "metric": "hour_scale_wall_s",
        "value": per_hour,
        "unit": "s_per_source_hour",
        "vs_baseline": 60.0 / per_hour,
        "seconds": args.seconds,
        "n_frames": n,
        "n_shots": len(result["boundaries"]),
        "backend": torch.device(args.device).type,
        "device": device,
        "runs_s": runs,
        "stages_s": stages[best_i],
        "kernels": kernels,
        "peak_device_mib": (torch.cuda.max_memory_allocated() / 2 ** 20
                            if on_card(args.device) else None),
    })
    return 0
