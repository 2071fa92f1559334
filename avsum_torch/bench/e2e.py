"""End-to-end benchmark, the counterpart of the JAX package's ``bench.py``:
decode -> shots -> features -> score -> summary on a synthetic 640x360,
30 fps scene clip (25 scenes of 90-210 frames, written once to
``bench_data/bench_640x360_120s.{y4m,wav}`` by the same generator and seed
as ``bench.py``, so both packages measure one file).

The pipeline is the dual-backbone one in bfloat16 (ResNet50 and
InceptionV3, VGGish), the 296-d audio features and the dataclass default
scorer (the attention encoder), with weights drawn from ``--seed`` or
read from ``--weights``. One cold summarize, then ``--runs`` timed ones,
each under ``collect_stages``; every run's segments must equal the cold
run's. Prints one JSON line: ``e2e_video_fps`` (frames / best run s) and
``vs_baseline`` (against BASELINE's one hour of 30 fps video in 60 s,
1800 frames/s), the best run's stage seconds, the embed FLOPs per frame
(``FlopCounterMode`` over the backbone on the meta device), an MFU lower
bound over the whole best run and the embed program's own MFU (a
device-resident packed batch, CUDA events) against the H100's dense bf16
rate, the device's busy share in a profiled warm run, K1 and K2 launches
per run, a fresh process's build and first summarizes (``warm_probe``,
the kernels already built), and the same runs with frame dedup at 12.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from avsum_torch.bench import (
    BENCH_DIR,
    H100_BF16_FLOPS,
    REPO,
    card,
    emit,
    log,
    on_card,
    require_device,
    timed_summarizes,
    write_once,
)

SCENES = 25
SEED = 123
FPS = 30.0
WIDTH, HEIGHT = 640, 360
SCENE_LEN = (90, 210)
TARGET_FPS = 1800.0  # one hour of 30 fps video in 60 s (BASELINE.md)
BENCH_SETS = ["visual.dtype=bfloat16", "visual.backbone=dual",
              "audio.dtype=bfloat16"]
DEDUP_THRESHOLD = 12.0  # bench.py's adaptive-sampling probe
EMBED_ITERS = 6


def add_arguments(ap) -> None:
    ap.add_argument("--runs", type=int, default=8,
                    help="timed summarize runs after the cold one")
    ap.add_argument("--scenes", type=int, default=SCENES,
                    help="scenes of the clip (25: bench.py's clip)")
    ap.add_argument("--media-dir", default=BENCH_DIR,
                    help="where the clip is written once and reused")
    ap.add_argument("--warm-probe", action="store_true",
                    help="child mode: build, two summarizes, one JSON line")


def media_stem(media_dir: str, scenes: int) -> str:
    name = "bench_640x360_120s"
    if scenes != SCENES:
        name += f"_{scenes}scenes"
    return os.path.join(media_dir, name)


def ensure_media(stem: str, scenes: int) -> None:
    from avsum_torch.io.synthetic import write_scene_video

    write_once(stem, lambda tmp: write_scene_video(
        tmp, n_scenes=scenes, seed=SEED, fps=FPS, height=HEIGHT, width=WIDTH,
        scene_len_frames=SCENE_LEN))


def _setup(args):
    """-> (config, pipeline, scorer, build seconds)."""
    from avsum_torch.cli.main import _media_setup, build_pipeline
    from avsum_torch.train.config import load_config

    weights = _media_setup(args)
    cfg = load_config(args.config, BENCH_SETS + list(args.overrides))
    t0 = time.perf_counter()
    pipeline, model = build_pipeline(cfg, args.device, args.seed, weights)
    return cfg, pipeline, model, time.perf_counter() - t0


def embed_flops_per_frame(model, ship: int) -> float:
    """FLOPs of one ``ship`` x ``ship`` frame through the backbone
    ``model`` (``FlopCounterMode`` on a meta-device copy: nothing runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(model).to("meta")
    frames = torch.zeros((1, ship, ship, 3), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        meta(frames)
    return float(counter.get_total_flops())


def measure_embed_program(pipeline, flops_per_frame: float) -> dict:
    """The packed embed (YUV420 planes -> RGB -> backbone) on a
    device-resident batch of ``visual.batch_size`` frames, by CUDA
    events over ``EMBED_ITERS`` calls after a warm one."""
    ship = pipeline.config.visual.ship_size
    bs = pipeline.visual.batch_size
    n = bs * (ship * ship + 2 * (ship // 2) * (ship // 2))
    gen = torch.Generator(device=pipeline.device).manual_seed(0)
    buf = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=gen,
                        device=pipeline.device)
    with torch.inference_mode():
        pipeline.visual._embed_packed(buf, ship, ship)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(EMBED_ITERS):
            pipeline.visual._embed_packed(buf, ship, ship)
        end.record()
        torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3 / EMBED_ITERS
    return {"embed_program_ms_per_frame": 1e3 * sec / bs,
            "embed_program_mfu_pct": 100 * flops_per_frame * bs / sec
            / H100_BF16_FLOPS}


def device_busy_pct(pipeline, model, video: str) -> float:
    """The device's busy share of one warm summarize under torch.profiler:
    the device time of every kernel and copy (not the ``avsum.*`` spans
    laid over them) against the profiled run's host wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.summarize(video, model)
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("avsum."))
    return 100 * busy / 1e6 / wall


def adaptive(pipeline, model, video: str, want_segments) -> tuple:
    """bench.py's secondary metric: one untimed and two timed summarizes
    with ``visual.dedup_threshold`` 12 -> (best seconds, segments equal to
    the exact run's)."""
    cfg = pipeline.config
    pipeline.config = dataclasses.replace(cfg, visual=dataclasses.replace(
        cfg.visual, dedup_threshold=DEDUP_THRESHOLD))
    try:
        pipeline.summarize(video, model)
        best, result = None, None
        for _ in range(2):
            t0 = time.perf_counter()
            result = pipeline.summarize(video, model)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
    finally:
        pipeline.config = cfg
    return best, bool(np.array_equal(result["segments"], want_segments))


def _child_argv(args) -> list:
    argv = ["--device", args.device, "--seed", str(args.seed),
            "--scenes", str(args.scenes), "--media-dir", args.media_dir]
    for flag, value in (("--config", args.config),
                        ("--weights", args.weights)):
        if value:
            argv += [flag, value]
    for item in args.overrides:
        argv += ["--set", item]
    return argv


def fresh_process(args) -> dict:
    """``--warm-probe`` in a new process (the kernels and the decoder
    already built) -> its JSON line."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    res = subprocess.run(
        [sys.executable, "-m", "avsum_torch.bench", "e2e", "--warm-probe",
         *_child_argv(args)], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=1800)
    if res.returncode != 0:
        raise RuntimeError(f"warm probe exited {res.returncode}:\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def warm_probe(args) -> None:
    """Child mode: the pipeline built, then two summarizes, timed."""
    stem = media_stem(args.media_dir, args.scenes)
    _, pipeline, model, build_s = _setup(args)
    out = {"build_s": build_s}
    for key in ("warmup_s", "second_s"):
        t0 = time.perf_counter()
        pipeline.summarize(stem + ".y4m", model)
        out[key] = time.perf_counter() - t0
    emit(out)


def run(args) -> int:
    require_device(args.device)
    stem = media_stem(args.media_dir, args.scenes)
    ensure_media(stem, args.scenes)
    if args.warm_probe:
        warm_probe(args)
        return 0
    video = stem + ".y4m"
    device = card(args.device)
    log(f"device: {device or args.device}")
    cfg, pipeline, model, build_s = _setup(args)
    t0 = time.perf_counter()
    first = pipeline.summarize(video, model)
    warmup_cold = time.perf_counter() - t0
    log(f"build {build_s:.1f} s, cold summarize {warmup_cold:.1f} s")
    runs, stages, kernels, _ = timed_summarizes(
        pipeline, model, video, args.runs, first["segments"])
    best_i = int(np.argmin(runs))
    best = runs[best_i]
    n_frames = int(first["n_frames"])
    fps = float(first["fps"])
    n_embedded = len(range(0, n_frames,
                           max(1, round(fps / cfg.visual.sample_fps))))
    fpf = embed_flops_per_frame(pipeline.visual.model, cfg.visual.ship_size)
    card_metrics = {"mfu_lower_bound_pct": None,
                    "embed_program_ms_per_frame": None,
                    "embed_program_mfu_pct": None, "device_busy_pct": None}
    if on_card(args.device):
        card_metrics.update(
            mfu_lower_bound_pct=100 * n_embedded * fpf / best
            / H100_BF16_FLOPS,
            **measure_embed_program(pipeline, fpf),
            device_busy_pct=device_busy_pct(pipeline, model, video))
    adaptive_s, adaptive_same = adaptive(pipeline, model, video,
                                         first["segments"])
    probe = fresh_process(args)
    log(f"{n_frames} frames in {best:.3f} s -> {n_frames / best:.1f} "
        f"frames/s; {len(first['segments'])} segments; warm probe {probe}")
    from avsum_torch.data.cache import config_fingerprint

    emit({
        "metric": "e2e_video_fps",
        "value": n_frames / best,
        "unit": "frames/sec",
        "vs_baseline": n_frames / best / TARGET_FPS,
        "media": {"file": os.path.basename(video), "width": WIDTH,
                  "height": HEIGHT, "fps": fps, "seconds": n_frames / fps,
                  "n_frames": n_frames, "n_shots": len(first["boundaries"])},
        "config_fingerprint": config_fingerprint(cfg.visual, cfg.audio,
                                                 pipeline.detector),
        "backend": torch.device(args.device).type,
        "device": device,
        "runs_s": runs,
        "stages_s": stages[best_i],
        "n_embedded_frames": n_embedded,
        "embed_gflops_per_frame": fpf / 1e9,
        **card_metrics,
        "kernels": kernels,
        "warmup_cold_s": warmup_cold,
        "warm_probe": probe,
        "adaptive_fps": n_frames / adaptive_s,
        "adaptive_identical_segments": adaptive_same,
    })
    return 0
