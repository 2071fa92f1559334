"""Summarize as users run it over many videos: a closed loop with one
caller and one video begun ahead, the way the dataset sweep and the
server's worker run it.

Set-up builds the native decoder into the checkout (``native/build/``),
writes the traffic's clip once into a fresh directory under ``TMPDIR``
(its seconds printed), draws every weight on the device from the seed in
the type it is served in (the backbones and VGGish bfloat16, the scorer
float32), builds the port's pipeline from its own classes, and warms it
with one cold summarize and one pair begun back to back.

The window begins video i+1 (``AVPipeline.summarize_begin``) before it
calls video i's finisher, on the fast, device-resident path, until its
seconds are up, then finishes the video in flight. A video's latency
runs from the start of its begin to its finisher's return:
``summarize_frames_per_s`` is the source frames of every completed
video over the window, ``summarize_p90_s`` the 90th percentile of the
latencies. For a sample of the window's videos, drawn from the seed as
they complete, and for the last, the check keeps what the finisher
pooled and scored and the per-frame log-mel that K1 made for that video
(the device tensors the pipeline handed on; no copy).

The check reads the clip again with the plain reference
(``benchmark/reference/summarize.py``, float32) and compares a sample of
the window's videos drawn from the seed: boundaries and selected
segments exactly (the segments as the knapsack picks them from the
port's own scores), and the worst relative gap (the norm of the
difference over the reference's norm) of the visual features, of the
MFCC columns (computed from K1's mel), of VGGish's columns and of K1's
log-mel of every frame of the soundtrack, before the pooling, each
against its limit; and the scorer as a stage: the port's scores against
the reference scorer's over the port's own pooled rows (float32, TF32
off), since scores from the reference's rows carry the backbones'
bfloat16 rounding through the scorer, which swings with the seed
(PERF.md).
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.generators import scene_clip, weights
from benchmark.harness import Window, log
from benchmark.program import program_config, program_state
from benchmark.reference import audio as ref_audio
from benchmark.reference import scorer as ref_scorer
from benchmark.reference import summarize as reference
from benchmark.reference import vision as ref_vision

MODES = ("sound", "control", "altered_scores")


def make_weights(config: dict, seed: int, device) -> Dict[str, dict]:
    """The backbones', VGGish's and the scorer's weights from the seed."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    prog = config["program"]
    backbone = weights.fill(ref_vision.DualBackbone().to(device), seed,
                            dtypes[prog["visual"]["dtype"]])
    vggish = weights.fill(ref_audio.VGGish().to(device), seed + 1,
                          dtypes[prog["audio"]["dtype"]])
    return {"visual": backbone.state_dict(), "vggish": vggish.state_dict(),
            "scorer": ref_scorer.init_leaves(prog["model"], seed + 2, device)}


def build(config: dict, w: Dict[str, dict], device):
    """The port's pipeline and scorer, built from its own classes."""
    from avsum_torch.audio.frontend import AudioFrontend
    from avsum_torch.audio.vggish import make_audio_encoder
    from avsum_torch.models.scorer import AVScorer
    from avsum_torch.pipeline import AVPipeline
    from avsum_torch.vision.backbone import (
        DTYPES,
        VisualFrontend,
        make_backbone,
    )

    cfg = program_config(config)
    with torch.device(device):
        backbone = make_backbone(cfg.visual, state_dict=w["visual"])
        vggish = make_audio_encoder(cfg.audio.encoder, cfg.audio.vggish_dim,
                                    DTYPES[cfg.audio.dtype])
        vggish.load_state_dict(w["vggish"])
        model = AVScorer(cfg.model)
    model.load_state_dict(program_state(w["scorer"],
                                        config["program"]["model"]))
    pipeline = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, device),
                          AudioFrontend(cfg.audio, vggish, device,
                                        use_pallas=cfg.audio.use_pallas))
    return pipeline, model.eval()


class Sample:
    """``k - 1`` of the videos offered, drawn from the seed as they come
    (reservoir sampling), and the last offered: at most ``k`` kept at
    once, by the video's index."""

    def __init__(self, k: int, seed: int):
        self.k = max(k, 1)
        self.rng = np.random.default_rng(seed % 2 ** 63)
        self.slots: List[int] = []
        self.kept: Dict[int, dict] = {}
        self.offered = 0

    def offer(self, item: dict) -> None:
        i = self.offered
        self.offered += 1
        if len(self.slots) < self.k - 1:
            self.slots.append(i)
        elif self.slots:
            j = int(self.rng.integers(i + 1))
            if j < len(self.slots):
                self.slots[j] = i
        self.kept[i] = item
        keep = set(self.slots) | {i}
        for old in [x for x in self.kept if x not in keep]:
            del self.kept[old]


def tap(pipeline, current: dict) -> None:
    """Hold, in ``current``, what the latest finisher pooled: the visual
    rows, the audio rows and the per-frame log-mel they were pooled from."""
    visual_pool, audio_pool = pipeline.visual.pool_on_device, pipeline.audio.pool

    def visual(*args, **kwargs):
        out = visual_pool(*args, **kwargs)
        current["visual"] = out[0]
        return out

    def audio(full, *args, **kwargs):
        out = audio_pool(full, *args, **kwargs)
        current.update(audio=out, logmel=full[1])
        return out

    pipeline.visual.pool_on_device = visual
    pipeline.audio.pool = audio


def setup(run):
    from avsum_torch.build import ensure_native_io

    ensure_native_io()
    clip = run.cell.traffic["clip"]
    media = tempfile.mkdtemp(prefix="avsum-bench-", dir=os.environ.get("TMPDIR"))
    stem = os.path.join(media, "clip")
    t0 = time.perf_counter()
    scene_clip.write(stem, clip, run.seed, run.device)
    log(f"clip written in {time.perf_counter() - t0:.3f} s")
    w = make_weights(run.cell.config, run.seed, run.device)
    pipeline, model = build(run.cell.config, w, run.device)
    current: dict = {}
    tap(pipeline, current)
    path = stem + ".y4m"
    t0 = time.perf_counter()
    pipeline.summarize(path, model)
    first = pipeline.summarize_begin(path, model)
    second = pipeline.summarize_begin(path, model)
    first(), second()
    run.sync()
    log(f"warm-up summarizes {time.perf_counter() - t0:.3f} s")
    return {"pipeline": pipeline, "model": model, "path": path, "media": media,
            "weights": w, "current": current}


def window(run, st, seconds: float) -> Window:
    from avsum_torch.utils.profiling import collect_stages

    pipeline, model, path = st["pipeline"], st["model"], st["path"]
    latencies: List[float] = []
    results: List[dict] = []
    failed = attempted = 0
    frames = 0
    sample = Sample(run.cell.traffic["compare_videos"], run.seed)
    current = st["current"]
    with collect_stages() as spans, run.window() as clock:
        t0 = time.perf_counter()
        pending: List[Tuple[float, object]] = []

        def begin():
            nonlocal attempted, failed
            attempted += 1
            t = time.perf_counter()
            try:
                pending.append((t, pipeline.summarize_begin(path, model)))
            except Exception as e:  # noqa: BLE001 - a failed video counts
                log(f"begin failed: {e!r}")
                failed += 1

        begin()
        while pending:
            if time.perf_counter() - t0 < seconds:
                begin()
            t, finish = pending.pop(0)
            current.clear()
            try:
                result = finish()
            except Exception as e:  # noqa: BLE001 - a failed video counts
                log(f"finish failed: {e!r}")
                failed += 1
                continue
            latencies.append(time.perf_counter() - t)
            results.append(result)
            sample.offer(dict(current, result=result))
            frames += int(result["n_frames"])
    current.clear()
    st["sample"] = sample
    seconds_done = clock["seconds"]
    p90 = float(np.percentile(latencies, 90))
    log(f"window: {len(results)} videos of "
        f"{len(results[-1]['boundaries']) if results else 0} shots, "
        f"{frames} frames in {seconds_done:.3f} s; latency median "
        f"{statistics.median(latencies):.4f} s, p90 {p90:.4f} s over "
        f"{len(latencies)} videos")
    n_frames = int(results[0]["n_frames"]) if results else 0
    fps = float(results[0]["fps"]) if results else 0.0
    stride = max(1, round(fps / run.cell.config["program"]["visual"]["sample_fps"]))
    return Window(
        attempted=attempted, failed=failed,
        metrics={"summarize_frames_per_s": frames / seconds_done,
                 "summarize_p90_s": p90},
        counts={"videos": len(results),
                "embedded_frames": len(results) * len(range(0, n_frames, stride))},
        spans=dict(spans))


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a.astype(np.float64) - b)
                 / max(np.linalg.norm(b.astype(np.float64)), 1e-30))


def reference_scores(v: dict, leaves, model: dict, device) -> np.ndarray:
    """The reference scorer's scores over a video's own pooled rows."""
    with torch.no_grad(), reference.tf32(False):
        return reference.score(
            leaves, model, torch.as_tensor(v["visual"], device=device),
            torch.as_tensor(v["audio"], device=device)).cpu().numpy()


def compare(videos: List[dict], ref: dict, budget: float, leaves,
            model: dict, device) -> List[Tuple[str, float]]:
    """[(name, reading)]: each the worst over ``videos``, each a dict of
    the port's boundaries, scores, segments, visual and audio rows and
    per-frame log-mel; ``leaves``: the scorer's weights."""
    worst = {"boundary_mismatch": 0.0, "segment_mismatch": 0.0,
             "visual_gap": 0.0, "mfcc_gap": 0.0, "vggish_gap": 0.0,
             "logmel_gap": 0.0, "scorer_gap": 0.0}
    cols = {"mfcc_gap": slice(0, 40), "vggish_gap": slice(168, 296)}
    for v in videos:
        want = reference.knapsack(v["scores"], v["boundaries"], ref["n_frames"],
                                  budget)
        if not np.array_equal(want, v["segments"]):
            worst["segment_mismatch"] += 1
        if not np.array_equal(v["boundaries"], ref["boundaries"]):
            worst["boundary_mismatch"] += 1
            for k in ("visual_gap", "logmel_gap", *cols):
                worst[k] = float("inf")
            continue
        worst["visual_gap"] = max(worst["visual_gap"],
                                  _gap(v["visual"], ref["visual"]))
        for k, c in cols.items():
            worst[k] = max(worst[k], _gap(v["audio"][:, c], ref["audio"][:, c]))
        worst["logmel_gap"] = max(
            worst["logmel_gap"],
            _gap(v["logmel"], ref["logmel"])
            if v["logmel"].shape == ref["logmel"].shape else float("inf"))
    for v in videos:
        worst["scorer_gap"] = max(
            worst["scorer_gap"],
            _gap(v["scores"], reference_scores(v, leaves, model, device)))
    return list(worst.items())


def program_videos(sample: Sample) -> List[dict]:
    """The sampled videos, as host arrays."""
    out = []
    for _, kept in sorted(sample.kept.items()):
        r = kept["result"]
        s = len(r["boundaries"])
        out.append({"boundaries": r["boundaries"], "scores": r["scores"],
                    "segments": r["segments"],
                    "visual": kept["visual"][:s].float().cpu().numpy(),
                    "audio": kept["audio"][:s].float().cpu().numpy(),
                    "logmel": kept["logmel"].float().cpu().numpy()})
    return out


def free_program(st) -> None:
    for key in ("pipeline", "model"):
        st.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, st) -> List[Tuple[str, float, float]]:
    try:
        sample = st.pop("sample", None)
        videos = program_videos(sample) if sample is not None else []
        del sample
        st.pop("current", None)
        free_program(st)
        ref = reference.features(os.path.join(st["media"], "clip"),
                                 st["weights"], run.cell.config, run.device)
        budget = run.cell.config["program"]["summary"]["budget_fraction"]
        readings = compare(videos, ref, budget, st["weights"]["scorer"],
                           run.cell.config["program"]["model"],
                           run.device) if videos else [
            (name, float("inf")) for name in run.cell.limits]
    finally:
        shutil.rmtree(st["media"], ignore_errors=True)
    limits = run.cell.limits
    return [(name, value, limits[name]) for name, value in readings]


def readings(run, mode: str) -> Dict[str, float]:
    """One mode's readings (``benchmark.control``): the port's summaries
    of the clip, three of them, against the reference; the control's
    (``reference.features`` in the precision below) in their place; or
    the port's under a planted fault."""
    from benchmark import faults

    fault = faults.FAULTS[mode]() if mode in faults.FAULTS else None
    st = None
    try:
        if fault is not None:
            fault.__enter__()
        st = setup(run)
        stem = os.path.join(st["media"], "clip")
        budget = run.cell.config["program"]["summary"]["budget_fraction"]
        if mode == "control":
            free_program(st)
            ctrl = reference.features(stem, st["weights"], run.cell.config,
                                      run.device, precision="control")
            ctrl["segments"] = reference.knapsack(
                ctrl["scores"], ctrl["boundaries"], ctrl["n_frames"], budget)
            videos = [ctrl]
        else:
            sample = Sample(3, run.seed)
            for _ in range(3):
                st["current"].clear()
                result = st["pipeline"].summarize(st["path"], st["model"])
                sample.offer(dict(st["current"], result=result))
            videos = program_videos(sample)
            del sample
            st.pop("current", None)
            free_program(st)
        ref = reference.features(stem, st["weights"], run.cell.config,
                                 run.device)
        return dict(compare(videos, ref, budget, st["weights"]["scorer"],
                            run.cell.config["program"]["model"], run.device))
    finally:
        if fault is not None:
            fault.__exit__(None, None, None)
        if st is not None:
            shutil.rmtree(st["media"], ignore_errors=True)
