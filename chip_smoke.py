#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the two CUDA kernels (``avsum_torch/csrc``) and the host decoder
   (``native/build/libavsumio.so``) from the checkout;
3. ``summarize`` of a 12-scene 640x360 synthetic video at the
   ``configs/tvsum.yaml`` widths (dual backbone and VGGish in bfloat16,
   BiLSTM scorer, hidden 512, 4 heads) with random weights: K1 must run,
   scores must be finite in [0, 1], agree with the plain versions on the
   CPU, and the summary must fit the 15% budget;
4. ``summarize`` of a synthetic video with >= 520 shots, so the padded
   shot axis reaches 512 and the scorer's attention runs kernel K2;
5. each kernel against its plain PyTorch version on the card, float32
   with TF32 off, on fixed cases and at the shapes the two runs gave it,
   with CUDA-event times of both at those shapes.

Launch counts are reset just before each summarize and read just after
it; the comparisons of phase 5 are not counted.

The second-to-last line is the kernels' JSON, the last one
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA device or no checkout beside the script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
TVSUM_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "tvsum.yaml")
K1_TOL = dict(rtol=2e-3, atol=2e-3)  # mel and log2-mel, as the JAX test
K2_TOL = dict(rtol=1e-5, atol=1e-5)  # attention output and LSE
SCORE_TOL = 1e-4  # card scores vs the CPU plain path on the same features


def card_line() -> str:
    out = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the device, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from avsum_torch import build

    t0 = time.perf_counter()
    native = build.ensure_native_io()
    libs = [build.kernel_library(k) for k in build.KERNELS]
    secs = time.perf_counter() - t0
    print(f"build: {native.name} + {[p.name for p in libs]} in {secs:.1f} s")
    for lib in libs:
        print(lib.with_name(lib.name + ".log").read_text().strip())
    return {"build_s": secs}


def _waveform(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.4 * np.sin(2 * np.pi * 523 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def check_k1(path_samples: list) -> dict:
    """K1 vs its plain version on 10 s, 607 s and odd-length waveforms
    and at the bucketed lengths the main path gave it; times at the
    latter (the JSON keeps the longest)."""
    import torch

    from avsum_torch.ops.melspec import fused_log_mel, log_mel_plain

    worst, timing = 0.0, {}
    cases = [("10 s", 160_000), ("607 s", 607 * 16000), ("odd", 48_123)]
    cases += [(f"path {n}", n) for n in sorted(set(path_samples))]
    for name, n in cases:
        x = torch.from_numpy(_waveform(n, seed=n)).cuda()
        mel_k, lm_k = fused_log_mel(x)
        mel_p, lm_p = log_mel_plain(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(mel_k, mel_p, **K1_TOL)
        torch.testing.assert_close(lm_k, lm_p, **K1_TOL)
        err = (lm_k - lm_p).abs().max().item()
        rel = ((mel_k - mel_p).abs().max() / mel_p.abs().max()).item()
        worst = max(worst, err)
        print(f"K1 {name}: frames {mel_k.shape[0]}, max|dlog2mel| {err:.3e}, "
              f"max|dmel|/max|mel| {rel:.3e}")
        if name.startswith("path"):
            timing = {"ms": cuda_ms(lambda: fused_log_mel(x)),
                      "plain_ms": cuda_ms(lambda: log_mel_plain(x))}
            print(f"K1 at the path's {n} samples: kernel {timing['ms']:.3f} "
                  f"ms, plain {timing['plain_ms']:.3f} ms")
    return {"max_abs_err": worst, **timing}


def _qkv(b: int, s: int, h: int, d: int, seed: int):
    """q, k, v as strided views of one [B, S, 3, H, D] tensor, the layout
    the scorer's fused projection hands the kernel."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, device="cuda", generator=g)
    return qkv.unbind(2)


def check_k2(path_seq: int) -> dict:
    import torch

    from avsum_torch.ops.attention import attention_plain, flash_attention_fwd

    worst = 0.0
    for d in (128, 256):
        for s in sorted({512, 544, 1000, path_seq}):
            q, k, v = _qkv(2, s, 4, d, seed=s + d)
            mask = torch.ones(2, s, device="cuda")
            mask[0, s - s // 5:] = 0.0  # padded tail
            mask[1] = 0.0  # every key masked: uniform average
            out, lse = flash_attention_fwd(q, k, v, mask)
            ref = attention_plain(q, k, v, mask)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
            logits = logits + torch.where(mask.bool(), 0.0, -1e30)[:, None, None]
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **K2_TOL)
            torch.testing.assert_close(lse, torch.logsumexp(logits, -1),
                                       **K2_TOL)
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            print(f"K2 D={d} S={s}: max|dout| {err:.3e}")
    q, k, v = _qkv(1, path_seq, 4, 256, seed=7)
    mask = torch.ones(1, path_seq, device="cuda")
    mask[:, path_seq - 20:] = 0.0
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, mask))
    print(f"K2 at the path's [1, {path_seq}, 4, 256]: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _video(stem: str, n_scenes: int, height: int, width: int,
           scene_len: tuple, seed: int) -> None:
    from avsum_tpu.io.synthetic import write_scene_video

    t0 = time.perf_counter()
    write_scene_video(stem, n_scenes=n_scenes, seed=seed, height=height,
                      width=width, scene_len_frames=scene_len)
    print(f"wrote {stem}.y4m ({n_scenes} scenes, {width}x{height}) in "
          f"{time.perf_counter() - t0:.1f} s")


def _check_summary(result: dict, budget: float) -> None:
    import numpy as np

    scores = np.asarray(result["scores"])
    if scores.shape != (len(result["boundaries"]),):
        raise AssertionError(f"scores {scores.shape} for "
                             f"{len(result['boundaries'])} shots")
    if not (np.isfinite(scores).all() and (scores >= 0).all()
            and (scores <= 1).all()):
        raise AssertionError(f"scores outside [0, 1]: {scores}")
    seg = np.asarray(result["segments"]).reshape(-1, 2)
    used = int((seg[:, 1] - seg[:, 0]).sum())
    cap = max(int(budget * result["n_frames"]), 1)
    if not 0 < used <= cap:
        raise AssertionError(f"summary of {used} frames, budget {cap}")
    print(f"summary: {len(seg)} segments, {used}/{cap} budget frames")


def run_summarize(pipeline, model, path: str, budget: float):
    from avsum_torch.ops.attention import flash_attention
    from avsum_torch.ops.melspec import fused_log_mel

    fused_log_mel.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    result = pipeline.summarize(path, model)
    secs = time.perf_counter() - t0
    counts = {"melspec": fused_log_mel.launches,
              "flash_fwd": flash_attention.launches}
    stages = {k: round(v, 4) for k, v in pipeline.stage_seconds.items()}
    print(f"summarize {path}: {len(result['boundaries'])} shots, "
          f"{secs:.2f} s, launches {counts}, stages {json.dumps(stages)}")
    _check_summary(result, budget)
    return result, counts


def check_against_cpu(pipeline, model, path: str, result: dict) -> None:
    """The card's scorer against its plain path on the CPU, on the same
    features; the MFCC / log-mel columns of the audio features (kernel
    K1's outputs) against the CPU's plain versions."""
    import numpy as np
    import torch

    from avsum_torch.audio.frontend import AudioFrontend
    from avsum_torch.audio.vggish import VGGish
    from avsum_tpu.io.wav import load_audio_mono_16k_ship

    p = pipeline.process_video(path)
    card = pipeline.score(p, model)
    rerun = np.abs(card - result["scores"]).max()
    _, visual, audio, mask = pipeline.pad_scorer_inputs(p)
    cpu_model = model.to("cpu")
    try:
        with torch.inference_mode():
            ref = cpu_model(torch.from_numpy(visual), torch.from_numpy(audio),
                            torch.from_numpy(mask))[0, :len(p.visual)].numpy()
    finally:
        model.to(pipeline.device)
    err = np.abs(ref - card).max()
    print(f"scores: card vs CPU plain path max|d| {err:.3e}; "
          f"rerun vs summarize max|d| {rerun:.3e}")
    if err > SCORE_TOL or rerun > SCORE_TOL:
        raise AssertionError(f"scores disagree: {err}, {rerun}")
    cpu_audio = AudioFrontend(pipeline.config.audio, VGGish(), "cpu")
    wave = load_audio_mono_16k_ship(path[:-len(".y4m")] + ".wav")
    bounds = p.boundaries.astype(np.float64) / p.fps * 16000
    ref_a = cpu_audio.shot_features(wave, bounds).numpy()[:, :168]
    np.testing.assert_allclose(p.audio[:, :168], ref_a, **K1_TOL)
    print(f"audio MFCC/log-mel: card vs CPU max|d| "
          f"{np.abs(p.audio[:, :168] - ref_a).max():.3e}")


def main() -> int:
    try:
        import torch

        import avsum_torch  # noqa: F401  (the checkout beside this script)
    except ImportError as e:
        print(f"chip_smoke: {e}; run it from the root of a checkout",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from avsum_torch.cli.main import build_pipeline
    from avsum_tpu.io.wav import load_audio_mono_16k_ship
    from avsum_tpu.train.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    phase_build()

    cfg = load_config(TVSUM_CONFIG)
    budget = cfg.summary.budget_fraction
    with tempfile.TemporaryDirectory() as tmp:
        short, many = f"{tmp}/short", f"{tmp}/many"
        _video(short, 12, 360, 640, (24, 90), seed=5)
        _video(many, 540, 72, 96, (30, 40), seed=6)
        t0 = time.perf_counter()
        pipeline, model = build_pipeline(cfg, "cuda", seed=0)
        print(f"random weights on the card in {time.perf_counter() - t0:.1f} s")

        res_short, n_short = run_summarize(pipeline, model, f"{short}.y4m",
                                           budget)
        if n_short["melspec"] <= 0:
            raise AssertionError("K1 did not run on the short video")
        check_against_cpu(pipeline, model, f"{short}.y4m", res_short)

        res_many, n_many = run_summarize(pipeline, model, f"{many}.y4m",
                                         budget)
        # the audio front-end pads each waveform to a power of two
        k1_samples = [1 << (len(load_audio_mono_16k_ship(f"{v}.wav")) - 1)
                      .bit_length() for v in (short, many)]
        s_pad = -(-len(res_many["boundaries"]) // 32) * 32
        if s_pad < 512 or n_many["flash_fwd"] <= 0 or n_many["melspec"] <= 0:
            raise AssertionError(
                f"padded S {s_pad}: the long video did not run both "
                f"kernels ({n_many})")

    k1 = check_k1(k1_samples)
    k2 = check_k2(s_pad)
    kernels = [
        {"name": "melspec", "route": "cuda",
         "source": "avsum_torch/csrc/melspec.cu",
         "replaces": "avsum_tpu/ops/pallas_melspec.py:39",
         "launches": n_short["melspec"] + n_many["melspec"], **k1},
        {"name": "flash_fwd", "route": "cuda",
         "source": "avsum_torch/csrc/flash_fwd.cu",
         "replaces": "avsum_tpu/ops/attention.py:42",
         "launches": n_short["flash_fwd"] + n_many["flash_fwd"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
