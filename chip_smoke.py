#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
raising on failure:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels (``avsum_torch/csrc``, one nvcc per source, all
   at once) and the host decoder (``native/build/libavsumio.so``) from
   the checkout;
3. ``summarize`` of a 12-scene 640x360 synthetic video at the
   ``configs/tvsum.yaml`` widths (dual backbone and VGGish in bfloat16,
   BiLSTM scorer, hidden 512, 4 heads) with random weights: K1 must run,
   scores must be finite in [0, 1], agree with the plain versions on the
   CPU, and the summary must fit the 15% budget;
4. ``summarize`` of a synthetic video with >= 520 shots, so the padded
   shot axis reaches 512 and the scorer's attention runs kernel K2;
5. ``train`` through the CLI at the ``configs/hour_scale.yaml`` widths
   (attention encoder, hidden 512, 4 heads, 2 layers; S = 1024 shots, so
   the encoders' attention runs at D = 128 and the fusion's at D = 256)
   on a synthetic feature cache of 4 videos for 2 epochs, then
   ``--resume`` for a third: K2, B3 and B4 must run, the loss must be
   finite, the checkpoint written and the resumed run start at epoch 2;
6. each kernel against its plain PyTorch version on the card, float32
   with TF32 off, on fixed cases and at the shapes the runs gave it (K1
   also at 64 mel bands and on a quiet waveform; B3 also at S = 7168),
   with CUDA-event times of both at those shapes, taken in turns over 5
   rounds (median, min-max); the flash backward also against autograd of
   the plain attention;
7. one hour-scale train step on the card against the same step on the
   CPU (same parameters and batch, dropout 0): loss, every gradient and
   the parameters after 3 steps;
8. one train step at S = 7168 with remat (``scripts/bench_train_hour.py``'s
   shape): its time and peak device memory.

Launch counts are reset just before each run of phases 3-5 and read just
after it; the comparisons of phases 6-8 are not counted.

The last three lines are the kernels' JSON, the card's nvidia-smi line
and ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when there is no CUDA device or no checkout beside the script.
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
B34_TOL = dict(rtol=1e-4, atol=1e-4)  # dq, dk, dv
SCORE_TOL = 1e-4  # card scores vs the CPU plain path on the same features
GRAD_TOL = 1e-4  # card vs CPU gradients, relative to each tensor's max |g|
PARAM_TOL = 1e-5  # card vs CPU parameters after 3 train steps
HOUR_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "hour_scale.yaml")


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


def compare_ms(fns: dict, rounds: int = 5, iters: int = 20) -> dict:
    """``{name: fn}`` -> ``{name: (median, min, max)}`` milliseconds by
    :func:`cuda_ms`, the functions timed in turns in each of ``rounds``
    rounds (the order reversed every other round), so a kernel and its
    plain version see the same clocks and neighbours."""
    import numpy as np

    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name], iters))
    return {name: (float(np.median(t)), min(t), max(t))
            for name, t in times.items()}


def fmt_ms(t: tuple) -> str:
    return f"{t[0]:.3f} ms ({t[1]:.3f}-{t[2]:.3f})"


def phase_build() -> dict:
    from avsum_torch import build

    t0 = time.perf_counter()
    native = build.ensure_native_io()
    libs = build.build_all()
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


def _quiet_waveform():
    """A tone at 0.5, then a stretch at 5e-4 (60 dB down), then 1 s of
    exact silence."""
    import numpy as np

    t = np.arange(16000) / 16000
    rng = np.random.default_rng(7)
    return np.concatenate([
        0.5 * np.sin(2 * np.pi * 440 * t),
        5e-4 * (np.sin(2 * np.pi * 3000 * t)
                + 0.5 * rng.standard_normal(16000)),
        np.zeros(16000)]).astype(np.float32)


def check_k1(path_samples: list) -> dict:
    """K1 vs its plain version at 128 and 64 mel bands on 10 s, 607 s,
    odd-length and quiet waveforms and at the bucketed lengths the main
    path gave it; times at the latter (the JSON keeps the longest, at 128
    bands)."""
    import torch

    from avsum_torch.ops.melspec import fused_log_mel, log_mel_plain

    worst, timing = 0.0, {}
    cases = [("10 s", _waveform(160_000, seed=160_000)),
             ("607 s", _waveform(607 * 16000, seed=607 * 16000)),
             ("odd", _waveform(48_123, seed=48_123)),
             ("quiet", _quiet_waveform())]
    cases += [(f"path {n}", _waveform(n, seed=n))
              for n in sorted(set(path_samples))]
    for n_mels in (128, 64):
        for name, wave in cases:
            x = torch.from_numpy(wave).cuda()
            mel_k, lm_k = fused_log_mel(x, n_mels=n_mels)
            mel_p, lm_p = log_mel_plain(x, n_mels=n_mels)
            torch.cuda.synchronize()
            torch.testing.assert_close(mel_k, mel_p, **K1_TOL)
            torch.testing.assert_close(lm_k, lm_p, **K1_TOL)
            err = (lm_k - lm_p).abs().max().item()
            rel = ((mel_k - mel_p).abs().max() / mel_p.abs().max()).item()
            worst = max(worst, err)
            print(f"K1 {n_mels} mels, {name}: frames {mel_k.shape[0]}, "
                  f"max|dlog2mel| {err:.3e}, max|dmel|/max|mel| {rel:.3e}")
            if name.startswith("path") and (n_mels == 128
                                            or x.numel() == max(path_samples)):
                t = compare_ms({
                    "kernel": lambda: fused_log_mel(x, n_mels=n_mels),
                    "plain": lambda: log_mel_plain(x, n_mels=n_mels)})
                print(f"K1 {n_mels} mels at the path's {x.numel()} samples: "
                      f"kernel {fmt_ms(t['kernel'])}, plain "
                      f"{fmt_ms(t['plain'])}")
                if n_mels == 128:
                    timing = {"ms": t["kernel"][0], "plain_ms": t["plain"][0]}
    return {"max_abs_err": worst, **timing}


def _flash_case(b: int, s: int, d: int, seed: int):
    """qkv [B, S, 3, 4, D] (q, k, v are strided views of it, the layout the
    scorer's fused projection hands the kernels), a mask with a padded
    tail in row 0 and no valid key in row 1 (when B > 1), and a cotangent
    zeroed at masked queries."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3, 4, d, device="cuda", generator=g)
    mask = torch.ones(b, s, device="cuda")
    mask[0, s - s // 5:] = 0.0
    if b > 1:
        mask[1] = 0.0
    cot = torch.randn(b, s, 4, d, device="cuda", generator=g)
    return qkv, mask, cot * mask[:, :, None, None]


def check_k2(path_seq: int) -> dict:
    import torch

    from avsum_torch.ops.attention import (
        attention_fwd_plain,
        attention_plain,
        flash_attention_fwd,
    )

    worst = 0.0
    for d in (128, 256):
        for s in sorted({512, 544, 1000, path_seq}):
            qkv, mask, _ = _flash_case(2, s, d, seed=s + d)
            q, k, v = qkv.unbind(2)
            out, lse = flash_attention_fwd(q, k, v, mask)
            ref, ref_lse = attention_fwd_plain(q, k, v, mask)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **K2_TOL)
            torch.testing.assert_close(lse, ref_lse, **K2_TOL)
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            print(f"K2 D={d} S={s}: max|dout| {err:.3e}")
    qkv, mask, _ = _flash_case(1, path_seq, 256, seed=7)
    q, k, v = qkv.unbind(2)
    t = compare_ms({"kernel": lambda: flash_attention_fwd(q, k, v, mask),
                    "plain": lambda: attention_plain(q, k, v, mask)})
    print(f"K2 at the path's [1, {path_seq}, 4, 256]: kernel "
          f"{fmt_ms(t['kernel'])}, plain {fmt_ms(t['plain'])}")
    return {"max_abs_err": worst, "ms": t["kernel"][0],
            "plain_ms": t["plain"][0]}


def _grads(fn, qkv, mask, cot):
    leaf = qkv.clone().requires_grad_()
    out = fn(*leaf.unbind(2), mask)
    (out * cot).sum().backward()
    return leaf.grad.unbind(2)


def _bwd_inputs(qkv, mask, cot):
    from avsum_torch.ops.attention import flash_attention_fwd

    q, k, v = qkv.unbind(2)
    out, lse = flash_attention_fwd(q, k, v, mask)
    delta = (cot * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, cot, mask, lse, delta


def check_b34() -> tuple:
    """B3 and B4 against their plain versions on the same inputs, and the
    whole backward (K2 -> B3 -> B4) against autograd of the plain
    attention; CUDA-event times at the train run's shapes."""
    import torch

    from avsum_torch.ops import attention as att

    worst = {"dkv": 0.0, "dq": 0.0}
    for d in (128, 256):
        for s in (40, 512, 544, 1000, 1024, 2049):
            qkv, mask, cot = _flash_case(2, s, d, seed=s + d)
            args = _bwd_inputs(qkv, mask, cot)
            dk, dv = att.flash_bwd_dkv(*args)
            dq = att.flash_bwd_dq(*args)
            pk, pv = att.flash_bwd_dkv_plain(*args)
            pq = att.flash_bwd_dq_plain(*args)
            got = _grads(att.flash_attention, qkv, mask, cot)
            want = _grads(att.attention_plain, qkv, mask, cot)
            torch.cuda.synchronize()
            for a, b_ in ((dk, pk), (dv, pv), (dq, pq), *zip(got, want)):
                torch.testing.assert_close(a, b_, **B34_TOL)
            dkv = max((dk - pk).abs().max().item(),
                      (dv - pv).abs().max().item())
            worst["dkv"] = max(worst["dkv"], dkv)
            worst["dq"] = max(worst["dq"], (dq - pq).abs().max().item())
            auto = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
            print(f"B3/B4 D={d} S={s}: max|d(dk,dv)| vs plain {dkv:.3e}, "
                  f"max|d dq| {worst['dq']:.3e}, grads vs autograd of the "
                  f"plain attention {auto:.3e}")
    timing = {}
    for d in (256, 128):
        qkv, mask, cot = _flash_case(1, 1024, d, seed=d)
        args = _bwd_inputs(qkv, mask, cot)
        t = compare_ms({
            "dkv": lambda: att.flash_bwd_dkv(*args),
            "dkv_plain": lambda: att.flash_bwd_dkv_plain(*args),
            "dq": lambda: att.flash_bwd_dq(*args),
            "dq_plain": lambda: att.flash_bwd_dq_plain(*args),
            "route": lambda: _grads(att.flash_attention, qkv, mask, cot),
            "route_plain": lambda: _grads(att.attention_plain, qkv, mask,
                                          cot)})
        print(f"B3/B4 at [1, 1024, 4, {d}]: B3 {fmt_ms(t['dkv'])}, plain "
              f"{fmt_ms(t['dkv_plain'])}; B4 {fmt_ms(t['dq'])}, plain "
              f"{fmt_ms(t['dq_plain'])}; forward+backward, kernel route "
              f"{fmt_ms(t['route'])}, plain route {fmt_ms(t['route_plain'])}")
        timing.setdefault(d, {k: v[0] for k, v in t.items()})
    for d in (256, 128):  # the hour step's shapes, one B3 launch each
        qkv, mask, cot = _flash_case(1, 7168, d, seed=d)
        mask.fill_(1.0)
        args = _bwd_inputs(qkv, mask, cot)
        dk, dv = att.flash_bwd_dkv(*args)
        pk, pv = att.flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(dk, pk, **B34_TOL)
        torch.testing.assert_close(dv, pv, **B34_TOL)
        del dk, dv, pk, pv
        t = compare_ms({"dkv": lambda: att.flash_bwd_dkv(*args),
                        "dkv_plain": lambda: att.flash_bwd_dkv_plain(*args)},
                       iters=5)
        print(f"B3 at [1, 7168, 4, {d}]: kernel {fmt_ms(t['dkv'])}, plain "
              f"{fmt_ms(t['dkv_plain'])}")
    t = timing[256]
    return ({"max_abs_err": worst["dkv"], "ms": t["dkv"],
             "plain_ms": t["dkv_plain"]},
            {"max_abs_err": worst["dq"], "ms": t["dq"],
             "plain_ms": t["dq_plain"]})


def _write_feature_cache(cache_dir: str, n: int, seed: int) -> None:
    """``n`` videos of 600-1000 shots at 4096 / 296 dims, seeded."""
    import numpy as np

    from avsum_torch.data import FeatureCache

    rng = np.random.default_rng(seed)
    cache = FeatureCache(cache_dir)
    for i in range(n):
        s = int(rng.integers(600, 1001))
        ends = np.cumsum(rng.integers(30, 300, s))
        bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
        cache.put(f"hour_{i}", rng.standard_normal((s, 4096), np.float32),
                  rng.standard_normal((s, 296), np.float32), bounds, 30.0,
                  int(ends[-1]))


def _train_counts():
    from avsum_torch.ops import attention as att

    return {"flash_fwd": att.flash_attention.launches,
            "flash_bwd_dkv": att.flash_bwd_dkv.launches,
            "flash_bwd_dq": att.flash_bwd_dq.launches}


def _reset_train_counts() -> None:
    from avsum_torch.ops import attention as att

    att.flash_attention.launches = 0
    att.flash_bwd_dkv.launches = 0
    att.flash_bwd_dq.launches = 0


def run_train(tmp: str) -> dict:
    """``train`` at the hour_scale widths through the CLI, 2 epochs, then
    ``--resume`` for a third; -> summed launch counts of both runs."""
    import numpy as np

    from avsum_torch.cli.main import main
    from avsum_torch.train.checkpoint import CheckpointManager

    _write_feature_cache(f"{tmp}/cache", 4, seed=11)
    log_path = f"{tmp}/train.jsonl"
    sets = ["mesh.seq=1", f"data.cache_dir={tmp}/cache",
            f"train.checkpoint_dir={tmp}/ckpt", f"train.log_path={log_path}",
            "train.warmup_steps=2", "train.log_every=1"]

    def cli(epochs: int, *extra: str) -> dict:
        args = [a for x in sets + [f"train.epochs={epochs}"]
                for a in ("--set", x)]
        _reset_train_counts()
        t0 = time.perf_counter()
        rc = main(["train", "--config", HOUR_CONFIG, "--device", "cuda",
                   *extra, *args])
        counts = _train_counts()
        print(f"train {list(extra)} to epoch {epochs}: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        if rc != 0 or min(counts.values()) <= 0:
            raise AssertionError(f"train did not run all three kernels: "
                                 f"rc {rc}, {counts}")
        return counts

    first = cli(2)
    records = [json.loads(line) for line in open(log_path)]
    steps = CheckpointManager(f"{tmp}/ckpt").steps()
    losses = np.array([r["loss"] for r in records])
    if len(records) != 8 or steps[-1] != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"train: {len(records)} steps logged, "
                             f"checkpoints {steps}, losses {losses}")
    dt = np.diff([r["time"] for r in records])[1:]
    print(f"train: losses {np.round(losses, 5).tolist()}, checkpoints "
          f"{steps}, warm step {1e3 * np.median(dt):.1f} ms (median of "
          f"{len(dt)}; host clock, each step synchronized by its logging)")
    resumed = cli(3, "--resume")
    more = [json.loads(line) for line in open(log_path)][len(records):]
    if not more or more[0]["epoch"] != 2 or more[0]["step"] != 9:
        raise AssertionError(f"--resume did not start at epoch 2: {more[:1]}")
    print(f"resume: {len(more)} steps from step {more[0]['step']} at epoch "
          f"{int(more[0]['epoch'])}, loss {more[-1]['loss']:.5f}")
    return {k: first[k] + resumed[k] for k in first}


def compare_train_step() -> None:
    """The hour_scale train step on the card against the CPU: the same
    parameters and batch (S = 600, a padded tail), dropout 0, lr 1e-4
    from the second step on."""
    import copy

    import numpy as np
    import torch

    from avsum_torch.models.scorer import make_model
    from avsum_torch.train import steps
    from avsum_torch.train.config import load_config

    cfg = load_config(HOUR_CONFIG, ["mesh.seq=1", "model.dropout=0",
                                    "train.warmup_steps=1"])
    rng = np.random.default_rng(3)
    s = 600
    mask = np.ones((1, s), np.float32)
    mask[0, 560:] = 0.0
    batch = {"visual": rng.standard_normal((1, s, 4096), np.float32),
             "audio": rng.standard_normal((1, s, 296), np.float32),
             "targets": rng.random((1, s), np.float32) * mask, "mask": mask}
    cpu_model = make_model(cfg.model, seed=0)
    runs = {}
    for dev, model in (("cuda", copy.deepcopy(cpu_model).cuda()),
                       ("cpu", cpu_model)):
        b = steps.batch_to_device(batch, dev)
        state = steps.create_train_state(model, cfg.train, total_steps=100)
        model.train()
        loss = steps.masked_mse(model(b["visual"], b["audio"], b["mask"]),
                                b["targets"], b["mask"])
        grads = torch.autograd.grad(loss, state.optimizer.params)
        step = steps.make_train_step(model, seed=0)
        losses = [float(step(state, b)[1]["loss"]) for _ in range(3)]
        runs[dev] = (losses, [g.cpu() for g in grads],
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(l_card, l_cpu))
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(g_card, g_cpu))
    worst = max(p_cpu, key=lambda k: (p_card[k] - p_cpu[k]).abs().max())
    param_err = (p_card[worst] - p_cpu[worst]).abs().max().item()
    moved = max((p_cpu[k] - v).abs().max().item()
                for k, v in make_model(cfg.model, seed=0).state_dict().items())
    print(f"train step card vs CPU: losses {l_card} / {l_cpu}, max|dloss| "
          f"{loss_err:.2e}, max grad error / max|g| {grad_err:.2e}, params "
          f"after 3 steps max|d| {param_err:.2e} in {worst} (moved up to "
          f"{moved:.2e})")
    if loss_err > PARAM_TOL or grad_err > GRAD_TOL or param_err > PARAM_TOL:
        raise AssertionError("the card's train step disagrees with the CPU's")


def hour_step() -> None:
    """One train step at S = 7168 with remat, hidden 512 (dropout on)."""
    import numpy as np
    import torch

    from avsum_torch.models.scorer import make_model
    from avsum_torch.train import steps
    from avsum_torch.train.config import load_config

    cfg = load_config(HOUR_CONFIG, ["mesh.seq=1", "model.remat=true"])
    s = 7168
    rng = np.random.default_rng(0)
    batch = steps.batch_to_device({
        "visual": rng.standard_normal((1, s, 4096), np.float32),
        "audio": rng.standard_normal((1, s, 296), np.float32),
        "targets": rng.random((1, s), np.float32),
        "mask": np.ones((1, s), np.float32)}, "cuda")
    model = make_model(cfg.model, seed=0).cuda()
    state = steps.create_train_state(model, cfg.train, total_steps=100)
    step = steps.make_train_step(model, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    float(step(state, batch)[1]["loss"])
    first = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = float(step(state, batch)[1]["loss"])
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"hour step [1, {s}] remat: first {first * 1e3:.1f} ms, warm "
          f"{[round(t * 1e3, 1) for t in times]} ms, loss {loss:.5f}, peak "
          f"device memory {peak:.2f} GiB")
    if not np.isfinite(loss):
        raise AssertionError(f"hour step loss {loss}")


def _video(stem: str, n_scenes: int, height: int, width: int,
           scene_len: tuple, seed: int) -> None:
    from avsum_torch.io import write_scene_video

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
    from avsum_torch.io import load_audio_mono_16k_ship

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
    from avsum_torch.io import load_audio_mono_16k_ship
    from avsum_torch.train.config import load_config

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
        n_train = run_train(tmp)

    k1 = check_k1(k1_samples)
    k2 = check_k2(s_pad)
    b3, b4 = check_b34()
    compare_train_step()
    hour_step()
    kernels = [
        {"name": "melspec", "route": "cuda",
         "source": "avsum_torch/csrc/melspec.cu",
         "replaces": "avsum_tpu/ops/pallas_melspec.py:39",
         "launches": n_short["melspec"] + n_many["melspec"], **k1},
        {"name": "flash_fwd", "route": "cuda",
         "source": "avsum_torch/csrc/flash_fwd.cu",
         "replaces": "avsum_tpu/ops/attention.py:42",
         "launches": (n_short["flash_fwd"] + n_many["flash_fwd"]
                      + n_train["flash_fwd"]), **k2},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "avsum_torch/csrc/flash_bwd.cu",
         "replaces": "avsum_tpu/ops/attention.py:173",
         "launches": n_train["flash_bwd_dkv"], **b3},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "avsum_torch/csrc/flash_bwd.cu",
         "replaces": "avsum_tpu/ops/attention.py:221",
         "launches": n_train["flash_bwd_dq"], **b4},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
