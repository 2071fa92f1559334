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
   ``--resume`` for a third: K2 and the backward must run, the loss must be
   finite, the checkpoint written and the resumed run start at epoch 2;
6. each kernel against its plain PyTorch version on the card, float32
   with TF32 off, on fixed cases and at the shapes the runs gave it (K1
   also at 64 mel bands and on a quiet waveform; K2 and the backward also
   at the hour step's S = 7168; K2 also at the train run's S = 1024 and
   at S = 63, 64, 65, 127 and 129 in both its block sizes, around its
   64-key tiles, with its tiling held to the library's; the backward
   also at S = 63, 64, 65, 127 and 129, around its 64-key blocks and
   64-query tiles, with its tiling held to the library's and the clusters
   the card runs at once), with CUDA-event times of both at those
   shapes, taken in turns over 5 rounds (median, min-max), beside each
   kernel's bound (:func:`bound`) and the time of the one PyTorch call
   that computes the same function (SDPA's efficient attention for K2,
   its backward for the backward kernel; none for K1); the flash
   backward also against autograd of the plain attention; K2 and the
   backward also at latent attention's q/k 192, v 128 on the same cases,
   and timed at the decoder's [1, 7168, 16, 192 / 128] beside the same
   inputs zero-padded to 256 through the square kernels (the route the
   decoder took before the kernels took (192, 128)); the Linear GEMM
   through its wrapper on the forward, dX and dW of each main-path Linear
   against float64 (``check_linear``), then timed there and at smaller
   shapes (``time_linear``) beside its plain version, cuBLAS at
   "highest" and the bound counting 3xTF32's passes and each FLOP once,
   with the route's choice at each; Kimi Delta Attention's kernel
   (``csrc/kda.cu``) at the hybrid decoder's [1, 7168, 32, 128]: its
   forward and backward passes over chunks, on chunks made from keys and
   gates as the layer draws them, against their plain version
   (``pass_plain``), then timed in turns with it beside the bound, and
   ``chunk_kda`` against the benchmark reference's token recurrence in
   float64, forward and every input gradient (``check_kda``);
7. one hour-scale train step on the card against the same step on the
   CPU (same parameters and batch, dropout 0): loss, every gradient and
   the parameters after 3 steps;
8. one train step at S = 7168 with remat (``scripts/bench_train_hour.py``'s
   shape): its time, peak device memory, and the device time of two
   steps by kernel (K2, the backward, cuBLAS, the rest and its largest
   kernels; torch.profiler); then one train step of
   ``configs/torch/kimi_linear_hour.yaml`` at S = 7168 (the hybrid
   decoder: the KDA kernel, latent attention, the experts), its time,
   peak memory and the KDA kernel's launches (``kda_step``);
9. the dataset path through the CLI at the ``configs/summe.yaml`` widths
   (those of phase 3), on a directory of the phase 3 and 4 videos and
   three more, with SumMe-shaped ground truth of five users each:
   ``preprocess`` (K1 once a video, the cache [S, 4096] / [S, 296] and
   finite, the short video's entry equal to phase 3's features; a second
   sweep launches nothing); the classic path (the pure-NumPy Y4M reader,
   the device shot detector) on the short video against the fast path,
   and the detector's scores on the card against the CPU's; ``splits
   --kfold``; ``train --splits --fold 0`` for 2 epochs; ``evaluate
   --canonical`` over the five videos (K2 runs: the 533-shot video's
   ladder reaches S = 1024); ``summarize DIR`` and ``summarize --render``
   with the trained scorer;
10. serving, at the phase 3 widths and weights: (a) the device-resident
   summarize against the materializing path on the short and the long
   video (K1 on both, K2 on the long one, whose 533 shots both paths pad
   to 544), and the device's busy share in a profiled run of the
   long one; (b) frame dedup on the short video against none; (c) a
   ``SummarizeServer`` on a free local port answering two bursts of 6
   concurrent requests and an upload, each equal to ``summarize`` of its
   video, with latencies beside the same videos summarized one after
   another; (d)
   the scorer exported on the card and scored in a process where
   ``avsum_torch`` cannot be imported, against the eager scorer (K2), and
   one request to ``serve --artifact``; (e) the knapsack DP on the card at
   3200 shots x capacity 16200 against the NumPy DP;
11. BASELINE config 4, the upgraded encoders, at the phase 3 widths and
   seed: (a) ``summarize`` of the short video (twice) and the long one
   with the ViT-B/16 backbone (768 wide, 12 layers, 12 heads, class
   token), the large audio encoder, cross fusion and the MoE encoder at
   ``configs/moe_ep.yaml``'s widths (hidden 512, 8 experts, top 2, 2
   layers): K1 on every call, scores against the CPU's plain path, the
   summary within budget; (b) ``summarize`` of the long video with the
   ResNet50-only backbone, the TCN encoder and self fusion, whose fusion
   attention at S = 544 runs K2; (c) ``train`` through the CLI with
   ``configs/moe_ep.yaml`` and then ``configs/deep_pp.yaml`` (12 blocks in
   4 stages, hidden 512) at ``--set mesh.data=1 --set mesh.model=1`` on a
   synthetic cache of 32 videos (``max_shots`` 128, batch 8), 2 epochs
   then ``--resume``, and one step of each against the CPU's; (d) one
   ``configs/hour_scale.yaml`` step at S = 7168 with
   ``model.use_pallas=false`` (the fusion attention chunked) and its peak
   memory; (e) the (a) scorer exported by ``export`` in a background
   process started before phase 3, reloaded and scored against the
   eager scorer. Each wall, stage second and peak memory is printed on a
   line of its own after the card's line;
12. the shipped mesh configs, each rank a spawned process on the card
   (several ranks share one card over gloo, the transport staging its
   tensors through pinned host memory): (a) ``configs/hour_scale.yaml``
   at its own seq 4 mesh and widths: 3 steps at S = 7168 with remat
   through ring attention (each rank's step time and peak memory beside
   phase 8's flash step), and 3 steps at S = 1024, dropout 0, against
   one process on the card; (b) the same at ``mesh.seq=1 mesh.data=2``,
   S = 1024, where K2 and the backward must run on each rank; (c)
   ``configs/moe_ep.yaml`` and (d) ``configs/deep_pp.yaml`` at their own
   2 x 4 meshes and widths, 3 steps against one process, each rank
   holding a quarter of the experts or one stage of four; (e) ``train``
   with hour_scale.yaml under ``python -m torch.distributed.run
   --nproc-per-node 4`` (2 epochs, ``--resume``) and ``evaluate`` there
   and in one process from the same checkpoint; (f) the NCCL backend at
   a world of as many ranks as the machine has cards (one step of (b)'s
   config). The mesh runs are held by ``compare_train_step``'s rule
   (parameters to 3e-4 behind the ring, JAX's bound);
13. tensor parallelism over ``model`` and the tools: (a)
   ``configs/hour_scale.yaml``'s widths at data 1 x model 2 with the
   state placed by ``shard_state`` and stepped with ``state_sharding``:
   3 steps at S = 7168 with remat (K2 and the backward on each rank), then 3
   at S = 1024, dropout 0, at seq 2 x model 2, each against one process
   by ``compare_train_step``'s rule, with each rank's step time, peak
   memory and parameter bytes against the replicated placement's; (b)
   ``configs/moe_ep.yaml`` at its 2 x 4 mesh under ``state_sharding``, 3
   steps on phase 12 (c)'s batch, against phase 12 (c)'s losses and its
   one process; (c) ``trace_to`` around a warm summarize of the long
   video: the trace holds the JAX package's span names of the fast path
   and K1's and K2's launches, and the device's busy share is printed;
   (d) ``debug_nans`` raising on a NaN injected into a scorer forward
   on the card and on one made in a backward, ``checked`` passing a
   clean forward; (e) ``dtw_cost_device`` at 2000 x 600 on the card
   against ``dtw_host``;
14. the measurement entry points and the JAX package's weight files: (a)
   ``python -m avsum_torch.bench e2e`` on ``bench.py``'s 640x360 clip (25
   scenes, written in a process started before phase 3), its JSON line
   printed: a positive ``e2e_video_fps``, K1 on every timed run (each run's
   segments equal to the cold run's, or the bench fails), the fresh
   process's ``warm_probe``; (b) ``python -m avsum_torch.bench train-hour
   --mode chip``: the S = 7168 step with and without remat, finite losses,
   K2 and the backward launched in each; (c) ``visual.weights`` naming the JAX
   package's msgpack file of the tiny backbone with bfloat16 leaves
   (``tests/fixtures``), read without the ``msgpack`` package: summarize of
   the phase 3 video (encoders in float32) against the CPU's plain path
   from the same file and against ``--weights`` made by ``convert
   --visual`` from it (the same weights; scores to SCORE_TOL, equal
   segments).
15. the F1-parity harness and the compressed-media path: (a) ``python -m
   avsum_torch.bench parity --quick --dataset both --device cuda`` in a
   subprocess: the quick TVSum and SumMe worlds preprocessed on the card
   (K1 once a video: the default audio config's n_fft 400 = 2 x hop 200),
   the reference arm trained on the CPU and the port's BiLSTM and
   attention scorers on the card; each dataset's rows and verdicts
   printed, every F1 finite in [0, 1], ``PARITY_F1_TORCH.{json,md}``
   written; (b) where OpenCV and the bundled ffmpeg's AAC encoder are
   present (else one line says which is missing and nothing more runs):
   the dress rehearsal through the CLI on the card over 3 small mp4 files
   (an mp4v video track, an AAC audio track, SumMe-shaped ground truth):
   ``preprocess`` through the classic path (its stage names in the
   sweep's log, K1 once a video, finite features), ``splits --kfold``,
   ``train --splits --fold 0``, ``evaluate --canonical`` (F1 in [0, 1]).
16. the JAX side's experiment scripts as bench commands, each in a
   subprocess on the card, and deep_pp.yaml under ``state_sharding``: (a)
   ``bench ppep`` at full width (hidden 512; deep_pp's 12 blocks in 4
   stages, moe_ep's 8 experts, top 2) on a 10-video parity world, 3
   epochs, one seed, with ``--mesh-one`` and at the contenders' own
   meshes (8 gloo ranks sharing the card) on the same world: every F1
   in [0, 1], the same parameter counts in both placements, K1 once a
   world video; (b)
   ``bench pp-equality 3`` on 8 ranks: every parameter of the GPipe run
   within 5e-5 of the data mesh's; (c) ``bench deep-pp-curve --epochs 20
   --eval-every 10`` on (a)'s world: two finite points and the schedule
   it ran; (d) ``bench embed-sweep`` of the dual bf16 backbone at ship
   304 (batches 128 and 256, each backbone alone at 128); (e) ``bench
   embed-ab --batches 256,512 --rounds 2`` on phase 14's clip, identical
   segments at both batches; (f) ``configs/deep_pp.yaml`` at its 2 x 4
   mesh under ``state_sharding``, 3 steps against phase 12 (d)'s losses
   and its one process by ``compare_train_step``'s rule, each rank's
   parameter bytes against the computed 82,177,540. (b) runs in the
   background during (a)'s one-process run and (c), which time nothing.

Launch counts are reset just before each run of phases 3-5, 9-11, 12 (b),
13 (a) (in each rank) and (c), 14 (the bench's timed runs and steps,
in its process, and (c)'s summarize on the card), 15 (the parity
worlds' preprocess, in its process, and each command of (b)) and 16 (the
ppep and curve worlds' preprocess and the A/B's timed summarizes, each in
its process), and read just after it;
the KDA kernel's are reset just before phase 8's hybrid step and read
after it; the comparisons of phases 6-8 and 11 (c)-(e), 10 (d)'s eager scorer and
the one-process runs of phases 12 and 13 are not counted.

The last three lines are the kernels' JSON, the card's nvidia-smi line
and ``{"ok": true, "device": {...}}``. Exits non-zero, with no result,
when there is no CUDA device or no checkout beside the script.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import logging
import math
import multiprocessing
import os
import signal
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
KIMI_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "torch", "kimi_linear_hour.yaml")
# the KDA kernel against its plain version, and chunk_kda against the
# float64 recurrence: float32 sums of 64 or 128 products in other orders,
# relative to the largest entry (one TF32 pass errs ~1e-3)
KDA_TOL = 1e-5
SUMME_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "summe.yaml")
FEATURE_TOL = dict(rtol=1e-3, atol=1e-3)  # preprocess vs summarize features
DEDUP_COS = 0.98  # dedup vs none, per-shot cosine (tests/test_dedup.py)
DEDUP_THRESHOLD = 12.0  # mean |d luma| (tests/test_dedup.py's moderate one)
KNAPSACK_RTOL = 1e-6  # device (float32) vs NumPy (float64) DP total value
SEED = 0  # the random weights of phases 3, 4, 9, 10 and 11
MOE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "moe_ep.yaml")
DEEP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "deep_pp.yaml")
# phase 11 (a): ViT-B/16, the large audio encoder, cross fusion and the
# MoE encoder at moe_ep.yaml's widths, over tvsum.yaml
CONFIG4_A = ["visual.backbone=vit", "visual.vit_variant=b16",
             "audio.encoder=large", "model.fusion=cross",
             "model.temporal_encoder=moe", "model.moe_experts=8",
             "model.moe_topk=2", "model.temporal_layers=2"]
# phase 11 (b): ResNet50 alone, the TCN encoder, self fusion
CONFIG4_B = ["visual.backbone=resnet50", "model.temporal_encoder=tcn"]
ONE_DEVICE = ["mesh.data=1", "mesh.model=1"]
MOVE_SHOTS = 64  # shots scored by the artifact moved to the CPU
SHOT_TOL = 1e-3  # device shot scores, card vs CPU
CLASSIC_CORR = 0.98  # classic vs fast path features (the JAX test's bound)
# NVIDIA H100 SXM, dense (data sheet): TF32 tensor-core rate, HBM3 rate
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12


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


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for work of ``flops`` float32
    flops (counted once) that must move ``nbytes`` (each input read once,
    each output written once): the larger of the flops in 3xTF32, three
    TF32 products each (one pass misses the kernels' float32 tolerances),
    at the dense TF32 peak, and the bytes at the HBM rate."""
    ops_ms = 3 * flops / TF32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_bound(b: int, s: int, h: int, d: int, products: int,
                    in_rows: int, out_rows: int) -> dict:
    """Bound of a flash kernel at [b, s, h, d]: ``products`` S x S x D
    products per head; ``in_rows`` and ``out_rows`` [B, S, H, D] tensors
    read and written, plus the [B, S] mask and two [B, H, S] row vectors
    (at unequal widths: :func:`latent_bound`)."""
    flops = 2 * products * b * h * s * s * d
    nbytes = 4 * ((in_rows + out_rows) * b * s * h * d + b * s + 2 * b * h * s)
    return bound(flops, nbytes)


def latent_bound(b: int, s: int, h: int, dqk: int, dv: int,
                 backward: bool) -> dict:
    """Bound of K2 (q, k, v read, out written: Q K^T at Dqk, P V at Dv) or
    of the backward (q, k, v, dO read, dq, dk, dv written: S, dK and dQ at
    Dqk, dP and dV at Dv) at q/k width ``dqk`` and v width ``dv``."""
    if backward:
        cols, io = 3 * dqk + 2 * dv, 4 * dqk + 3 * dv
    else:
        cols, io = dqk + dv, 2 * dqk + 2 * dv
    flops = 2 * b * h * s * s * cols
    return bound(flops, 4 * (io * b * s * h + b * s + 2 * b * h * s))


def melspec_bound(samples: int, n_mels: int, n_fft: int = 400,
                  hop: int = 200) -> dict:
    """K1's bound: the windowed DFT (cos and sin of n_fft / 2 + 1 bins) and
    the mel product of every frame; the waveform read, mel and log-mel
    written."""
    frames, bins = 1 + samples // hop, n_fft // 2 + 1
    flops = 2 * frames * bins * (2 * n_fft + n_mels)
    return bound(flops, 4 * (samples + 2 * frames * n_mels))


def sdpa_inputs(q, k, v, mask, requires_grad: bool = False):
    """[B, H, S, D] transposes of q, k, v (leaves when ``requires_grad``)
    and the key bias as a [B, 1, 1, S] float mask, for the library call."""
    import torch

    from avsum_torch.ops.attention import NEG_INF

    qt, kt, vt = (x.detach().clone().transpose(1, 2).requires_grad_(
        requires_grad) for x in (q, k, v))
    bias = torch.where(mask.bool(), 0.0, NEG_INF)[:, None, None, :]
    return qt, kt, vt, bias


def sdpa(qt, kt, vt, bias):
    """The one PyTorch call that computes K2's function, pinned to the
    float32 memory-efficient backend; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)


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
                    # no one PyTorch call computes the fused log-mel
                    timing = {"ms": t["kernel"][0], "plain_ms": t["plain"][0],
                              **melspec_bound(x.numel(), n_mels),
                              "library_ms": None}
    print(f"K1 bound at {max(path_samples)} samples: {timing['bound_ms']:.4f} "
          f"ms ({timing['bound_by']}); library call: none")
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


def _latent_case(b: int, s: int, h: int, seed: int):
    """q, k [B, S, H, 192] (strided views of one tensor), v [B, S, H, 128]
    (the second half of a [.., 256] tensor, as latent attention's kv_b
    projection hands it), :func:`_flash_case`'s mask and a [B, S, H, 128]
    cotangent zeroed at masked queries."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qk = torch.randn(b, s, 2, h, 192, device="cuda", generator=g)
    kv = torch.randn(b, s, h, 256, device="cuda", generator=g)
    mask = torch.ones(b, s, device="cuda")
    mask[0, s - s // 5:] = 0.0
    if b > 1:
        mask[1] = 0.0
    cot = torch.randn(b, s, h, 128, device="cuda", generator=g)
    q, k = qk.unbind(2)
    return (q, k, kv[..., 128:]), mask, cot * mask[:, :, None, None]


def _pad256(*ts):
    """Each tensor zero-padded on its last axis to 256, contiguous: the
    route the decoder took at q/k 192, v 128 before the kernels took
    those widths (q also scaled by (256 / 192)^1/2 by the caller)."""
    import torch.nn.functional as F

    return [F.pad(t, (0, 256 - t.shape[-1])) for t in ts]


def check_k2(path_seq: int) -> dict:
    """K2 against its plain version on fixed cases (S around its 64-key
    tile, in both block sizes) and at the timed shapes; its tiling against
    the library's; times per launch of K2, its plain version and the
    library call at the path's [1, S, 4, 256], the train run's
    [1, 1024, 4, D] and the hour step's [1, 7168, 4, D]."""
    import torch

    from avsum_torch.ops import attention as att
    from avsum_torch.ops.attention import (
        attention_fwd_plain,
        attention_plain,
        flash_attention_fwd,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dqk, dv in att.KERNEL_HEAD_DIMS:
        att._checked_fwd_lib(dqk, dv)
        for rows in att.FWD_ROWS:
            print(f"K2 layout at (Dqk, Dv) = ({dqk}, {dv}), {rows} queries "
                  f"a block: {att.fwd_layout(dqk, dv, rows)} (the library's)")
    worst = 0.0
    for d in (128, 256):
        for b, s in sorted({(2, 40), (1, 544), (2, 512), (2, 544), (1, 1024),
                            (2, 1000), (1, path_seq), (2, path_seq),
                            (2, 63), (2, 64), (2, 65), (2, 127), (2, 129),
                            (17, 127), (11, 129)}):
            qkv, mask, _ = _flash_case(b, s, d, seed=s + d)
            q, k, v = qkv.unbind(2)
            out, lse = flash_attention_fwd(q, k, v, mask)
            ref, ref_lse = attention_fwd_plain(q, k, v, mask)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **K2_TOL)
            torch.testing.assert_close(lse, ref_lse, **K2_TOL)
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            print(f"K2 D={d} [{b}, {s}] ({att.fwd_rows(b, s, 4, sms)}-query "
                  f"blocks): max|dout| {err:.3e}, max|dlse| "
                  f"{(lse - ref_lse).abs().max().item():.3e}")
    for b, s in ((2, 40), (1, 544), (2, 512), (2, 1000), (2, 63), (2, 64),
                 (2, 65), (2, 127), (2, 129), (17, 127), (11, 129)):
        (q, k, v), mask, _ = _latent_case(b, s, 4, seed=s + 192)
        out, lse = flash_attention_fwd(q, k, v, mask)
        ref, ref_lse = attention_fwd_plain(q, k, v, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **K2_TOL)
        torch.testing.assert_close(lse, ref_lse, **K2_TOL)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        print(f"K2 (192, 128) [{b}, {s}] ({att.fwd_rows(b, s, 4, sms)}-query "
              f"blocks): max|dout| {err:.3e}, max|dlse| "
              f"{(lse - ref_lse).abs().max().item():.3e}")
    time_k2_latent()
    result = {}
    for s, d, iters in ((path_seq, 256, 20), (1024, 256, 20), (1024, 128, 20),
                        (7168, 256, 5), (7168, 128, 5)):
        qkv, mask, _ = _flash_case(1, s, d, seed=7)
        q, k, v = qkv.unbind(2)
        out, lse = flash_attention_fwd(q, k, v, mask)
        ref, ref_lse = attention_fwd_plain(q, k, v, mask)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, **K2_TOL)
        torch.testing.assert_close(lse, ref_lse, **K2_TOL)
        worst = max(worst, (out - ref).abs().max().item())
        del out, lse, ref, ref_lse
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v, mask),
               "plain": lambda: attention_plain(q, k, v, mask)}
        lib = sdpa_inputs(q, k, v, mask)
        try:
            lib_err = (sdpa(*lib).transpose(1, 2)
                       - attention_plain(q, k, v, mask)).abs().max().item()
            fns["library"] = lambda: sdpa(*lib)
            lib_note = f"max|d| vs plain {lib_err:.3e}"
        except RuntimeError as e:
            lib_note = f"no fused backend: {str(e).splitlines()[0]}"
        t = compare_ms(fns, iters=iters)
        bnd = attention_bound(1, s, 4, d, products=2, in_rows=3, out_rows=1)
        library = (f"{fmt_ms(t['library'])}, {t['library'][0] / t['kernel'][0]:.3f}"
                   f"x the kernel's" if "library" in t else "none")
        print(f"K2 at [1, {s}, 4, {d}] ({att.fwd_rows(1, s, 4, sms)}-query "
              f"blocks): kernel {fmt_ms(t['kernel'])}, plain "
              f"{fmt_ms(t['plain'])}, library (SDPA, efficient attention) "
              f"{library} ({lib_note}), bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; {bnd['bound_ms'] / t['kernel'][0]:.1%})")
        if not result:
            result = {"ms": t["kernel"][0], "plain_ms": t["plain"][0], **bnd,
                      "library_ms": t["library"][0] if "library" in t
                      else None}
        del qkv, q, k, v, lib
    return {"max_abs_err": worst, **result}


def time_k2_latent(s: int = 7168, h: int = 16, iters: int = 5) -> dict:
    """K2 at the decoder's [1, S, H, 192 / 128] against its plain version
    (once, to the tolerance), timed in turns with its plain version and
    the same inputs padded to 256 through the square kernel (the kernel
    alone, and the route: the pads, the kernel and the output's slice) ->
    their (median, min, max) ms."""
    import torch

    from avsum_torch.ops import attention as att

    (q, k, v), mask, _ = _latent_case(1, s, h, seed=192)
    mask.fill_(1.0)
    out, lse = att.flash_attention_fwd(q, k, v, mask)
    ref, ref_lse = att.attention_fwd_plain(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **K2_TOL)
    torch.testing.assert_close(lse, ref_lse, **K2_TOL)
    err = (out - ref).abs().max().item()
    del out, lse, ref, ref_lse
    scale = (256 / 192) ** 0.5
    padded = _pad256(q * scale, k, v)

    def route():
        qp, kp, vp = _pad256(q * scale, k, v)
        return att.flash_attention_fwd(qp, kp, vp, mask)[0][..., :128]

    t = compare_ms({"native": lambda: att.flash_attention_fwd(q, k, v, mask),
                    "padded": lambda: att.flash_attention_fwd(*padded, mask),
                    "padded_route": route,
                    "plain": lambda: att.attention_plain(q, k, v, mask)},
                   iters=iters)
    bnd = latent_bound(1, s, h, 192, 128, backward=False)
    print(f"K2 at [1, {s}, {h}, 192 / 128] ({att.fwd_rows(1, s, h, 132)}-"
          f"query blocks): native {fmt_ms(t['native'])}, padded to 256 "
          f"{fmt_ms(t['padded'])} (route with pads and slice "
          f"{fmt_ms(t['padded_route'])}), "
          f"{t['padded'][0] / t['native'][0]:.3f}x the native; plain "
          f"{fmt_ms(t['plain'])}; max|dout| "
          f"{err:.3e}; bound at the true widths {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}; native {bnd['bound_ms'] / t['native'][0]:.1%},"
          f" padded {bnd['bound_ms'] / t['padded'][0]:.1%})")
    return t


def time_bwd_latent(s: int = 7168, h: int = 16, iters: int = 5) -> dict:
    """The backward at the decoder's [1, S, H, 192 / 128] against its plain
    version (once, to the tolerance), timed in turns with its plain
    version and the same inputs padded to 256 through the square kernel
    -> their (median, min, max) ms."""
    import torch

    from avsum_torch.ops import attention as att

    (q, k, v), mask, cot = _latent_case(1, s, h, seed=193)
    mask.fill_(1.0)
    out, lse = att.flash_attention_fwd(q, k, v, mask)
    delta = (cot * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, cot, mask, lse, delta)
    got = att.flash_bwd(*args)
    want = att.flash_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, **B34_TOL)
    err = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
    del got, want, out
    qp, kp, vp, dp = _pad256(q * (256 / 192) ** 0.5, k, v, cot)
    out_p, lse_p = att.flash_attention_fwd(qp, kp, vp, mask)
    delta_p = (dp * out_p).sum(-1).transpose(1, 2).contiguous()
    padded = (qp, kp, vp, dp, mask, lse_p, delta_p)
    del out_p
    t = compare_ms({"native": lambda: att.flash_bwd(*args),
                    "padded": lambda: att.flash_bwd(*padded),
                    "plain": lambda: att.flash_bwd_plain(*args)},
                   iters=iters)
    bnd = latent_bound(1, s, h, 192, 128, backward=True)
    print(f"backward at [1, {s}, {h}, 192 / 128]: native "
          f"{fmt_ms(t['native'])} (clusters of 3 the card runs at once: "
          f"{att.bwd_max_clusters(192, 128)}), padded to 256 "
          f"{fmt_ms(t['padded'])}, {t['padded'][0] / t['native'][0]:.3f}x "
          f"the native; plain {fmt_ms(t['plain'])}; max|d(dq,dk,dv)| "
          f"{err:.3e}; bound at the true widths "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; native "
          f"{bnd['bound_ms'] / t['native'][0]:.1%}, padded "
          f"{bnd['bound_ms'] / t['padded'][0]:.1%})")
    return t


# (M, K, N) of the hybrid decoder's Linear products that reach the
# kernel (``kimi_linear_hour``, 7168 shots): the modality Linears (the
# visual one the shape of KDA's o_proj), KDA's q/k/v projections, its
# gates' f_a, f_b and g_a, g_b, the NoPE MLA's q, kv_a and kv_b, the 9216
# SwiGLU, the shared expert, a held expert's gate_up at ~224 rows, the
# fusion over 4608 and the head
HYBRID_LINEAR_SHAPES = (
    (7168, 4096, 2304), (7168, 296, 2304), (7168, 2304, 4096),
    (7168, 2304, 128), (7168, 128, 4096), (7168, 2304, 6144),
    (7168, 2304, 576), (7168, 512, 8192), (7168, 2304, 18432),
    (7168, 9216, 2304), (7168, 2304, 2048), (7168, 1024, 2304),
    (224, 2304, 2048), (7168, 4608, 13824), (7168, 4608, 4608),
    (7168, 4608, 64))
# (M, K, N) of the Linear products of the main path: the decoder's at
# 7168 shots (MLA's projections, the dense SwiGLU, the shared experts, the
# router), a held expert's ~672 rows, the hour cell's Linears, the hybrid
# decoder's; and, for the route's rule, small ones below them
LINEAR_SHAPES = (
    (7168, 2048, 3072), (7168, 2048, 576), (7168, 512, 4096),
    (7168, 2048, 2048), (7168, 2048, 22528), (7168, 11264, 2048),
    (7168, 2048, 5632), (7168, 2816, 2048), (7168, 2048, 64),
    (672, 2048, 2816), (672, 1408, 2048),
    (7168, 4096, 512), (7168, 296, 512), (7168, 512, 1536),
    (7168, 512, 2048), (7168, 2048, 512), (7168, 1024, 3072),
    *HYBRID_LINEAR_SHAPES)
LINEAR_RULE_SHAPES = (
    (64, 512, 512), (128, 512, 512), (256, 512, 512), (544, 512, 512),
    (1024, 512, 512), (2048, 512, 512), (3072, 512, 512), (4096, 512, 512),
    (1024, 1024, 3072), (64, 2048, 64), (7168, 64, 64), (64, 2048, 2816),
    (128, 2048, 2816), (256, 2048, 2816), (128, 1408, 2048),
    (256, 1408, 2048), (384, 1408, 2048))


def check_linear(shapes=LINEAR_SHAPES) -> None:
    """The Linear products through the wrapper (``ops/linear.py``'s
    ``linear``: the route, the autograd Function and ``product``) at each
    main-path (M, K, N) on the card: Y = X W^T, dX = dY W and dW = dY^T X
    against float64. Each must lie within 3 times cuBLAS float32's own
    error against float64 (at least 1e-7 of the largest entry) and at
    least 10 times below one TF32 pass's, as
    ``tests/test_torch_kernels_cuda.py`` holds them; each shape must reach
    the kernel, and launch it once for each product the route gives it."""
    import torch

    from avsum_torch.ops.linear import linear, route

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    misses = []
    for m, k, n in shapes:
        g = torch.Generator(device="cuda").manual_seed(m + 3 * k + 7 * n)
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(n, k, device="cuda", generator=g) / math.sqrt(k)
        dy = torch.randn(m, n, device="cuda", generator=g)
        routes = [route(x.device, torch.float32, *shape) for shape in (
            (m, n, k), (m, k, n, True, False), (n, k, m, False, False))]
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = linear.launches
        y = linear(xl, wl)
        y.backward(dy)
        launched = linear.launches - before
        got = {"Y": y.detach(), "dX": xl.grad, "dW": wl.grad}
        x64, w64, dy64 = x.double(), w.double(), dy.double()
        want = {"Y": x64 @ w64.T, "dX": dy64 @ w64, "dW": dy64.T @ x64}

        def library():
            return {"Y": x @ w.T, "dX": dy @ w, "dW": dy.T @ x}

        f32 = library()
        setting = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            tf32 = library()
        finally:
            torch.set_float32_matmul_precision(setting)
        errs = {key: (rel(got[key], want[key]), rel(f32[key], want[key]),
                      rel(tf32[key], want[key])) for key in want}
        print(f"linear check M {m}, K {k}, N {n}: routes {routes}, "
              f"launches {launched}; error against float64 (kernel or "
              f"route, cuBLAS float32, one TF32 pass): " + ", ".join(
                  f"{key} {e:.2e} / {e32:.2e} / {e19:.2e}"
                  for key, (e, e32, e19) in errs.items()), flush=True)
        if "kernel" not in routes or launched != routes.count("kernel"):
            misses.append((m, k, n, routes, launched))
        misses += [(m, k, n, key, e) for key, (e, e32, e19) in errs.items()
                   if e > 3 * max(e32, 1e-7) or e19 < 10 * e]
        del x, w, dy, xl, wl, y, got, want, f32, tf32, x64, w64, dy64
    if misses:
        raise AssertionError(f"the Linear GEMM missed float64: {misses}")


def time_linear(shapes=LINEAR_SHAPES + LINEAR_RULE_SHAPES,
                iters: int = 5) -> dict:
    """The 3xTF32 GEMM (``ops/linear.py``) on each Linear's three products
    at each (M, K, N): the forward C [M, N] over K, dX [M, K] over N, dW
    [N, K] over M, each timed in turns with its plain version
    (``linear_plain``) and ``torch.matmul`` at "highest" (cuBLAS), beside
    two bounds: :func:`bound`'s, which counts 3xTF32's three passes, and
    the same with each FLOP counted once (the scale of the benchmark's
    rooflines and of ``step_mfu_pct``) -> {(M, K, N, product): times}. The
    kernel runs through ``product`` where the route takes it, and is
    launched directly where the rule leaves the product to cuBLAS, so
    that the rule can be read off these times; its correctness is
    :func:`check_linear`'s."""
    import torch

    from avsum_torch.ops import linear as lin

    out = {}
    for m, k, n in shapes:
        g = torch.Generator(device="cuda").manual_seed(m * 7 + k * 3 + n)
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(n, k, device="cuda", generator=g)
        dy = torch.randn(m, n, device="cuda", generator=g)
        for name, a, a_rows, b, b_rows, lhs, rhs, (mm, nn, kk) in (
                ("fwd", x, True, w, True, x, w.t(), (m, n, k)),
                ("dX", dy, True, w, False, dy, w, (m, k, n)),
                ("dW", dy, False, x, False, dy.t(), x, (n, k, m))):
            takes = lin.kernel_takes(mm, nn, kk, a_rows, b_rows)
            kernel = (functools.partial(lin.product, a, b, a_rows, b_rows)
                      if takes else functools.partial(
                          lin._launch, a, a_rows, b, b_rows, None, mm, nn,
                          kk))
            fns = {"kernel": kernel,
                   "plain": functools.partial(
                       lin.linear_plain, lhs, rhs.t()),
                   "library": functools.partial(torch.matmul, lhs, rhs)}
            t = compare_ms(fns, iters=iters)
            nbytes = 4 * (mm * kk + nn * kk + mm * nn)
            bnd = bound(2 * mm * nn * kk, nbytes)
            once = max(2 * mm * nn * kk / TF32_FLOPS, nbytes / HBM_BYTES)
            out[m, k, n, name] = {"ms": t["kernel"][0],
                                  "plain_ms": t["plain"][0],
                                  "library_ms": t["library"][0], **bnd,
                                  "bound_once_ms": once * 1e3}
            print(f"linear {name} C [{mm}, {nn}] over {kk} (Linear M {m}, "
                  f"K {k}, N {n}; {lin.plan_splits(mm, nn, kk, 132)} "
                  f"parts): kernel {fmt_ms(t['kernel'])}, plain "
                  f"{fmt_ms(t['plain'])}, library {fmt_ms(t['library'])} "
                  f"(x{t['library'][0] / t['kernel'][0]:.2f}), bound "
                  f"{bnd['bound_ms']:.4f} ms counting 3 passes "
                  f"({bnd['bound_by']}; "
                  f"{bnd['bound_ms'] / t['kernel'][0]:.1%}), "
                  f"{once * 1e3:.4f} ms counting each FLOP once "
                  f"({once * 1e3 / t['kernel'][0]:.1%}); the rule: "
                  f"{'kernel' if takes else 'cuBLAS'}", flush=True)
        del x, w, dy
    return out


def _kda_inputs(s: int, h: int, d: int = 128, seed: int = 7) -> tuple:
    """q, k, v, g [1, S, H, d] and beta [1, S, H] on the card, as the KDA
    layer makes them at its init: q and k of unit length (q then times
    d^-1/2), the log decay -A softplus(x - 4) with A in [1, 16] a head
    and x of unit size (-G passes float32's range within a chunk), beta a
    sigmoid."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = F.normalize(randn(1, s, h, d), dim=-1) * d ** -0.5
    k = F.normalize(randn(1, s, h, d), dim=-1)
    v = randn(1, s, h, d)
    a = 1 + 15 * torch.rand(h, generator=gen, device="cuda")
    g = -a[:, None] * F.softplus(randn(1, s, h, d) - 4.0)
    return q, k, v, g, torch.sigmoid(randn(1, s, h))


def kda_pass_bound(a2, base, extra) -> dict:
    """:func:`bound` of one pass of ``csrc/kda.cu`` over chunks a2 [B, H,
    N, C, K] of values base [B, H, N, C, V]: a chunk's two products (X =
    base - a1t^T R, R = gamma R + a2^T X), 4 C K V flops a chunk and head;
    a1t, a2, base, gamma (and the backward's dS, ``extra``) read once, the
    states [.., K, V] and X written once."""
    b, h, n, c, dk = a2.shape
    states = b * h * n * dk * base.shape[-1]
    reads = 2 * a2.numel() + base.numel() + b * h * n * dk + (
        0 if extra is None else extra.numel())
    return bound(4 * states * c, 4 * (reads + states + base.numel()))


def check_kda(s: int = 7168, h: int = 32, iters: int = 5) -> dict:
    """Kimi Delta Attention's kernel (``csrc/kda.cu`` through
    ``ops/kda.py``) at the hybrid decoder's [1, S, H, 128], on
    :func:`_kda_inputs`: the forward pass over chunks (``kda_fwd``) on the
    chunks ``chunk_parts`` makes of them, and the backward's reverse pass
    (``kda_bwd``) on cotangents of unit size, against their plain version
    (``pass_plain``, a torch loop over the chunks), then each timed in
    turns with it beside :func:`kda_pass_bound`; and ``chunk_kda``,
    forward and the gradients of q, k, v, g and beta, against the
    benchmark reference's token recurrence (``benchmark/reference/
    kimi_linear.py``) run in float64. Raises past KDA_TOL of the largest
    entry -> the kernel's entry of the kernels' JSON."""
    import torch

    from avsum_torch.ops import kda
    from benchmark.reference.kimi_linear import kda_recurrence

    def gap(got, want):
        got, want = got.detach().double(), want.detach().double()
        return float((got - want).abs().max() / want.abs().max())

    inputs = _kda_inputs(s, h)
    n = -(-s // kda.CHUNK)
    parts = [kda._chunks(t, n) for t in inputs[:4]]
    parts.append(kda._chunks(inputs[4][..., None], n)[..., 0])
    with torch.no_grad():
        _, _, w, u0, kt, gamma = kda.chunk_parts(*parts)
    del parts
    gen = torch.Generator(device="cuda").manual_seed(8)
    d_u = torch.randn(u0.shape, generator=gen, device="cuda")
    d_states = torch.randn(*kt.shape[:3], kt.shape[-1], u0.shape[-1],
                           generator=gen, device="cuda")
    passes = {
        "forward": (lambda: kda.kda_fwd(w, u0, kt, gamma),
                    lambda: kda.pass_plain(w.transpose(-1, -2), kt, u0, gamma,
                                           None, 1.0, reverse=False),
                    kda_pass_bound(kt, u0, None)),
        "backward": (lambda: kda.kda_bwd(w, kt, gamma, d_states, d_u),
                     lambda: kda.pass_plain(kt.transpose(-1, -2), w, d_u,
                                            gamma, d_states, -1.0,
                                            reverse=True),
                     kda_pass_bound(w, d_u, d_states))}
    misses, out = [], {}
    for name, (kernel, plain, bnd) in passes.items():
        got, want = kernel(), plain()
        err = max(gap(a, b_) for a, b_ in zip(got, want))
        del got, want
        t = compare_ms({"kernel": kernel, "plain": plain}, iters=iters)
        print(f"KDA {name} pass at [1, {s}, {h}, 128] ({n} chunks): kernel "
              f"{fmt_ms(t['kernel'])}, plain {fmt_ms(t['plain'])}; max "
              f"error over the largest entry {err:.3e}; bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; "
              f"{bnd['bound_ms'] / t['kernel'][0]:.1%})", flush=True)
        key = "" if name == "forward" else "bwd_"
        out.update({f"{key}ms": t["kernel"][0],
                    f"{key}plain_ms": t["plain"][0],
                    f"{key}bound_ms": bnd["bound_ms"],
                    f"{key}max_rel_err": err})
        if err > KDA_TOL:
            misses.append((name, err))
    del w, u0, kt, gamma, d_u, d_states
    mine = [t.clone().requires_grad_(True) for t in inputs]
    theirs = [t.double().requires_grad_(True) for t in inputs]
    got, want = kda.chunk_kda(*mine), kda_recurrence(*theirs)
    cot = torch.randn(got.shape, generator=gen, device="cuda")
    (got * cot).sum().backward()
    (want * cot.double()).sum().backward()
    gaps = {"o": gap(got, want), **{f"d{name}": gap(a.grad, b_.grad)
                                    for name, a, b_ in zip(
                                        ("q", "k", "v", "g", "beta"), mine,
                                        theirs)}}
    print(f"chunk_kda at [1, {s}, {h}, 128] against the float64 recurrence, "
          f"max error over the largest entry: " + ", ".join(
              f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
    misses += [(k, v) for k, v in gaps.items() if v > KDA_TOL]
    if misses:
        raise AssertionError(f"the KDA kernel missed its plain version: "
                             f"{misses}")
    return {"chunk_kda_max_rel_err": max(gaps.values()), **out}


def kda_step(steps: int = 2) -> dict:
    """``steps`` train steps of ``configs/torch/kimi_linear_hour.yaml`` at
    S = 7168 (Kimi Linear's hybrid decoder as each modality's encoder,
    random weights, dropout on) through ``make_train_step``, after a
    first one that builds and warms: their times, the peak memory and the
    KDA kernel's launches, counted from 0 just before them; each step
    must launch it once forward and once backward in each of the 8 KDA
    layers (4 a decoder, 2 modalities) -> {"launches", "warm", "peak"}."""
    import numpy as np
    import torch

    from avsum_torch.models.scorer import make_model
    from avsum_torch.ops import kda
    from avsum_torch.train import steps as train_steps
    from avsum_torch.train.config import load_config

    cfg = load_config(KIMI_CONFIG)
    s = 7168
    rng = np.random.default_rng(0)
    batch = train_steps.batch_to_device({
        "visual": rng.standard_normal((1, s, 4096), np.float32),
        "audio": rng.standard_normal((1, s, 296), np.float32),
        "targets": rng.random((1, s), np.float32),
        "mask": np.ones((1, s), np.float32)}, "cuda")
    model = make_model(cfg.model, seed=0).cuda()
    state = train_steps.create_train_state(model, cfg.train, total_steps=100)
    step = train_steps.make_train_step(model, seed=0)
    float(step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kda.kda_fwd.launches = kda.kda_bwd.launches = 0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(step(state, batch)[1]["loss"])
        times.append(round((time.perf_counter() - t0) * 1e3, 1))
    launches = {"forward": kda.kda_fwd.launches,
                "backward": kda.kda_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    layers = 2 * len(cfg.model.kda_layers)
    print(f"hybrid step [1, {s}] (kimi_linear_hour.yaml): warm {times} ms, "
          f"loss {loss:.5f}, peak device memory {peak:.2f} GiB; KDA kernel "
          f"launches in {steps} steps {launches} ({layers} KDA layers)",
          flush=True)
    if not np.isfinite(loss) or launches != {"forward": steps * layers,
                                             "backward": steps * layers}:
        raise AssertionError(f"hybrid step: loss {loss}, KDA launches "
                             f"{launches}, want {steps * layers} each")
    return {"launches": launches["forward"] + launches["backward"],
            "warm": times, "peak": peak}


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


def check_bwd() -> dict:
    """The backward kernel against its plain version on the same inputs,
    and the whole backward (K2 -> it) against autograd of the plain
    attention; CUDA-event times at the train run's and the hour step's
    shapes beside its plain version, its bound (five S x S x D products)
    and SDPA's backward."""
    import torch

    from avsum_torch.ops import attention as att

    worst = 0.0
    for dqk, dv in att.KERNEL_HEAD_DIMS:
        print(f"backward layout at (Dqk, Dv) = ({dqk}, {dv}): "
              f"{att.bwd_layout(dqk, dv)} (held to the library's at the "
              f"first launch); clusters of {dqk // 64} CTAs the card runs "
              f"at once: {att.bwd_max_clusters(dqk, dv)}")
    for s in (40, 63, 64, 65, 127, 129, 512, 544, 1000, 1024, 2049):
        (q, k, v), mask, cot = _latent_case(2, s, 4, seed=s + 192)
        out, lse = att.flash_attention_fwd(q, k, v, mask)
        delta = (cot * out).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, cot, mask, lse, delta)
        got, want = att.flash_bwd(*args), att.flash_bwd_plain(*args)
        leaves = [[t.clone().requires_grad_() for t in (q, k, v)]
                  for _ in range(2)]
        for fn, lv in zip((att.flash_attention, att.attention_plain), leaves):
            (fn(*lv, mask) * cot).sum().backward()
        torch.cuda.synchronize()
        auto = [(a.grad, b_.grad) for a, b_ in zip(*leaves)]
        for a, b_ in (*zip(got, want), *auto):
            torch.testing.assert_close(a, b_, **B34_TOL)
        err = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
        worst = max(worst, err)
        auto_err = max((a - b_).abs().max().item() for a, b_ in auto)
        print(f"backward (192, 128) S={s}: max|d(dq,dk,dv)| vs plain "
              f"{err:.3e}, grads vs autograd of the plain attention "
              f"{auto_err:.3e}")
    time_bwd_latent()
    for d in (128, 256):
        # S around the tiles (64 keys a cluster, 64 queries a tile)
        for s in (40, 63, 64, 65, 127, 129, 512, 544, 1000, 1024, 2049):
            qkv, mask, cot = _flash_case(2, s, d, seed=s + d)
            args = _bwd_inputs(qkv, mask, cot)
            got = att.flash_bwd(*args)
            want = att.flash_bwd_plain(*args)
            auto = _grads(att.flash_attention, qkv, mask, cot)
            auto_want = _grads(att.attention_plain, qkv, mask, cot)
            torch.cuda.synchronize()
            for a, b_ in (*zip(got, want), *zip(auto, auto_want)):
                torch.testing.assert_close(a, b_, **B34_TOL)
            err = max((a - b_).abs().max().item() for a, b_ in zip(got, want))
            worst = max(worst, err)
            auto_err = max((a - b_).abs().max().item()
                           for a, b_ in zip(auto, auto_want))
            print(f"backward D={d} S={s}: max|d(dq,dk,dv)| vs plain "
                  f"{err:.3e}, grads vs autograd of the plain attention "
                  f"{auto_err:.3e}")
    result = {}
    for s, d, iters in ((1024, 256, 20), (1024, 128, 20), (7168, 256, 5),
                        (7168, 128, 5)):
        qkv, mask, cot = _flash_case(1, s, d, seed=d)
        if s == 7168:
            mask.fill_(1.0)
        args = _bwd_inputs(qkv, mask, cot)
        got, want = att.flash_bwd(*args), att.flash_bwd_plain(*args)
        torch.cuda.synchronize()
        for a, b_ in zip(got, want):
            torch.testing.assert_close(a, b_, **B34_TOL)
        worst = max(worst, max((a - b_).abs().max().item()
                               for a, b_ in zip(got, want)))
        del got, want
        fns = {"kernel": lambda: att.flash_bwd(*args),
               "plain": lambda: att.flash_bwd_plain(*args)}
        if s == 1024:
            fns["route"] = lambda: _grads(att.flash_attention, qkv, mask, cot)
            fns["route_plain"] = lambda: _grads(att.attention_plain, qkv,
                                                mask, cot)
        lib_note, library = _library_backward(qkv, mask, cot)
        if library is not None:
            fns["library"] = library
        t = compare_ms(fns, iters=iters)
        bnd = attention_bound(1, s, 4, d, products=5, in_rows=4, out_rows=3)
        lib = (f"{fmt_ms(t['library'])}, {t['library'][0] / t['kernel'][0]:.3f}"
               f"x the kernel's" if library else "none")
        route = (f"; forward+backward, kernel route {fmt_ms(t['route'])}, "
                 f"plain route {fmt_ms(t['route_plain'])}" if s == 1024
                 else "")
        print(f"backward at [1, {s}, 4, {d}]: kernel {fmt_ms(t['kernel'])}, "
              f"plain {fmt_ms(t['plain'])}, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; {bnd['bound_ms'] / t['kernel'][0]:.1%})"
              f"{route}; library (SDPA efficient-attention backward, dq dk "
              f"dv) {lib} ({lib_note})")
        if not result:
            result = {"ms": t["kernel"][0], "plain_ms": t["plain"][0], **bnd,
                      "library_ms": t["library"][0] if library else None}
        del fns, library, args
    return {"max_abs_err": worst, **result}


def _library_backward(qkv, mask, cot):
    """-> (note, fn): fn times the backward of the library call (SDPA's
    efficient attention: dq, dk and dv in one backward) on the same
    inputs, after checking its gradients against the plain attention's;
    (message, None) where the backend refuses the inputs."""
    import torch

    from avsum_torch.ops import attention as att

    qt, kt, vt, bias = sdpa_inputs(*qkv.unbind(2), mask, requires_grad=True)
    try:
        out = sdpa(qt, kt, vt, bias)
    except RuntimeError as e:
        return f"no fused backend: {str(e).splitlines()[0]}", None
    cot_t = cot.transpose(1, 2)
    want = _grads(att.attention_plain, qkv, mask, cot)

    def backward():
        return torch.autograd.grad(out, (qt, kt, vt), cot_t,
                                   retain_graph=True)

    err = max((a.transpose(1, 2) - b).abs().max().item()
              for a, b in zip(backward(), want))
    return f"max|d grad| vs autograd of plain {err:.3e}", backward


def _write_feature_cache(cache_dir: str, n: int, seed: int,
                         shots: tuple = (600, 1000)) -> None:
    """``n`` videos of ``shots`` (least, most) shots at 4096 / 296 dims,
    seeded."""
    import numpy as np

    from avsum_torch.data import FeatureCache

    rng = np.random.default_rng(seed)
    cache = FeatureCache(cache_dir)
    for i in range(n):
        s = int(rng.integers(shots[0], shots[1] + 1))
        ends = np.cumsum(rng.integers(30, 300, s))
        bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
        cache.put(f"video_{i}", rng.standard_normal((s, 4096), np.float32),
                  rng.standard_normal((s, 296), np.float32), bounds, 30.0,
                  int(ends[-1]))


def _train_counts():
    from avsum_torch.ops import attention as att

    return {"flash_fwd": att.flash_attention.launches,
            "flash_bwd": att.flash_bwd.launches}


def _reset_train_counts() -> None:
    from avsum_torch.ops import attention as att

    att.flash_attention.launches = 0
    att.flash_bwd.launches = 0


def run_train(tmp: str) -> dict:
    """``train`` at the hour_scale widths through the CLI, 2 epochs, then
    ``--resume`` for a third; -> summed launch counts of both runs (K2,
    the backward and the Linear GEMM, ``gemm``), each counted from zero."""
    import numpy as np

    from avsum_torch.cli.main import main
    from avsum_torch.ops.linear import linear
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
        linear.launches = 0
        t0 = time.perf_counter()
        rc = main(["train", "--config", HOUR_CONFIG, "--device", "cuda",
                   *extra, *args])
        counts = _train_counts()
        print(f"train {list(extra)} to epoch {epochs}: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}, "
              f"GEMM {linear.launches}")
        if rc != 0 or min(counts.values()) <= 0:
            raise AssertionError(f"train did not run both kernels: "
                                 f"rc {rc}, {counts}")
        return {**counts, "gemm": linear.launches}

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


def compare_train_step(config: str = HOUR_CONFIG, sets=("mesh.seq=1",),
                       batch_size: int = 1, s: int = 600,
                       n_steps: int = 3) -> None:
    """A train step of ``config`` on the card against the CPU: the same
    parameters and batch (``batch_size`` x ``s`` shots, a padded tail),
    dropout 0, lr 1e-4 from the second step on: the loss and gradients of
    the first batch, then ``n_steps`` steps. Adam scales each entry's
    update by that entry's own gradient, so an entry whose gradient lies
    under the gradient check's noise floor (``GRAD_TOL`` of its tensor's
    max |g|) moves by rounding noise on either device: those entries are
    held by the gradient check, every other one to ``PARAM_TOL``."""
    import copy

    import numpy as np
    import torch

    from avsum_torch.models.scorer import make_model
    from avsum_torch.train import steps
    from avsum_torch.train.config import load_config

    cfg = load_config(config, [*sets, "model.dropout=0",
                               "train.warmup_steps=1"])
    rng = np.random.default_rng(3)
    mask = np.ones((batch_size, s), np.float32)
    mask[0, s - s // 15:] = 0.0
    batch = {"visual": rng.standard_normal(
                 (batch_size, s, cfg.model.visual_dim), np.float32),
             "audio": rng.standard_normal(
                 (batch_size, s, cfg.model.audio_dim), np.float32),
             "targets": rng.random((batch_size, s), np.float32) * mask,
             "mask": mask}
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
        losses = [float(step(state, b)[1]["loss"]) for _ in range(n_steps)]
        runs[dev] = (losses, [g.cpu() for g in grads],
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(l_card, l_cpu))
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(g_card, g_cpu))
    errs, noisy, noisy_err = {}, 0, 0.0
    for (name, _), g in zip(cpu_model.named_parameters(), g_cpu):
        settled = g.abs() >= GRAD_TOL * g.abs().max()
        d = (p_card[name] - p_cpu[name]).abs()
        errs[name] = d[settled].max().item() if settled.any() else 0.0
        noisy += int((~settled).sum())
        if (~settled).any():
            noisy_err = max(noisy_err, d[~settled].max().item())
    worst = max(errs, key=errs.get)
    param_err = errs[worst]
    moved = max((p_cpu[k] - v).abs().max().item()
                for k, v in make_model(cfg.model, seed=0).state_dict().items())
    print(f"train step card vs CPU ({os.path.basename(config)}, "
          f"[{batch_size}, {s}]): losses {l_card} / {l_cpu}, max|dloss| "
          f"{loss_err:.2e}, max grad error / max|g| {grad_err:.2e}, params "
          f"after {n_steps} steps max|d| {param_err:.2e} in {worst} (moved up "
          f"to {moved:.2e}); {noisy} entries under the gradient's noise "
          f"floor, max|d| {noisy_err:.2e} there")
    if loss_err > PARAM_TOL or grad_err > GRAD_TOL or param_err > PARAM_TOL:
        raise AssertionError("the card's train step disagrees with the CPU's")


def hour_step(sets: tuple = (), label: str = "hour step",
              profile: bool = True) -> dict:
    """One train step at S = 7168 with remat, hidden 512 (dropout on);
    ``sets`` are further config overrides -> the warm times (ms) and the
    peak memory (GiB)."""
    import numpy as np
    import torch

    from avsum_torch.models.scorer import make_model
    from avsum_torch.train import steps
    from avsum_torch.train.config import load_config

    cfg = load_config(HOUR_CONFIG, ["mesh.seq=1", "model.remat=true", *sets])
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
    print(f"{label} [1, {s}] remat: first {first * 1e3:.1f} ms, warm "
          f"{[round(t * 1e3, 1) for t in times]} ms, loss {loss:.5f}, peak "
          f"device memory {peak:.2f} GiB")
    if not np.isfinite(loss):
        raise AssertionError(f"hour step loss {loss}")
    if profile:
        profile_step(lambda: float(step(state, batch)[1]["loss"]), steps=2)
    return {"warm": [round(t * 1e3, 1) for t in times], "peak": peak}


# kernel-name fragments -> the split of a profiled step
KERNEL_GROUPS = (("K2", "flash_fwd_kernel"), ("backward", "flash_bwd_kernel"),
                 ("cuBLAS", "gemm"))


def _device_work(evt) -> bool:
    """A profiler event of device work: on the card, and not one of the
    pipeline's ``annotate`` spans (``avsum.*``), which the profiler also
    lays over the kernels they enqueued on the device's timeline."""
    from torch.autograd import DeviceType

    return (evt.device_type == DeviceType.CUDA
            and not evt.key.startswith("avsum."))


def profile_step(run_step, steps: int) -> None:
    """Device time of ``steps`` train steps by kernel group
    (torch.profiler), per step: K2, the backward, cuBLAS GEMMs and the
    rest, and the rest's five largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    split = {name: [0.0, 0] for name, _ in KERNEL_GROUPS + (("other", ""),)}
    others = []
    for evt in prof.key_averages():
        if not _device_work(evt) or evt.self_device_time_total <= 0:
            continue
        name = evt.key.lower()
        group = next((g for g, frag in KERNEL_GROUPS if frag.lower() in name),
                     "other")
        ms = evt.self_device_time_total / 1e3 / steps
        split[group][0] += ms
        split[group][1] += evt.count / steps
        if group == "other":
            others.append((ms, evt.count / steps, evt.key[:60]))
    busy = sum(ms for ms, _ in split.values())
    print("hour step profile, per step (device ms, launches): "
          + ", ".join(f"{g} {ms:.2f} ({n:g})" for g, (ms, n) in split.items())
          + f"; device busy {busy:.2f} of {wall:.1f} ms wall (profiled); "
          + "largest of the rest: " + "; ".join(
              f"{k} {ms:.2f} ({n:g})" for ms, n, k in sorted(others)[::-1][:5]))
    if busy <= 0:
        print("hour step profile: the profiler saw no device time")


def _video(stem: str, n_scenes: int, height: int, width: int,
           scene_len: tuple, seed: int) -> int:
    """Write ``stem``.y4m and .wav -> the number of frames."""
    from avsum_torch.io import write_scene_video

    t0 = time.perf_counter()
    scenes = write_scene_video(stem, n_scenes=n_scenes, seed=seed,
                               height=height, width=width,
                               scene_len_frames=scene_len)
    print(f"wrote {stem}.y4m ({n_scenes} scenes, {width}x{height}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return int(scenes[-1][1])


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


def _k12_counts() -> dict:
    from avsum_torch.ops.attention import flash_attention
    from avsum_torch.ops.melspec import fused_log_mel

    return {"melspec": fused_log_mel.launches,
            "flash_fwd": flash_attention.launches}


def _reset_k12() -> None:
    from avsum_torch.ops.attention import flash_attention
    from avsum_torch.ops.melspec import fused_log_mel

    fused_log_mel.launches = 0
    flash_attention.launches = 0


def run_summarize(pipeline, model, path: str, budget: float):
    """``summarize`` of ``path`` -> its result and the launches of K1, K2
    and the Linear GEMM (``gemm``) in it, each counted from zero."""
    from avsum_torch.ops.linear import linear

    _reset_k12()
    linear.launches = 0
    t0 = time.perf_counter()
    result = pipeline.summarize(path, model)
    secs = time.perf_counter() - t0
    counts = {**_k12_counts(), "gemm": linear.launches}
    stages = {k: round(v, 4) for k, v in pipeline.stage_seconds.items()}
    print(f"summarize {path}: {len(result['boundaries'])} shots, "
          f"{secs:.2f} s, launches {counts}, stages {json.dumps(stages)}")
    _check_summary(result, budget)
    return result, counts


def check_against_cpu(pipeline, model, path: str, result: dict,
                      check_audio: bool = True):
    """The card's scorer against its plain path on the CPU, on the same
    features; with ``check_audio``, the MFCC / log-mel columns of the audio
    features (kernel K1's outputs) against the CPU's plain versions -> the
    video's ``ProcessedVideo``."""
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
    if not check_audio:
        return p
    cpu_audio = AudioFrontend(pipeline.config.audio, VGGish(), "cpu")
    wave = load_audio_mono_16k_ship(path[:-len(".y4m")] + ".wav")
    bounds = p.boundaries.astype(np.float64) / p.fps * 16000
    ref_a = cpu_audio.shot_features(wave, bounds).numpy()[:, :168]
    np.testing.assert_allclose(p.audio[:, :168], ref_a, **K1_TOL)
    print(f"audio MFCC/log-mel: card vs CPU max|d| "
          f"{np.abs(p.audio[:, :168] - ref_a).max():.3e}")
    return p


def _write_summe_gt(path: str, n_frames: int, seed: int,
                    n_users: int = 5) -> None:
    """A SumMe-shaped ground-truth .mat: each user keeps three runs of
    ~5% of the frames."""
    import numpy as np
    import scipy.io

    rng = np.random.default_rng(seed)
    users = np.zeros((n_frames, n_users), np.float32)
    run = max(3, n_frames // 20)
    for u in range(n_users):
        for start in rng.choice(n_frames - run, 3, replace=False):
            users[start:start + run, u] = 1.0
    scipy.io.savemat(path, {"gt_score": users.mean(1, keepdims=True),
                            "user_score": users, "nFrames": n_frames,
                            "FPS": 30.0})


class _Messages(logging.Handler):
    """Keeps the messages of one logger (the sweep's per-video lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_cli(label: str, *argv: str) -> tuple:
    """One CLI command with K1's and K2's counts reset just before it ->
    (counts, its standard output)."""
    from avsum_torch.cli.main import main

    _reset_k12()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    counts = _k12_counts()
    print(f"{label}: rc {rc}, {time.perf_counter() - t0:.2f} s, launches "
          f"{counts}")
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}")
    return counts, out.getvalue()


def check_classic(pipeline, vdir: str, short_fast) -> None:
    """The classic path (pure-NumPy Y4M reader, the device shot detector)
    on the card: against the fast path on ``scenes0``, whose cuts both
    detectors find with a wide margin; on ``short`` (640x360, scored at
    half width), against the detector's scores on the CPU over the same
    frames."""
    import numpy as np
    import torch

    import avsum_torch.pipeline as pipeline_mod
    from avsum_torch.io.y4m import Y4MReader
    from avsum_torch.temporal import shots

    fast = pipeline.process_video(f"{vdir}/scenes0.y4m")
    native = pipeline_mod.open_video
    pipeline_mod.open_video = lambda p, prefer_native=True: Y4MReader(p)
    try:
        classic = {}
        for vid in ("scenes0", "short"):
            t0 = time.perf_counter()
            classic[vid] = pipeline.process_video(f"{vdir}/{vid}.y4m")
            stages = {k: round(v, 4) for k, v in
                      pipeline.stage_seconds.items()}
            print(f"classic path {vid}: {len(classic[vid].boundaries)} "
                  f"shots, {time.perf_counter() - t0:.2f} s, stages "
                  f"{json.dumps(stages)}")
    finally:
        pipeline_mod.open_video = native
    got = classic["scenes0"]
    corr = [float(np.corrcoef(a.ravel(), b.ravel())[0, 1]) for a, b in
            ((got.visual, fast.visual), (got.audio, fast.audio))]
    print(f"classic vs fast path on scenes0: shots {len(got.boundaries)} / "
          f"{len(fast.boundaries)}, feature correlation visual {corr[0]:.5f}, "
          f"audio {corr[1]:.5f}")
    if not np.array_equal(got.boundaries, fast.boundaries):
        raise AssertionError("the classic path's shots differ from the fast "
                             "path's")
    if min(corr) <= CLASSIC_CORR:
        raise AssertionError(f"classic vs fast features: correlation {corr}")

    with Y4MReader(f"{vdir}/short.y4m") as reader:
        frames = torch.from_numpy(reader.read_frames_scaled(
            range(reader.n_frames), pipeline._detect_downscale(reader.width)))
    card = shots.content_scores(frames.cuda()).cpu().numpy()
    cpu = shots.content_scores(frames).numpy()
    err = float(np.abs(card - cpu).max())
    cuts = shots.cuts_from_scores(cpu)
    bounds = shots.boundaries_from_cuts(cuts, len(frames))
    print(f"device shot scores on short {tuple(frames.shape)}: card vs CPU "
          f"max|d| {err:.3e}; {len(cuts)} cuts, the same on both: "
          f"{shots.cuts_from_scores(card) == cuts}; the native detector's "
          f"fast path found {len(short_fast.boundaries) - 1}")
    if (err > SHOT_TOL or shots.cuts_from_scores(card) != cuts
            or not np.array_equal(classic["short"].boundaries, bounds)):
        raise AssertionError("the device shot detector disagrees with the "
                             "CPU's")


def run_dataset(tmp: str, pipeline, n_frames: dict, fast_short) -> dict:
    """Phase 9 on the videos in ``{tmp}/data/videos`` (``n_frames`` by
    video id) -> the launches of K1 in preprocess and of K2 in evaluate."""
    import numpy as np

    from avsum_torch.data import FeatureCache
    from avsum_torch.io.y4m import Y4MReader

    data = f"{tmp}/data"
    vdir, gt, cache_dir = f"{data}/videos", f"{data}/gt", f"{data}/cache"
    # seeds whose cuts both shot detectors find with a wide margin
    for i, seed in enumerate((20, 23, 24)):
        n_frames[f"scenes{i}"] = _video(f"{vdir}/scenes{i}", 8, 180, 320,
                                        (30, 75), seed=seed)
    os.makedirs(gt)
    for i, (vid, n) in enumerate(sorted(n_frames.items())):
        _write_summe_gt(f"{gt}/{vid}.mat", n, seed=30 + i)
    args = ["--config", SUMME_CONFIG, "--device", "cuda"] + [
        a for x in (f"data.cache_dir={cache_dir}", f"data.annotation_path={gt}",
                    f"train.checkpoint_dir={data}/ckpt",
                    f"train.log_path={data}/train.jsonl", "train.epochs=2",
                    "train.log_every=1")
        for a in ("--set", x)]

    sweep = _Messages()
    logging.getLogger("avsum_torch.pipeline").addHandler(sweep)
    try:
        pre, _ = run_cli("preprocess", "preprocess", "--input-dir", vdir,
                         *args)
    finally:
        logging.getLogger("avsum_torch.pipeline").removeHandler(sweep)
    for line in sweep.lines:
        print(f"preprocess: {line}")
    cache = FeatureCache(cache_dir)
    if cache.video_ids() != sorted(n_frames) or pre["melspec"] != len(n_frames):
        raise AssertionError(f"preprocess cached {cache.video_ids()}, K1 "
                             f"launched {pre['melspec']} times")
    for vid in cache.video_ids():
        ex = cache.get(vid)
        s = len(ex.shot_boundaries)
        if (ex.visual.shape != (s, 4096) or ex.audio.shape != (s, 296)
                or not (np.isfinite(ex.visual).all()
                        and np.isfinite(ex.audio).all())):
            raise AssertionError(f"cache entry {vid}: {ex.visual.shape} / "
                                 f"{ex.audio.shape}")
    short = cache.get("short")
    np.testing.assert_array_equal(short.shot_boundaries, fast_short.boundaries)
    np.testing.assert_allclose(short.visual, fast_short.visual, **FEATURE_TOL)
    np.testing.assert_allclose(short.audio, fast_short.audio, **FEATURE_TOL)
    print(f"preprocess: short's entry vs summarize's features max|d| visual "
          f"{np.abs(short.visual - fast_short.visual).max():.3e}, audio "
          f"{np.abs(short.audio - fast_short.audio).max():.3e}")
    again, _ = run_cli("preprocess again", "preprocess", "--input-dir", vdir,
                       *args)
    if again["melspec"] != 0:
        raise AssertionError(f"the second sweep launched K1: {again}")

    check_classic(pipeline, vdir, fast_short)

    splits = f"{data}/splits.json"
    run_cli("splits", "splits", "--kfold", "--output", splits, *args)
    run_cli("train", "train", "--splits", splits, "--fold", "0", *args)
    records = [json.loads(line) for line in open(f"{data}/train.jsonl")]
    losses = [r["loss"] for r in records if "loss" in r]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"train on the folds: losses {losses}")
    print(f"train on fold 0: losses {losses}")

    ev, out = run_cli("evaluate", "evaluate", "--canonical", *args)
    metrics = json.loads(out.strip().splitlines()[-1])
    print(f"evaluate --canonical: {json.dumps(metrics)}")
    keys = {"f1", "spearman", "kendall", "canonical_f1", "n_videos"}
    finite = all(np.isfinite(metrics.get(k, np.nan)) for k in keys)
    if (set(metrics) != keys or not finite or metrics["n_videos"] != 5
            or not 0 <= metrics["f1"] <= 1 or not 0 <= metrics["canonical_f1"] <= 1
            or not -1 <= metrics["spearman"] <= 1
            or not -1 <= metrics["kendall"] <= 1 or ev["flash_fwd"] <= 0):
        raise AssertionError(f"evaluate: {metrics}, launches {ev}")

    summaries = f"{data}/summaries"
    run_cli("summarize DIR", "summarize", vdir, "--output", summaries,
            "--checkpoint", f"{data}/ckpt", *args)
    if sorted(os.listdir(summaries)) != [f"{v}.json" for v in sorted(n_frames)]:
        raise AssertionError(f"summarize DIR wrote {os.listdir(summaries)}")
    stem = f"{data}/short_summary"
    _, out = run_cli("summarize --render", "summarize", f"{vdir}/short.y4m",
                     "--render", stem, "--checkpoint", f"{data}/ckpt", *args)
    segments = json.loads(out.strip().splitlines()[-1])["segments"]
    with Y4MReader(f"{stem}.y4m") as reader:
        rendered = reader.n_frames
    want = sum(b - a for a, b in segments)
    print(f"render: {rendered} frames for {len(segments)} segments of {want} "
          f"frames, {os.path.getsize(stem + '.wav')} bytes of wav")
    if rendered != want or not os.path.getsize(f"{stem}.wav"):
        raise AssertionError("the rendered summary does not match its "
                             "segments")
    return {"melspec": pre["melspec"], "flash_fwd": ev["flash_fwd"]}


def _post(port: int, path: str, body, timeout: float = 600):
    """One request to the local server (GET when ``body`` is None) ->
    (status, JSON payload)."""
    from http.client import HTTPConnection

    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST" if body is not None else "GET", path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _wait_ready(port: int, proc=None, limit: float = 300) -> None:
    deadline = time.time() + limit
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}")
        try:
            if _post(port, "/readyz", None, timeout=5)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("the server never became ready")


def _same_summary(got_scores, got_segments, want: dict, what: str) -> float:
    import numpy as np

    err = float(np.abs(np.asarray(got_scores) - want["scores"]).max())
    if err > SCORE_TOL or not np.array_equal(
            np.asarray(got_segments).reshape(-1, 2), want["segments"]):
        raise AssertionError(f"{what}: scores max|d| {err}, segments "
                             f"{got_segments} vs {want['segments'].tolist()}")
    return err


def check_fast_path(pipeline, model, path: str) -> dict:
    """(a) The device-resident summarize against the materializing path
    (``process_video``, then the scorer at a multiple of 32) -> the
    launches of both runs."""
    import numpy as np

    _reset_k12()
    t0 = time.perf_counter()
    fast = pipeline.summarize(path, model)
    secs = time.perf_counter() - t0
    stages = {k: round(v, 4) for k, v in pipeline.stage_seconds.items()}
    counts = _k12_counts()
    _reset_k12()
    t0 = time.perf_counter()
    mat = pipeline._score_summary(pipeline.process_video(path), model, None)
    mat_secs = time.perf_counter() - t0
    mat_counts = _k12_counts()
    if not np.array_equal(fast["boundaries"], mat["boundaries"]):
        raise AssertionError("fast and materializing paths cut differently")
    err = _same_summary(fast["scores"], fast["segments"], mat,
                        f"fast vs materializing on {path}")
    syncs = _syncs(pipeline, model, path)
    print(f"fast path {os.path.basename(path)}: {len(fast['boundaries'])} "
          f"shots, {secs:.3f} s, launches {counts}, stages "
          f"{json.dumps(stages)}; materializing {mat_secs:.3f} s, launches "
          f"{mat_counts}; scores max|d| {err:.3e}, segments equal; "
          f"synchronizing operations in a third run: {len(syncs)} {syncs}")
    if len(syncs) > 1:
        raise AssertionError("the device-resident summarize waits for the "
                             "device before the scores' readback")
    return {k: counts[k] + mat_counts[k] for k in counts}


def _syncs(pipeline, model, path: str) -> list:
    """The operations torch's sync debug mode reports as waiting for the
    device in one device-resident summarize (the final scores' readback
    is one; the counts' copy waits on its own event, which is not one)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipeline.summarize(path, model)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's one-time notice ("a prototype feature") is no operation
    return [str(w.message).splitlines()[0][:80] for w in caught
            if "called a synchronizing" in str(w.message)]


def profile_summarize(pipeline, model, path: str) -> None:
    """The device's busy share in one warm device-resident summarize
    (torch.profiler): the device time of every kernel and copy against
    the host wall of the profiled run (the profiler's own host cost is
    inside that wall, so the share is a lower bound), and the five
    largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.summarize(path, model)
        wall = (time.perf_counter() - t0) * 1e3
    evts = [e for e in prof.key_averages() if _device_work(e)
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:5]
    print(f"profile of summarize {os.path.basename(path)}: device busy "
          f"{busy:.1f} of {wall:.1f} ms wall ({100 * busy / wall:.0f}%), "
          f"{sum(e.count for e in evts)} device operations; largest: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} "
                      f"ms ({e.count})" for e in top))


def check_dedup(pipeline, path: str) -> None:
    """(b) ``visual.dedup_threshold`` against none on one video: the same
    boundaries, per-shot cosine above DEDUP_COS, fewer frames embedded."""
    import dataclasses

    import numpy as np

    from avsum_torch.pipeline import AVPipeline

    runs, shipped = {}, {}
    for thr in (0.0, DEDUP_THRESHOLD):
        cfg = dataclasses.replace(pipeline.config, visual=dataclasses.replace(
            pipeline.config.visual, dedup_threshold=thr))
        pipe = AVPipeline(cfg, pipeline.visual, pipeline.audio)
        real = pipe.visual.dispatch_yuv
        counted = []

        def counting(y, u, v, real=real, counted=counted):
            counted.append(y.shape[0])
            return real(y, u, v)

        pipe.visual.dispatch_yuv = counting
        try:
            runs[thr] = pipe.process_video(path)
        finally:
            del pipe.visual.dispatch_yuv
        shipped[thr] = sum(counted)
    off, on = runs[0.0], runs[DEDUP_THRESHOLD]
    unit = [v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
            for v in (off.visual, on.visual)]
    cos = (unit[0] * unit[1]).sum(1)
    sampled = len(range(0, off.n_frames, max(1, round(
        off.fps / pipeline.config.visual.sample_fps))))
    same = np.array_equal(off.boundaries, on.boundaries)
    print(f"dedup {DEDUP_THRESHOLD} on {os.path.basename(path)}: "
          f"{shipped[DEDUP_THRESHOLD]}/{sampled} sampled frames embedded, "
          f"same boundaries {same}, per-shot cosine against no dedup min "
          f"{cos.min():.5f}")
    if (not same or cos.min() <= DEDUP_COS
            or not 0 < shipped[DEDUP_THRESHOLD] < sampled):
        raise AssertionError("dedup changed the shots or the features")


def _burst(port: int, videos: list) -> tuple:
    """One request per video from a client thread each, all at once ->
    ([(status, payload, client seconds)], wall seconds of the burst)."""
    import threading

    results = [None] * len(videos)

    def client(i):
        t = time.perf_counter()
        body = json.dumps({"path": videos[i]}).encode()
        results[i] = (*_post(port, "/v1/summarize", body),
                      time.perf_counter() - t)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(videos))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client never got its answer")
    return results, time.perf_counter() - t0


def check_server(pipeline, model, videos: list) -> dict:
    """(c) A server on a free local port: two bursts of concurrent
    requests (the first also sets up the worker thread's own cuDNN plans
    for these shapes), each answer equal to ``summarize`` of its video;
    an upload; stats -> the launches from the server's start to its
    stop."""
    import dataclasses

    from avsum_torch.pipeline import AVPipeline
    from avsum_torch.serve import ServeConfig, SummarizeServer

    # an upload has no wav sidecar: it is summarized with silence
    cfg = dataclasses.replace(pipeline.config, audio=dataclasses.replace(
        pipeline.config.audio, silence_fallback=True))
    served = AVPipeline(cfg, pipeline.visual, pipeline.audio)
    server = SummarizeServer(served, ServeConfig(port=0, warmup=True),
                             model=model)
    _reset_k12()
    t0 = time.perf_counter()
    server.start(block=False)
    try:
        _wait_ready(server.port)
        print(f"server ready on port {server.port} in "
              f"{time.perf_counter() - t0:.2f} s (warmup included)")
        bursts = [_burst(server.port, videos) for _ in range(2)]
        with open(videos[0], "rb") as fh:
            code, up = _post(server.port, "/v1/summarize/upload?ext=y4m",
                             fh.read())
        if code != 200 or not up["segments"]:
            raise AssertionError(f"upload: {code} {up}")
        _, stats = _post(server.port, "/v1/stats", None)
    finally:
        server.stop()
    counts = _k12_counts()
    seq, walls = {}, []
    for path in videos:
        t0 = time.perf_counter()
        seq[path] = pipeline.summarize(path, model)
        walls.append(time.perf_counter() - t0)
    for n, (results, wall) in enumerate(bursts):
        for path, (code, payload, _) in zip(videos, results):
            if code != 200:
                raise AssertionError(f"{path}: {code} {payload}")
            _same_summary(payload["shot_scores"], payload["segments"],
                          seq[path], f"served {path}")
        print(f"server burst {n + 1}: {len(videos)} concurrent requests all "
              f"200 and equal to summarize; latency s "
              f"{[round(r[2], 3) for r in results]} (server-side "
              f"{[r[1]['latency_s'] for r in results]}); wall {wall:.3f} s")
    print(f"server: the same videos summarized one after another "
          f"{sum(walls):.3f} s ({[round(w, 3) for w in walls]}); upload "
          f"{len(up['shot_scores'])} shots; stats {json.dumps(stats)}; "
          f"launches {counts}")
    if stats.get("requests", 0) < 2 * len(videos) + 2 or stats["failures"]:
        raise AssertionError(f"stats {stats}")
    return counts


EXPORT_PROBE = """
import sys
sys.modules["avsum_torch"] = None  # the artifact needs no model code
import numpy as np, torch
fn = torch.export.load(sys.argv[1]).module()
x = np.load(sys.argv[2])
with torch.no_grad():
    out = fn(*(torch.from_numpy(x[k]).cuda() for k in ("visual", "audio",
                                                       "mask")))
np.save(sys.argv[3], out.cpu().numpy())
"""


def start_export(tmp: str, name: str = "scorer", sets: tuple = ()):
    """``export`` of the scorer through the CLI on the card, started in
    the background (``--seed`` draws the phase 3 scorer's weights; ``sets``
    are config overrides) -> (the process, the artifact's path, its log's
    path)."""
    art, err = f"{tmp}/{name}.pt2", f"{tmp}/{name}_export.log"
    with open(err, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "avsum_torch.cli", "export",
             "--random-init", "--seed", str(SEED), "--config",
             TVSUM_CONFIG, "--device", "cuda", "--output", art,
             *[a for x in sets for a in ("--set", x)]],
            stdout=subprocess.DEVNULL, stderr=fh)
    return proc, art, err


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as fh:
        return fh.read()[-n:]


def check_export(pipeline, model, tmp: str, many: str, short: str,
                 export) -> None:
    """(d) The artifact written by the background ``export``, scored in a
    process where ``avsum_torch`` cannot be imported and, moved to the
    CPU, in this one, against the eager scorer on the long video's padded
    features (K2 at S = 544); at the same time one request to ``serve
    --artifact``."""
    import socket

    import numpy as np
    import torch

    from avsum_torch.serve.export import load_scorer

    proc, art, err = export
    if proc.wait(timeout=600) != 0:
        raise AssertionError(f"export exited {proc.returncode}: {_tail(err)}")
    print(f"export (CLI, in the background since phase 3): "
          f"{_tail(err, 400).strip().splitlines()[-1]}")
    _, visual, audio, mask = pipeline.pad_scorer_inputs(
        pipeline.process_video(many))
    np.savez(f"{tmp}/many_inputs.npz", visual=visual, audio=audio, mask=mask)
    _reset_k12()
    with torch.inference_mode():
        eager = model(*(torch.from_numpy(a).cuda() for a in
                        (visual, audio, mask))).cpu().numpy()
    counts = _k12_counts()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with open(f"{tmp}/serve.log", "w") as log_fh:
        server = subprocess.Popen(
            [sys.executable, "-m", "avsum_torch.cli", "serve", "--artifact",
             art, "--port", str(port), "--config", TVSUM_CONFIG,
             "--random-init", "--no-warmup", "--device", "cuda"],
            stdout=subprocess.DEVNULL, stderr=log_fh)
    try:
        probe = subprocess.run(
            [sys.executable, "-c", EXPORT_PROBE, art,
             f"{tmp}/many_inputs.npz", f"{tmp}/many_scores.npy"],
            capture_output=True, text=True, timeout=300)
        probe_s = time.perf_counter() - t0
        _wait_ready(port, server)
        code, out = _post(port, "/v1/summarize",
                          json.dumps({"path": short}).encode())
        serve_s = time.perf_counter() - t0
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    if probe.returncode:
        raise AssertionError(f"artifact probe failed: {probe.stderr[-3000:]}")
    diff = float(np.abs(np.load(f"{tmp}/many_scores.npy") - eager).max())
    print(f"artifact: scored in a process without avsum_torch "
          f"{probe_s:.2f} s after its start at {list(mask.shape)}: max|d| "
          f"vs the eager scorer {diff:.3e} (eager launches {counts})")
    if diff > SCORE_TOL or counts["flash_fwd"] <= 0:
        raise AssertionError(f"artifact vs eager {diff}, launches {counts}")
    t0 = time.perf_counter()
    head = [a[:, :MOVE_SHOTS] for a in (visual, audio, mask)]
    on_cpu = load_scorer(art, "cpu")(*head).numpy()
    with torch.inference_mode():
        want = model(*(torch.from_numpy(a).cuda() for a in head)).cpu()
    diff = float(np.abs(on_cpu - want.numpy()).max())
    print(f"artifact moved from the card to the CPU: loaded and scored "
          f"[1, {MOVE_SHOTS}] in {time.perf_counter() - t0:.2f} s, max|d| "
          f"vs the eager scorer {diff:.3e}")
    if diff > SCORE_TOL:
        raise AssertionError(f"the artifact on the CPU disagrees: {diff}")
    if code != 200 or rc != 0:
        raise AssertionError(f"serve --artifact: {code} {out}, rc {rc}: "
                             f"{_tail(f'{tmp}/serve.log')}")
    diff = _same_summary(out["shot_scores"], out["segments"],
                         pipeline.summarize(short, model), "serve --artifact")
    print(f"serve --artifact: one request 200 {serve_s:.2f} s after the "
          f"process's start, scores max|d| vs summarize {diff:.3e}, SIGTERM "
          f"rc {rc}")


def check_knapsack() -> None:
    """(e) The device DP at 3200 shots x capacity 16200 (an hour at 30
    fps, 15% budget) against the NumPy DP, on seeded continuous scores."""
    import numpy as np
    import torch

    from avsum_torch.summary.knapsack import (
        MAX_DP_CELLS,
        knapsack_select_np,
        select_summary,
    )

    rng = np.random.default_rng(17)
    n, total = 3200, 108000
    lengths = rng.integers(10, 58, n)
    ends = np.cumsum(lengths)
    bounds = np.stack([ends - lengths, ends], 1)
    scores = rng.random(n).astype(np.float32)
    cap = int(0.15 * total)
    values = scores * lengths.astype(np.float32)
    if n * (cap + 1) < MAX_DP_CELLS:
        raise AssertionError("the problem does not reach the device DP")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel, _ = select_summary(scores, bounds, total, 0.15, "cuda")
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = knapsack_select_np(values, lengths, cap)
    np_s = time.perf_counter() - t0
    got_v = float(values[sel].astype(np.float64).sum())
    want_v = float(values[ref].astype(np.float64).sum())
    rel = abs(got_v - want_v) / want_v
    same = np.array_equal(sel, ref)
    print(f"knapsack {n} x {cap + 1} ({n * (cap + 1)} cells): device DP "
          f"{dev_s:.3f} s, NumPy DP {np_s:.3f} s (host clock, each to its "
          f"selection on the host); total value {got_v:.6f} vs {want_v:.6f} "
          f"(rel {rel:.2e}), {int(sel.sum())} shots, same selection {same}, "
          f"{int(lengths[sel].sum())}/{cap} frames")
    if rel > KNAPSACK_RTOL or not same or lengths[sel].sum() > cap:
        raise AssertionError("the device knapsack disagrees with NumPy's")


def run_serving(tmp: str, pipeline, model, vdir: str, export) -> dict:
    """Phase 10 -> the launches of K1 and K2 in its runs; ``export`` is
    :func:`start_export`'s."""
    short, many = f"{vdir}/short.y4m", f"{vdir}/many.y4m"
    counts = check_fast_path(pipeline, model, short)
    n_many = check_fast_path(pipeline, model, many)
    if (counts["melspec"] <= 0 or n_many["melspec"] <= 0
            or n_many["flash_fwd"] <= 0):
        raise AssertionError(f"phase 10 (a) launches {counts} / {n_many}")
    profile_summarize(pipeline, model, many)
    check_dedup(pipeline, short)
    videos = [short, many] + [f"{vdir}/scenes{i}.y4m" for i in range(3)] + [
        short]
    served = check_server(pipeline, model, videos)
    # (d)'s eager scorer is the reference side of a comparison: its
    # launches are not the main path's
    check_export(pipeline, model, tmp, many, short, export)
    check_knapsack()
    return {k: counts[k] + n_many[k] + served[k] for k in counts}


def _peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30


def config4_summarize(label: str, sets: list, videos: list, budget: float,
                      card: str):
    """Phase 11 (a) / (b): ``summarize`` of each video with ``sets`` over
    tvsum.yaml at the phase 3 seed, each against the CPU's plain path ->
    (summed K1 / K2 launches, the pipeline, the scorer)."""
    import torch

    from avsum_torch.cli.main import build_pipeline
    from avsum_torch.train.config import load_config

    cfg = load_config(TVSUM_CONFIG, sets)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline, model = build_pipeline(cfg, "cuda", seed=SEED)
    print(f"phase 11 {label}: {' '.join(sets)}: random weights on the card "
          f"in {time.perf_counter() - t0:.1f} s ({card})")
    total, results = {"melspec": 0, "flash_fwd": 0}, {}
    for path in videos:
        results[path], counts = run_summarize(pipeline, model, path, budget)
        if counts["melspec"] <= 0:
            raise AssertionError(f"K1 did not run on {path}: {counts}")
        total = {k: total[k] + counts[k] for k in total}
    torch.cuda.synchronize()
    print(f"phase 11 {label}: peak device memory {_peak_gib():.2f} GiB "
          f"({card})")
    for i, (path, result) in enumerate(results.items()):
        # K1's outputs on the short video, as in phase 3; on the long one
        # phase 6 holds K1 to its plain version at its waveform's length
        check_against_cpu(pipeline, model, path, result,
                          check_audio=i == 0 and path.endswith("short.y4m"))
    return total, pipeline, model


def config4_train(tmp: str, card: str) -> None:
    """Phase 11 (c): ``train`` with moe_ep.yaml and deep_pp.yaml on one
    device through the CLI (2 epochs, then ``--resume``), and one step of
    each against the CPU's."""
    import numpy as np

    from avsum_torch.cli.main import main
    from avsum_torch.ops import attention as att

    _write_feature_cache(f"{tmp}/clips", 32, seed=13, shots=(60, 128))
    for config in (MOE_CONFIG, DEEP_CONFIG):
        name = os.path.basename(config)[:-len(".yaml")]
        log_path = f"{tmp}/{name}.jsonl"
        sets = [*ONE_DEVICE, f"data.cache_dir={tmp}/clips",
                f"train.checkpoint_dir={tmp}/{name}_ckpt",
                f"train.log_path={log_path}", "train.warmup_steps=2",
                "train.log_every=1"]
        for epochs, extra in ((2, []), (3, ["--resume"])):
            args = [a for x in sets + [f"train.epochs={epochs}"]
                    for a in ("--set", x)]
            _reset_train_counts()
            t0 = time.perf_counter()
            rc = main(["train", "--config", config, "--device", "cuda",
                       *extra, *args])
            print(f"phase 11 (c) train {name} {extra} to epoch {epochs}: rc "
                  f"{rc}, {time.perf_counter() - t0:.2f} s, launches "
                  f"{_train_counts()} ({card})")
            if rc != 0:
                raise AssertionError(f"train {name} exited {rc}")
        records = [json.loads(line) for line in open(log_path)]
        losses = np.array([r["loss"] for r in records])
        resumed = [r for r in records if r["step"] > 8]
        if (len(records) != 12 or not np.isfinite(losses).all()
                or resumed[0]["epoch"] != 2):
            raise AssertionError(f"train {name}: {records}")
        # steps 2-4 of the first epoch: no checkpoint is written between
        dt = np.diff([r["time"] for r in records[:4]])[1:]
        print(f"phase 11 (c) {name}: losses {np.round(losses, 5).tolist()}, "
              f"warm step {1e3 * np.median(dt):.1f} ms (batch 8 x 128 shots, "
              f"host clock; median of {len(dt)}) ({card})")
        compare_train_step(config, ONE_DEVICE, batch_size=8, s=128,
                           n_steps=2)
    if att.flash_attention.launches:
        raise AssertionError("a flash kernel ran at S = 128")


def config4_hour_chunked(card: str) -> None:
    """Phase 11 (d): one hour_scale.yaml step at S = 7168 with the kernel
    off: the fusion attention takes the chunked path (chunk 512), the
    encoders' attention is materialized, remat on."""
    from avsum_torch.models import attention as attention_module
    from avsum_torch.ops import attention as att

    plain = attention_module.attention_plain
    calls = []

    def counted(*args, chunk=0, **kwargs):
        if chunk > 0:
            calls.append(chunk)
        return plain(*args, chunk=chunk, **kwargs)

    attention_module.attention_plain = counted
    _reset_train_counts()
    try:
        hour_step(["model.use_pallas=false"], label=f"phase 11 (d) "
                  f"use_pallas=false ({card}): hour step", profile=False)
    finally:
        attention_module.attention_plain = plain
    print(f"phase 11 (d): chunked fusion calls {len(calls)} (chunk "
          f"{set(calls)}), kernel launches {_train_counts()}")
    if not calls or set(calls) != {512} or att.flash_attention.launches:
        raise AssertionError("the hour step did not take the chunked path")


def config4_export(tmp: str, export, pipeline, model, many: str,
                   card: str) -> None:
    """Phase 11 (e): the (a) scorer's artifact from the background
    ``export``, loaded on the card and scored against the eager scorer on
    the long video's padded features."""
    import numpy as np
    import torch

    from avsum_torch.serve.export import load_scorer

    proc, art, err = export
    if proc.wait(timeout=900) != 0:
        raise AssertionError(f"export exited {proc.returncode}: {_tail(err)}")
    print(f"phase 11 (e) export (CLI, in the background since phase 3): "
          f"{_tail(err, 400).strip().splitlines()[-1]} ({card})")
    _, visual, audio, mask = pipeline.pad_scorer_inputs(
        pipeline.process_video(many))
    with torch.inference_mode():
        eager = model(*(torch.from_numpy(a).cuda() for a in
                        (visual, audio, mask))).cpu().numpy()
    t0 = time.perf_counter()
    scored = load_scorer(art, "cuda")(visual, audio, mask).cpu().numpy()
    diff = float(np.abs(scored - eager).max())
    print(f"phase 11 (e) artifact loaded and scored {list(mask.shape)} in "
          f"{time.perf_counter() - t0:.2f} s, {os.path.getsize(art)} bytes, "
          f"max|d| vs the eager scorer {diff:.3e} ({card})")
    if diff > SCORE_TOL:
        raise AssertionError(f"the config 4 artifact disagrees: {diff}")


def run_config4(tmp: str, vdir: str, budget: float, export4,
                card: str) -> dict:
    """Phase 11 -> the launches of K1 and K2 in its summarize runs."""
    import gc

    import torch

    short, many = f"{vdir}/short.y4m", f"{vdir}/many.y4m"
    print(card)
    t0 = time.perf_counter()
    n_a, pipeline, model = config4_summarize(
        "(a)", CONFIG4_A, [short, short, many], budget, card)
    config4_export(tmp, export4, pipeline, model, many, card)
    del pipeline, model
    gc.collect()
    torch.cuda.empty_cache()
    n_b, pipeline, model = config4_summarize("(b)", CONFIG4_B, [many],
                                             budget, card)
    if n_b["flash_fwd"] <= 0:
        raise AssertionError(f"phase 11 (b): K2 did not run at S = 544: {n_b}")
    del pipeline, model
    gc.collect()
    torch.cuda.empty_cache()
    config4_train(tmp, card)
    config4_hour_chunked(card)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s ({card})")
    return {k: n_a[k] + n_b[k] for k in n_a}


# ---------------------------------------------------------------------------
# Phase 12: the shipped mesh configs on spawned ranks.
# ---------------------------------------------------------------------------

RING_PARAM_TOL = 3e-4  # ring vs one process, JAX's bound (test_ring_in_model)
LOSS_RTOL = 1e-5  # mesh vs one-process losses, relative


def _mesh_batch(b: int, s: int, cfg, seed: int) -> dict:
    """A [b, s] batch at ``cfg``'s widths, the first row's tail padded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    mask[0, s - s // 15:] = 0.0
    return {"visual": rng.standard_normal((b, s, cfg.model.visual_dim),
                                          np.float32),
            "audio": rng.standard_normal((b, s, cfg.model.audio_dim),
                                         np.float32),
            "targets": rng.random((b, s), np.float32) * mask, "mask": mask}


def _record_first_grads(state) -> list:
    """The gradients the optimizer gets at its first step, kept."""
    first, update = [], state.optimizer.step

    def recording(grads, g_norm=None):
        if not first:
            first.extend(g.detach().cpu() for g in grads)
        return update(grads, g_norm)

    state.optimizer.step = recording
    return first


def mesh_train_rank(config: str, sets: list, batch: dict, n_steps: int,
                    backend: str = "gloo",
                    tensor_parallel: bool = False) -> dict:
    """One rank of a phase 12 or 13 run: ``config`` with ``sets`` at its
    own mesh over the spawned world (with ``tensor_parallel``, the state
    placed by ``shard_state`` and stepped with ``state_sharding``),
    ``n_steps`` steps on ``batch`` -> its losses, warm step times, peak
    memory, parameter bytes, kernel launches, and, on the ranks of the
    first ``model`` group, its first gradients and final parameters by
    name."""
    import torch

    from avsum_torch.models.scorer import make_model, to_mesh
    from avsum_torch.parallel.mesh import AXIS_DATA, AXIS_SEQ, build_mesh
    from avsum_torch.parallel.mesh import mesh_config, shard_batch
    from avsum_torch.train import steps
    from avsum_torch.train.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(config, sets)
    mesh = build_mesh(mesh_config(cfg.mesh), "cuda", backend)
    model, sharding = make_model(cfg.model, seed=0), None
    if tensor_parallel:
        state = steps.shard_state(
            steps.create_train_state(model, cfg.train, total_steps=100), mesh)
        sharding = steps.state_shardings(model, mesh)
        model = state.model
    else:
        model = to_mesh(model, mesh)
        state = steps.create_train_state(model, cfg.train, total_steps=100)
    first = _record_first_grads(state)
    step = steps.make_train_step(model, mesh, seed=0,
                                 state_sharding=sharding)
    _reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n_steps):
        block = shard_batch(batch, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, block)[1]["loss"]))
        times.append(time.perf_counter() - t0)
    out = {"rank": mesh.rank, "coords": mesh.coords, "losses": losses,
           "times": times, "counts": _train_counts(), "peak": _peak_gib(),
           "split": model.split_names(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}
    if mesh.coords[AXIS_DATA] == 0 and mesh.coords[AXIS_SEQ] == 0:
        names = [n for n, _ in model.named_parameters()]
        out["grads"] = {n: g.numpy() for n, g in zip(names, first)}
        out["params"] = {k: v.detach().cpu().numpy()
                         for k, v in model.state_dict().items()}
    return out


def one_process_steps(config: str, sets: list, batch: dict,
                      n_steps: int) -> dict:
    """The same steps in this process on the card, on the whole batch."""
    import torch

    from avsum_torch.models.scorer import make_model
    from avsum_torch.train import steps
    from avsum_torch.train.config import load_config

    cfg = load_config(config, sets)
    model = make_model(cfg.model, seed=0).cuda()
    state = steps.create_train_state(model, cfg.train, total_steps=100)
    first = _record_first_grads(state)
    step = steps.make_train_step(model, seed=0)
    b = steps.batch_to_device(batch, "cuda")
    losses = [float(step(state, b)[1]["loss"]) for _ in range(n_steps)]
    names = [n for n, _ in model.named_parameters()]
    out = {"losses": losses,
           "grads": {n: g.numpy() for n, g in zip(names, first)},
           "params": {k: v.detach().cpu().numpy()
                      for k, v in model.state_dict().items()},
           "full_bytes": {n: p.numel() * p.element_size()
                          for n, p in model.named_parameters()}}
    del model, state
    torch.cuda.empty_cache()
    return out


def check_mesh_run(label: str, ranks: list, want: dict,
                   param_tol: float, phase: int = 12) -> None:
    """``compare_train_step``'s rule for a mesh run against one process:
    the losses (relative ``LOSS_RTOL``), the first gradients gathered to
    the one-device layout (``GRAD_TOL`` of each tensor's max |g|), the
    parameters after the steps to ``param_tol`` where the gradient check
    settles them (Adam moves the rest by rounding noise)."""
    import numpy as np

    from avsum_torch.parallel.mesh import merge_shards

    lead = sorted((r for r in ranks if "grads" in r),
                  key=lambda r: r["coords"]["model"])
    split = lead[0]["split"]
    grads = merge_shards([r["grads"] for r in lead], split, want["grads"])
    params = merge_shards([r["params"] for r in lead], split, want["params"])
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], want["losses"]))
    grad_err, param_err, noisy, worst = 0.0, 0.0, 0, ""
    for name, g in want["grads"].items():
        scale = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(grads[name] - g).max()) / scale
        if err > grad_err:
            grad_err, worst = err, name
        settled = np.abs(g) >= GRAD_TOL * scale
        noisy += int((~settled).sum())
        if settled.any():
            param_err = max(param_err, float(np.abs(
                params[name] - want["params"][name])[settled].max()))
    print(f"phase {phase} {label}: losses "
          f"{[round(x, 6) for x in ranks[0]['losses']]}"
          f" vs one process {[round(x, 6) for x in want['losses']]} (max rel "
          f"{loss_err:.2e}), max grad error / max|g| {grad_err:.2e} "
          f"({worst}), params "
          f"max|d| {param_err:.2e} ({noisy} entries under the gradient's "
          "noise floor)")
    if loss_err > LOSS_RTOL or grad_err > GRAD_TOL or param_err > param_tol:
        raise AssertionError(f"phase {phase} {label}: the mesh run "
                             "disagrees with one process")


def _rank_summary(label: str, ranks: list, card: str,
                  phase: int = 12) -> None:
    import numpy as np

    warm = [1e3 * float(np.median(r["times"][1:])) for r in ranks]
    print(f"phase {phase} {label}: warm step {np.round(warm, 1).tolist()} "
          f"ms by rank (host clock, median after the first), peak device "
          f"memory "
          f"{[round(r['peak'], 2) for r in ranks]} GiB, parameter bytes "
          f"{[r['param_bytes'] for r in ranks]} ({card})")


def mesh_hour(ranks_4, card: str, flash: dict) -> None:
    """Phase 12 (a): hour_scale.yaml at its seq 4 mesh and widths: the
    S = 7168 step through the ring beside phase 8's flash step, then
    3 steps at S = 1024, dropout 0, against one process."""
    from avsum_torch.train.config import load_config

    cfg = load_config(HOUR_CONFIG)
    sets = ["model.remat=true"]
    ranks = ranks_4.run(mesh_train_rank, HOUR_CONFIG, sets,
                        _mesh_batch(1, 7168, cfg, 0), 3)
    _rank_summary("(a) hour_scale.yaml seq 4, [1, 7168] remat, ring", ranks,
                  card)
    print(f"phase 12 (a): one process, flash kernels (phase 8): warm "
          f"{flash['warm']} ms, peak {flash['peak']:.2f} GiB ({card})")
    if any(not all(map(math.isfinite, r["losses"])) for r in ranks):
        raise AssertionError("phase 12 (a): a loss is not finite")
    sets = ["model.dropout=0", "train.warmup_steps=1"]
    batch = _mesh_batch(1, 1024, cfg, 3)
    ranks = ranks_4.run(mesh_train_rank, HOUR_CONFIG, sets, batch, 3)
    want = one_process_steps(HOUR_CONFIG, sets, batch, 3)
    _rank_summary("(a) hour_scale.yaml seq 4, [1, 1024]", ranks, card)
    check_mesh_run("(a) seq 4 [1, 1024]", ranks, want, RING_PARAM_TOL)


def mesh_data(card: str) -> dict:
    """Phase 12 (b): hour_scale.yaml at data 2 (seq 1), S = 1024, 3 steps:
    each rank runs K2 and the backward -> their launches summed over the ranks."""
    from avsum_torch.parallel.multihost import Ranks
    from avsum_torch.train.config import load_config

    sets = ["mesh.seq=1", "mesh.data=2", "train.warmup_steps=1"]
    batch = _mesh_batch(2, 1024, load_config(HOUR_CONFIG), 4)
    with Ranks(2, "gloo") as ranks_2:
        ranks = ranks_2.run(mesh_train_rank, HOUR_CONFIG, sets, batch, 3)
    want = one_process_steps(HOUR_CONFIG, sets, batch, 3)
    _rank_summary("(b) hour_scale.yaml data 2, [2, 1024]", ranks, card)
    check_mesh_run("(b) data 2 [2, 1024]", ranks, want, PARAM_TOL)
    for r in ranks:
        print(f"phase 12 (b) rank {r['rank']}: launches {r['counts']}")
        if min(r["counts"].values()) <= 0:
            raise AssertionError(f"phase 12 (b): rank {r['rank']} did not "
                                 f"run K2 and the backward: {r['counts']}")
    return {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}


def mesh_model(ranks_8, config: str, label: str, card: str) -> tuple:
    """Phase 12 (c) / (d): ``config`` at its 2 x 4 mesh and widths, 3 steps
    against one process; each rank holds a quarter of the experts, or one
    stage of four -> (the ranks' results, the one process's)."""
    from avsum_torch.train.config import load_config

    cfg = load_config(config)
    batch = _mesh_batch(cfg.data.batch_videos, cfg.data.max_shots, cfg, 5)
    sets = ["train.warmup_steps=1"]
    ranks = ranks_8.run(mesh_train_rank, config, sets, batch, 3)
    want = one_process_steps(config, sets, batch, 3)
    name = os.path.basename(config)
    _rank_summary(f"{label} {name} 2 x 4, [{cfg.data.batch_videos}, "
                  f"{cfg.data.max_shots}]", ranks, card)
    check_mesh_run(f"{label} {name}", ranks, want, PARAM_TOL)
    what = "experts" if ranks[0]["split"] else "stages"
    sharded = set(ranks[0]["split"]) or {n for n in want["full_bytes"]
                                         if ".stages." in n}
    full = sum(want["full_bytes"][n] for n in sharded)
    for r in (r for r in ranks if "params" in r):
        mine = sum(v.nbytes for n, v in r["params"].items() if n in sharded)
        print(f"phase 12 {label} rank {r['rank']}: {mine} of {full} bytes "
              f"of {what}")
        if mine * 4 != full:
            raise AssertionError(f"phase 12 {label}: rank {r['rank']} holds "
                                 f"{mine} of {full} bytes, not a quarter")
    return ranks, want


def score_rank(sets: list) -> tuple:
    """One rank of phase 12 (e)'s scoring: the trainer at hour_scale.yaml's
    mesh with ``sets``, restored from the checkpoint -> (its step, the
    scores of every cached video)."""
    import torch

    from avsum_torch.data import FeatureCache
    from avsum_torch.data.datasets import load_cached_examples
    from avsum_torch.models.scorer import make_model
    from avsum_torch.train.config import load_config
    from avsum_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(HOUR_CONFIG, sets)
    trainer = Trainer(make_model(cfg.model, seed=cfg.train.seed), cfg,
                      device="cuda", backend="gloo")
    trainer.init_state()
    step = trainer.maybe_restore()
    return step, [trainer.score_video(ex) for ex in load_cached_examples(
        FeatureCache(cfg.data.cache_dir))]


def mesh_cli(tmp: str, card: str, ranks_4) -> None:
    """Phase 12 (e): ``train`` with hour_scale.yaml unmodified under
    ``torch.distributed.run`` with 4 processes on the card (gloo), 2
    epochs then ``--resume``, then ``evaluate`` there; the checkpoint
    restored at the seq 4 mesh (the spawned ranks) and in one process
    scores every video the same."""
    import numpy as np

    from avsum_torch.train.checkpoint import CheckpointManager

    _write_feature_cache(f"{tmp}/mesh_cache", 4, seed=17)
    log_path = f"{tmp}/mesh_train.jsonl"
    sets = [f"data.cache_dir={tmp}/mesh_cache",
            f"train.checkpoint_dir={tmp}/mesh_ckpt",
            f"train.log_path={log_path}", "train.log_every=1"]
    root = os.path.dirname(os.path.abspath(__file__))

    def torchrun(cmd: str, epochs: int, *extra: str) -> str:
        args = [a for x in sets + [f"train.epochs={epochs}"]
                for a in ("--set", x)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "avsum_torch.cli", cmd,
             "--config", HOUR_CONFIG, "--device", "cuda", "--backend",
             "gloo", *extra, *args], cwd=root, capture_output=True,
            text=True, timeout=600, env={**os.environ, "PYTHONPATH": root})
        print(f"phase 12 (e) torchrun {cmd} {list(extra)} to epoch {epochs}:"
              f" rc {proc.returncode}, {time.perf_counter() - t0:.1f} s "
              f"({card})")
        if proc.returncode != 0:
            raise AssertionError(f"torchrun {cmd}: {proc.stderr[-3000:]}")
        return proc.stdout

    torchrun("train", 2)
    torchrun("train", 3, "--resume")
    printed = [line for line in torchrun("evaluate", 3).splitlines()
               if line.startswith("{")]
    records = [json.loads(line) for line in open(log_path)]
    losses = np.array([r["loss"] for r in records])
    steps = CheckpointManager(f"{tmp}/mesh_ckpt").steps()
    print(f"phase 12 (e): losses {np.round(losses, 5).tolist()}, "
          f"checkpoints {steps}, evaluate {printed}")
    if (len(records) != 12 or steps[-1] != 12 or len(printed) != 1
            or not np.isfinite(losses).all() or records[8]["epoch"] != 2):
        raise AssertionError("phase 12 (e): the torchrun run went wrong")
    ranks = ranks_4.run(score_rank, sets)
    step, one = score_rank([*sets, "mesh.seq=1"])
    diff = max(float(np.abs(a - b).max()) for r in ranks
               for a, b in zip(r[1], one))
    print(f"phase 12 (e): the step-{step} checkpoint scores "
          f"{sum(map(len, one))} shots of {len(one)} videos on the 4 "
          f"ranks and in one process, max|d| {diff:.2e}")
    if diff > SCORE_TOL or any(r[0] != step for r in ranks) or step != 12:
        raise AssertionError("phase 12 (e): one process scores the "
                             "checkpoint otherwise than the ranks")


def nccl_rank(sets: list, batch: dict) -> dict:
    """Phase 12 (f) on one rank of an NCCL world: a sum over the world of
    a CUDA tensor, then one train step of (b)'s config."""
    import torch
    import torch.distributed as dist

    x = torch.ones(1, device=f"cuda:{dist.get_rank() % torch.cuda.device_count()}")
    dist.all_reduce(x)
    out = mesh_train_rank(HOUR_CONFIG, sets, batch, 1, backend="nccl")
    out["world_sum"] = float(x.item())
    return out


def mesh_nccl(card: str) -> None:
    """Phase 12 (f): the NCCL backend at the world the card count allows."""
    import torch

    from avsum_torch.parallel.multihost import Ranks
    from avsum_torch.train.config import load_config

    n = torch.cuda.device_count()
    sets = ["mesh.seq=1", f"mesh.data={n}"]
    batch = _mesh_batch(n, 1024, load_config(HOUR_CONFIG), 6)
    with Ranks(n, "nccl") as world:
        ranks = world.run(nccl_rank, sets, batch)
    print(f"phase 12 (f) NCCL, world {n}: losses "
          f"{[r['losses'] for r in ranks]}, sum over the world "
          f"{ranks[0]['world_sum']} ({card})")
    if n == 1:
        print("phase 12 (f): this machine has one card, so NCCL ran a "
              "world of one: a run with NCCL across two or more cards was "
              "not possible here")
    if any(r["world_sum"] != n or not math.isfinite(r["losses"][0])
           for r in ranks):
        raise AssertionError("phase 12 (f): the NCCL run went wrong")


def run_mesh(tmp: str, card: str, flash: dict) -> tuple:
    """Phase 12 -> (K2 and backward launches of (b)'s ranks, (c)'s ranks and
    one-process run, (d)'s)."""
    from avsum_torch.parallel.multihost import Ranks

    print(card)
    t0 = time.perf_counter()
    with Ranks(4, "gloo") as ranks_4:
        mesh_hour(ranks_4, card, flash)
        mesh_cli(tmp, card, ranks_4)
    n_b = mesh_data(card)
    with Ranks(8, "gloo") as ranks_8:
        moe = mesh_model(ranks_8, MOE_CONFIG, "(c)", card)
        deep = mesh_model(ranks_8, DEEP_CONFIG, "(d)", card)
    mesh_nccl(card)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s ({card})")
    return n_b, moe, deep


# ---------------------------------------------------------------------------
# Phase 13: tensor parallelism over `model`, the trace, the debug tools and
# the device DTW.
# ---------------------------------------------------------------------------

TRACE_SPANS = ("avsum.detect_thread", "avsum.visual_dispatch",
               "avsum.audio_dispatch", "avsum.shot_detect_host",
               "avsum.visual_pool", "avsum.audio_pool", "avsum.score_select",
               # the port's own, beside the JAX package's names
               "avsum.frame_read", "avsum.frame_upload",
               "avsum.embed_enqueue", "avsum.detect_join",
               "avsum.audio_embed", "avsum.scorer_launch",
               "avsum.device_wait", "avsum.audio_load", "avsum.prep",
               "avsum.pool", "avsum.score", "avsum.select")
DTW_RTOL = 1e-5  # device wavefront vs host DTW cost (tests/test_dtw.py)


def tp_bytes(config: str, model_axis: int) -> tuple:
    """(one-device parameter bytes, a rank's under ``state_shardings`` at
    ``model_axis``) of ``config``'s scorer (rank 0 of the model group)."""
    import torch

    from avsum_torch.models.scorer import AVScorer
    from avsum_torch.parallel.mesh import Split
    from avsum_torch.train.config import load_config
    from avsum_torch.train.steps import state_shardings

    with torch.device("meta"):
        model = AVScorer(load_config(config).model)
    placed = state_shardings(model, model_axis)
    full = mine = 0
    for name, p in model.named_parameters():
        size = p.numel() * p.element_size()
        full += size
        where = placed[name]
        mine += (size // model_axis if isinstance(where, Split)
                 else 0 if where is not None and ".stages.0." not in name
                 else size)
    return full, mine


def _tp_bytes_check(label: str, ranks: list, config: str, m: int,
                    replicated: int, phase: int = 13) -> None:
    full, want = tp_bytes(config, m)
    got = [r["param_bytes"] for r in ranks]
    print(f"phase {phase} {label}: parameter bytes a rank {got} under "
          f"state_sharding (state_shardings: {want} of {full}; replicated "
          f"placement, phase 12: {replicated})")
    if any(b != want for b in got) or want >= replicated:
        raise AssertionError(f"phase {phase} {label}: a rank holds {got} "
                             f"bytes, not {want}")


def tp_hour(card: str, flash: dict) -> dict:
    """Phase 13 (a): hour_scale.yaml's widths at data 1 x model 2 under
    ``shard_state`` / ``state_sharding``: 3 steps at S = 7168 with remat
    (K2 and the backward on each rank) against one process, then 3 steps at
    S = 1024, dropout 0, at seq 2 x model 2 (ring attention) against one
    process -> the 7168 run's launches, summed over its ranks."""
    from avsum_torch.parallel.multihost import Ranks
    from avsum_torch.train.config import load_config

    cfg = load_config(HOUR_CONFIG)
    sets = ["mesh.seq=1", "mesh.model=2", "model.remat=true",
            "train.warmup_steps=1"]
    batch = _mesh_batch(1, 7168, cfg, 7)
    with Ranks(2, "gloo") as ranks_2:
        ranks = ranks_2.run(mesh_train_rank, HOUR_CONFIG, sets, batch, 3,
                            "gloo", True)
    want = one_process_steps(HOUR_CONFIG, sets, batch, 3)
    _rank_summary("(a) hour_scale.yaml TP data 1 x model 2, [1, 7168] remat",
                  ranks, card, 13)
    print(f"phase 13 (a): one process, flash kernels (phase 8): warm "
          f"{flash['warm']} ms, peak {flash['peak']:.2f} GiB ({card})")
    check_mesh_run("(a) TP model 2 [1, 7168]", ranks, want, PARAM_TOL, 13)
    _tp_bytes_check("(a)", ranks, HOUR_CONFIG, 2,
                    sum(want["full_bytes"].values()))
    for r in ranks:
        print(f"phase 13 (a) rank {r['rank']}: launches {r['counts']}")
        if min(r["counts"].values()) <= 0:
            raise AssertionError(f"phase 13 (a): rank {r['rank']} did not "
                                 f"run K2 and the backward: {r['counts']}")
    sets = ["mesh.seq=2", "mesh.model=2", "model.dropout=0",
            "train.warmup_steps=1"]
    batch = _mesh_batch(1, 1024, cfg, 8)
    with Ranks(4, "gloo") as ranks_4:
        ring = ranks_4.run(mesh_train_rank, HOUR_CONFIG, sets, batch, 3,
                           "gloo", True)
    _rank_summary("(a) hour_scale.yaml TP seq 2 x model 2, [1, 1024], ring",
                  ring, card, 13)
    check_mesh_run("(a) TP seq 2 x model 2 [1, 1024]", ring,
                   one_process_steps(HOUR_CONFIG, sets, batch, 3),
                   RING_PARAM_TOL, 13)
    return {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}


def tp_moe(card: str, moe: tuple) -> None:
    """Phase 13 (b): moe_ep.yaml at its 2 x 4 mesh under ``state_sharding``,
    3 steps on phase 12 (c)'s batch: the losses of phase 12 (c)'s
    replicated placement (relative ``LOSS_RTOL``), and its one process by
    ``compare_train_step``'s rule."""
    import numpy as np

    from avsum_torch.parallel.multihost import Ranks
    from avsum_torch.train.config import load_config

    replicated, want = moe
    cfg = load_config(MOE_CONFIG)
    batch = _mesh_batch(cfg.data.batch_videos, cfg.data.max_shots, cfg, 5)
    with Ranks(8, "gloo") as ranks_8:
        ranks = ranks_8.run(mesh_train_rank, MOE_CONFIG,
                            ["train.warmup_steps=1"], batch, 3, "gloo", True)
    _rank_summary("(b) moe_ep.yaml TP 2 x 4, [8, 128]", ranks, card, 13)
    err = max(abs(a - b) / abs(b) for r, q in zip(ranks, replicated)
              for a, b in zip(r["losses"], q["losses"]))
    print(f"phase 13 (b): losses against phase 12 (c)'s placement, max rel "
          f"{err:.2e}")
    if err > LOSS_RTOL or not np.isfinite(err):
        raise AssertionError("phase 13 (b): TP and phase 12 (c) disagree")
    check_mesh_run("(b) moe_ep.yaml TP", ranks, want, PARAM_TOL, 13)
    _tp_bytes_check("(b)", ranks, MOE_CONFIG, 4, replicated[0]["param_bytes"])


def trace_summarize(tmp: str, pipeline, model, path: str) -> dict:
    """Phase 13 (c): ``trace_to`` around a warm device-resident summarize
    of ``path``: the trace holds the fast path's span names (the JAX
    package's and the port's own) and the launches of K1 and K2;
    ``collect_stages`` sees the same spans -> K1 and K2 launches of the
    run."""
    import glob

    import torch

    from avsum_torch.utils.profiling import collect_stages, trace_to

    pipeline.summarize(path, model)
    torch.cuda.synchronize()
    _reset_k12()
    t0 = time.perf_counter()
    with collect_stages() as stages, trace_to(f"{tmp}/trace") as prof:
        pipeline.summarize(path, model)
    wall = (time.perf_counter() - t0) * 1e3
    counts = _k12_counts()
    (trace,) = glob.glob(f"{tmp}/trace/*.trace.json")
    with open(trace) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if _device_work(e)) / 1e3
    kernels = {k: sum(k in n for n in names)
               for k in ("melspec_kernel", "flash_fwd_kernel")}
    print(f"phase 13 (c): trace of a warm summarize of "
          f"{os.path.basename(path)}: {os.path.getsize(trace)} bytes, "
          f"spans {sorted(stages)}, device busy {busy:.1f} of {wall:.1f} ms "
          f"wall ({100 * busy / wall:.0f}%, profiled), kernel names in the "
          f"trace {kernels}, launches {counts}")
    missing = [n for n in TRACE_SPANS if n not in names]
    if (missing or set(stages) != set(TRACE_SPANS)
            or min(kernels.values()) <= 0 or min(counts.values()) <= 0):
        raise AssertionError(f"phase 13 (c): spans {missing} missing from "
                             f"the trace, or no K1 / K2 ({kernels})")
    return counts


def check_debug(model) -> None:
    """Phase 13 (d): ``debug_nans`` raises on a NaN injected into a scorer
    forward on the card and on one made in a backward (the autograd
    engine's device thread); ``checked`` passes a clean forward."""
    import torch

    from avsum_torch.utils.debug import checked, debug_nans

    rng = torch.Generator().manual_seed(1)
    s = 64
    visual = torch.randn(1, s, model.config.visual_dim, generator=rng)
    audio = torch.randn(1, s, model.config.audio_dim, generator=rng)
    mask = torch.ones(1, s)
    args = [t.cuda() for t in (visual, audio, mask)]
    with torch.inference_mode():
        scores = checked(model)(*args)
    args[0][0, 5, 7] = float("nan")
    caught = []
    for what, run in (
            ("forward", lambda: model(*args)),
            ("backward", lambda: (torch.sqrt(torch.zeros(
                3, device="cuda", requires_grad=True)) * 0).sum().backward())):
        try:
            with debug_nans():
                run()
        except FloatingPointError as e:
            caught.append(f"{what}: {e}")
    print(f"phase 13 (d): checked scorer forward [1, {s}] clean (scores "
          f"in [{float(scores.min()):.3f}, {float(scores.max()):.3f}]); "
          f"debug_nans raised {caught}")
    if len(caught) != 2:
        raise AssertionError("phase 13 (d): debug_nans missed a NaN")


def check_dtw() -> None:
    """Phase 13 (e): ``dtw_cost_device`` on the card at 2000 x 600 against
    ``dtw_host`` (relative ``DTW_RTOL``), with its time."""
    import numpy as np
    import torch

    from avsum_torch.ops.dtw import _pairwise_dist, dtw_cost_device, dtw_host

    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2000, 8)), rng.standard_normal((600, 8))
    dist = torch.as_tensor(_pairwise_dist(a, b), dtype=torch.float32).cuda()
    float(dtw_cost_device(dist[:50, :20]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = float(dtw_cost_device(dist))
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want, _ = dtw_host(a, b)
    host_ms = (time.perf_counter() - t0) * 1e3
    rel = abs(got - want) / abs(want)
    print(f"phase 13 (e): dtw_cost_device [2000, 600] on the card {ms:.1f} "
          f"ms (host clock to the readback), dtw_host {host_ms:.1f} ms; cost "
          f"{got:.4f} vs {want:.4f} (rel {rel:.2e})")
    if rel > DTW_RTOL:
        raise AssertionError("phase 13 (e): the device DTW disagrees")


def run_phase13(tmp: str, card: str, flash: dict, moe: tuple, pipeline,
                model, many: str) -> dict:
    """Phase 13 -> the launches of its K1, K2 and backward runs."""
    print(card)
    t0 = time.perf_counter()
    n_tp = tp_hour(card, flash)
    tp_moe(card, moe)
    n_trace = trace_summarize(tmp, pipeline, model, many)
    check_debug(model)
    check_dtw()
    print(f"phase 13: {time.perf_counter() - t0:.1f} s ({card})")
    return {**n_tp, "melspec": n_trace["melspec"],
            "flash_fwd": n_tp["flash_fwd"] + n_trace["flash_fwd"]}


# ---------------------------------------------------------------------------
# Phase 14: the measurement entry points and the JAX package's msgpack
# weight files.
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
TINY_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                            "tiny_backbone_bf16.msgpack")
# phase 14 (c): float32 encoders, so the card and the CPU agree to
# SCORE_TOL on the whole summarize
MSGPACK_SETS = ["visual.backbone=tiny", "visual.dtype=float32",
                "audio.dtype=float32"]


def bench_media(media_dir: str) -> str:
    """The e2e bench's clip (bench.py's 640x360 scene clip) written into
    ``media_dir``, in a process started before phase 3 -> its stem."""
    from avsum_torch.bench import e2e

    stem = e2e.media_stem(media_dir, e2e.SCENES)
    e2e.ensure_media(stem, e2e.SCENES)
    return stem


def start_bench(*argv: str) -> tuple:
    """``python -m avsum_torch.bench ARGV`` from the checkout, started ->
    what :func:`end_bench` waits for."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen([sys.executable, "-m", "avsum_torch.bench",
                             *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)
    return proc, argv, time.perf_counter()


def end_bench(started: tuple, timeout: float) -> list:
    """The JSON lines of a command :func:`start_bench` started (its log
    goes to the end of a failure's message); killed at ``timeout``."""
    proc, argv, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"bench {list(argv)} exited {proc.returncode}:"
                             f"\n{err[-4000:]}")
    print(f"bench {' '.join(argv)}: {time.perf_counter() - t0:.1f} s")
    return [json.loads(line) for line in out.strip().splitlines()]


def run_bench(*argv: str, timeout: float) -> list:
    """``python -m avsum_torch.bench ARGV`` from the checkout -> its JSON
    lines."""
    return end_bench(start_bench(*argv), timeout)


def bench_e2e(media) -> dict:
    """Phase 14 (a): ``python -m avsum_torch.bench e2e`` on the 120 s clip
    -> K1 and K2 launches over its timed runs."""
    stem = media.result()
    (line,) = run_bench("e2e", "--media-dir", os.path.dirname(stem),
                        timeout=900)
    print(f"phase 14 (a) bench e2e: {json.dumps(line)}")
    k1 = line["kernels"]["melspec"]
    if (line["metric"] != "e2e_video_fps" or not line["value"] > 0
            or len(k1) != len(line["runs_s"]) or min(k1) <= 0
            or set(line["warm_probe"]) != {"build_s", "warmup_s",
                                          "second_s"}):
        raise AssertionError("phase 14 (a): the e2e bench's line is wrong")
    return {k: sum(v) for k, v in line["kernels"].items()}


def bench_train_hour() -> dict:
    """Phase 14 (b): ``python -m avsum_torch.bench train-hour --mode chip``
    at S = 7168, with and without remat -> K2 and backward launches."""
    lines = run_bench("train-hour", "--mode", "chip", timeout=900)
    for line in lines:
        print(f"phase 14 (b) bench train-hour: {json.dumps(line)}")
    labels = [line["label"] for line in lines]
    if (labels != ["chip_remat_flash", "chip_norematerialize"]
            or any(line["seq_len"] != 7168 or not math.isfinite(line["loss"])
                   or min(line["kernels"].values()) <= 0 for line in lines)):
        raise AssertionError("phase 14 (b): the train-hour bench's lines "
                             "are wrong")
    return {k: sum(line["kernels"][k] for line in lines)
            for k in lines[0]["kernels"]}


def check_msgpack(tmp: str, short: str, budget: float) -> dict:
    """Phase 14 (c): ``visual.weights`` naming the JAX package's msgpack
    file of the tiny backbone (bfloat16 leaves, tests/fixtures), VGGish and
    the scorer from the phase 3 seed: summarize of the short video on the
    card, against the CPU's plain path from the same file and against
    ``--weights`` made by ``convert --visual`` from it (bitwise the same
    weights) -> K1 launches."""
    import numpy as np
    import torch

    from avsum_torch import convert
    from avsum_torch.cli.main import build_pipeline
    from avsum_torch.train.config import load_config

    cfg = load_config(TVSUM_CONFIG, MSGPACK_SETS + [
        f"visual.weights={TINY_FIXTURE}"])
    pipeline, model = build_pipeline(cfg, "cuda", seed=SEED)
    card_res, counts = run_summarize(pipeline, model, short, budget)
    cpu_pipe, cpu_model = build_pipeline(cfg, "cpu", seed=SEED)
    cpu_res = cpu_pipe.summarize(short, cpu_model)
    convert.main(["--visual", TINY_FIXTURE, "--out", f"{tmp}/tiny.pt"])
    conv_pipe, conv_model = build_pipeline(
        load_config(TVSUM_CONFIG, MSGPACK_SETS), "cuda", seed=SEED,
        weights=torch.load(f"{tmp}/tiny.pt", weights_only=True))
    conv_res = conv_pipe.summarize(short, conv_model)
    err = float(np.abs(card_res["scores"] - cpu_res["scores"]).max())
    # the same weights; the scores agree to the card's rerun noise (the
    # per-shot pooling sums with atomics, in no fixed order)
    loaded = pipeline.visual.model.state_dict()
    same_weights = all(torch.equal(v, loaded[k]) for k, v in
                       conv_pipe.visual.model.state_dict().items())
    conv_err = float(np.abs(card_res["scores"] - conv_res["scores"]).max())
    same = (same_weights and conv_err <= SCORE_TOL
            and np.array_equal(card_res["segments"], conv_res["segments"]))
    import importlib.util

    msgpack = importlib.util.find_spec("msgpack") is not None
    print(f"phase 14 (c): visual.weights = the JAX package's msgpack "
          f"(bfloat16 leaves), msgpack package installed: {msgpack} (the "
          f"port never imports it): card vs CPU plain path "
          f"scores max|d| {err:.3e}, segments equal "
          f"{np.array_equal(card_res['segments'], cpu_res['segments'])}; "
          f"against --weights from convert --visual: weights equal "
          f"{same_weights}, scores max|d| {conv_err:.3e}, segments equal "
          f"{np.array_equal(card_res['segments'], conv_res['segments'])}")
    if (err > SCORE_TOL or not same or not np.array_equal(
            card_res["boundaries"], cpu_res["boundaries"])
            or counts["melspec"] <= 0):
        raise AssertionError("phase 14 (c): the msgpack weights disagree")
    return counts


def run_phase14(tmp: str, card: str, media, short: str,
                budget: float) -> dict:
    """Phase 14 -> the launches of its K1, K2 and backward runs."""
    print(card)
    t0 = time.perf_counter()
    n_e2e = bench_e2e(media)
    n_train = bench_train_hour()
    n_msgpack = check_msgpack(tmp, short, budget)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s ({card})")
    return {"melspec": n_e2e["melspec"] + n_msgpack["melspec"],
            "flash_fwd": (n_e2e["flash_fwd"] + n_msgpack["flash_fwd"]
                          + n_train["flash_fwd"]),
            "flash_bwd": n_train["flash_bwd"]}


# ---------------------------------------------------------------------------
# Phase 15: the F1-parity harness and the compressed-media path.
# ---------------------------------------------------------------------------


def parity_quick(tmp: str) -> int:
    """Phase 15 (a): ``python -m avsum_torch.bench parity --quick
    --dataset both`` on the card -> K1's launches in the worlds'
    preprocess."""
    out = f"{tmp}/parity"
    lines = run_bench("parity", "--quick", "--dataset", "both", "--device",
                      "cuda", "--out-dir", out, "--work-dir",
                      f"{tmp}/parity_work", timeout=600)
    k1 = 0
    for line in lines:
        print(f"phase 15 (a) {line['dataset']}: verdict {line['verdict']}; "
              f"contenders on {line['card']}, the reference on the "
              f"{line['reference_device']}; K1 launches in the world's "
              f"preprocess {line['world_launches']['melspec']}")
        for key, r in line["models"].items():
            print(f"phase 15 (a) {line['dataset']} {key}: canonical F1 "
                  f"{r['canonical_f1']:.4f}, keyframe F1 {r['f1']:.4f}, "
                  f"paired delta {r.get('paired_delta_pts', '-')} pts")
        f1s = [r[m] for r in line["models"].values()
               for m in ("canonical_f1", "f1")]
        if (line["device"] != "cuda" or len(line["models"]) != 3
                or not all(math.isfinite(f) and 0 <= f <= 1 for f in f1s)
                or line["world_launches"]["melspec"] <= 0):
            raise AssertionError(f"phase 15 (a): {line['dataset']}'s line "
                                 "is wrong")
        k1 += line["world_launches"]["melspec"]
    with open(f"{out}/PARITY_F1_TORCH.json") as fh:
        report = json.load(fh)
    if ([line["dataset"] for line in lines] != ["tvsum", "summe"]
            or set(report["datasets"]) != {"tvsum", "summe"}
            or not os.path.getsize(f"{out}/PARITY_F1_TORCH.md")):
        raise AssertionError("phase 15 (a): the report was not written")
    return k1


def _compressed_video(stem: str, n_scenes: int, seed: int) -> int:
    """``stem``.mp4: an mp4v video track and an AAC audio track -> the
    number of frames."""
    import cv2

    from avsum_torch.io.mp4_mux import remux_video_with_aac
    from avsum_torch.io.synthetic import make_scene_video

    frames, audio, _ = make_scene_video(n_scenes=n_scenes, seed=seed,
                                        height=72, width=96)
    writer = cv2.VideoWriter(f"{stem}.v.mp4", cv2.VideoWriter_fourcc(
        *"mp4v"), 30.0, (96, 72))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    remux_video_with_aac(f"{stem}.v.mp4", f"{stem}.mp4", audio, rate=16000)
    os.remove(f"{stem}.v.mp4")
    return len(frames)


def dress_rehearsal(tmp: str) -> int:
    """Phase 15 (b): preprocess -> splits -> train -> evaluate --canonical
    through the CLI on the card over 3 mp4v + AAC files -> K1's launches
    (0 and one line saying why where OpenCV or the AAC encoder is
    missing)."""
    import numpy as np

    from avsum_torch.data import FeatureCache
    from avsum_torch.io.cv2video import cv2_available
    from avsum_torch.io.ffaudio import aac_encode_available

    missing = [name for name, ok in (("OpenCV (cv2)", cv2_available()), (
        "the bundled ffmpeg's AAC encoder", aac_encode_available()))
        if not ok]
    if missing:
        print(f"phase 15 (b): not run: {' and '.join(missing)} not "
              "installed")
        return 0
    data = f"{tmp}/compressed"
    vdir, gt, cache_dir = f"{data}/videos", f"{data}/gt", f"{data}/cache"
    os.makedirs(vdir)
    os.makedirs(gt)
    for i in range(3):
        n = _compressed_video(f"{vdir}/cv{i}", 4, seed=300 + i)
        _write_summe_gt(f"{gt}/cv{i}.mat", n, seed=40 + i)
    args = ["--config", SUMME_CONFIG, "--device", "cuda"] + [
        a for x in (f"data.cache_dir={cache_dir}", f"data.annotation_path={gt}",
                    f"train.checkpoint_dir={data}/ckpt",
                    f"train.log_path={data}/train.jsonl", "train.epochs=2")
        for a in ("--set", x)]
    sweep = _Messages()
    logging.getLogger("avsum_torch.pipeline").addHandler(sweep)
    try:
        pre, _ = run_cli("phase 15 (b) preprocess", "preprocess",
                         "--input-dir", vdir, *args)
    finally:
        logging.getLogger("avsum_torch.pipeline").removeHandler(sweep)
    cached = [line for line in sweep.lines if line.startswith("cached ")]
    for line in cached:
        print(f"phase 15 (b) preprocess: {line}")
    cache = FeatureCache(cache_dir)
    finite = all(np.isfinite(cache.get(v).visual).all()
                 and np.isfinite(cache.get(v).audio).all()
                 for v in cache.video_ids())
    classic = all("'visual_features'" in line and "'audio_features'" in line
                  and "'shot_detect'" in line for line in cached)
    if (cache.video_ids() != ["cv0", "cv1", "cv2"] or len(cached) != 3
            or not classic or not finite or pre["melspec"] != 3):
        raise AssertionError(f"phase 15 (b): preprocess cached "
                             f"{cache.video_ids()}, classic path {classic}, "
                             f"finite {finite}, K1 {pre['melspec']}")
    splits = f"{data}/splits.json"
    run_cli("phase 15 (b) splits", "splits", "--kfold", "--output", splits,
            *args)
    run_cli("phase 15 (b) train", "train", "--splits", splits, "--fold", "0",
            *args)
    _, out = run_cli("phase 15 (b) evaluate", "evaluate", "--splits", splits,
                     "--fold", "0", "--canonical", *args)
    metrics = json.loads(out.strip().splitlines()[-1])
    print(f"phase 15 (b) evaluate --canonical: {json.dumps(metrics)}")
    if not (metrics["n_videos"] >= 1 and 0 <= metrics["canonical_f1"] <= 1
            and 0 <= metrics["f1"] <= 1):
        raise AssertionError(f"phase 15 (b): evaluate gave {metrics}")
    return pre["melspec"]


def run_phase15(tmp: str, card: str) -> int:
    """Phase 15 -> K1's launches."""
    import importlib.util

    print(card)
    t0 = time.perf_counter()
    print("phase 15: h5py importable: "
          f"{importlib.util.find_spec('h5py') is not None} (the parity "
          "world keeps TVSum's annotations in memory without it)")
    k1 = parity_quick(tmp) + dress_rehearsal(tmp)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s ({card})")
    return k1


# ---------------------------------------------------------------------------
# Phase 16: the JAX side's experiment scripts as bench commands, and
# deep_pp.yaml under state_sharding.
# ---------------------------------------------------------------------------

PPEP_VIDEOS = 10  # phase 16 (a)'s world: 8 train and 2 held-out videos
PP_EQ_ATOL = 5e-5  # JAX's test_pp_training_math_equals_sequential
DEEP_BYTES = 82_177_540  # deep_pp.yaml's parameter bytes a rank, computed
EMBED_PLAN = "base:128,256;resnet_only:128;inception_only:128"


def _unit(x) -> bool:
    return math.isfinite(x) and 0 <= x <= 1


def ppep_run(tmp: str, i: int) -> tuple:
    """Phase 16 (a): ``bench ppep`` at full width (hidden 512) on a
    10-video world, 3 epochs, one seed: in one process (``--mesh-one``,
    ``i`` 0, building the world), or at the contenders' own meshes (8
    gloo ranks sharing the card, ``i`` 1, on the cached world) -> (K1's
    launches in the world's preprocess, the parameter counts)."""
    label, extra = (("one process", ["--mesh-one"]), ("own meshes", []))[i]
    lines = run_bench(
        "ppep", "--device", "cuda", "--n-videos", str(PPEP_VIDEOS),
        "--epochs", "3", "--n-seeds", "1", "--work-dir", f"{tmp}/ppep",
        "--out", f"{tmp}/ppep{i}.json", *extra, timeout=900)
    *rows, last = lines
    for r in rows:
        print(f"phase 16 (a) ppep {label} {r['config']}: canonical F1 "
              f"{r['canonical_f1']}, keyframe F1 {r['keyframe_f1']}, "
              f"step {r['step_ms']} ms, warm-up {r['warmup_s']} s, "
              f"{r['n_params']} parameters, mesh {r['mesh']}, "
              f"{r['ranks']} rank(s) over {r['dist_backend']}")
    k = last["world_launches"]["melspec"]
    medians = {n: v["step_ms_median"] for n, v in last["summary"].items()}
    print(f"phase 16 (a) ppep {label}: step medians {medians}; K1 "
          f"launches in the world's preprocess {k}")
    f1s = [f for r in rows for f in (r["canonical_f1"], r["keyframe_f1"],
                                     *r["video_canonical_f1"].values())]
    if ([r["config"] for r in rows] != ["flagship_attention", "deep_pp",
                                        "moe_ep"]
            or not all(map(_unit, f1s))
            or k != (PPEP_VIDEOS if i == 0 else 0)
            or any(r["ranks"] != (1, 8)[i] or r["device"] != "cuda"
                   for r in rows)):
        raise AssertionError(f"phase 16 (a): ppep {label} went wrong")
    return k, {r["config"]: r["n_params"] for r in rows}


def pp_equality(started: tuple) -> None:
    """Phase 16 (b): ``bench pp-equality 3`` on 8 gloo ranks sharing the
    card (``started`` by :func:`start_bench`): the GPipe run's parameters
    against the data mesh's."""
    (line,) = end_bench(started, timeout=600)
    print(f"phase 16 (b) pp-equality: {line['n_leaves']} leaves, worst "
          f"|d| {line['worst_abs']:.3e}, worst relative {line['worst_rel']} "
          f"({line['worst_leaf']}), {line['n_leaves_over_1e-3_rel']} over "
          f"1e-3 relative, meshes {line['meshes']}")
    if line["ranks"] != 8 or not line["worst_abs"] <= PP_EQ_ATOL:
        raise AssertionError("phase 16 (b): GPipe training differs from the "
                             "data mesh's")


def deep_pp_curve(tmp: str) -> int:
    """Phase 16 (c): ``bench deep-pp-curve --epochs 20 --eval-every 10`` at
    full width on (a)'s world (its cache reused) -> K1's launches (none:
    the world is cached)."""
    out = f"{tmp}/deep_pp_curve.json"
    (*_, last) = run_bench(
        "deep-pp-curve", "--device", "cuda", "--epochs", "20",
        "--eval-every", "10", "--n-videos", str(PPEP_VIDEOS), "--work-dir",
        f"{tmp}/ppep", "--out", out, timeout=600)
    with open(out) as fh:
        result = json.load(fh)
    for point in result["curve"]:
        print(f"phase 16 (c) deep-pp-curve: {json.dumps(point)}")
    print(f"phase 16 (c): schedule total_steps {result['total_steps']}, "
          f"ema_decay {result['ema_decay']}, warm-up "
          f"{result['warmup_steps_run']} steps, {result['steps_per_epoch']} "
          f"steps an epoch")
    values = [v for p in result["curve"] for v in p.values()]
    if ([p["epoch"] for p in result["curve"]] != [10, 20]
            or not all(map(math.isfinite, values))
            or not all(_unit(p["canonical_f1"]) for p in result["curve"])
            or (result["total_steps"], result["ema_decay"]) != (10_000, 0.98)):
        raise AssertionError("phase 16 (c): the curve is wrong")
    return last["world_launches"]["melspec"]


def embed_sweep() -> None:
    """Phase 16 (d): ``bench embed-sweep`` of the dual bf16 backbone at
    ship 304, batches 128 and 256, and each backbone alone at 128."""
    *rows, best = run_bench("embed-sweep", "--device", "cuda", "--plan",
                            EMBED_PLAN, "--ship", "304", timeout=600)
    for r in rows:
        print(f"phase 16 (d) embed-sweep {r['variant']} {r['batch']}: "
              f"{r.get('ms_per_frame')} ms a frame, "
              f"{r.get('gflops_per_frame')} GFLOP a frame, MFU "
              f"{r.get('mfu_pct')}% (set-up {r.get('compile_s')} s)")
    cells = [(r["variant"], r["batch"]) for r in rows]
    if (cells != [("base", 128), ("base", 256), ("resnet_only", 128),
                  ("inception_only", 128)]
            or any("error" in r or not r["mfu_pct"] > 0 for r in rows)
            or "best" not in best):
        raise AssertionError("phase 16 (d): the sweep went wrong")


def embed_ab(media) -> int:
    """Phase 16 (e): ``bench embed-ab --batches 256,512 --rounds 2`` on
    phase 14's clip -> K1's launches over the timed summarizes."""
    stem = media.result()
    (line,) = run_bench("embed-ab", "--device", "cuda", "--batches",
                        "256,512", "--rounds", "2", "--media-dir",
                        os.path.dirname(stem), timeout=600)
    print(f"phase 16 (e) embed-ab: {json.dumps(line)}")
    k1 = line["kernels"]["melspec"]
    if (not line["identical_segments"] or set(line["per_batch"]) != {
            "256", "512"} or k1 != 4):
        raise AssertionError("phase 16 (e): the A/B went wrong")
    return k1


def tp_deep(card: str, deep: tuple, ranks_8) -> None:
    """Phase 16 (f): deep_pp.yaml at its 2 x 4 mesh under
    ``state_sharding`` on ``ranks_8``, 3 steps on phase 12 (d)'s batch,
    against phase 12 (d)'s losses and its one process, with each rank's
    parameter bytes beside the computed 82,177,540."""
    import numpy as np

    from avsum_torch.train.config import load_config

    replicated, want = deep
    cfg = load_config(DEEP_CONFIG)
    batch = _mesh_batch(cfg.data.batch_videos, cfg.data.max_shots, cfg, 5)
    ranks = ranks_8.run(mesh_train_rank, DEEP_CONFIG, ["train.warmup_steps=1"],
                        batch, 3, "gloo", True)
    _rank_summary("(f) deep_pp.yaml TP 2 x 4, [8, 128]", ranks, card, 16)
    err = max(abs(a - b) / abs(b) for r, q in zip(ranks, replicated)
              for a, b in zip(r["losses"], q["losses"]))
    print(f"phase 16 (f): losses against phase 12 (d)'s placement, max rel "
          f"{err:.2e}; parameter bytes a rank "
          f"{[r['param_bytes'] for r in ranks]}, computed {DEEP_BYTES}")
    if err > LOSS_RTOL or not np.isfinite(err):
        raise AssertionError("phase 16 (f): TP and phase 12 (d) disagree")
    check_mesh_run("(f) deep_pp.yaml TP", ranks, want, PARAM_TOL, 16)
    _tp_bytes_check("(f)", ranks, DEEP_CONFIG, 4,
                    replicated[0]["param_bytes"], 16)
    if any(r["param_bytes"] != DEEP_BYTES for r in ranks):
        raise AssertionError("phase 16 (f): bytes a rank differ from the "
                             "computed count")


def run_phase16(tmp: str, card: str, media, deep: tuple) -> int:
    """Phase 16 -> K1's launches. (b) runs on its ranks while (a)'s
    one-process run and (c) run (their checks time nothing); (f)'s ranks
    start with the phase and wait for it; (d) and (e), which time the
    card, run alone."""
    from avsum_torch.parallel.multihost import Ranks

    print(card)
    t0 = time.perf_counter()
    equality = start_bench("pp-equality", "3", "--device", "cuda")
    try:
        with Ranks(8, "gloo") as ranks_8:
            k1, one = ppep_run(tmp, 0)
            k1 += deep_pp_curve(tmp)
            pp_equality(equality)
            embed_sweep()
            k1 += embed_ab(media)
            k_own, own = ppep_run(tmp, 1)
            if one != own:
                raise AssertionError(f"phase 16 (a): parameter counts {one} "
                                     f"in one process, {own} at the meshes")
            tp_deep(card, deep, ranks_8)
    finally:
        if equality[0].poll() is None:
            equality[0].kill()
            equality[0].communicate()
    print(f"phase 16: {time.perf_counter() - t0:.1f} s ({card})")
    return k1 + k_own


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
    from avsum_torch.train.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    phase_build()

    cfg = load_config(TVSUM_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        exports = (start_export(tmp), start_export(tmp, "config4", CONFIG4_A))
        writer = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        media = writer.submit(bench_media, f"{tmp}/bench")
        try:
            return _run_in(tmp, cfg, card, *exports, media)
        finally:
            writer.shutdown(cancel_futures=True)
            for proc, _, _ in exports:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _run_in(tmp: str, cfg, card: str, export, export4, media) -> int:
    """Phases 3-5 and 9-11 in ``tmp``, then the kernels' checks (phases
    6-8), phases 12-15 and the result lines."""
    import torch

    from avsum_torch.cli.main import build_pipeline
    from avsum_torch.io import load_audio_mono_16k_ship

    budget = cfg.summary.budget_fraction
    vdir = f"{tmp}/data/videos"
    os.makedirs(vdir)
    short, many = f"{vdir}/short", f"{vdir}/many"
    # the two videos are written in two processes at once
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = {"short": pool.submit(_video, short, 12, 360, 640, (24, 90),
                                     5),
                "many": pool.submit(_video, many, 540, 72, 96, (30, 40), 6)}
        n_frames = {vid: job.result() for vid, job in jobs.items()}
    t0 = time.perf_counter()
    pipeline, model = build_pipeline(cfg, "cuda", seed=SEED)
    print(f"random weights on the card in {time.perf_counter() - t0:.1f} s")

    res_short, n_short = run_summarize(pipeline, model, f"{short}.y4m",
                                       budget)
    if n_short["melspec"] <= 0:
        raise AssertionError("K1 did not run on the short video")
    fast_short = check_against_cpu(pipeline, model, f"{short}.y4m",
                                   res_short)

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
    n_data = run_dataset(tmp, pipeline, n_frames, fast_short)
    n_serve = run_serving(tmp, pipeline, model, vdir, export)
    n_cfg4 = run_config4(tmp, vdir, budget, export4, card)

    k1 = check_k1(k1_samples)
    k2 = check_k2(s_pad)
    bwd = check_bwd()
    check_linear()
    gemm = time_linear()
    kda = check_kda()
    compare_train_step()
    flash = hour_step()
    hybrid = kda_step()
    n_mesh, moe, deep = run_mesh(tmp, card, flash)
    n_13 = run_phase13(tmp, card, flash, moe, pipeline, model, f"{many}.y4m")
    n_14 = run_phase14(tmp, card, media, f"{short}.y4m", budget)
    n_15 = run_phase15(tmp, card)
    n_16 = run_phase16(tmp, card, media, deep)
    kernels = [
        {"name": "melspec", "route": "cuda",
         "source": "avsum_torch/csrc/melspec.cu",
         "replaces": "avsum_tpu/ops/pallas_melspec.py:39",
         "launches": (n_short["melspec"] + n_many["melspec"]
                      + n_data["melspec"] + n_serve["melspec"]
                      + n_cfg4["melspec"] + n_13["melspec"]
                      + n_14["melspec"] + n_15 + n_16), **k1},
        {"name": "flash_fwd", "route": "cuda",
         "source": "avsum_torch/csrc/flash_fwd.cu",
         "replaces": "avsum_tpu/ops/attention.py:42",
         "launches": (n_short["flash_fwd"] + n_many["flash_fwd"]
                      + n_train["flash_fwd"] + n_data["flash_fwd"]
                      + n_serve["flash_fwd"] + n_cfg4["flash_fwd"]
                      + n_mesh["flash_fwd"] + n_13["flash_fwd"]
                      + n_14["flash_fwd"]), **k2},
        {"name": "flash_bwd", "route": "cuda",
         "source": "avsum_torch/csrc/flash_bwd.cu",
         "replaces": ("avsum_tpu/ops/attention.py:173 and "
                      "avsum_tpu/ops/attention.py:221"),
         "launches": (n_train["flash_bwd"] + n_mesh["flash_bwd"]
                      + n_13["flash_bwd"] + n_14["flash_bwd"]),
         **bwd},
        # the main path's runs alone: time_linear's and check_linear's
        # launches are not among them
        {"name": "gemm_tf32x3", "route": "cuda",
         "source": "avsum_torch/csrc/gemm_tf32x3.cu", "replaces": None,
         "launches": n_short["gemm"] + n_many["gemm"] + n_train["gemm"],
         **gemm[7168, 2048, 2048, "fwd"]},
        # the hybrid step's launches alone, forward and backward passes;
        # the times are the forward's, bwd_ the backward's
        {"name": "kda", "route": "cuda", "source": "avsum_torch/csrc/kda.cu",
         "replaces": None, "launches": hybrid["launches"], **kda},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
