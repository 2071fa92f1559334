"""The port's measurement entry points, counterparts of the JAX package's
``bench.py``, ``scripts/bench_hour.py`` and ``scripts/bench_train_hour.py``:

``python -m avsum_torch.bench e2e`` (:mod:`.e2e`) summarizes a synthetic
640x360 scene clip and reports ``e2e_video_fps``; ``python -m
avsum_torch.bench hour`` (:mod:`.hour`) summarizes an hour of 640x360
video and reports ``hour_scale_wall_s``; ``python -m avsum_torch.bench
train-hour`` (:mod:`.train_hour`) times the train step at S = 7168.

Each prints exactly one JSON line per measured configuration on stdout,
logs to stderr, and exits non-zero on any failure. They run on the card
(``--device cuda``, the default) and raise without one unless ``--device
cpu`` is given; a CPU run writes null under every key that names a device
metric, since its times say nothing of the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(REPO, "bench_data")
# NVIDIA H100 SXM, dense bf16 tensor-core rate (data sheet)
H100_BF16_FLOPS = 989e12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(result: dict) -> None:
    """One result line on stdout."""
    print(json.dumps(result), flush=True)


def require_device(device: str) -> str:
    """``device`` when it can run here; a CUDA device without a card
    raises (a measurement never falls back to the CPU)."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device here; pass --device cpu to "
            "run on the CPU")
    return device


def on_card(device: str) -> bool:
    return torch.device(device).type == "cuda"


def tf32_off(device: str) -> None:
    """TF32 off for matmuls and cuDNN on the card (float32 products stay
    float32, the port's parity setting); process-wide, so every spawned
    rank sets it too."""
    if on_card(device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def card(device: str) -> Optional[str]:
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    if not on_card(device):
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _wrappers() -> dict:
    """Kernel name -> its wrapper, whose ``launches`` counts the launches
    of the kernel (never those of its plain version)."""
    from avsum_torch.ops import attention, melspec

    return {"melspec": melspec.fused_log_mel,
            "flash_fwd": attention.flash_attention,
            "flash_bwd": attention.flash_bwd}


def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def launches(*names: str) -> Dict[str, int]:
    """The launch counts of the kernels ``names``."""
    wrappers = _wrappers()
    return {name: wrappers[name].launches for name in names}


def write_once(stem: str, write: Callable[[str], None]) -> None:
    """``write(stem)`` makes ``stem``.y4m and .wav unless both are there;
    it writes under a temporary stem, renamed after, so an interrupted
    write is never reused."""
    if os.path.exists(stem + ".y4m") and os.path.exists(stem + ".wav"):
        return
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    tmp = f"{stem}.partial{os.getpid()}"
    t0 = time.perf_counter()
    write(tmp)
    for ext in (".wav", ".y4m"):
        os.replace(tmp + ext, stem + ext)
    log(f"media written to {stem} in {time.perf_counter() - t0:.1f} s")


def timed_summarizes(pipeline, model, video: str, n: int,
                     want_segments=None):
    """``n`` summarizes of ``video``, each under ``collect_stages`` ->
    (seconds, stage seconds by span, K1 and K2 launches, each a list by
    run; the last result). A run whose segments differ from
    ``want_segments`` raises."""
    from avsum_torch.utils.profiling import collect_stages

    runs, stages, kernels = [], [], []
    for i in range(n):
        reset_launches()
        with collect_stages() as st:
            t0 = time.perf_counter()
            result = pipeline.summarize(video, model)
            dt = time.perf_counter() - t0
        runs.append(dt)
        stages.append({k.split(".")[-1]: v for k, v in st.items()})
        kernels.append(launches("melspec", "flash_fwd"))
        log(f"run {i}: {dt:.3f} s ({int(result['n_frames'])} frames, "
            f"{len(result['boundaries'])} shots, "
            f"{len(result['segments'])} summary segments), launches "
            f"{kernels[-1]}")
        if want_segments is not None and not np.array_equal(
                result["segments"], want_segments):
            raise AssertionError(f"run {i}: segments differ from the first "
                                 "run's")
    return runs, stages, {name: [k[name] for k in kernels]
                          for name in ("melspec", "flash_fwd")}, result
