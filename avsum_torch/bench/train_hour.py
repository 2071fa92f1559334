"""Hour-scale train step, the counterpart of the JAX package's
``scripts/bench_train_hour.py``: one AVScorer train step at S = 7168 shots
(an hour at 30 fps sampled at 2 fps), attention encoder, hidden
``--hidden``, 4 heads, 2 layers, float32, lr 1e-4 with 5 warmup steps, on
the JAX script's batch (``default_rng(0)``: visual, audio, targets, mask).

- ``--mode chip``: one device, the flash kernels (K2 forward, the fused
  backward), with remat (``chip_remat_flash``) and without
  (``chip_norematerialize``), so the memory-for-FLOPs trade shows in
  ``hbm_peak_mib`` (``torch.cuda.max_memory_allocated`` after a reset).
- ``--mode mesh --ranks N``: the sequence split N ways (``seq`` = N), every
  self-attention a ring over the ranks (``parallel/ring.py``), on spawned
  ranks: NCCL, a card each, where the machine has N cards, else gloo ranks
  sharing the one card (or the CPU).

Prints one JSON line per configuration: the warm step's milliseconds
(best of ``--steps``, each ending in a host read of the loss), every
step's, the first step's seconds (there is no compile: that is the
first step with its allocations and cuDNN / cuBLAS set-up), the peak
device memory, the loss, tokens per second and the kernels' launches.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from avsum_torch.bench import (
    card,
    emit,
    launches,
    log,
    on_card,
    require_device,
    reset_launches,
)

FLASH = ("flash_fwd", "flash_bwd")


def add_arguments(ap) -> None:
    ap.add_argument("--mode", default="chip", choices=("chip", "mesh"))
    ap.add_argument("--seq", type=int, default=7168)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5,
                    help="timed steps after the first")
    ap.add_argument("--ranks", type=int, default=8,
                    help="--mode mesh: the seq axis, one process a rank")


def bench_config(config: Optional[str], overrides, hidden: int,
                 remat: bool):
    """The JAX script's ModelConfig and TrainConfig, then ``overrides``."""
    from avsum_torch.train.config import load_config

    return load_config(config, [
        f"model.hidden_dim={hidden}", "model.num_heads=4",
        "model.temporal_layers=2", f"model.remat={str(remat).lower()}",
        "model.dtype=float32", "train.lr=1e-4", "train.warmup_steps=5",
        *overrides])


def make_batch(model_cfg, seq_len: int, batch_videos: int = 1) -> dict:
    """The JAX script's batch, drawn in its order."""
    rng = np.random.default_rng(0)
    b = batch_videos
    return {
        "visual": rng.standard_normal(
            (b, seq_len, model_cfg.visual_dim)).astype(np.float32),
        "audio": rng.standard_normal(
            (b, seq_len, model_cfg.audio_dim)).astype(np.float32),
        "targets": rng.random((b, seq_len)).astype(np.float32),
        "mask": np.ones((b, seq_len), np.float32),
    }


def measure(model_cfg, train_cfg, seq_len: int, label: str, steps: int = 5,
            batch_videos: int = 1, device: str = "cuda", mesh=None,
            seed: int = 0, state_dict: Optional[dict] = None) -> dict:
    """One configuration: the first step, then ``steps`` timed ones ->
    the result line (not printed)."""
    from avsum_torch.models.scorer import make_model, to_mesh
    from avsum_torch.parallel.mesh import shard_batch
    from avsum_torch.train import steps as train_steps

    batch = make_batch(model_cfg, seq_len, batch_videos)
    model = make_model(model_cfg, seed, state_dict)
    if mesh is None:
        model = model.to(device)
        batch = train_steps.batch_to_device(batch, device)
    else:  # this rank's block, on its device
        model, device = to_mesh(model, mesh), mesh.device
        batch = shard_batch(batch, mesh)
    state = train_steps.create_train_state(model, train_cfg, total_steps=100)
    step = train_steps.make_train_step(model, mesh, seed=0)
    if on_card(device):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    loss = float(step(state, batch)[1]["loss"])
    first = time.perf_counter() - t0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(step(state, batch)[1]["loss"])
        times.append(time.perf_counter() - t0)
    result = {
        "bench": "hour_scale_train_step",
        "label": label,
        "seq_len": seq_len,
        "backend": torch.device(device).type,
        "n_devices": 1,
        "step_ms": 1e3 * min(times),
        "steps_ms": [1e3 * t for t in times],
        "first_step_s": first,
        "hbm_peak_mib": (torch.cuda.max_memory_allocated(device) / 2 ** 20
                         if on_card(device) else None),
        "loss": loss,
        "tokens_per_s": seq_len * batch_videos / min(times),
        "kernels": launches(*FLASH),
    }
    log(f"{label}: {result['step_ms']:.1f} ms/step, peak "
        f"{result['hbm_peak_mib']} MiB, loss {loss:.5f}, launches "
        f"{result['kernels']}")
    return result


def mesh_rank(args_dict: dict, backend: str) -> dict:
    """One rank of ``--mode mesh`` (runs in a spawned process)."""
    from avsum_torch.parallel.mesh import MeshConfig, build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a = args_dict
    cfg = bench_config(a["config"], a["overrides"], a["hidden"], True)
    mesh = build_mesh(MeshConfig(data=1, seq=a["ranks"], model=1,
                                 auto_data=False), a["device"], backend)
    out = measure(cfg.model, cfg.train, a["seq"],
                  f"mesh_seq{a['ranks']}_ring_remat", a["steps"], mesh=mesh,
                  seed=a["seed"], state_dict=a["scorer"])
    out["device_index"] = mesh.device.index
    return out


def run_mesh(args, scorer: Optional[dict]) -> dict:
    from avsum_torch.parallel.multihost import Ranks

    n = args.ranks
    several = on_card(args.device) and torch.cuda.device_count() >= n
    backend = "nccl" if several else "gloo"
    a = {"config": args.config, "overrides": list(args.overrides),
         "hidden": args.hidden, "ranks": n, "device": args.device,
         "seq": args.seq, "steps": args.steps, "seed": args.seed,
         "scorer": scorer}
    with Ranks(n, backend) as world:
        ranks = world.run(mesh_rank, a, backend)
    devices = {r.pop("device_index") for r in ranks}
    return {**ranks[0], "n_devices": len(devices), "ranks": n,
            "dist_backend": backend,
            "ranks_step_ms": [r["step_ms"] for r in ranks]}


def run(args) -> int:
    from avsum_torch.cli.main import _device_setup

    require_device(args.device)
    weights = _device_setup(args)
    device = card(args.device)
    log(f"device: {device or args.device}")
    if args.mode == "mesh":
        emit({**run_mesh(args, weights.get("scorer")), "device": device})
        return 0
    for label, remat in (("chip_remat_flash", True),
                         ("chip_norematerialize", False)):
        cfg = bench_config(args.config, args.overrides, args.hidden, remat)
        emit({**measure(cfg.model, cfg.train, args.seq, label, args.steps,
                        device=args.device, seed=args.seed,
                        state_dict=weights.get("scorer")),
              "device": device})
    return 0
