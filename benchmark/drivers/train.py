"""A training job: the port's train step over host batches.

Set-up builds the scorer from the configuration, loads the initial
weights the benchmark drew from the seed, makes the train state and the
step of ``avsum_torch.train.steps.make_train_step``, and drives that same
step through its first three steps on the pool's first three batches,
each placed from host NumPy by ``shard_batch_dict`` as ``Trainer.fit``
places it. It keeps each step's loss, the first step's gradient as the
optimizer took it (Adam's first moment after one step over 1 - b1) and
the parameters' change after the three, each by reference leaf. Those
steps build the kernels and warm every shape the window uses.

The window goes on stepping through the pool, placing every batch anew,
reading the metrics every ``train.log_every`` steps as ``fit`` does, and
ends in a synchronize: ``train_shots_per_s`` is the real (unmasked)
shots of every step over the window's seconds.

The check runs the plain reference (``benchmark/reference/scorer.py``)
over the same three batches from the same seeded weights and dropout
seeds, float32 with TF32 off, and compares, each against its limit:
the worst relative loss gap of the three steps, and the worst leaf's gap
of the first gradient's norm and of the change's norm, each over the
larger of that leaf's reference norm and the median leaf's. Leaves whose
first reference gradient is under a thousandth of the median leaf's
(a key's bias under softmax) move by round-off alone and are left out
of the change.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Tuple

import torch

from benchmark.generators import feature_batches
from benchmark.harness import Window, log
from benchmark.program import leaf_norms, program_config, program_state
from benchmark.reference import scorer as reference

CHECKED_STEPS = 3
IDLE_GRADIENT = 1e-3  # of the median leaf's first gradient norm


def setup(run):
    from avsum_torch.models.scorer import AVScorer, to_mesh
    from avsum_torch.parallel.mesh import build_mesh, mesh_config
    from avsum_torch.train import steps

    config, traffic = run.cell.config, run.cell.traffic
    model_cfg = config["program"]["model"]
    train_cfg = config["program"]["train"]
    cfg = program_config(config)
    steps.apply_matmul_precision(cfg.train.matmul_precision)
    pool = feature_batches.make(traffic["batches"], model_cfg, run.seed,
                                run.device)
    mesh = build_mesh(mesh_config(cfg.mesh), run.device)
    leaves = reference.init_leaves(model_cfg, run.seed, run.device)
    with torch.device(run.device):
        model = AVScorer(cfg.model)
    model.load_state_dict(program_state(leaves, model_cfg))
    model = to_mesh(model, mesh)
    del leaves
    total = train_cfg["epochs"] * traffic["batches"]["pool"]
    state = steps.create_train_state(model, cfg.train, total_steps=total)
    step = steps.make_train_step(model, mesh, run.seed % 2 ** 63,
                                 ema_decay=cfg.train.ema_decay)

    def place(i: int):
        return steps.shard_batch_dict(pool[i % len(pool)], mesh)

    names = [n for n, _ in model.named_parameters()]
    start = [p.detach().clone() for p in state.optimizer.params]
    shapes = {n: s for n, s, _ in reference.leaf_specs(model_cfg)}
    losses = []
    for i in range(CHECKED_STEPS):
        state, metrics = step(state, place(i))
        losses.append(metrics["loss"])
        if i == 0:
            first = {n: mu / (1 - steps.B1)
                     for n, mu in zip(names, state.optimizer.mu)}
            grad1 = leaf_norms(first, model_cfg, shapes)
            del first
    change = leaf_norms({n: p.detach() - p0 for n, p, p0 in zip(
        names, state.optimizer.params, start)}, model_cfg, shapes)
    del start
    return {"state": state, "step": step, "place": place, "pool": pool,
            "shots": [float(b["mask"].sum()) for b in pool],
            "video_shots": [[int(m.sum()) for m in b["mask"]] for b in pool],
            "next": CHECKED_STEPS, "log_every": cfg.train.log_every,
            "losses": [float(x) for x in losses], "grad1": grad1,
            "change": change, "total_steps": total}


def window(run, st, seconds: float) -> Window:
    step, place, state = st["step"], st["place"], st["state"]
    n, i0 = len(st["pool"]), st["next"]
    i = i0
    shots = 0.0
    failed = 0
    videos = []
    reads: List[float] = []
    with run.window() as clock:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            try:
                state, metrics = step(state, place(i))
            except RuntimeError as e:
                log(f"step {i} failed: {e}")
                failed += 1
                i += 1
                continue
            shots += st["shots"][i % n]
            videos += st["video_shots"][i % n]
            i += 1
            if state.step % st["log_every"] == 0:  # fit's read of the metrics
                [v.item() for v in metrics.values()]
                reads.append(time.perf_counter())
    st["state"] = state
    steps_done = i - i0
    blocks = [1e3 * (b - a) / st["log_every"] for a, b in zip(reads, reads[1:])]
    log(f"window: {steps_done} steps, {shots:.0f} shots in "
        f"{clock['seconds']:.3f} s; ms a step between metric reads: "
        + (f"min {min(blocks):.2f}, median {statistics.median(blocks):.2f}, "
           f"max {max(blocks):.2f}" if blocks else "none"))
    return Window(attempted=steps_done, failed=failed,
                  metrics={"train_shots_per_s": shots / clock["seconds"]},
                  counts={"steps": steps_done - failed, "shots": shots,
                          "video_shots": videos})


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   names: List[str]) -> Tuple[float, str]:
    """(max over ``names`` of |prog - ref| over the larger of the leaf's
    reference norm and the median leaf's, the leaf that gives it)."""
    median = statistics.median(ref[n] for n in names)
    return max((abs(prog[n] - ref[n]) / max(ref[n], median), n)
               for n in names)


def reference_readings(run, st, tf32: bool = False) -> dict:
    """The reference's three steps from the seed: losses, first-gradient
    and change norms by leaf (float32; with ``tf32``, TF32 products)."""
    config, traffic = run.cell.config, run.cell.traffic
    model_cfg = config["program"]["model"]
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        leaves = reference.init_leaves(model_cfg, run.seed, run.device)
        start = {k: v.clone() for k, v in leaves.items()}
        batches = [{k: torch.as_tensor(v, device=run.device)
                    for k, v in st["pool"][i % len(st["pool"])].items()}
                   for i in range(CHECKED_STEPS)]
        losses, first = reference.train_steps(
            leaves, model_cfg, config["program"]["train"],
            st["total_steps"], batches, run.seed % 2 ** 63)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
    return {"losses": losses,
            "grad1": {k: float(g.double().norm()) for k, g in first.items()},
            "change": {k: float((leaves[k] - start[k]).double().norm())
                       for k in leaves}}


def compare(prog: dict, ref: dict) -> List[Tuple[str, float]]:
    """[(name, reading)] of the numbers compared."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    names = sorted(ref["grad1"])
    grad, grad_leaf = worst_leaf_gap(prog["grad1"], ref["grad1"], names)
    median = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= IDLE_GRADIENT * median]
    change, change_leaf = worst_leaf_gap(prog["change"], ref["change"], moving)
    log(f"worst leaves: first gradient {grad_leaf}, change {change_leaf}; "
        f"{len(names) - len(moving)} of {len(names)} leaves left out of the "
        f"change")
    return [("loss_gap", loss), ("grad1_gap", grad), ("change_gap", change)]


def free_program(st) -> None:
    for key in ("state", "step", "place"):
        st.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, st) -> List[Tuple[str, float, float]]:
    free_program(st)
    ref = reference_readings(run, st)
    readings = compare(st, ref)
    limits = run.cell.limits
    return [(name, value, limits[name]) for name, value in readings]



# the readings ``benchmark.control`` takes on the card: the port as it
# runs, the reference in TF32 (the precision below the configuration's
# float32) in its place, and the port with a fault planted
MODES = ("sound", "control", "half_batch")


def readings(run, mode: str) -> Dict[str, float]:
    from benchmark import faults

    if mode == "control":
        pool = {"pool": feature_batches.make(
            run.cell.traffic["batches"], run.cell.config["program"]["model"],
            run.seed, run.device),
            "total_steps": (run.cell.config["program"]["train"]["epochs"]
                            * run.cell.traffic["batches"]["pool"])}
        prog = reference_readings(run, pool, tf32=True)
        return dict(compare(prog, reference_readings(run, pool)))
    fault = (faults.FAULTS[mode]() if mode != "sound"
             else contextlib.nullcontext())
    with fault:
        st = setup(run)
    free_program(st)
    return dict(compare(st, reference_readings(run, st)))
