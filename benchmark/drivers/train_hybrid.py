"""A training job of the scorer whose temporal encoder is Kimi-Linear-48B-A3B's
hybrid decoder (Kimi Delta Attention and NoPE latent attention,
``model.kda_layers``): the port's train step over host batches, driven
as ``train_decoder.py`` drives Moonlight's, whose window, counters and
comparison it shares.

Set-up builds the scorer from the configuration on the card, loads the
initial weights the benchmark drew from the seed through the reference's
own rule (``benchmark/reference/kimi_linear.py``) under the leaf map
below, and takes the first three steps of ``make_train_step`` on the
pool's first three batches, keeping what ``train_decoder.py`` keeps, and
besides the input and the output of the visual decoder's first KDA layer
in the first step (a forward hook). The window also takes the
differences of the KDA kernel's launch counters, ``kda_fwd.launches``
and ``kda_bwd.launches``.

The check runs the reference over the same three batches (float32, TF32
off, its MoE layers replaying the program's choice of experts) and
compares ``loss_gap``, ``grad1_gap``, ``change_gap`` and
``route_miss_share`` as ``train_decoder.py`` does, and one direct reading
of the new mechanism, ``kda_out_gap``: the reference's KDA layer, its
recurrence token by token, run from the seed's weights on the input the
program's first KDA layer took, against that layer's output: the largest
|difference| over the largest |reference| entry.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, List, Tuple

import torch

from benchmark.drivers import train, train_decoder
from benchmark.generators import feature_batches
from benchmark.harness import Window, log
from benchmark.program import program_config
from benchmark.reference import kimi_linear as reference
from benchmark.reference.scorer import step_seeds

CHECKED_STEPS = train.CHECKED_STEPS
# the port's KDA parameter (under a layer's self_attn) -> the reference leaf
KDA_LEAVES = {"q_proj.weight": "q", "k_proj.weight": "k",
              "v_proj.weight": "v", "q_conv1d.weight": "q_conv",
              "k_conv1d.weight": "k_conv", "v_conv1d.weight": "v_conv",
              "f_a_proj.weight": "f_a", "f_b_proj.weight": "f_b",
              "A_log": "A_log", "dt_bias": "dt_bias", "b_proj.weight": "b",
              "g_a_proj.weight": "g_a", "g_b_proj.weight": "g_b.w",
              "g_b_proj.bias": "g_b.b", "o_norm.weight": "o_norm.g",
              "o_proj.weight": "o"}
# the window's counts by name -> the KDA kernel's counters
KDA_COUNTERS = ("kda_fwd", "kda_bwd")


def program_leaf_map(model: dict) -> train_decoder.LeafMap:
    """Moonlight's map, with each KDA layer's attention leaves in place of
    its latent attention's."""
    out = train_decoder.program_leaf_map(model)
    for m in ("visual", "audio"):
        for i in range(model["temporal_layers"]):
            if not reference.is_kda(model, i):
                continue
            att = f"{m}_temporal.layers.{i}.self_attn"
            for name in [n for n in out if n.startswith(att + ".")]:
                del out[name]
            for prog, ref in KDA_LEAVES.items():
                out[f"{att}.{prog}"] = ([f"{m}_enc.{i}.{ref}"], 0)
    return out


def program_state(leaves: Dict[str, torch.Tensor], model: dict
                  ) -> Dict[str, torch.Tensor]:
    """The port's parameters, by name, out of the reference's leaves."""
    return {prog: torch.cat([leaves[r] for r in refs], dim=axis)
            for prog, (refs, axis) in program_leaf_map(model).items()}


def leaf_norms(tensors: Dict[str, torch.Tensor], model: dict
               ) -> Dict[str, float]:
    """Each reference leaf's norm, out of the port's tensors by name."""
    shapes = {n: s for n, s, _ in reference.leaf_specs(model)}
    out = {}
    for prog, (refs, axis) in program_leaf_map(model).items():
        parts = torch.split(tensors[prog], [shapes[r][axis] for r in refs],
                            dim=axis)
        for ref, part in zip(refs, parts):
            out[ref] = float(part.double().norm())
    return out


def first_kda(model: dict) -> int:
    """The 0-based index of the decoder's first KDA layer."""
    return next(i for i in range(model["temporal_layers"])
                if reference.is_kda(model, i))


def setup(run, model_overrides: Dict[str, object] = None):
    """``model_overrides``: keys of the program's ``model`` changed from
    the configuration's, for a planted fault (the reference keeps them)."""
    from avsum_torch.models.decoder import MoEGate
    from avsum_torch.models.scorer import AVScorer, to_mesh
    from avsum_torch.parallel.mesh import build_mesh, mesh_config
    from avsum_torch.train import steps

    config, traffic = run.cell.config, run.cell.traffic
    model_cfg = config["program"]["model"]
    train_cfg = config["program"]["train"]
    program = copy.deepcopy(config)
    program["program"]["model"].update(model_overrides or {})
    cfg = program_config(program)
    steps.apply_matmul_precision(cfg.train.matmul_precision)
    with torch.device(run.device):
        model = AVScorer(cfg.model)
    pool = feature_batches.make(traffic["batches"], model_cfg, run.seed,
                                run.device)
    mesh = build_mesh(mesh_config(cfg.mesh), run.device)
    state = model.state_dict()
    state.update(program_state(
        reference.init_leaves(model_cfg, run.seed, run.device), model_cfg))
    model.load_state_dict(state)
    del state
    model = to_mesh(model, mesh)
    total = train_cfg["epochs"] * traffic["batches"]["pool"]
    state = steps.create_train_state(model, cfg.train, total_steps=total)
    step = steps.make_train_step(model, mesh, run.seed % 2 ** 63,
                                 ema_decay=cfg.train.ema_decay)

    def place(i: int):
        return steps.shard_batch_dict(pool[i % len(pool)], mesh)

    names = [n for n, _ in model.named_parameters()]
    start = [p.detach().clone() for p in state.optimizer.params]
    routes: List[List[torch.Tensor]] = []  # a list of the layers' a step
    hooks = [m.register_forward_hook(
        lambda mod, args, out: routes[-1].append(out[0].detach().clone()))
        for m in model.modules() if isinstance(m, MoEGate)]
    probe: Dict[str, torch.Tensor] = {}

    def keep(mod, args, out):
        if not probe:
            probe.update(x=args[0].detach().clone(), out=out.detach().clone())

    hooks.append(model.visual_temporal.layers[first_kda(
        model_cfg)].self_attn.register_forward_hook(keep))
    losses = []
    for i in range(CHECKED_STEPS):
        routes.append([])
        state, metrics = step(state, place(i))
        losses.append(metrics["loss"])
        if i == 0:
            grad1 = leaf_norms({n: mu / (1 - steps.B1) for n, mu in zip(
                names, state.optimizer.mu)}, model_cfg)
    for h in hooks:
        h.remove()
    change = leaf_norms({n: p.detach() - p0 for n, p, p0 in zip(
        names, state.optimizer.params, start)}, model_cfg)
    del start
    return {"state": state, "step": step, "place": place, "pool": pool,
            "shots": [float(b["mask"].sum()) for b in pool],
            "video_shots": [[int(m.sum()) for m in b["mask"]] for b in pool],
            "next": CHECKED_STEPS, "log_every": cfg.train.log_every,
            "losses": [float(x) for x in losses], "grad1": grad1,
            "change": change, "total_steps": total, "routes": routes,
            "probe": probe}


def _kda_counters() -> Dict[str, int]:
    from avsum_torch.ops import kda

    return {f"{name}.launches": getattr(kda, name).launches
            for name in KDA_COUNTERS}


def window(run, st, seconds: float) -> Window:
    before = _kda_counters()
    win = train_decoder.window(run, st, seconds)
    after = _kda_counters()
    win.counts.update({name: after[name] - before[name] for name in after})
    return win


@contextlib.contextmanager
def _tf32(on: bool):
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def reference_readings(run, st, tf32: bool = False, replay=None) -> dict:
    """``train_decoder.reference_readings`` through this reference."""
    config = run.cell.config
    model_cfg = config["program"]["model"]
    with _tf32(tf32):
        leaves = reference.init_leaves(model_cfg, run.seed, run.device)
        # kept on the host, as the first gradient is, out of the steps' way
        start = {k: v.to("cpu", copy=True) for k, v in leaves.items()}
        batches = [{k: torch.as_tensor(v, device=run.device)
                    for k, v in st["pool"][i % len(st["pool"])].items()}
                   for i in range(CHECKED_STEPS)]
        losses, first, routes = reference.train_steps(
            leaves, model_cfg, config["program"]["train"], st["total_steps"],
            batches, run.seed % 2 ** 63, replay)
        grad1 = {k: float(g.double().norm()) for k, g in first.items()}
        del first
        change = {k: float((leaves[k] - start[k].to(leaves[k].device))
                           .double().norm()) for k in leaves}
    return {"losses": losses, "grad1": grad1, "change": change,
            "routes": routes}


def reference_kda(run, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The reference's first KDA layer of the visual decoder, from the
    seed's weights, on ``x``."""
    model_cfg = run.cell.config["program"]["model"]
    with _tf32(tf32), torch.no_grad():
        leaves = reference.init_leaves(model_cfg, run.seed, run.device)
        return reference.kda(x, leaves, f"visual_enc.{first_kda(model_cfg)}",
                             model_cfg)


def out_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def compare(run, prog: dict, ref: dict) -> List[Tuple[str, float]]:
    return train_decoder.compare(run, prog, ref) + [
        ("kda_out_gap", out_gap(prog["probe"]["out"], ref["kda_out"]))]


def reference_side(run, st) -> dict:
    """The check's reference readings, the program freed first; logs the
    reference's seconds, the most pairs a layer the program sent to the
    held experts, and the check's own peak memory on the card."""
    train.free_program(st)
    if run.on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    started = time.perf_counter()
    ref = reference_readings(run, st, replay=st["routes"])
    ref["kda_out"] = reference_kda(run, st["probe"]["x"])
    held = run.cell.config["program"]["model"]["moe_experts_held"]
    pairs = max(int((choice < held).sum()) for layers in st["routes"]
                for choice in layers)
    peak = (f"; its peak allocated "
            f"{torch.cuda.max_memory_allocated(run.device)} bytes, reserved "
            f"{torch.cuda.max_memory_reserved(run.device)}"
            if run.on_card else "")
    log(f"check: the reference took {time.perf_counter() - started:.1f} s; "
        f"at most {pairs} pairs a layer to the held experts{peak}")
    return ref


def check(run, st) -> List[Tuple[str, float, float]]:
    ref = reference_side(run, st)
    limits = run.cell.limits
    return [(name, value, limits[name])
            for name, value in compare(run, st, ref)]


# the readings ``benchmark.control`` takes on the card: the port as it
# runs, the reference in TF32 (the precision below the configuration's
# float32) in its place, the port with half of each batch left out, the
# port routing each shot to one expert fewer than the reference, and the
# port with each fault of ``benchmark/faults_kda.py`` planted
MODES = ("sound", "control", "half_batch", "top_k_less", "no_decay",
         "no_delta", "noncausal_conv", "unnormalized_qk")


def readings(run, mode: str) -> Dict[str, float]:
    from benchmark import faults, faults_kda

    model_cfg = run.cell.config["program"]["model"]
    if mode == "control":
        pool = {"pool": feature_batches.make(
            run.cell.traffic["batches"], model_cfg, run.seed, run.device),
            "total_steps": (run.cell.config["program"]["train"]["epochs"]
                            * run.cell.traffic["batches"]["pool"])}
        prog = {**pool, **reference_readings(run, pool, tf32=True)}
        visual = torch.as_tensor(pool["pool"][0]["visual"], device=run.device)
        with torch.no_grad():
            x = reference.first_kda_input(
                reference.init_leaves(model_cfg, run.seed, run.device),
                model_cfg, visual, step_seeds(run.seed % 2 ** 63, 0))
        prog["probe"] = {"out": reference_kda(run, x, tf32=True)}
        ref = reference_readings(run, pool, replay=prog["routes"])
        ref["kda_out"] = reference_kda(run, x)
        return dict(compare(run, prog, ref))
    overrides = {}
    fault = contextlib.nullcontext()
    if mode == "top_k_less":
        overrides = {"num_experts_per_tok": model_cfg["num_experts_per_tok"]
                     - 1}
    elif mode in faults_kda.FAULTS:
        fault = faults_kda.FAULTS[mode]()
    elif mode != "sound":
        fault = faults.FAULTS[mode]()
    if run.on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    with fault:
        st = setup(run, overrides)
    if run.on_card:
        log(f"program: peak allocated "
            f"{torch.cuda.max_memory_allocated(run.device)} bytes")
    return dict(compare(run, st, reference_side(run, st)))
