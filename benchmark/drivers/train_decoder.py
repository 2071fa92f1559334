"""A training job of the scorer whose temporal encoder is Moonlight-16B-A3B's
decoder (``temporal_encoder: mla_moe``): the port's train step over host
batches, as ``train.py`` drives the attention scorer's.

Set-up builds the scorer from the configuration on the card, loads the
initial weights the benchmark drew from the seed through the reference's
own rule (``benchmark/reference/decoder.py``) under the leaf map below,
makes the train state and the step of ``make_train_step``, and drives
that step through its first three steps on the pool's first three
batches, each placed from host NumPy by ``shard_batch_dict``. It keeps
each step's loss, the first step's gradient as the optimizer took it,
the parameters' change after the three, each by reference leaf, and
each step's choice of experts in every MoE layer (a hook on each
router). The window is ``train.py``'s; it also takes the differences of
the held experts' counters over the window, as ``moe.routed_held``,
``moe.routed_total`` and ``moe.host_syncs``.

The check runs the reference over the same three batches from the same
seeded weights and dropout seeds, float32 with TF32 off, its MoE layers
taking the program's choice of experts (``replay``; each weighed by the
reference's own scores), and compares, each against its limit:
``train.py``'s ``loss_gap``, ``grad1_gap`` and ``change_gap``, and
``route_miss_share``: the share of the token-expert pairs the reference
chose itself in the three steps (every MoE layer, both modalities, real
shots) that the program did not choose; the reference's own choice in
each step is made from the weights of its own updates. The choices are compared apart
because the top k is discontinuous: two float32 runs that differ by
rounding choose differently where two experts' scores tie within it, a
few shots a step, and each such shot then differs by a whole expert's
output, which would swamp the gaps of everything else.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Tuple

import torch

from benchmark.drivers import train
from benchmark.generators import feature_batches
from benchmark.harness import Window
from benchmark.program import program_config
from benchmark.reference import decoder as reference

CHECKED_STEPS = train.CHECKED_STEPS
# the window's counts by name -> the held experts' counters
COUNTERS = {"moe.routed_held": "routed_held",
            "moe.routed_total": "routed_total",
            "moe.host_syncs": "host_syncs"}

# the port's parameter name -> (the reference leaves it holds, the axis
# they are concatenated along)
LeafMap = Dict[str, Tuple[List[str], int]]


def program_leaf_map(model: dict) -> LeafMap:
    out: LeafMap = {}

    def one(prog: str, ref: str) -> None:
        out[prog] = ([ref], 0)

    def linear(prog: str, ref: str) -> None:
        one(f"{prog}.weight", f"{ref}.w")
        one(f"{prog}.bias", f"{ref}.b")

    def swiglu(prog: str, ref: str, suffix: str = ".weight",
               axis: int = 0) -> None:
        out[f"{prog}.gate_up{suffix}"] = ([f"{ref}.gate", f"{ref}.up"], axis)
        one(f"{prog}.down{suffix}", f"{ref}.down")

    for m in ("visual", "audio"):
        linear(f"{m}_fc.dense", f"{m}_fc")
        for i in range(model["temporal_layers"]):
            prog, ref = f"{m}_temporal.layers.{i}", f"{m}_enc.{i}"
            att = f"{prog}.self_attn"
            one(f"{prog}.input_layernorm.weight", f"{ref}.ln0.g")
            one(f"{att}.q_proj.weight", f"{ref}.q")
            one(f"{att}.kv_a_proj_with_mqa.weight", f"{ref}.kv_a")
            one(f"{att}.kv_a_layernorm.weight", f"{ref}.kv_norm.g")
            one(f"{att}.kv_b_proj.weight", f"{ref}.kv_b")
            one(f"{att}.o_proj.weight", f"{ref}.o")
            one(f"{prog}.post_attention_layernorm.weight", f"{ref}.ln1.g")
            if i < model["first_k_dense_replace"]:
                swiglu(f"{prog}.mlp", f"{ref}.mlp")
            else:
                one(f"{prog}.mlp.gate.weight", f"{ref}.router")
                swiglu(f"{prog}.mlp.experts", f"{ref}.experts", "", 1)
                swiglu(f"{prog}.mlp.shared_experts", f"{ref}.shared")
        one(f"{m}_temporal.norm.weight", f"{m}_enc.norm.g")
    out["cross_attention.qkv.weight"] = ([f"fusion.{p}.w" for p in "qkv"], 0)
    out["cross_attention.qkv.bias"] = ([f"fusion.{p}.b" for p in "qkv"], 0)
    linear("cross_attention.out", "fusion.o")
    linear("scorer_hidden", "head")
    linear("scorer_out", "out")
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
            "change": change, "total_steps": total, "routes": routes}


def _counters() -> Dict[str, int]:
    from avsum_torch.models.decoder import HeldExperts

    return {name: getattr(HeldExperts, attr)
            for name, attr in COUNTERS.items()}


def window(run, st, seconds: float) -> Window:
    before = _counters()
    win = train.window(run, st, seconds)
    after = _counters()
    win.counts.update({name: after[name] - before[name] for name in after})
    return win


def reference_readings(run, st, tf32: bool = False, replay=None) -> dict:
    """The reference's three steps from the seed: losses, first-gradient
    and change norms by leaf, each step's own choices (float32; with
    ``tf32``, TF32 products); ``replay``: each step's choices of another
    run, which its MoE layers take."""
    config = run.cell.config
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
        losses, first, routes = reference.train_steps(
            leaves, model_cfg, config["program"]["train"], st["total_steps"],
            batches, run.seed % 2 ** 63, replay)
        grad1 = {k: float(g.double().norm()) for k, g in first.items()}
        del first
        change = {k: float((leaves[k] - start[k]).double().norm())
                  for k in leaves}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
    return {"losses": losses, "grad1": grad1, "change": change,
            "routes": routes}


def route_miss_share(prog: List[List[torch.Tensor]],
                     ref: List[List[torch.Tensor]], masks: list,
                     n_experts: int) -> float:
    """The share of ``ref``'s token-expert pairs ([N, k] choices a layer,
    a list of the layers' a step) on the real shots of each step's mask
    that ``prog`` did not choose in that step."""
    if [len(p) for p in prog] != [len(r) for r in ref]:
        raise RuntimeError(f"routed layers a step {[len(p) for p in prog]},"
                           f" the reference {[len(r) for r in ref]}")
    missed = total = 0
    for layers, ref_layers, mask in zip(prog, ref, masks):
        for p, r in zip(layers, ref_layers):
            real = torch.as_tensor(mask, device=r.device).reshape(-1) > 0
            chosen = torch.zeros((r.shape[0], n_experts), dtype=torch.bool,
                                 device=r.device)
            wanted = chosen.clone().scatter_(1, r, True)[real]
            chosen = chosen.scatter_(1, p.to(r.device), True)[real]
            missed += int((wanted & ~chosen).sum())
            total += int(wanted.sum())
    return missed / total


def compare(run, prog: dict, ref: dict) -> List[Tuple[str, float]]:
    n_experts = run.cell.config["program"]["model"]["n_routed_experts"]
    pool = prog["pool"]
    if len(prog["routes"]) != CHECKED_STEPS or len(ref["routes"]) != (
            CHECKED_STEPS):
        raise RuntimeError(f"{len(prog['routes'])} routed steps, the "
                           f"reference {len(ref['routes'])}")
    masks = [pool[i % len(pool)]["mask"] for i in range(CHECKED_STEPS)]
    return train.compare(prog, ref) + [("route_miss_share", route_miss_share(
        prog["routes"], ref["routes"], masks, n_experts))]


def check(run, st) -> List[Tuple[str, float, float]]:
    train.free_program(st)
    readings = compare(run, st, reference_readings(run, st,
                                                   replay=st["routes"]))
    limits = run.cell.limits
    return [(name, value, limits[name]) for name, value in readings]


# the readings ``benchmark.control`` takes on the card: the port as it
# runs, the reference in TF32 (the precision below the configuration's
# float32) in its place, the port with half of each batch left out, and
# the port routing each shot to one expert fewer than the reference
MODES = ("sound", "control", "half_batch", "top5")


def readings(run, mode: str) -> Dict[str, float]:
    from benchmark import faults

    if mode == "control":
        model_cfg = run.cell.config["program"]["model"]
        pool = {"pool": feature_batches.make(
            run.cell.traffic["batches"], model_cfg, run.seed, run.device),
            "total_steps": (run.cell.config["program"]["train"]["epochs"]
                            * run.cell.traffic["batches"]["pool"])}
        prog = {**pool, **reference_readings(run, pool, tf32=True)}
        return dict(compare(run, prog, reference_readings(
            run, pool, replay=prog["routes"])))
    overrides = {}
    fault = contextlib.nullcontext()
    if mode == "top5":
        overrides = {"num_experts_per_tok": run.cell.config["program"][
            "model"]["num_experts_per_tok"] - 1}
    elif mode != "sound":
        fault = faults.FAULTS[mode]()
    with fault:
        st = setup(run, overrides)
    train.free_program(st)
    return dict(compare(run, st, reference_readings(run, st,
                                                    replay=st["routes"])))
