"""Quality and step time of the PP and EP configs, the counterpart of the
JAX package's ``scripts/bench_pp_ep.py``: ``python -m avsum_torch.bench
ppep [--epochs 100] [--n-seeds 2] [--mesh-one] [--out F.json]``.

Three contenders (:func:`contenders`) train on the parity world
(:func:`avsum_torch.bench.parity.build_world` with ``--n-videos`` videos,
preprocessed once on ``--device``, encoders drawn from ``--seed``): the
flagship (the attention encoder, 2 layers), ``configs/deep_pp.yaml``'s
encoder (12 blocks in 4 GPipe stages) and ``configs/moe_ep.yaml``'s (8
experts, top 2), each at hidden 512 with the JAX script's overrides and
the Trainer's default schedule. Each is scored by TVSum's canonical
knapsack F1 on the held-out videos of each ``--folds`` fold (of 5), per
video, so that rows of one (fold, seed) give paired deltas against the
flagship. Epoch 1 is timed apart (``warmup_s``, the first steps' set-up);
the other epochs give ``step_ms``.

Where the contenders run: by default each at its own mesh (data 8, or
data 2 x model 4), on 8 spawned ranks over gloo
(:class:`avsum_torch.parallel.multihost.Ranks`), which share the card on
a one-card machine; every rank steps and predicts, rank 0 keeps the row.
``--mesh-one`` runs each in this process on a 1 x 1 x 1 mesh (stages and
experts in turn: the same math).

A row has the JAX script's keys, with ``step_ms`` in place of
``step_ms_virtual_cpu``, and says where it ran: ``device``, ``card``
(nvidia-smi's name and power limit), ``ranks``, ``dist_backend`` and
``shares_one_card``. The summary keeps the step medians of two placements
apart (:func:`summarize`). ``--append-rows`` merges rows of an earlier run
of this command; it refuses a row the JAX package wrote (no placement
stamps: another world's encoders, so another protocol). Output: ``--out``
(default ``PPEP_BENCH_TORCH.json``), with the JAX file's top-level keys.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from avsum_torch.bench import (
    REPO,
    card,
    emit,
    launches,
    log,
    on_card,
    require_device,
    reset_launches,
    tf32_off,
)

DEFAULT_OUT = os.path.join(REPO, "PPEP_BENCH_TORCH.json")
FLAGSHIP = "flagship_attention"
RANKS = 8  # every contender's own mesh: data 8, or data 2 x model 4
ONE = ["mesh.data=1", "mesh.seq=1", "mesh.model=1"]
STAMPS = ("device", "card", "ranks", "dist_backend", "shares_one_card")


def contenders():
    """(name, model overrides, mesh overrides). All share hidden_dim=512,
    the parity world's feature dims, batch_videos=8."""
    return [
        (
            FLAGSHIP,
            ["model.temporal_encoder=attention", "model.temporal_layers=2"],
            ["mesh.data=8", "mesh.seq=1", "mesh.model=1"],
        ),
        (
            "deep_pp",  # configs/deep_pp.yaml: 12 blocks over 4 stages
            [
                "model.temporal_encoder=attention",
                "model.temporal_layers=12",
                "model.pp_stages=4",
            ],
            ["mesh.data=2", "mesh.seq=1", "mesh.model=4"],
        ),
        (
            "moe_ep",  # configs/moe_ep.yaml: 8 experts over 4 ranks
            [
                "model.temporal_encoder=moe",
                "model.temporal_layers=2",
                "model.moe_experts=8",
                "model.moe_topk=2",
            ],
            ["mesh.data=2", "mesh.seq=1", "mesh.model=4"],
        ),
    ]


def run_config(hidden_dim: int, name: str, model_ov, mesh_ov,
               max_shots: int, epochs: int, seed: int, work: str,
               ckpt: str, extra=()):
    """The JAX script's training config of one contender, then ``extra``."""
    from avsum_torch.train.config import load_config

    return load_config(overrides=[
        *model_ov,
        *mesh_ov,
        f"model.hidden_dim={hidden_dim}",
        "model.num_heads=4",
        f"data.max_shots={max_shots}",
        "data.batch_videos=8",
        f"train.epochs={epochs}",
        f"train.checkpoint_dir={work}/{ckpt}",
        f"train.seed={seed}",
        "train.ema_decay=0.98",
        "train.save_every_epochs=1000000",
        "visual.dtype=float32",
        *extra,
    ])


def batches_fn(train_ex, max_shots: int, seed: int):
    """The JAX script's batches: 8 videos, reshuffled by ``seed + epoch``."""
    from avsum_torch.data.batching import batch_iterator

    def batches(epoch=0):
        return batch_iterator(train_ex, batch_size=8, max_shots=max_shots,
                              shuffle=True, seed=seed + epoch)

    return batches


def make_trainer(run_cfg, device: str, backend: Optional[str]):
    """-> (the Trainer on ``run_cfg.mesh`` over the world, the one-device
    model's parameter count)."""
    from avsum_torch.models.scorer import make_model
    from avsum_torch.train.trainer import Trainer

    model = make_model(run_cfg.model, seed=run_cfg.train.seed)
    n_params = sum(p.numel() for p in model.parameters())
    return Trainer(model, run_cfg, device=device, backend=backend), n_params


def train_and_eval(hidden_dim: int, name: str, model_ov, mesh_ov, train_ex,
                   test_ex, canon_fn, max_shots: int, epochs: int, seed: int,
                   work: str, fold_idx: int = 0, device: str = "cuda",
                   backend: Optional[str] = None) -> dict:
    """One (contender, fold, seed) cell -> its row (without the placement
    stamps). On a mesh every rank calls it."""
    from avsum_torch.bench.parity import evaluate_model

    run_cfg = run_config(hidden_dim, name, model_ov, mesh_ov, max_shots,
                         epochs, seed, work,
                         f"ckpt_{name}_f{fold_idx}_s{seed}")
    trainer, n_params = make_trainer(run_cfg, device, backend)
    batches = batches_fn(train_ex, max_shots, seed)
    steps_per_epoch = max(1, -(-len(train_ex) // 8))
    # epoch 1 pays the set-up; time the rest (each epoch ends in a host
    # read of its mean loss)
    t0 = time.perf_counter()
    trainer.fit(batches, epochs=1)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.fit(batches, epochs=epochs - 1)
    steady = time.perf_counter() - t0
    step_ms = 1e3 * steady / ((epochs - 1) * steps_per_epoch)

    mean, per_vid = evaluate_model(
        lambda ex: trainer.score_video(ex, max_shots), test_ex, canon_fn)
    return {
        "config": name,
        "seed": seed,
        "fold": fold_idx,
        "epochs": epochs,
        "backend": torch.device(device).type,
        "canonical_f1": round(mean["canonical_f1"], 4),
        "keyframe_f1": round(mean["f1"], 4),
        "spearman": round(mean["spearman"], 4),
        # per-video canonical F1: rows of one (fold, seed) give PAIRED
        # deltas against the flagship (the same held-out videos)
        "video_canonical_f1": {v: round(f, 4) for v, f in per_vid.items()},
        "step_ms": round(step_ms, 1),
        "warmup_s": round(warm_s, 1),
        "n_params": n_params,
        "mesh": mesh_dims(mesh_ov),
    }


def mesh_dims(mesh_ov) -> Dict[str, int]:
    return {o.split("=")[0].split(".")[1]: int(o.split("=")[1])
            for o in mesh_ov}


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


def load_world(world: dict) -> dict:
    """The examples, canonical F1, folds and shot bucket of a world built
    by :func:`build`, read back from its feature cache (each rank does)."""
    from avsum_torch.bench.parity import _examples
    from avsum_torch.data.cache import FeatureCache
    from avsum_torch.data.splits import create_kfold_splits

    examples, canon_fn = _examples(world["settings"],
                                   FeatureCache(world["cache_dir"]),
                                   world["anno"])
    max_shots = 1
    while max_shots < max(ex.n_shots for ex in examples.values()):
        max_shots *= 2
    return {"examples": examples, "canon_fn": canon_fn,
            "folds": create_kfold_splits(sorted(examples), 5, seed=0),
            "max_shots": max_shots}


def fold_examples(loaded: dict, fold_idx: int):
    fold = loaded["folds"][fold_idx]
    ex = loaded["examples"]
    return [ex[v] for v in fold["train"]], [ex[v] for v in fold["test"]]


def build(work: str, n_videos: int, device: str, seed: int = 0,
          weights: Optional[dict] = None, overrides=()) -> dict:
    """The parity world of ``n_videos`` videos in ``work``/world, its
    preprocess on ``device`` -> the world (picklable, for the ranks) with
    K1's launches during the preprocess."""
    from avsum_torch.bench.parity import ParitySettings, build_world

    st = ParitySettings(n_videos=n_videos, n_seeds=1)
    reset_launches()
    t0 = time.perf_counter()
    cfg, cache, anno = build_world(os.path.join(work, "world"), st, device,
                                   seed, weights, overrides)
    world = {"settings": st, "cache_dir": cache.cache_dir, "anno": anno,
             "hidden_dim": cfg.model.hidden_dim,
             "world_s": time.perf_counter() - t0,
             "world_launches": launches("melspec")}
    log(f"world of {n_videos} videos in {world['world_s']:.1f} s, K1 "
        f"launches {world['world_launches']['melspec']}")
    return world


def rank_row(world: dict, cell: tuple, device: str) -> Optional[dict]:
    """One rank of a contender at its own mesh (gloo) -> the row on rank
    0, None on the others."""
    import torch.distributed as dist

    tf32_off(device)
    loaded = load_world(world)
    name, model_ov, mesh_ov, f_idx, seed, epochs, work = cell
    train_ex, test_ex = fold_examples(loaded, f_idx)
    row = train_and_eval(world["hidden_dim"], name, model_ov, mesh_ov,
                         train_ex, test_ex, loaded["canon_fn"],
                         loaded["max_shots"], epochs, seed, work, f_idx,
                         device, backend="gloo")
    return row if dist.get_rank() == 0 else None


def stamp(row: dict, device: str, ranks: int) -> dict:
    """The placement stamps of a row measured here."""
    row.update(device=device, card=card(device), ranks=ranks,
               dist_backend="gloo" if ranks > 1 else None,
               shares_one_card=bool(on_card(device)
                                    and ranks > torch.cuda.device_count()))
    return row


# ---------------------------------------------------------------------------
# Rows and the summary (the JAX script's arithmetic)
# ---------------------------------------------------------------------------


def read_appended(path: str, epochs: int) -> List[dict]:
    """The rows of an earlier run (JSONL), each well-formed, of the same
    protocol and stamped with its placement; else SystemExit."""
    with open(path) as fh:
        appended = [json.loads(line) for line in fh if line.strip()]
    for i, r in enumerate(appended):
        missing = {"config", "seed", "canonical_f1"} - set(r)
        if missing:
            raise SystemExit(f"--append-rows line {i + 1}: malformed row, "
                             f"missing {sorted(missing)}: {r}")
        r.setdefault("fold", 0)
        r.setdefault("epochs", 100)
        if r["epochs"] != epochs:
            raise SystemExit(
                f"--append-rows line {i + 1}: row trained {r['epochs']} "
                f"epochs but this run uses {epochs} — protocols must match "
                "to merge")
        unstamped = [k for k in STAMPS if k not in r]
        if unstamped:
            raise SystemExit(
                f"--append-rows line {i + 1}: no placement stamps "
                f"{unstamped}: not a row of this command, so its world's "
                "encoders were not the port's and the protocols do not "
                "match")
    return appended


def unique_cells(rows: List[dict]) -> Dict[tuple, dict]:
    """{(config, fold, seed): row}; a duplicate raises SystemExit."""
    cells = {}
    for r in rows:
        k = (r["config"], r.get("fold", 0), r["seed"])
        if k in cells:
            raise SystemExit(f"duplicate (config, fold, seed) row: {k}")
        cells[k] = r
    return cells


def placement(row: dict) -> str:
    """Where a row's steps ran, e.g. ``cuda, 8 ranks over gloo sharing
    one card``."""
    n = row["ranks"]
    out = f"{row['device']}, {n} rank{'s' if n > 1 else ''}"
    if row.get("dist_backend"):
        out += f" over {row['dist_backend']}"
    if row.get("shares_one_card"):
        out += " sharing one card"
    return out


def paired_vs_flagship(rows: List[dict], cells: Dict[tuple, dict]
                       ) -> Optional[dict]:
    """For each (fold, seed) where both a row of ``rows`` and the
    flagship have per-video F1: the mean delta over the common held-out
    videos (points), then a t CI over those cell deltas; None without
    any such cell."""
    cell_deltas = []
    for r in rows:
        flag = cells.get((FLAGSHIP, r.get("fold", 0), r["seed"]))
        if not (flag and "video_canonical_f1" in r
                and "video_canonical_f1" in flag):
            continue
        own, fv = r["video_canonical_f1"], flag["video_canonical_f1"]
        common = sorted(set(own) & set(fv))
        if common:
            cell_deltas.append(100.0 * float(
                np.mean([own[v] - fv[v] for v in common])))
    if not cell_deltas:
        return None
    from scipy import stats as sps

    d = np.asarray(cell_deltas, np.float64)
    se = (float(d.std(ddof=1) / np.sqrt(len(d))) if len(d) > 1
          else float("nan"))
    tcrit = (float(sps.t.ppf(0.975, len(d) - 1)) if len(d) > 1
             else float("inf"))
    return {
        "per_cell_delta_pts": [round(x, 2) for x in d],
        "mean_delta_pts": round(float(d.mean()), 2),
        "ci95_pts": [round(float(d.mean()) - tcrit * se, 2),
                     round(float(d.mean()) + tcrit * se, 2)],
        "n_cells": len(d),
    }


def summarize(rows: List[dict]) -> dict:
    """By contender: the canonical F1 mean, the step medians by
    :func:`placement` (rows without ``step_ms`` enter none), the row
    count, folds, parameters, mesh and the paired statistic."""
    cells = unique_cells(rows)
    summary = {}
    for name, _, _ in contenders():
        rs = [r for r in rows if r["config"] == name]
        if not rs:
            continue
        steps: Dict[str, List[float]] = {}
        for r in rs:
            if "step_ms" in r:
                steps.setdefault(placement(r), []).append(r["step_ms"])
        summary[name] = {
            "canonical_f1_mean": round(
                float(np.mean([r["canonical_f1"] for r in rs])), 4),
            "step_ms_median": {p: round(float(np.median(v)), 1)
                               for p, v in steps.items()},
            "n_rows": len(rs),
            "folds": sorted({r.get("fold", 0) for r in rs}),
            "n_params": rs[0]["n_params"],
            "mesh": rs[0]["mesh"],
        }
        if name != FLAGSHIP:
            paired = paired_vs_flagship(rs, cells)
            if paired is not None:
                summary[name]["paired_vs_flagship"] = paired
    return summary


def protocol(st, n_videos: int, fold_idxs, epochs: int,
             rows: List[dict]) -> str:
    places = sorted({placement(r) for r in rows if "ranks" in r})
    return (
        f"parity world (alpha={st.signal_alpha}, noise={st.scene_noise}, "
        f"{n_videos} videos, the port's seeded encoders), folds {fold_idxs} "
        f"of 5, {epochs} epochs, seeds {sorted({r['seed'] for r in rows})} "
        "(per-config rows may differ), canonical per-annotator knapsack F1; "
        "paired deltas vs flagship over per-(fold,seed)-cell held-out "
        f"videos; step times by placement: {places} (ranks that share one "
        "card contend for it and for the host: comparable within one "
        "placement only)")


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def add_arguments(ap) -> None:
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--n-seeds", type=int, default=2)
    ap.add_argument("--n-videos", type=int, default=20)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--work-dir", default=None,
                    help="the world, its cache and the checkpoints "
                         "(default: a new temporary directory)")
    ap.add_argument("--configs", default=None,
                    help="comma list of contender names to run, in the "
                         "given order (default: all)")
    ap.add_argument("--folds", default="0",
                    help="comma list of fold indices (of the canonical 5)")
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="first seed to run (seeds seed-offset .. "
                         "seed-offset+n_seeds-1)")
    ap.add_argument("--mesh-one", action="store_true",
                    help="run every contender in this process on a 1x1x1 "
                         "mesh (stages and experts in turn, the same math)")
    ap.add_argument("--append-rows", default=None,
                    help="JSONL of rows this command printed before, to "
                         "include in the summary and the output file")


def run(args) -> int:
    from avsum_torch.cli.main import _media_setup
    from avsum_torch.parallel.multihost import Ranks

    require_device(args.device)
    weights = _media_setup(args)
    if args.config:
        raise SystemExit("ppep: the world's config is the harness's own; "
                         "use --set for an override")
    work = args.work_dir or tempfile.mkdtemp(prefix="ppep_")
    world = build(work, args.n_videos, args.device, args.seed, weights,
                  args.overrides)
    loaded = load_world(world)
    fold_idxs = [int(x) for x in args.folds.split(",") if x != ""]
    rows = (read_appended(args.append_rows, args.epochs)
            if args.append_rows else [])
    by_name = {name: (name, m, mo) for name, m, mo in contenders()}
    wanted = ([by_name[n] for n in args.configs.split(",")]
              if args.configs else contenders())
    log(f"ppep: work {work}, contenders "
        f"{'in this process' if args.mesh_one else f'on {RANKS} ranks'} on "
        f"{card(args.device) or args.device}")
    ranks = None
    try:
        for f_idx in fold_idxs:
            train_ex, test_ex = fold_examples(loaded, f_idx)
            for name, model_ov, mesh_ov in wanted:
                if args.mesh_one:
                    mesh_ov = ONE
                for seed in range(args.seed_offset,
                                  args.seed_offset + args.n_seeds):
                    if any(r["config"] == name and r["seed"] == seed
                           and r.get("fold", 0) == f_idx for r in rows):
                        log(f"skip {name} fold {f_idx} seed {seed}: already "
                            "present in appended rows")
                        continue
                    if args.mesh_one:
                        row = stamp(train_and_eval(
                            world["hidden_dim"], name, model_ov, mesh_ov,
                            train_ex, test_ex, loaded["canon_fn"],
                            loaded["max_shots"], args.epochs, seed, work,
                            f_idx, args.device), args.device, 1)
                    else:
                        if ranks is None:
                            ranks = Ranks(RANKS, "gloo", timeout=3 * 3600)
                        cell = (name, model_ov, mesh_ov, f_idx, seed,
                                args.epochs, work)
                        row = stamp(ranks.run(rank_row, world, cell,
                                              args.device)[0],
                                    args.device, RANKS)
                    rows.append(row)
                    emit(row)
    finally:
        if ranks is not None:
            ranks.close()

    summary = summarize(rows)
    out = {"protocol": protocol(world["settings"], args.n_videos, fold_idxs,
                                args.epochs, rows),
           "rows": rows, "summary": summary}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    emit({"summary": summary, "out": args.out, "card": card(args.device),
          "world_launches": world["world_launches"]})
    return 0
