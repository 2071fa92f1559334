"""deep_pp's canonical F1 against its training budget, the counterpart of
the JAX package's ``scripts/exp_deep_pp.py``: ``python -m
avsum_torch.bench deep-pp-curve [--config deep_pp] [--epochs 600]
[--eval-every 50] [--use-contender-mesh] [--out F.json]``.

One contender of ``ppep`` (:func:`avsum_torch.bench.ppep.contenders`)
trains on the ppep world (``--n-videos`` videos in ``--work-dir``/world,
preprocessed on ``--device`` unless its cache is there) with ppep's
overrides and ``--lr`` / ``--warmup-steps``, on fold ``--fold`` with seed
``--seed``. Every ``--eval-every`` epochs the held-out videos are scored:
canonical and keyframe F1, Spearman, and the distribution of the
predicted scores (their mean and spread over all held-out shots, and the
spread within a video averaged over the videos: near-constant scores
make the knapsack pick by shot length, not by score).

The schedule is the Trainer's: cosine over its default ``total_steps``
(10,000, not scaled to the epochs, as ``train`` scales it) with EMA 0.98;
the output records both. By default the run is one process on a 1 x 1 x
1 mesh (the stages in turn); ``--use-contender-mesh`` runs it at the
contender's own mesh on 8 spawned gloo ranks, which share the card on a
one-card machine. Each point is printed as a JSON line; ``--out`` gets
the whole curve, with the JAX script's keys.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from avsum_torch.bench import card, emit, log, require_device, tf32_off
from avsum_torch.bench import ppep


def fit_chunked(trainer, batches, epochs: int, chunk: int,
                after: Optional[Callable[[int], None]] = None) -> None:
    """``epochs`` epochs in chunks of ``chunk``, ``after(done)`` after
    each. ``fit``'s epoch loop is range(start_epoch, epochs), so each call
    gets the ABSOLUTE target (a chunk-sized target with start_epoch=done
    trains nothing from the second chunk on)."""
    done = 0
    while done < epochs:
        step = min(chunk, epochs - done)
        trainer.fit(batches, epochs=done + step, start_epoch=done)
        done += step
        if after is not None:
            after(done)


def score_stats(trainer, test_ex, max_shots: int, canon_fn) -> tuple:
    """(the point's metrics without epoch and wall, per-video canonical
    F1) of the held-out videos, each scored once."""
    from avsum_torch.bench.parity import evaluate_model

    scores = {ex.video_id: np.asarray(trainer.score_video(ex, max_shots),
                                      np.float32)[: ex.n_shots]
              for ex in test_ex}
    mean, per_vid = evaluate_model(lambda ex: scores[ex.video_id], test_ex,
                                   canon_fn)
    every = np.concatenate([scores[ex.video_id] for ex in test_ex])
    within = float(np.mean([np.std(scores[ex.video_id]) for ex in test_ex]))
    return {
        "canonical_f1": round(mean["canonical_f1"], 4),
        "keyframe_f1": round(mean["f1"], 4),
        "spearman": round(mean["spearman"], 4),
        "score_mean": round(float(every.mean()), 4),
        "score_std": round(float(every.std()), 4),
        "score_std_within_video": round(within, 4),
    }, per_vid


def curve(world: dict, spec: dict, device: str,
          backend: Optional[str] = None) -> Optional[dict]:
    """The run (in this process, or on every rank of a spawned world) ->
    the result on rank 0, None on the others."""
    import torch.distributed as dist

    tf32_off(device)
    primary = not dist.is_initialized() or dist.get_rank() == 0
    loaded = ppep.load_world(world)
    train_ex, test_ex = ppep.fold_examples(loaded, spec["fold"])
    max_shots, seed = loaded["max_shots"], spec["seed"]
    extra = [f"train.lr={spec['lr']}"]
    if spec["warmup_steps"] is not None:
        extra.append(f"train.warmup_steps={spec['warmup_steps']}")
    run_cfg = ppep.run_config(world["hidden_dim"], spec["name"],
                              spec["model_ov"], spec["mesh_ov"], max_shots,
                              spec["epochs"], seed, spec["work_dir"],
                              f"ckpt_{spec['name']}_s{seed}", extra)
    trainer, _ = ppep.make_trainer(run_cfg, device, backend)
    schedule = {"total_steps": trainer.total_steps,
                "warmup_steps_run": run_cfg.train.warmup_steps,
                "ema_decay": run_cfg.train.ema_decay,
                "steps_per_epoch": max(1, -(-len(train_ex) // 8))}
    if primary:
        emit({"config": spec["name"], "backend": spec["backend"],
              "epochs": spec["epochs"], "lr": spec["lr"],
              "fold": spec["fold"], "seed": seed,
              "eval_every": spec["eval_every"], **schedule})
    points, last = [], {}
    t_start = time.perf_counter()

    def evaluate(done: int) -> None:
        stats, last["per_vid"] = score_stats(trainer, test_ex, max_shots,
                                             loaded["canon_fn"])
        points.append({"epoch": done, **stats,
                       "wall_s": round(time.perf_counter() - t_start, 1)})
        if primary:
            emit(points[-1])

    fit_chunked(trainer, ppep.batches_fn(train_ex, max_shots, seed),
                spec["epochs"], spec["eval_every"], evaluate)
    if not primary:
        return None
    return {
        "config": spec["name"],
        "backend": spec["backend"],
        "protocol": (
            f"parity world (alpha={world['settings'].signal_alpha}, noise="
            f"{world['settings'].scene_noise}, {world['settings'].n_videos} "
            f"videos, the port's seeded encoders), fold {spec['fold']} of 5, "
            f"seed {seed}, lr {spec['lr']}, warmup-cosine over the Trainer's "
            f"total_steps {trainer.total_steps}; mesh overrides "
            f"{spec['mesh_ov']}"),
        "lr": spec["lr"],
        "warmup_steps": spec["warmup_steps"],
        **schedule,
        "curve": points,
        "final_per_video_canonical_f1": {
            v: round(f, 4) for v, f in last["per_vid"].items()},
    }


def add_arguments(ap) -> None:
    ap.add_argument("--config", default="deep_pp",
                    help="contender name of ppep")
    ap.add_argument("--epochs", type=int, default=600)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="override train.warmup_steps (default: config)")
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0,
                    help="the training seed (the world's encoders are drawn "
                         "from seed 0)")
    ap.add_argument("--fold", type=int, default=0)
    ap.add_argument("--use-contender-mesh", action="store_true",
                    help="train at the contender's own mesh on spawned gloo "
                         "ranks instead of 1x1x1 in this process")
    ap.add_argument("--n-videos", type=int, default=20)
    ap.add_argument("--work-dir", default=None,
                    help="the world and checkpoints (default: a new "
                         "temporary directory); a world already there is "
                         "reused")
    ap.add_argument("--out", default=None)


def run(args) -> int:
    from avsum_torch.cli.main import _media_setup
    from avsum_torch.parallel.multihost import Ranks

    require_device(args.device)
    weights = _media_setup(args)
    name, model_ov, mesh_ov = {c[0]: c for c in ppep.contenders()}[
        args.config]
    if not args.use_contender_mesh:
        mesh_ov = ppep.ONE
    work = args.work_dir or tempfile.mkdtemp(prefix="deep_pp_")
    os.makedirs(work, exist_ok=True)
    world = ppep.build(work, args.n_videos, args.device, 0, weights,
                       args.overrides)
    spec = {"name": name, "model_ov": model_ov, "mesh_ov": mesh_ov,
            "epochs": args.epochs, "lr": args.lr,
            "warmup_steps": args.warmup_steps, "eval_every": args.eval_every,
            "seed": args.seed, "fold": args.fold, "work_dir": work,
            "backend": args.device.split(":")[0]}
    n_ranks = ppep.RANKS if args.use_contender_mesh else 1
    if args.use_contender_mesh:
        with Ranks(n_ranks, "gloo", timeout=6 * 3600) as ranks:
            result = ranks.run(curve, world, spec, args.device, "gloo")[0]
    else:
        result = curve(world, spec, args.device)
    result.update(device=args.device, card=card(args.device), ranks=n_ranks,
                  dist_backend="gloo" if n_ranks > 1 else None,
                  world_launches=world["world_launches"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        log(f"wrote {args.out}")
    emit({"final": result["curve"][-1], "total_steps": result["total_steps"],
          "ema_decay": result["ema_decay"], "card": result["card"],
          "world_launches": world["world_launches"], "out": args.out})
    return 0
