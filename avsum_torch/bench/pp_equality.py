"""Does GPipe change the trained math? The counterpart of the JAX
package's ``scripts/exp_pp_param_equality.py``: ``python -m
avsum_torch.bench pp-equality [EPOCHS] [--ranks 8] [--out F.json]``.

The deep_pp shape scaled down (12 attention blocks in 4 stages, hidden
64, visual 48, audio 24; 16 synthetic videos of 8-14 shots, batches of 8
padded to 16 shots, lr 1e-4, EMA 0.98, seed 0) trains for EPOCHS epochs
(default 3) twice on ``--ranks`` spawned gloo ranks (sharing the card on
a one-card machine): once on the GPipe mesh (data ranks/4 x model 4:
microbatched stages, each rank holding one stage) and once on a data
mesh (data ranks x model 1: the stages in turn on every rank). TF32 is
off. The stage-split parameters are gathered to the one-device layout
(:func:`avsum_torch.parallel.mesh.gather_tensors`) and compared leaf by
leaf. ``--set`` overrides follow the shape's (the JAX script's
``extra_overrides``).

Prints one JSON line with the JAX script's report keys (``epochs``,
``n_leaves``, ``n_leaves_over_1e-3_rel``, ``worst_leaf``, ``worst_rel``,
``diverged_leaves``) and ``worst_abs`` (the largest |difference| of any
entry), and where it ran; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict

import numpy as np

from avsum_torch.bench import card, emit, log, require_device, tf32_off

SHAPE = ["model.temporal_encoder=attention", "model.temporal_layers=12",
         "model.pp_stages=4", "model.hidden_dim=64", "model.num_heads=4",
         "model.visual_dim=48", "model.audio_dim=24"]
STAGES = 4


def meshes(ranks: int) -> Dict[str, list]:
    """The GPipe mesh and the data mesh over ``ranks`` ranks."""
    if ranks % STAGES:
        raise SystemExit(f"--ranks {ranks}: the GPipe mesh needs a multiple "
                         f"of {STAGES}")
    return {"pp-mesh": [f"mesh.data={ranks // STAGES}", "mesh.seq=1",
                        f"mesh.model={STAGES}", "mesh.auto_data=false"],
            "seq-mesh": [f"mesh.data={ranks}", "mesh.seq=1", "mesh.model=1",
                         "mesh.auto_data=false"]}


def train(mesh_ov, epochs: int, label: str, work: str, device: str,
          extra_overrides=()) -> Dict[str, np.ndarray]:
    """One rank of a run: the shape trained at ``mesh_ov`` over the world
    -> the final parameters in the one-device layout (float64 arrays by
    name) on rank 0, {} on the others."""
    import torch.distributed as dist

    from avsum_torch.data.batching import batch_iterator
    from avsum_torch.data.synthetic import make_synthetic_videos
    from avsum_torch.models.scorer import make_model
    from avsum_torch.parallel.mesh import AXIS_MODEL, gather_tensors
    from avsum_torch.parallel.tensor import one_device
    from avsum_torch.train.config import load_config
    from avsum_torch.train.trainer import Trainer

    tf32_off(device)
    cfg = load_config(overrides=[
        *SHAPE,
        *mesh_ov,
        "data.max_shots=16",
        "data.batch_videos=8",
        f"train.epochs={epochs}",
        "train.lr=1e-4",
        "train.seed=0",
        "train.ema_decay=0.98",
        "train.save_every_epochs=1000000",
        f"train.checkpoint_dir={work}/pp_eq_ckpt_{label}",
        *extra_overrides,
    ])
    vids = make_synthetic_videos(n_videos=16, min_shots=8, max_shots=14,
                                 visual_dim=48, audio_dim=24, seed=0)

    def batches(epoch=0):
        return batch_iterator(vids, 8, 16, shuffle=True, seed=epoch)

    full = make_model(cfg.model, seed=cfg.train.seed)
    tr = Trainer(full, cfg, device=device, backend="gloo")
    tr.fit(batches, epochs=epochs)
    model, mesh = tr.model, tr.mesh
    layout = one_device(model) if mesh.size(AXIS_MODEL) > 1 else model
    names = [n for n, _ in layout.named_parameters()]
    params = gather_tensors(dict(model.named_parameters()),
                            model.split_names(), mesh, names)
    if dist.get_rank() != 0:
        return {}
    log(f"{label}: trained {epochs} epochs")
    return {k: v.double().numpy() for k, v in params.items()}


def compare(pp: Dict[str, np.ndarray], sq: Dict[str, np.ndarray],
            epochs: int) -> dict:
    """The JAX script's report of the GPipe run's leaves against the data
    mesh's, plus the largest absolute difference."""
    report, worst, worst_abs = {}, (None, 0.0), 0.0
    for key, a in pp.items():
        b = sq[key]
        d = float(np.max(np.abs(a - b)))
        worst_abs = max(worst_abs, d)
        scale = float(np.max(np.abs(b)) or 1.0)
        rel = d / scale
        if rel > worst[1]:
            worst = (key, rel)
        if rel > 1e-3:
            report[key] = {"max_abs": round(d, 6), "rel": round(rel, 6)}
    return {
        "epochs": epochs,
        "n_leaves": len(pp),
        "n_leaves_over_1e-3_rel": len(report),
        "worst_leaf": worst[0],
        "worst_rel": round(worst[1], 8),
        "diverged_leaves": dict(sorted(report.items())[:20]),
        "worst_abs": worst_abs,
    }


def add_arguments(ap) -> None:
    ap.add_argument("epochs", type=int, nargs="?", default=3)
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks of each run (a multiple of 4)")
    ap.add_argument("--out", default=None, help="also write the report here")


def run(args) -> int:
    from avsum_torch.parallel.multihost import Ranks

    require_device(args.device)
    if args.config or args.weights:
        raise SystemExit("pp-equality: the shape is the script's own; use "
                         "--set for an override")
    runs = meshes(args.ranks)
    work = tempfile.mkdtemp(prefix="pp_eq_")
    params = {}
    with Ranks(args.ranks, "gloo", timeout=3600) as ranks:
        for label, mesh_ov in runs.items():
            params[label] = ranks.run(train, mesh_ov, args.epochs, label,
                                      work, args.device,
                                      list(args.overrides))[0]
    out = {**compare(params["pp-mesh"], params["seq-mesh"], args.epochs),
           "meshes": runs, "ranks": args.ranks, "device": args.device,
           "card": card(args.device)}
    emit(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0
