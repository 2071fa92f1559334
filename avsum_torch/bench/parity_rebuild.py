"""Rewrite ``PARITY_F1_TORCH.{json,md}`` from a parity run's
``progress.json`` with the current analysis code, the counterpart of the
JAX package's ``scripts/parity_rebuild.py``: ``python -m avsum_torch.bench
parity-rebuild --work <work>/<dataset> [--prev PARITY_F1_TORCH.json]
[--out-dir .]``.

A running ``parity`` writes its reports with the code it started with;
this re-runs the (deterministic) statistics over the raw per-seed data,
so a change to the report reaches a run already under way. The keyframe
F1 / rho / tau of each fold are not in progress.json: they are taken from
the last report the run wrote (valid at a seed boundary, the only time it
writes one).
"""

from __future__ import annotations

import json
import os
import time

from avsum_torch.bench import REPO
from avsum_torch.bench.parity import (
    REPORT,
    ParitySettings,
    _summarize,
    write_reports,
)

USES_DEVICE = False  # no --device, --config, --set, --seed, --weights


def rebuild(work: str, prev_path: str) -> dict:
    with open(os.path.join(work, "progress.json")) as fh:
        prog = json.load(fh)
    with open(prev_path) as fh:
        prev = json.load(fh)
    if "datasets" in prev:
        prev = prev["datasets"][os.path.basename(work)]

    st = ParitySettings(**prev["settings"])
    video_f1 = prog["video_f1"]
    vids = sorted(video_f1["reference_torch_bilstm"][0])
    n_done = sum(
        1 for s in range(st.n_seeds)
        if len(video_f1["reference_torch_bilstm"][s]) == len(vids))
    if n_done == 0:
        raise SystemExit("no complete seed in progress.json")
    fold_means = {
        k: [[{"canonical_f1": f} for f in seed_folds]
            for seed_folds in per_seed]
        for k, per_seed in prog["fold_canonical"].items()
    }
    result = _summarize(st, n_done, fold_means, video_f1, vids, time.time())
    # the metrics progress.json does not carry, from the run's own last
    # report (written at the same seed boundary)
    for key, r in result["models"].items():
        for m in ("f1", "spearman", "kendall"):
            r[m] = prev["models"][key][m]
    result["wall_s"] = prev.get("wall_s", result["wall_s"])
    return result


def add_arguments(ap) -> None:
    ap.add_argument("--work", required=True,
                    help="a dataset's work directory holding progress.json")
    ap.add_argument("--prev", default=os.path.join(REPO, f"{REPORT}.json"))
    ap.add_argument("--out-dir", default=REPO)


def run(args) -> int:
    result = rebuild(args.work, args.prev)
    with open(os.path.join(args.work, "progress.json")) as fh:
        arms = json.load(fh).get("arms")
    write_reports([result], args.out_dir, arms)
    print(json.dumps(
        {k: {m: r[m] for m in ("canonical_f1", "paired_delta_pts",
                               "paired_ci95_pts", "p_noninferior_bootstrap")
             if m in r}
         for k, r in result["models"].items()}, indent=1))
    return 0
