"""Merge a seed-subset parity run into a committed report, the counterpart
of the JAX package's ``scripts/parity_merge.py``: ``python -m
avsum_torch.bench parity-merge --work DIR [--prev PARITY_F1_TORCH.json]
[--out-dir .] [--also OTHER.json] [--cross-host REASON]``.

``--work`` is one dataset's work directory of ``python -m
avsum_torch.bench parity --seed-indices ...`` (its ``progress.json``).
The merge is exact because every (seed, fold) cell is a function of
(settings.seed, s, fold) on one world: the world is seeded,
``torch.manual_seed(run_seed)`` fixes the reference's init and order, and
the port's contenders take ``run_seed`` through the ``Trainer``. That
holds only where the subset run reused the committed run's world, its
feature cache included (``parity`` never rebuilds a cached video; two
preprocesses on the card agree to ~6e-8, not bitwise, and a knapsack
near-tie can flip on less). A subset that includes a seed the report
already has is a reproduction: its per-seed canonical F1 and paired delta
must equal the committed values to report rounding, or the merge aborts
(``--cross-host`` records the drift instead, for seeds re-run on another
host, whose CPU reduction order moves the reference arm).

Merged exactly from per-seed statistics: the per-seed lists
(concatenated), the aggregates (means over equal fold counts), the paired
delta (the mean of the per-seed deltas), the seed sigma and the seed-level
t CI (recomputed). The video-level CI and its diagnostics need the
committed seeds' per-video data and are carried, with their seed basis in
``video_level_basis_seeds``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from avsum_torch.bench import REPO
from avsum_torch.bench.parity import KEYS, REPORT, write_reports

USES_DEVICE = False  # no --device, --config, --set, --seed, --weights


def _complete_seeds(prog: dict, n_folds: int) -> list:
    """Seed indices whose every fold is in the progress data."""
    cells = {(s, f) for s, f in prog.get("cells", [])}
    if not cells:  # a dump of a seed-major prefix
        pf, ps = prog["done_through"]
        cells = {
            (ss, ff)
            for ss in range(ps + 1)
            for ff in range(n_folds)
            if ss < ps or ff <= pf
        }
    n_seeds = prog["settings"]["n_seeds"]
    return [s for s in range(n_seeds)
            if all((s, f) in cells for f in range(n_folds))]


def _complete_seeds_key(prog: dict, key: str, n_folds: int) -> list:
    """Seeds at which ``key`` has every fold (a variants-limited run
    trains some contenders only)."""
    fm = prog["fold_means"][key]
    return [s for s in range(len(fm)) if len(fm[s]) == n_folds]


def _seed_stats(prog: dict, s: int) -> dict:
    """Seed ``s``'s statistics from the raw progress data, unrounded (the
    report's lists are rounded for display; rounding comes at output)."""
    out = {}
    vids = sorted(prog["video_f1"]["reference_torch_bilstm"][s])
    for key in KEYS:
        folds = prog["fold_means"][key][s]
        if not folds:
            continue  # not trained at this seed (a variants run)
        out[key] = {"fold_mean": {m: float(np.mean([f[m] for f in folds]))
                                  for m in folds[0]}}
        if key != "reference_torch_bilstm":
            ref = prog["video_f1"]["reference_torch_bilstm"][s]
            own = prog["video_f1"][key][s]
            out[key]["paired_delta_pts"] = 100.0 * float(
                np.mean([own[v] - ref[v] for v in vids]))
    return out


def merge(prev: dict, prog: dict, cross_host: str = None) -> dict:
    """The committed report ``prev`` extended by the complete seeds of
    ``prog`` (a progress.json) beyond it."""
    from scipy import stats as sps

    if "datasets" in prev:
        prev = prev["datasets"][prog["settings"]["dataset"]]
    # n_seeds is no part of a cell's computation, and an extension run
    # declares a larger one: compare everything else
    _minus = lambda s: {k: v for k, v in s.items() if k != "n_seeds"}  # noqa: E731
    if _minus(prog["settings"]) != _minus(prev["settings"]):
        raise SystemExit(
            "settings mismatch between progress.json and the committed "
            f"report:\n  fresh: {prog['settings']}\n  prev:  "
            f"{prev['settings']}")
    st = prev["settings"]
    n_folds = st["n_folds"]
    n_prev = prev["seeds_done"]
    # each model extends its own seed prefix; the reference trains in
    # every cell
    seeds_by_key = {k: _complete_seeds_key(prog, k, n_folds) for k in KEYS}
    repro_by_key = {k: [s for s in ss if s < n_prev]
                    for k, ss in seeds_by_key.items()}
    new_by_key = {k: [s for s in ss if s >= n_prev]
                  for k, ss in seeds_by_key.items()}
    if not any(new_by_key.values()):
        raise SystemExit(
            f"no seed beyond the committed {n_prev} in {seeds_by_key}")
    for k, new_k in new_by_key.items():
        if sorted(new_k) != list(range(n_prev, n_prev + len(new_k))):
            raise SystemExit(
                f"{k}: new seeds {new_k} do not extend the prefix {n_prev}")
    # paired deltas need the same seed's reference arm
    for k in KEYS[1:]:
        missing = set(new_by_key[k]) - set(new_by_key[KEYS[0]])
        if missing:
            raise SystemExit(
                f"{k} has seeds {sorted(missing)} without a matching "
                "reference arm in the progress data")
    repro = sorted(set().union(*repro_by_key.values()))
    new = new_by_key

    # a reproduced seed must match the committed numbers to report
    # rounding, or the merge would make a statistic no run produced;
    # with --cross-host the drift is recorded instead (the paired delta
    # stays a valid replication: both arms of a cell ran on one host)
    repro_drift = {}
    for s in repro:
        fresh = _seed_stats(prog, s)
        mism = {}
        for key in KEYS:
            if key not in fresh or s not in repro_by_key[key]:
                continue
            got = round(fresh[key]["fold_mean"]["canonical_f1"], 4)
            want = prev["models"][key]["per_seed_canonical_f1"][s]
            if abs(got - want) > 5e-5:
                if cross_host is None:
                    raise SystemExit(
                        f"DETERMINISM FAILURE seed {s} {key}: fresh "
                        f"canonical F1 {got} != committed {want} — "
                        "refusing to merge (pass --cross-host REASON if "
                        "the committed seeds ran on a different host)")
                mism[key] = {"fresh": got, "committed": want,
                             "abs_diff_pts": round(100 * abs(got - want), 2)}
            if key != "reference_torch_bilstm":
                gotd = round(fresh[key]["paired_delta_pts"], 2)
                wantd = prev["models"][key]["per_seed_paired_delta_pts"][s]
                if abs(gotd - wantd) > 5e-3:
                    if cross_host is None:
                        raise SystemExit(
                            f"DETERMINISM FAILURE seed {s} {key}: fresh "
                            f"paired delta {gotd} != committed {wantd}")
                    mism.setdefault(key, {})["paired_delta"] = {
                        "fresh": gotd, "committed": wantd,
                        "abs_diff_pts": round(abs(gotd - wantd), 2),
                    }
        if mism:
            repro_drift[s] = mism
            print(f"seed {s}: cross-host drift recorded for "
                  f"{sorted(mism)} (exact match for the rest)")
        else:
            print(f"seed {s}: reproduction matches committed report exactly")

    n_total_by_key = {k: n_prev + len(new[k]) for k in KEYS}
    n_total = max(n_total_by_key.values())
    protocol = prev["protocol"].replace(f"x {n_prev} seeds",
                                        f"x {n_total} seeds")
    if n_total != n_prev and protocol == prev["protocol"]:
        raise SystemExit(
            "protocol string substitution failed — the committed "
            f"protocol lacks 'x {n_prev} seeds': {prev['protocol']!r}")
    per_key_note = ", ".join(f"{k}: {n_total_by_key[k]}" for k in KEYS
                             if n_total_by_key[k] != n_total)
    result = {
        "settings": dict(st, n_seeds=max(st["n_seeds"], n_total)),
        "dataset": prev["dataset"],
        "seeds_done": n_total,
        "protocol": protocol
        + (f" (per-model seed counts differ: {per_key_note})"
           if per_key_note else ""),
        "wall_s": prev.get("wall_s"),
        "merge_note": (
            f"seeds 0-{n_prev - 1} from the committed run; fresh seeds "
            + "; ".join(f"{k}: {new[k] or 'none'}" for k in KEYS)
            + " run under identical deterministic settings"
            + (
                (f"; seeds {repro} re-run on the new host as a "
                 "reproduction probe — see cross_host_reproduction "
                 f"({cross_host})")
                if repro and cross_host and repro_drift else
                (f"; seeds {repro} re-run as determinism proof (matched "
                 "exactly)" if repro else "")
            )
            + "; video-level CI and its diagnostics carried from the "
            f"committed {n_prev}-seed run (raw per-video data for those "
            "seeds lost with the host)"
        ),
        "models": {},
    }
    if repro_drift:
        result["cross_host_reproduction"] = {
            "reason": cross_host,
            "drift_by_seed": {str(s): m for s, m in repro_drift.items()},
        }
    all_new = sorted(set().union(*new.values()))
    fresh_stats = {s: _seed_stats(prog, s) for s in all_new}
    for key in KEYS:
        r = dict(prev["models"][key])  # the diagnostics carried
        new_k, n_tot_k = new[key], n_total_by_key[key]
        r["n_seeds_model"] = n_tot_k
        if not new_k:  # no fresh seed for this model: its row as it was
            r["video_level_basis_seeds"] = n_prev
            result["models"][key] = r
            continue
        # equal fold counts a seed: the weighted mean
        for m in fresh_stats[new_k[0]][key]["fold_mean"]:
            if m not in r:
                continue
            fresh_sum = sum(fresh_stats[s][key]["fold_mean"][m]
                            for s in new_k)
            r[m] = (prev["models"][key][m] * n_prev + fresh_sum) / n_tot_k
        per_seed = list(r["per_seed_canonical_f1"]) + [
            round(fresh_stats[s][key]["fold_mean"]["canonical_f1"], 4)
            for s in new_k
        ]
        r["per_seed_canonical_f1"] = per_seed
        r["seed_std_pts"] = round(100.0 * float(np.std(per_seed)), 2)
        r["video_level_basis_seeds"] = n_prev
        result["models"][key] = r

    ref_f1 = result["models"]["reference_torch_bilstm"]["canonical_f1"]
    for key in ("avsum_bilstm", "avsum_attention"):
        r = result["models"][key]
        if not new[key]:
            continue  # the committed decision statistics stand
        # committed seeds give their rounded recorded deltas, fresh ones
        # unrounded values; rounding comes at output
        dseed = np.asarray(
            list(r["per_seed_paired_delta_pts"])
            + [fresh_stats[s][key]["paired_delta_pts"] for s in new[key]],
            np.float64)
        r["per_seed_paired_delta_pts"] = [round(float(d), 2) for d in dseed]
        r["delta_canonical_f1_pts"] = round(
            100.0 * (r["canonical_f1"] - ref_f1), 2)
        # the mean over videos of seed-averaged deltas is the mean of the
        # per-seed deltas (the same videos every seed)
        r["paired_delta_pts"] = round(float(dseed.mean()), 2)
        se = float(dseed.std(ddof=1) / np.sqrt(len(dseed)))
        tcrit = float(sps.t.ppf(0.975, len(dseed) - 1))
        r["seed_paired_se_pts"] = round(se, 2)
        r["seed_paired_ci95_pts"] = [
            round(float(dseed.mean()) - tcrit * se, 2),
            round(float(dseed.mean()) + tcrit * se, 2),
        ]
    return result


def add_arguments(ap) -> None:
    ap.add_argument("--work", required=True,
                    help="a dataset's work directory holding progress.json")
    ap.add_argument("--prev", default=os.path.join(REPO, f"{REPORT}.json"))
    ap.add_argument("--out-dir", default=REPO)
    ap.add_argument(
        "--also", action="append", default=[],
        help="another report's JSON (one result or {'datasets': ...}) "
             "whose other datasets' sections join the written report")
    ap.add_argument(
        "--cross-host", default=None, metavar="REASON",
        help="record, not refuse, a reproduced seed's drift when the "
             "committed seeds ran on another host; REASON goes into the "
             "report")


def run(args) -> int:
    with open(os.path.join(args.work, "progress.json")) as fh:
        prog = json.load(fh)
    with open(args.prev) as fh:
        prev = json.load(fh)
    result = merge(prev, prog, cross_host=args.cross_host)
    results = [result]
    for path in args.also:
        with open(path) as fh:
            extra = json.load(fh)
        extras = (list(extra["datasets"].values())
                  if "datasets" in extra else [extra])
        results += [e for e in extras if e["settings"]["dataset"]
                    != result["settings"]["dataset"]]
    write_reports(results, args.out_dir, prog.get("arms"))
    for key in ("avsum_bilstm", "avsum_attention"):
        r = result["models"][key]
        print(key, "delta", r["paired_delta_pts"],
              "seed CI", r["seed_paired_ci95_pts"])
    return 0
