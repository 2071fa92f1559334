"""The port's parity merge (``python -m avsum_torch.bench parity-merge``,
``avsum_torch/bench/parity_merge.py``) against the JAX package's
``scripts/parity_merge.py``: the cases of ``tests/test_parity_merge.py``,
each run through both merges on the same inputs, the outputs equal as
JSON (and the refusals with the same message). Also the rebuild
(``parity-rebuild``) against ``scripts/parity_rebuild.py``."""

import json

import numpy as np
import pytest
from scipy import stats as sps

import scripts.parity_merge as jax_merge
import scripts.parity_rebuild as jax_rebuild
from avsum_torch.bench import parity_merge, parity_rebuild
from avsum_torch.bench.__main__ import main as bench_main
from avsum_torch.bench.parity_merge import KEYS, _complete_seeds, merge


def _fold_mean(canon, f1=0.9, rho=0.95, tau=0.85):
    return {"canonical_f1": canon, "f1": f1, "spearman": rho,
            "kendall": tau}


def _world(n_folds=2, n_seeds=3):
    """A 2-video world with numbers checkable by hand: a committed report
    over seeds {0, 1} and a fresh subset run of seed 2."""
    settings = {"n_videos": 2, "n_folds": n_folds, "n_seeds": n_seeds,
                "seed": 0, "dataset": "tvsum"}
    prev = {"settings": settings, "dataset": "tvsum", "seeds_done": 2,
            "protocol": "synthetic TVSum, 2-fold CV x 2 seeds, paired",
            "wall_s": 100.0, "models": {}}
    for key in KEYS:
        base = {"reference_torch_bilstm": 0.60, "avsum_bilstm": 0.62,
                "avsum_attention": 0.61}[key]
        per_seed = [round(base, 4), round(base + 0.02, 4)]
        prev["models"][key] = {
            "canonical_f1": float(np.mean(per_seed)),
            "f1": 0.9, "spearman": 0.95, "kendall": 0.85,
            "per_seed_canonical_f1": per_seed,
            "seed_std_pts": round(100 * float(np.std(per_seed)), 2),
        }
    for key in ("avsum_bilstm", "avsum_attention"):
        d = 2.0 if key == "avsum_bilstm" else 1.0
        prev["models"][key].update({
            "per_seed_paired_delta_pts": [d, d + 1.0],
            "paired_delta_pts": d + 0.5,
            "paired_ci95_pts": [-5.0, 9.0],
            "paired_se_pts": 3.0,
            "videos_abs_delta_gt10": 1,
            "videos_needed_for_ci2pts": 300,
            "p_noninferior_bootstrap": 0.7,
        })
    prog = {
        "settings": settings,
        "cells": [[2, 0], [2, 1]],
        "fold_means": {
            k: [[], [], [_fold_mean(c1), _fold_mean(c2)]]
            for k, (c1, c2) in {
                "reference_torch_bilstm": (0.58, 0.62),
                "avsum_bilstm": (0.62, 0.66),
                "avsum_attention": (0.60, 0.64),
            }.items()
        },
        "video_f1": {
            "reference_torch_bilstm": [{}, {}, {"v0": 0.58, "v1": 0.62}],
            "avsum_bilstm": [{}, {}, {"v0": 0.62, "v1": 0.66}],
            "avsum_attention": [{}, {}, {"v0": 0.60, "v1": 0.64}],
        },
    }
    return prev, prog


def _copy(x):
    return json.loads(json.dumps(x))


def _both(prev, prog, **kw):
    """The port's merge and the JAX package's on copies of the same
    inputs -> the port's output, equal to JAX's as JSON."""
    got = merge(_copy(prev), _copy(prog), **kw)
    want = jax_merge.merge(_copy(prev), _copy(prog), **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    return got


def _both_refuse(prev, prog, match):
    with pytest.raises(SystemExit, match=match) as got:
        merge(_copy(prev), _copy(prog))
    with pytest.raises(SystemExit) as want:
        jax_merge.merge(_copy(prev), _copy(prog))
    assert str(got.value) == str(want.value)


def test_complete_seeds_from_cells():
    _, prog = _world()
    assert _complete_seeds(prog, 2) == jax_merge._complete_seeds(prog, 2) == [2]
    prog["cells"] = [[2, 0]]  # half a seed: not complete
    assert _complete_seeds(prog, 2) == jax_merge._complete_seeds(prog, 2) == []
    del prog["cells"]  # a prefix dump through fold 1 of seed 0
    prog["done_through"] = [1, 0]
    assert _complete_seeds(prog, 2) == jax_merge._complete_seeds(prog, 2) == [0]


def test_merge_extends_per_seed_and_recomputes_decision_ci():
    prev, prog = _world()
    out = _both(prev, prog)
    assert out["seeds_done"] == 3
    m = out["models"]["avsum_bilstm"]
    assert m["per_seed_paired_delta_pts"] == [2.0, 3.0, 4.0]
    assert m["paired_delta_pts"] == 3.0
    tcrit = float(sps.t.ppf(0.975, 2))
    hw = tcrit * 1.0 / np.sqrt(3.0)
    assert m["seed_paired_ci95_pts"] == [round(3 - hw, 2), round(3 + hw, 2)]
    assert m["per_seed_canonical_f1"] == [0.62, 0.64, 0.64]
    assert m["canonical_f1"] == pytest.approx((0.62 + 0.64 + 0.64) / 3)
    assert m["paired_ci95_pts"] == [-5.0, 9.0]
    assert m["video_level_basis_seeds"] == 2
    assert "merge_note" in out


def test_merge_verifies_reproduced_seed():
    prev, prog = _world()
    prog["cells"] = [[0, 0], [0, 1], [2, 0], [2, 1]]
    for key, c in (("reference_torch_bilstm", 0.60),
                   ("avsum_bilstm", 0.62), ("avsum_attention", 0.61)):
        prog["fold_means"][key][0] = [_fold_mean(c), _fold_mean(c)]
        prog["video_f1"][key][0] = {"v0": c, "v1": c}
    out = _both(prev, prog)
    assert out["seeds_done"] == 3
    assert "determinism proof" in out["merge_note"]

    prog["video_f1"]["avsum_bilstm"][0] = {"v0": 0.70, "v1": 0.70}
    prog["fold_means"]["avsum_bilstm"][0] = [_fold_mean(0.70),
                                             _fold_mean(0.70)]
    _both_refuse(prev, prog, "DETERMINISM FAILURE")
    # --cross-host records the drift instead, as JAX's does
    out = _both(prev, prog, cross_host="another host")
    assert out["cross_host_reproduction"]["drift_by_seed"]["0"][
        "avsum_bilstm"]["abs_diff_pts"] == 8.0


def test_merge_variants_limited_extension():
    prev, prog = _world()
    prog["fold_means"]["avsum_bilstm"][2] = []
    prog["video_f1"]["avsum_bilstm"][2] = {}
    prog["settings"] = dict(prog["settings"], n_seeds=4)
    out = _both(prev, prog)
    assert out["seeds_done"] == 3
    b = out["models"]["avsum_bilstm"]
    a = out["models"]["avsum_attention"]
    assert b["n_seeds_model"] == 2 and a["n_seeds_model"] == 3
    assert b["per_seed_paired_delta_pts"] == [2.0, 3.0]
    assert b["paired_delta_pts"] == 2.5
    assert a["per_seed_paired_delta_pts"] == [1.0, 2.0, 2.0]
    assert a["paired_delta_pts"] == round((1.0 + 2.0 + 2.0) / 3, 2)
    assert "per-model seed counts differ" in out["protocol"]


def test_merge_rejects_settings_mismatch_and_gaps():
    prev, prog = _world()
    _both_refuse(prev, dict(prog, settings=dict(prog["settings"],
                                                n_videos=3)),
                 "settings mismatch")
    prev2 = dict(prev, seeds_done=1)
    prev2["models"] = {}
    for key in KEYS:
        prev2["models"][key] = dict(
            prev["models"][key],
            per_seed_canonical_f1=prev["models"][key][
                "per_seed_canonical_f1"][:1])
    for key in ("avsum_bilstm", "avsum_attention"):
        prev2["models"][key]["per_seed_paired_delta_pts"] = (
            prev["models"][key]["per_seed_paired_delta_pts"][:1])
    _both_refuse(prev2, prog, "do not extend")


def test_main_also_appends_extra_dataset_sections(tmp_path):
    """--also joins a second dataset's result into one report, the merged
    dataset first, a stale section of the same dataset dropped; the
    written JSON is the JAX merge's."""
    prev, prog = _world()
    work = tmp_path / "work"
    work.mkdir()
    (work / "progress.json").write_text(json.dumps(dict(
        prog, arms={"reference": "cpu", "contenders": "cuda",
                    "card": "NVIDIA H100 80GB HBM3, 700.00 W"})))
    prev_path = tmp_path / "PARITY_F1_TORCH.json"
    prev_path.write_text(json.dumps(prev))
    summe = _copy(prev)
    summe["dataset"] = "summe"
    summe["settings"] = dict(prev["settings"], dataset="summe")
    also = tmp_path / "summe.json"
    also.write_text(json.dumps({"datasets": {"summe": summe, "tvsum": prev}}))

    argv = ["--work", str(work), "--prev", str(prev_path),
            "--also", str(also)]
    assert bench_main(["parity-merge", *argv, "--out-dir",
                       str(tmp_path / "out")]) == 0
    assert jax_merge.main([*argv, "--out-dir", str(tmp_path / "jax")]) == 0
    md = (tmp_path / "out" / "PARITY_F1_TORCH.md").read_text()
    assert "## tvsum" in md and "## summe" in md
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in md
    payload = json.loads((tmp_path / "out" / "PARITY_F1_TORCH.json")
                         .read_text())
    assert payload == json.loads((tmp_path / "jax" / "PARITY_F1.json")
                                 .read_text())
    assert set(payload["datasets"]) == {"tvsum", "summe"}
    assert payload["datasets"]["tvsum"]["seeds_done"] == 3
    assert payload["datasets"]["summe"]["seeds_done"] == 2
    assert not (tmp_path / "out" / "PARITY_F1.json").exists()


def test_rebuild_equals_jax(tmp_path):
    """The rebuild of a two-seed run from its progress.json and its last
    report: the JAX rebuild's result, but for the wall clock."""
    rng = np.random.default_rng(3)
    vids = [f"v{i}" for i in range(4)]
    video_f1 = {k: [{v: float(rng.uniform(0.3, 0.8)) for v in vids}
                    for _ in range(2)] for k in KEYS}
    fold_canonical = {k: [[float(np.mean([video_f1[k][s][v] for v in half]))
                           for half in (vids[:2], vids[2:])]
                          for s in range(2)] for k in KEYS}
    work = tmp_path / "tvsum"
    work.mkdir()
    (work / "progress.json").write_text(json.dumps(
        {"video_f1": video_f1, "fold_canonical": fold_canonical}))
    settings = {"n_videos": 4, "n_folds": 2, "n_seeds": 2, "seed": 0,
                "dataset": "tvsum"}
    prev = {"settings": settings, "wall_s": 12.5, "models": {
        k: {"f1": 0.8, "spearman": 0.5, "kendall": 0.4} for k in KEYS}}
    (tmp_path / "prev.json").write_text(json.dumps(prev))
    got = parity_rebuild.rebuild(str(work), str(tmp_path / "prev.json"))
    want = jax_rebuild.rebuild(str(work), str(tmp_path / "prev.json"))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["wall_s"] == 12.5 and got["seeds_done"] == 2
    assert bench_main(["parity-rebuild", "--work", str(work), "--prev",
                       str(tmp_path / "prev.json"), "--out-dir",
                       str(tmp_path / "out")]) == 0
    assert json.loads((tmp_path / "out" / "PARITY_F1_TORCH.json")
                      .read_text()) == json.loads(json.dumps(got))
    assert parity_merge.USES_DEVICE is parity_rebuild.USES_DEVICE is False
