"""``python -m avsum_torch.bench ppep`` against the JAX package's
``scripts/bench_pp_ep.py``: the same contenders and training configs
(field for field), the same one-device parameter counts as JAX's models,
the summary's arithmetic on the JAX run's own rows and on rows with
per-video F1 (the paired t CI by hand), the ``--append-rows`` refusals,
and two small runs in a process without JAX: every contender in one
process, then moe_ep at its own mesh on 8 gloo CPU ranks, on one world."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avsum_torch.bench import ppep
from avsum_torch.models.scorer import AVScorer
from torch_helpers import assert_config_equals_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("avsum_tpu", "jax", "flax", "optax", "msgpack")
NO_JAX = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.argv = ["avsum_torch.bench", *sys.argv[1:]]
try:
    runpy.run_module("avsum_torch.bench", run_name="__main__")
finally:
    assert not [m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {BLOCKED!r}]
"""
# the JAX script's row keys, with step_ms for step_ms_virtual_cpu
ROW_KEYS = {"config", "seed", "fold", "epochs", "backend", "canonical_f1",
            "keyframe_f1", "spearman", "video_canonical_f1", "step_ms",
            "warmup_s", "n_params", "mesh"}
TINY = ["--device", "cpu", "--n-videos", "6", "--epochs", "2", "--n-seeds",
        "1", "--set", "model.hidden_dim=32"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    """``scripts/bench_pp_ep.py``; its import pins JAX to the CPU and sets
    ``XLA_FLAGS``, which later processes of this worker must not see."""
    flags = os.environ.get("XLA_FLAGS")
    from scripts import bench_pp_ep

    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return bench_pp_ep


def _bench(*argv):
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, "ppep", *argv], capture_output=True,
        text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in res.stdout.strip().splitlines()]


def test_contenders_equal_the_jax_scripts(jax_script):
    assert ppep.contenders() == jax_script.contenders()


@pytest.mark.parametrize("index", range(3))
def test_training_config_equals_the_jax_scripts(jax_script, monkeypatch,
                                                index):
    """The JAX script's ``train_and_eval`` stopped where it builds its
    Trainer: its config against the port's, field for field."""
    import avsum_tpu.train.trainer as jax_trainer
    from avsum_tpu.train.config import load_config as jax_load_config

    class Built(Exception):
        pass

    def capture(model, cfg, *args, **kw):
        raise Built(cfg)

    monkeypatch.setattr(jax_trainer, "Trainer", capture)
    name, model_ov, mesh_ov = jax_script.contenders()[index]
    cfg = jax_load_config(overrides=["model.hidden_dim=512"])
    with pytest.raises(Built) as built:
        jax_script.train_and_eval(cfg, name, model_ov, mesh_ov, [], [], None,
                                  32, 100, 1, "/w", fold_idx=2)
    want = built.value.args[0]
    got = ppep.run_config(512, name, model_ov, mesh_ov, 32, 100, 1, "/w",
                          f"ckpt_{name}_f2_s1")
    assert_config_equals_jax(got, want)
    one = ppep.run_config(512, name, model_ov, ppep.ONE, 32, 100, 1, "/w",
                          "c")
    assert (one.mesh.data, one.mesh.seq, one.mesh.model) == (1, 1, 1)


@pytest.mark.parametrize("index", range(3))
def test_parameter_count_equals_jax(jax_script, index):
    """At the world's dims (hidden 512, features 4096 / 296): the port's
    one-device scorer against ``jax.eval_shape`` of JAX's init."""
    import jax
    import jax.numpy as jnp

    from avsum_tpu.models import make_model as jax_make_model
    from avsum_tpu.train.config import load_config as jax_load_config

    name, model_ov, mesh_ov = jax_script.contenders()[index]
    sets = [*model_ov, "model.hidden_dim=512", "model.num_heads=4"]
    jcfg = jax_load_config(overrides=sets).model
    shapes = jax.eval_shape(
        lambda: jax_make_model(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, jcfg.visual_dim)),
            jnp.zeros((1, 8, jcfg.audio_dim)), jnp.ones((1, 8))))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    cfg = ppep.run_config(512, name, model_ov, mesh_ov, 32, 100, 0, "/w",
                          "c")
    with torch.device("meta"):
        model = AVScorer(cfg.model)
    assert sum(p.numel() for p in model.parameters()) == want
    # PPEP_BENCH.json's counts (the JAX run)
    assert want == {"flagship_attention": 19123329, "deep_pp": 82171009,
                    "moe_ep": 77931681}[name]


def test_summary_of_the_jax_runs_rows():
    with open(os.path.join(ROOT, "PPEP_BENCH.json")) as fh:
        recorded = json.load(fh)
    summary = ppep.summarize(recorded["rows"])
    assert list(summary) == list(recorded["summary"])
    for name, want in recorded["summary"].items():
        got = summary[name]
        for key in ("canonical_f1_mean", "n_params", "mesh"):
            assert got[key] == want[key], (name, key)
        # the JAX rows ran on the virtual CPU mesh: no placement stamps,
        # so no step median of the port's
        assert got["step_ms_median"] == {}
        assert "paired_vs_flagship" not in got


def _row(config, seed, videos, fold=0, **stamps):
    return {"config": config, "seed": seed, "fold": fold, "epochs": 100,
            "canonical_f1": float(np.mean(list(videos.values()))),
            "video_canonical_f1": videos, "n_params": 1,
            "mesh": {"data": 1}, "step_ms": 10.0 + seed,
            "device": "cuda", "card": "H100", "ranks": 1,
            "dist_backend": None, "shares_one_card": False, **stamps}


def test_paired_t_ci_by_hand():
    """Cell deltas 1, 2 and 3 points: mean 2, sd 1, t(0.975, 2) =
    4.302653, so the CI is 2 -+ 4.302653 / sqrt(3)."""
    rows = []
    for seed, delta in enumerate((0.01, 0.02, 0.03)):
        flag = {"a": 0.5, "b": 0.3}
        rows.append(_row(ppep.FLAGSHIP, seed, flag))
        rows.append(_row("moe_ep", seed,
                         {v: f + delta for v, f in flag.items()}))
    # a deep_pp row on another fold pairs with nothing
    rows.append(_row("deep_pp", 0, {"a": 0.1}, fold=1))
    summary = ppep.summarize(rows)
    half = 4.302652729911275 / np.sqrt(3)
    paired = summary["moe_ep"]["paired_vs_flagship"]
    assert paired["per_cell_delta_pts"] == [1.0, 2.0, 3.0]
    assert paired["mean_delta_pts"] == 2.0
    assert paired["ci95_pts"] == [round(2 - half, 2), round(2 + half, 2)]
    assert paired["n_cells"] == 3
    assert "paired_vs_flagship" not in summary["deep_pp"]
    assert summary["moe_ep"]["step_ms_median"] == {"cuda, 1 rank": 11.0}
    # two placements' steps stay apart
    rows.append(_row(ppep.FLAGSHIP, 0, {"a": 0.5}, fold=3, ranks=8,
                     dist_backend="gloo", shares_one_card=True))
    assert ppep.summarize(rows)[ppep.FLAGSHIP]["step_ms_median"] == {
        "cuda, 1 rank": 11.0,
        "cuda, 8 ranks over gloo sharing one card": 10.0}


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def test_append_rows_refusals(tmp_path):
    good = _row(ppep.FLAGSHIP, 0, {"a": 0.5})
    assert ppep.read_appended(_jsonl(tmp_path / "ok", [good]), 100) == [good]
    bad = {k: v for k, v in good.items() if k != "canonical_f1"}
    with pytest.raises(SystemExit, match="malformed"):
        ppep.read_appended(_jsonl(tmp_path / "bad", [bad]), 100)
    with pytest.raises(SystemExit, match="protocols must match"):
        ppep.read_appended(_jsonl(tmp_path / "epochs", [good]), 50)
    with open(os.path.join(ROOT, "PPEP_BENCH.json")) as fh:
        jax_row = json.load(fh)["rows"][0]
    with pytest.raises(SystemExit, match="placement stamps"):
        ppep.read_appended(_jsonl(tmp_path / "jax", [jax_row]), 100)
    with pytest.raises(SystemExit, match="duplicate"):
        ppep.summarize([good, dict(good)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every contender in one process, then moe_ep at its own mesh (8
    gloo ranks) on the same world -> (lines, output) of each."""
    tmp = tmp_path_factory.mktemp("ppep")
    out = {}
    for label, extra in (("one", ["--mesh-one"]),
                         ("mesh", ["--configs", "moe_ep"])):
        path = tmp / f"{label}.json"
        lines = _bench(*TINY, *extra, "--work-dir", str(tmp / "work"),
                       "--out", str(path))
        out[label] = lines, json.loads(path.read_text())
    return out


def test_one_process_run_without_jax(runs):
    lines, written = runs["one"]
    rows, last = lines[:-1], lines[-1]
    assert [r["config"] for r in rows] == [
        "flagship_attention", "deep_pp", "moe_ep"]
    for r in rows:
        assert ROW_KEYS | set(ppep.STAMPS) == set(r)
        assert (r["device"], r["ranks"], r["dist_backend"], r["card"],
                r["shares_one_card"]) == ("cpu", 1, None, None, False)
        assert r["mesh"] == {"data": 1, "seq": 1, "model": 1}
        assert 0 <= r["canonical_f1"] <= 1 and r["step_ms"] > 0
        assert set(r["video_canonical_f1"]) and r["epochs"] == 2
    assert set(written) == {"protocol", "rows", "summary"}
    assert written["rows"] == rows and last["summary"] == written["summary"]
    assert set(written["summary"]["moe_ep"]["paired_vs_flagship"]) == {
        "per_cell_delta_pts", "mean_delta_pts", "ci95_pts", "n_cells"}


def test_own_mesh_run_on_eight_ranks(runs):
    (row, _), written = runs["mesh"][0], runs["mesh"][1]
    one = {r["config"]: r for r in runs["one"][1]["rows"]}
    assert (row["config"], row["ranks"], row["dist_backend"]) == (
        "moe_ep", 8, "gloo")
    assert row["mesh"] == {"data": 2, "seq": 1, "model": 4}
    # the one-device model's count, whatever the placement
    assert row["n_params"] == one["moe_ep"]["n_params"]
    assert set(row["video_canonical_f1"]) == set(
        one["moe_ep"]["video_canonical_f1"])
    assert list(written["summary"]["moe_ep"]["step_ms_median"]) == [
        "cpu, 8 ranks over gloo"]
    # one world: a row of each run pairs with the other's flagship
    merged = ppep.summarize(runs["one"][1]["rows"][:2] + [row])
    assert merged["moe_ep"]["paired_vs_flagship"]["n_cells"] == 1
