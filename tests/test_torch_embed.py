"""``python -m avsum_torch.bench embed-sweep`` and ``embed-ab`` against the
JAX package's ``scripts/sweep_embed_mfu.py`` and
``scripts/ab_embed_batch.py``: the sweep's plan runs the cells JAX's
does, in its order; on the CPU a sweep at one frame per variant writes
null device metrics; ``resize_bf16`` computes ``base``'s features; the
A/B at two batches of the tiny backbone gives identical segments."""

import importlib.util
import json
import os
import subprocess
import types

import numpy as np
import pytest
import torch

from avsum_torch.bench import __main__ as bench_main
from avsum_torch.bench import embed_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_METRICS = ("ms_per_frame", "batch_s", "mfu_pct", "compile_s",
                  "times_s")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cells(monkeypatch, argv):
    """The (variant, batch) cells ``scripts/sweep_embed_mfu.py`` measures
    for ``argv``, in its order (its backend probe and measurement
    replaced)."""
    spec = importlib.util.spec_from_file_location(
        "sweep_embed_mfu", os.path.join(ROOT, "scripts", "sweep_embed_mfu.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cells = []

    def measure(variant, batch, ship, iters):
        cells.append((variant, batch))
        return {"mfu_pct": 0.0}

    monkeypatch.setattr(script, "measure", measure)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.
                        SimpleNamespace(returncode=0, stdout="cpu 1"))
    monkeypatch.setattr("sys.argv", ["sweep_embed_mfu.py", *argv])
    script.main()
    return cells


@pytest.mark.parametrize("argv", [[], ["--plan", "inception_only:8,2;base:3"]])
def test_plan_runs_the_jax_scripts_cells(monkeypatch, argv):
    want = _jax_cells(monkeypatch, argv)
    plan = argv[1] if argv else embed_sweep.DEFAULT_PLAN
    got = [(v, b) for v, bs in embed_sweep.parse_plan(plan) for b in bs]
    assert got == want and len(want) >= 3


def test_sweep_on_the_cpu_writes_null_device_metrics(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    plan = ";".join(f"{v}:1" for v in embed_sweep.VARIANTS)
    assert bench_main.main(["embed-sweep", "--device", "cpu", "--plan", plan,
                            "--ship", "32", "--iters", "1", "--out",
                            str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    written = json.loads(out.read_text())
    assert written["rows"] == lines  # no "best" line without a device time
    assert [r["variant"] for r in lines] == list(embed_sweep.VARIANTS)
    for row in lines:
        assert row["batch"] == 1 and row["card"] is None
        assert all(row[k] is None for k in DEVICE_METRICS), row
    flops = {r["variant"]: r["gflops_per_frame"] for r in lines}
    assert flops["base"] == flops["resize_bf16"]
    # the dual program is its two backbones (and their resizes)
    assert flops["base"] == pytest.approx(
        flops["resnet_only"] + flops["inception_only"])
    assert written["best"] is None and written["card"] is None


def test_resize_bf16_is_the_base_program():
    base = embed_sweep.build_model("base", seed=3)
    other = embed_sweep.build_model("resize_bf16", seed=3)
    a, b = base.state_dict(), other.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40, 48, 3), dtype=np.uint8))
    with torch.inference_mode():
        want, got = base(frames), other(frames)
    assert want.shape == (2, 4096) and torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_ab_at_two_batches_gives_identical_segments(tmp_path, capsys):
    out = tmp_path / "ab.json"
    assert bench_main.main([
        "embed-ab", "--device", "cpu", "--set", "visual.backbone=tiny",
        "--batches", "32,64", "--rounds", "2", "--scenes", "2",
        "--media-dir", str(tmp_path / "media"), "--out", str(out)]) == 0
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert json.loads(out.read_text()) == line
    assert line["identical_segments"] is True
    assert line["max_abs_score_diff"] <= 1e-6
    assert (line["backend"], line["card"], line["rounds"]) == ("cpu", None, 2)
    assert set(line["per_batch"]) == {"32", "64"}
    for entry in line["per_batch"].values():
        assert set(entry) == {"best_s", "median_s", "runs_s",
                              "best_stages_s"}
        assert len(entry["runs_s"]) == 2
        assert entry["best_s"] == min(entry["runs_s"])
        assert "visual_dispatch" in entry["best_stages_s"]
