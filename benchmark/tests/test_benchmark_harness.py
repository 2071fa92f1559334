"""The harness on the CPU: every cell of ``BENCHMARK.json`` loads from its
files, cells added as files alone run through it, and each fault planted
under the timed path turns ``correct`` false."""

from __future__ import annotations

import json
import math
import re

import pytest

from benchmark import faults, harness
from benchmark.tests.conftest import HERE, add_cell, make_root, tiny_train

SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_from_its_files(cell):
    found = harness.find_cell(cell)
    assert found.entry["chips"] == 1
    assert found.config["program"]["model"]["hidden_dim"] == 512
    assert hasattr(found.driver, "setup") and hasattr(found.driver, "check")
    reported = {m["name"] for m in found.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert found.per_layer
    assert all(isinstance(v, (int, float)) and v >= 0
               for v in found.limits.values())
    for metric in found.per_layer:
        assert (HERE / "metrics" / f"{metric['name']}.py").exists()


def test_the_spec_keeps_to_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (HERE.parent / c["file"]).exists()
        assert len(c["source"]) <= 200 and c["name"] in cells[0] + " ".join(cells)
        config = json.loads((HERE.parent / c["file"]).read_text())
        assert sorted(config["reduced"]) == sorted(c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    moved = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in moved and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(cells)
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tinyatt.train", "tinylstm.train",
                                  "tinyclip.summarize"])
def test_cells_added_as_files_run_on_the_cpu(tiny_root, cell, trace):
    found = harness.find_cell(cell, root=tiny_root)
    result, compared = harness.execute(found, 2 ** 31 + 17, 0.5, trace, "cpu")
    assert result["correct"], compared
    assert list(result)[-1] == "compared"
    if trace:
        assert "breakdown" in result
        assert result["device"]["window_s"] > 0
    else:
        assert result["metrics"]["setup_s"]["value"] > 0
        assert set(result["metrics"]) == {m["name"] for m in found.end_to_end}


def test_a_new_metric_reader_is_found_by_name(tmp_path):
    root = make_root(tmp_path)
    add_cell(root, "tinynew.train", *tiny_train("attention"),
             ["train_shots_per_s"], [])
    (root / "metrics" / "steps_in_window.train.py").write_text(
        "def read(run):\n    return run.window_result.counts['steps']\n")
    spec_path = root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["per_layer"].append({
        "name": "steps_in_window.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "trainer (train/steps.py)",
        "moves": "train_shots_per_s", "workloads": ["tinynew.train"]})
    spec_path.write_text(json.dumps(spec))
    found = harness.find_cell("tinynew.train", root=root)
    result, _ = harness.execute(found, 3, 0.3, True, "cpu")
    assert result["metrics"]["steps_in_window.train"]["value"] >= 1


@pytest.mark.parametrize("fault,cell", [
    ("unchanged_state", "tinyatt.train"),
    ("unchanged_state", "tinylstm.train"),
    ("half_batch", "tinyatt.train"),
    ("half_batch", "tinylstm.train"),
    ("altered_scores", "tinyclip.summarize"),
])
def test_a_planted_fault_turns_correct_false(tiny_root, fault, cell):
    found = harness.find_cell(cell, root=tiny_root)
    with faults.FAULTS[fault]():
        result, compared = harness.execute(found, 11, 0.3, False, "cpu")
    assert not result["correct"]
    assert any(not value <= limit for _, value, limit in compared)


def test_forbidden_modules_are_compared_by_whole_top_level_names():
    assert harness.forbidden_modules(["avsum_torch.models", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "avsum_tpu.io",
                                      "optax"]) == ["avsum_tpu", "jax",
                                                    "optax"]


LOADS_JAX = """from benchmark.harness import Window
import sys, types

MODES = ()


def setup(run):
    return {}


def window(run, state, seconds):
    return Window(attempted=1, failed=0,
                  metrics={"train_shots_per_s": 1.0})


def check(run, state):
    sys.modules["jax"] = types.ModuleType("jax")
    return [("loss_gap", 0.0, 1.0)]
"""


def test_a_check_that_loads_jax_gives_no_result(tmp_path, monkeypatch,
                                                 capsys):
    import sys

    import torch

    from benchmark import run

    root = make_root(tmp_path)
    config, traffic, limits = tiny_train("attention")
    add_cell(root, "tinyjax.train", config, dict(traffic, driver="loads_jax"),
             limits, ["train_shots_per_s"], [])
    (root / "drivers" / "loads_jax.py").write_text(LOADS_JAX)
    found = harness.find_cell("tinyjax.train", root=root)
    execute = harness.execute
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "find_cell", lambda name: found)
    monkeypatch.setattr(harness, "execute",
                        lambda cell, seed, seconds, trace, device, started:
                        execute(cell, seed, seconds, trace, "cpu", started))
    saved = sys.modules.pop("jax", None)
    try:
        with pytest.raises(SystemExit) as ended:
            run.main(["--workload", "tinyjax.train", "--seed", "1",
                      "--seconds", "0.1"])
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved
    assert ended.value.code not in (0, None)
    assert "jax" in str(ended.value.code)
    assert capsys.readouterr().out == ""


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "hour_scale.train_s7168", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_limits_are_finite_and_exact_counts_are_zero():
    for cell in SPEC["workloads"]:
        limits = json.loads((HERE / "limits" / f"{cell['name']}.json")
                            .read_text())
        assert all(math.isfinite(v) for v in limits.values())
        for name, value in limits.items():
            if name.endswith("_mismatch"):
                assert value == 0


def test_the_summarize_sample_is_drawn_from_the_seed_over_the_window():
    from benchmark.harness import load_module

    driver = load_module(HERE / "drivers" / "summarize.py")
    picks = []
    for seed in (5, 5, 6):
        sample = driver.Sample(8, seed)
        for i in range(200):
            sample.offer({"i": i})
            assert len(sample.kept) <= 8 and i in sample.kept
        picks.append(sorted(sample.kept))
    assert picks[0] == picks[1] != picks[2]
    assert len(picks[0]) == 8 and picks[0][-1] == 199
    assert min(picks[0]) < 150  # not just the last videos of the window
