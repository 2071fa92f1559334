"""Tiny cells for the CPU: a copy of the benchmark's folders in a
temporary root, with small configurations, mixes and limits added as
files beside the real ones."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
TINY_MODEL = {"visual_dim": 16, "audio_dim": 8, "hidden_dim": 16,
              "num_heads": 2, "scorer_hidden": 8}


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """A root holding copies of the benchmark's data folders and code
    folders, and ``BENCHMARK.json``, to which tests add files."""
    root = tmp / "benchmark"
    for sub in ("configs", "traffic", "drivers", "metrics", "limits"):
        shutil.copytree(HERE / sub, root / sub)
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return root


def add_cell(root: Path, name: str, config: dict, traffic: dict,
             limits: dict, end_to_end=(), per_layer=()) -> None:
    """Add a cell, its configuration, mix and limits as files, and list
    it under the metrics it reports."""
    cfg_name, mix = name.split(".", 1)
    _dump(root / "configs" / f"{cfg_name}.json", config)
    _dump(root / "traffic" / f"{mix}.json", traffic)
    _dump(root / "limits" / f"{name}.json", limits)
    spec_path = root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": name, "config": cfg_name,
                              "traffic": mix, "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in set(end_to_end) | set(per_layer):
            m["workloads"].append(name)
    spec_path.write_text(json.dumps(spec, indent=1))


def tiny_train(encoder: str) -> tuple:
    config = json.loads((HERE / "configs" / "hour_scale.json").read_text())
    config["program"]["model"].update(TINY_MODEL, temporal_encoder=encoder)
    traffic = {"why": "a test", "driver": "train", "trace_seconds": 0.5,
               "batches": {"videos": 2, "bucket": 12, "shots": [5, 12],
                           "pool": 4}}
    limits = {"loss_gap": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-2}
    return config, traffic, limits


def tiny_summarize() -> tuple:
    config = json.loads((HERE / "configs" / "tvsum.json").read_text())
    traffic = copy.deepcopy(json.loads(
        (HERE / "traffic" / "summarize_clip120s.json").read_text()))
    traffic["clip"].update(scenes=3, scene_frames=[20, 40])
    traffic.update(compare_videos=2, trace_seconds=1)
    limits = {"boundary_mismatch": 0, "segment_mismatch": 0,
              "visual_gap": 0.05, "mfcc_gap": 1e-4, "logmel_gap": 1e-4,
              "vggish_gap": 0.05, "scorer_gap": 1e-5}
    return config, traffic, limits


TRAIN_E2E = ["train_shots_per_s"]
TRAIN_LAYER = ["step_mfu_pct.train", "kernel_launches_per_step.train",
               "device_idle_pct.train"]
SUMMARIZE_E2E = ["summarize_frames_per_s", "summarize_p90_s"]
SUMMARIZE_LAYER = ["shot_detect_s.summarize", "visual_dispatch_s.summarize",
                   "summarize_mfu_pct"]


@pytest.fixture
def tiny_root(tmp_path):
    """A root with the cells ``tinyatt.train``, ``tinylstm.train`` and
    ``tinyclip.summarize`` added as files."""
    root = make_root(tmp_path)
    for name, enc in (("tinyatt.train", "attention"),
                      ("tinylstm.train", "bilstm")):
        add_cell(root, name, *tiny_train(enc), TRAIN_E2E, TRAIN_LAYER)
    add_cell(root, "tinyclip.summarize", *tiny_summarize(), SUMMARIZE_E2E,
             SUMMARIZE_LAYER)
    return root
