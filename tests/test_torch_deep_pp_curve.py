"""``python -m avsum_torch.bench deep-pp-curve`` against the JAX package's
``scripts/exp_deep_pp.py``: a tiny curve in a process without JAX has the
JAX run's point keys (``docs/deep_pp_curve_r05.json``) and records the
schedule it ran; training in chunks (the absolute target each time) ends
in the parameters of one ``fit`` over all the epochs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avsum_torch.bench import deep_pp_curve
from avsum_torch.data.batching import batch_iterator
from avsum_torch.data.synthetic import make_synthetic_videos
from avsum_torch.models.scorer import make_model
from avsum_torch.train.config import load_config
from avsum_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("avsum_tpu", "jax", "flax", "optax", "msgpack")
NO_JAX = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.argv = ["avsum_torch.bench", *sys.argv[1:]]
runpy.run_module("avsum_torch.bench", run_name="__main__")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run():
    with open(os.path.join(ROOT, "docs", "deep_pp_curve_r05.json")) as fh:
        return json.load(fh)


def test_tiny_curve_has_the_jax_keys_and_its_schedule(tmp_path):
    out = tmp_path / "curve.json"
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, "deep-pp-curve", "--device", "cpu",
         "--epochs", "4", "--eval-every", "2", "--n-videos", "6", "--set",
         "model.hidden_dim=32", "--work-dir", str(tmp_path / "work"),
         "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    result = json.loads(out.read_text())
    want = _jax_run()
    assert set(want) <= set(result)
    assert [p["epoch"] for p in result["curve"]] == [2, 4]
    for point in result["curve"]:
        assert set(point) == set(want["curve"][0])
        assert all(np.isfinite(v) for v in point.values())
        assert 0 <= point["canonical_f1"] <= 1
    assert lines[1:3] == result["curve"]
    # the schedule it ran: the Trainer's cosine over its default steps
    assert (result["total_steps"], result["ema_decay"]) == (10_000, 0.98)
    assert result["steps_per_epoch"] == 1 and result["lr"] == 1e-4
    assert (result["config"], result["ranks"]) == ("deep_pp", 1)
    assert "mesh.model=1" in result["protocol"]
    assert lines[0]["total_steps"] == 10_000 and lines[-1]["out"] == str(out)


def _trainer(tmp_path, label):
    cfg = load_config(overrides=[
        "model.temporal_encoder=attention", "model.temporal_layers=4",
        "model.pp_stages=2", "model.hidden_dim=16", "model.num_heads=2",
        "model.visual_dim=12", "model.audio_dim=6", "data.max_shots=16",
        "train.ema_decay=0.98", "train.warmup_steps=2",
        f"train.checkpoint_dir={tmp_path}/{label}"])
    return Trainer(make_model(cfg.model, seed=0), cfg, device="cpu")


def test_chunked_training_equals_one_fit(tmp_path):
    vids = make_synthetic_videos(n_videos=6, min_shots=5, max_shots=12,
                                 visual_dim=12, audio_dim=6, seed=1)

    def batches(epoch=0):
        return batch_iterator(vids, 4, 16, shuffle=True, seed=epoch)

    whole = _trainer(tmp_path, "whole")
    whole.fit(batches, epochs=4)
    chunked, seen = _trainer(tmp_path, "chunked"), []
    deep_pp_curve.fit_chunked(chunked, batches, 4, 3, seen.append)
    assert seen == [3, 4]
    assert chunked.state.step == whole.state.step == 8
    for (name, a), b in zip(chunked.model.named_parameters(),
                            whole.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for name, a in chunked.state.ema.items():
        torch.testing.assert_close(a, whole.state.ema[name], rtol=0, atol=0)
