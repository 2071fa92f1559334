"""``python -m avsum_torch.bench pp-equality`` against the JAX package's
``scripts/exp_pp_param_equality.py``: the port's ``make_synthetic_videos``
draws the JAX package's bytes; training on the GPipe mesh (model 4) and
on a data mesh (data 4), 4 gloo CPU ranks in a process without JAX, ends
in the same parameters within atol 5e-5 (the bound of JAX's
``test_pp_training_math_equals_sequential``, at its shape: 8 layers in 4
stages, hidden 32, ``max_shots`` 8, 2 epochs); the report's keys and
arithmetic are the JAX script's."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from avsum_tpu.data.synthetic import make_synthetic_videos as jax_videos
from avsum_torch.bench import pp_equality
from avsum_torch.data.synthetic import make_synthetic_videos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("avsum_tpu", "jax", "flax", "optax", "msgpack")
NO_JAX = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.argv = ["avsum_torch.bench", *sys.argv[1:]]
runpy.run_module("avsum_torch.bench", run_name="__main__")
"""
ATOL = 5e-5  # JAX: test_pp_training_math_equals_sequential
JAX_KEYS = {"epochs", "n_leaves", "n_leaves_over_1e-3_rel", "worst_leaf",
            "worst_rel", "diverged_leaves"}


def test_synthetic_videos_are_the_jax_packages_bytes():
    """At the command's draw (16 videos of 8-14 shots, 48 / 24 wide)."""
    kw = dict(n_videos=16, min_shots=8, max_shots=14, visual_dim=48,
              audio_dim=24, seed=0)
    ours, theirs = make_synthetic_videos(**kw), jax_videos(**kw)
    assert len(ours) == len(theirs) == kw["n_videos"]
    for a, b in zip(ours, theirs):
        assert (a.video_id, a.n_frames, a.fps) == (b.video_id, b.n_frames,
                                                   b.fps)
        for key in ("visual", "audio", "targets", "shot_boundaries"):
            x, y = getattr(a, key), getattr(b, key)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key


@pytest.fixture(scope="module")
def report():
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, "pp-equality", "2", "--device", "cpu",
         "--ranks", "4", "--set", "model.temporal_layers=8", "--set",
         "model.hidden_dim=32", "--set", "data.max_shots=8"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    (line,) = res.stdout.strip().splitlines()
    return json.loads(line)


def test_gpipe_training_equals_the_data_mesh(report):
    assert report["meshes"] == pp_equality.meshes(4)
    assert report["meshes"]["pp-mesh"][:3] == [
        "mesh.data=1", "mesh.seq=1", "mesh.model=4"]
    assert report["epochs"] == 2 and report["ranks"] == 4
    # every parameter of the one-device layout, the stages gathered
    assert report["n_leaves"] > 100
    assert report["worst_abs"] <= ATOL, report


def test_report_keys_and_arithmetic_are_the_jax_scripts(report, monkeypatch):
    """The JAX script's ``main`` on two given parameter trees (its
    ``train`` replaced) against :func:`pp_equality.compare` on the same
    leaves. The script's import sets ``XLA_FLAGS`` and the matmul
    precision, restored after it."""
    precision = jax.config.jax_default_matmul_precision
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from scripts import exp_pp_param_equality as script

    jax.config.update("jax_default_matmul_precision", precision)
    rng = np.random.default_rng(3)
    pp = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5),
          "c": np.zeros(2)}
    sq = {"a": pp["a"] + 1e-2, "b": pp["b"] + 1e-6, "c": np.zeros(2)}
    trees = iter([(pp, None), (sq, None)])
    monkeypatch.setattr(script, "train", lambda *a, **k: next(trees))
    monkeypatch.setattr(sys, "argv", ["exp_pp_param_equality.py", "2"])
    lines = []
    monkeypatch.setattr("builtins.print",
                        lambda *a, **k: lines.append(a[0]))
    script.main()
    want = json.loads(lines[-1])
    names = {jax.tree_util.keystr((jax.tree_util.DictKey(k),)): v
             for k, v in pp.items()}
    got = pp_equality.compare(
        names, {jax.tree_util.keystr((jax.tree_util.DictKey(k),)): v
                for k, v in sq.items()}, 2)
    assert set(want) == JAX_KEYS
    assert set(report) >= JAX_KEYS | {"worst_abs"}
    assert {k: got[k] for k in JAX_KEYS} == want
    assert got["worst_abs"] == pytest.approx(1e-2)
