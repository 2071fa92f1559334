"""The scorer's ``torch.export`` artifact (``avsum_torch/serve/export.py``,
after ``tests/test_export.py``): for both encoders (BiLSTM; attention with
2 layers) one artifact with symbolic batch and shot axes scores S = 40,
96 and 544 (past the flash threshold, where the eager scorer takes the
flash route and the artifact the materialized softmax) within 1e-5 of
the eager scorer; it moves to another device as it loads, and scores in
a process where ``avsum_torch`` cannot be imported; the BiLSTM's scan
form equals its eager loop; the
pipeline scores with an artifact as with the module; ``export
--random-init`` through the CLI, and ``export`` with no weights rc 1."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avsum_torch.cli.main import main, make_scorer
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.models.temporal import BiLSTM
from avsum_torch.serve.export import export_scorer, load_scorer
from avsum_torch.train.config import ModelConfig, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
ENCODERS = {"bilstm": dict(temporal_encoder="bilstm"),
            "attention": dict(temporal_encoder="attention", temporal_layers=2)}

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """encoder -> (config, eager scorer, artifact path)."""
    root = tmp_path_factory.mktemp("export")
    out = {}
    for name, fields in ENCODERS.items():
        cfg = ModelConfig(hidden_dim=32, scorer_hidden=8, num_heads=4,
                          **fields)
        model = make_model(cfg, seed=3)
        path = root / f"{name}.pt2"
        path.write_bytes(export_scorer(model, cfg.visual_dim, cfg.audio_dim,
                                       device="cpu"))
        out[name] = (cfg, model, str(path))
    return out


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, s, cfg.visual_dim)).astype(np.float32)
    a = rng.standard_normal((b, s, cfg.audio_dim)).astype(np.float32)
    m = np.ones((b, s), np.float32)
    m[-1, s - s // 3:] = 0.0  # a padded tail
    return v, a, m


@pytest.mark.parametrize("s", [40, 96, 544])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_artifact_round_trip(artifacts, encoder, s):
    cfg, model, path = artifacts[encoder]
    fn = load_scorer(path, device="cpu")
    v, a, m = _inputs(cfg, 2, s, seed=s)
    with torch.inference_mode():
        want = model(*map(torch.from_numpy, (v, a, m)))
    got = fn(v, a, m)
    assert got.shape == (2, s)
    torch.testing.assert_close(got, want, **TOL)


def test_artifact_moves_to_another_device(artifacts):
    """An artifact exported on one device loads onto another (here the
    meta device): its weights and its outputs live there."""
    cfg, _, path = artifacts["bilstm"]
    v, a, m = _inputs(cfg, 1, 9, seed=4)
    out = load_scorer(path, device="meta")(v, a, m)
    assert out.device.type == "meta" and out.shape == (1, 9)


PROBE = """
import sys
sys.modules["avsum_torch"] = None
import numpy as np, torch
fn = torch.export.load(sys.argv[1]).module()
x = np.load(sys.argv[2])
with torch.no_grad():
    out = fn(*(torch.from_numpy(x[k]) for k in ("v", "a", "m")))
np.save(sys.argv[3], out.numpy())
assert not [m for m in sys.modules if m.startswith("avsum_torch")
            and sys.modules[m] is not None]
"""


def test_artifact_scores_without_the_package(artifacts, tmp_path):
    cfg, model, path = artifacts["bilstm"]
    v, a, m = _inputs(cfg, 1, 70, seed=1)
    np.savez(tmp_path / "x.npz", v=v, a=a, m=m)
    res = subprocess.run(
        [sys.executable, "-c", PROBE, path, str(tmp_path / "x.npz"),
         str(tmp_path / "out.npy")], capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with torch.inference_mode():
        want = model(*map(torch.from_numpy, (v, a, m))).numpy()
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want, **TOL)


def test_scan_form_equals_the_eager_loop(monkeypatch):
    """The form ``torch.export`` traces (the scan operator), run eagerly,
    against the Python loop, with a masked tail."""
    torch.manual_seed(0)
    lstm = BiLSTM(24, 32)
    for p in lstm.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(3, 37, 24)
    mask = torch.ones(3, 37)
    mask[1, 25:] = 0.0
    with torch.no_grad():
        want = lstm(x, mask)
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
        got = lstm(x, mask)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@needs_native
def test_pipeline_scores_with_the_artifact(tmp_path):
    cfg = load_config(overrides=["visual.backbone=tiny", "visual.dtype=float32",
                                 "audio.dtype=float32", "model.hidden_dim=32",
                                 "model.scorer_hidden=8"])
    from avsum_torch.cli.main import build_pipeline

    pipeline, model = build_pipeline(cfg, "cpu", seed=2)
    stem = str(tmp_path / "clip")
    write_scene_video(stem, n_scenes=3, seed=3, fps=8.0, height=64, width=96,
                      scene_len_frames=(10, 16))
    art = load_scorer(export_scorer(model, 4096, 296, device="cpu"), "cpu")
    with_model = pipeline.summarize(stem + ".y4m", model)
    with_artifact = pipeline.summarize(stem + ".y4m", art)
    np.testing.assert_allclose(with_artifact["scores"], with_model["scores"],
                               **TOL)
    np.testing.assert_array_equal(with_artifact["segments"],
                                  with_model["segments"])


def test_cli_export(tmp_path):
    out = str(tmp_path / "scorer.pt2")
    sets = ["--set", "model.hidden_dim=32", "--set", "model.scorer_hidden=8"]
    assert main(["export", "--random-init", "--seed", "4", "--device", "cpu",
                 "--output", out, *sets]) == 0
    cfg = load_config(overrides=["model.hidden_dim=32",
                                 "model.scorer_hidden=8"])
    v, a, m = _inputs(cfg.model, 1, 12, seed=2)
    # --seed draws the scorer summarize --random-init --seed 4 would use
    with torch.inference_mode():
        want = make_scorer(cfg, 4)(*map(torch.from_numpy, (v, a, m)))
    torch.testing.assert_close(load_scorer(out, "cpu")(v, a, m), want, **TOL)
    assert main(["export", "--device", "cpu", "--output",
                 str(tmp_path / "none.pt2"), *sets]) == 1
    assert not os.path.exists(tmp_path / "none.pt2")
