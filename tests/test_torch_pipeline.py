"""The port's summarize slice against the JAX package end to end, on one
6-scene synthetic y4m + wav: both ``AVPipeline``s with the same weights
(tiny backbone, VGGish and a hidden-64 BiLSTM scorer, all float32,
converted from JAX). Boundaries and segments must be equal; features and
scores agree within 1e-4. Also: the summarize slice and the train CLI
run with ``avsum_tpu``, jax, flax and optax unimportable, and the CLI
prints the JAX CLI's JSON keys."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.convert import (
    scorer_from_flax,
    tiny_backbone_from_flax,
    vggish_from_flax,
)
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train.config import load_config
from avsum_torch.vision.backbone import VisualFrontend, make_backbone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "model.hidden_dim=64", "model.temporal_encoder=bilstm"]
TOL = dict(rtol=1e-4, atol=1e-4)

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("slice") / "six")
    write_scene_video(stem, n_scenes=6, seed=21, height=144, width=192)
    return stem + ".y4m"


@pytest.fixture(scope="module")
def pipelines():
    jcfg = jax_load_config(overrides=SLICE)
    jax_pipe = JaxPipeline(jcfg)
    jax_model = jax_make_model(jcfg.model)
    with jax.default_matmul_precision("highest"):
        params = jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, jcfg.model.visual_dim)),
            jnp.zeros((1, 8, jcfg.model.audio_dim)), jnp.ones((1, 8)))["params"]
    cfg = load_config(overrides=SLICE)
    backbone = make_backbone(
        cfg.visual, state_dict=tiny_backbone_from_flax(jax_pipe.visual.variables))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))
    pipe = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, "cpu"),
                      AudioFrontend(cfg.audio, vggish, "cpu"))
    model = make_model(cfg.model, state_dict=scorer_from_flax(params))
    return jax_pipe, jax_model, params, pipe, model


@needs_native
def test_features_match_jax(video, pipelines):
    jax_pipe, _, _, pipe, _ = pipelines
    with jax.default_matmul_precision("highest"):
        ref = jax_pipe.process_video(video)
    got = pipe.process_video(video)
    np.testing.assert_array_equal(got.boundaries, ref.boundaries)
    assert len(got.boundaries) >= 4
    assert (got.fps, got.n_frames) == (ref.fps, ref.n_frames)
    np.testing.assert_allclose(got.visual, ref.visual, **TOL)
    np.testing.assert_allclose(got.audio, ref.audio, **TOL)


@needs_native
def test_summarize_matches_jax(video, pipelines):
    jax_pipe, jax_model, params, pipe, model = pipelines
    with jax.default_matmul_precision("highest"):
        ref = jax_pipe.summarize(video, jax_model, params)
    got = pipe.summarize(video, model)
    np.testing.assert_array_equal(got["boundaries"], ref["boundaries"])
    np.testing.assert_allclose(got["scores"], ref["scores"], **TOL)
    np.testing.assert_array_equal(got["segments"], ref["segments"])
    np.testing.assert_array_equal(got["selected"], ref["selected"])
    assert set(pipe.stage_seconds) == {
        "visual_embed", "shot_detect", "audio_features", "visual_pool",
        "audio_pool", "score", "select"}


# the port alone: the JAX package and JAX's libraries cannot be imported
BLOCK = """
import json, sys
for name in ("avsum_tpu", "jax", "flax", "optax"):
    sys.modules[name] = None
"""
NOT_LOADED = """
assert not [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("avsum_tpu", "jax", "flax", "optax")]
"""
NO_JAX = BLOCK + """
from avsum_torch.cli.main import build_pipeline, summary_json
from avsum_torch.io import write_scene_video
from avsum_torch.train.config import load_config
write_scene_video(sys.argv[1], n_scenes=4, seed=5, height=72, width=96)
cfg = load_config(overrides=sys.argv[2:])
pipe, model = build_pipeline(cfg, "cpu", seed=1)
out = summary_json(pipe.summarize(sys.argv[1] + ".y4m", model))
""" + NOT_LOADED + """
print(json.dumps(out))
"""


@needs_native
def test_slice_runs_without_jax(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, str(tmp_path / "v"), *SLICE],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["shot_scores"]) >= 2 and out["segments"]
    assert all(0.0 <= s <= 1.0 for s in out["shot_scores"])


NO_JAX_TRAIN = BLOCK + """
import numpy as np
from avsum_torch.cli.main import main
from avsum_torch.data import FeatureCache
tmp = sys.argv[1]
cache = FeatureCache(tmp + "/cache")
rng = np.random.default_rng(2)
for i, s in enumerate((6, 9, 12)):
    ends = np.cumsum(rng.integers(20, 60, s))
    bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
    cache.put(f"v{i}", rng.standard_normal((s, 16), np.float32),
              rng.standard_normal((s, 8), np.float32), bounds, 30.0,
              int(ends[-1]))
sets = ["data.dataset=synthetic", "data.cache_dir=" + tmp + "/cache",
        "data.max_shots=16", "data.batch_videos=2", "model.visual_dim=16",
        "model.audio_dim=8", "model.hidden_dim=16", "model.num_heads=2",
        "model.scorer_hidden=8", "train.epochs=1", "train.log_every=1",
        "train.checkpoint_dir=" + tmp + "/ckpt",
        "train.log_path=" + tmp + "/log.jsonl"]
assert main(["train", "--device", "cpu",
             *[a for s in sets for a in ("--set", s)]]) == 0
""" + NOT_LOADED + """
print(open(tmp + "/log.jsonl").read().strip().splitlines()[-1])
"""


def test_train_runs_without_jax(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX_TRAIN, str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["step"] == 2 and last["loss"] >= 0.0
    assert os.path.isdir(tmp_path / "ckpt" / "2")


@needs_native
def test_cli_summarize_json(tmp_path, monkeypatch, capsys):
    from avsum_torch import build
    from avsum_torch.cli.main import main

    # the native decoder the test suite already loaded serves this run
    monkeypatch.setattr(build, "ensure_native_io", lambda: None)
    stem = str(tmp_path / "c")
    write_scene_video(stem, n_scenes=3, seed=8, height=72, width=96)
    sets = [a for s in SLICE for a in ("--set", s)]
    assert main(["summarize", stem + ".y4m", "--random-init", "--seed", "3",
                 "--device", "cpu", *sets]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"video_id", "n_frames", "fps", "segments",
                        "shot_scores"}
    assert out["video_id"] == "c" and out["n_frames"] > 0
    assert len(out["shot_scores"]) >= 2
    torch.testing.assert_close(torch.tensor(out["shot_scores"]).clamp(0, 1),
                               torch.tensor(out["shot_scores"]))
