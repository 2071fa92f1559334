"""The encoder weight bridge: ``python -m avsum_torch.convert --visual
V.npz --vggish G.npz --params S.npz --out w.pt`` on ``.npz`` files written
as README.md's JAX-side lines write them (``flatten_dict(..., sep="/")`` of
random-init Flax variables: the tiny backbone, VGGish, a hidden-64
scorer). With the converted weights the port's VisualFrontend, audio
front-end and scorer equal the JAX package's within 1e-4 in float32; an
Orbax checkpoint directory named by ``visual.weights`` or
``audio.vggish_weights`` is refused with that command."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from avsum_tpu.audio.frontend import AudioFrontend as JaxAudioFrontend
from avsum_tpu.audio.vggish import VGGish as JaxVGGish
from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.train.config import AudioFeatConfig as JaxAudioFeatConfig
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_tpu.train.config import VisualFeatConfig as JaxVisualFeatConfig
from avsum_tpu.vision import backbone as jbb
from avsum_tpu.vision.resnet import Bottleneck as JaxBottleneck
from avsum_torch import convert
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.cli.main import build_pipeline
from avsum_torch.models.scorer import make_model
from avsum_torch.train.config import (
    AudioFeatConfig,
    ModelConfig,
    VisualFeatConfig,
    load_config,
)
from avsum_torch.vision.backbone import VisualFrontend, make_backbone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
HIDDEN = 64


def _savez(path, tree):
    np.savez(path, **{k: np.asarray(v) for k, v in
                      flatten_dict(tree, sep="/").items()})


@pytest.fixture(scope="module")
def flax_weights(tmp_path_factory):
    """Random-init Flax variables, their .npz files and the converted .pt
    (written by the CLI in a subprocess)."""
    root = tmp_path_factory.mktemp("convert")
    visual = jbb.fast_init(jbb.TinyBackbone(4096),
                           np.zeros((1, 64, 64, 3), np.float32), seed=4)
    vggish = jbb.fast_init(JaxVGGish(), np.zeros((1, 96, 64), np.float32),
                           seed=3)["params"]
    model = jax_make_model(JaxModelConfig(hidden_dim=HIDDEN))
    scorer = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4096)),
                        jnp.zeros((1, 8, 296)), jnp.ones((1, 8)))["params"]
    for name, tree in (("V", visual), ("G", vggish), ("S", scorer)):
        _savez(root / f"{name}.npz", tree)
    out = root / "w.pt"
    res = subprocess.run(
        [sys.executable, "-m", "avsum_torch.convert", "--visual",
         str(root / "V.npz"), "--vggish", str(root / "G.npz"), "--params",
         str(root / "S.npz"), "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    weights = torch.load(out, map_location="cpu", weights_only=True)
    return {"visual": visual, "vggish": vggish, "scorer": scorer,
            "model": model, "root": root, "weights": weights}


def test_cli_writes_all_three_parts(flax_weights):
    assert set(flax_weights["weights"]) == {"scorer", "visual", "vggish"}


def test_converted_visual_frontend_matches_jax(flax_weights):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (5, 48, 64), dtype=np.uint8)
    u = rng.integers(0, 256, (5, 24, 32), dtype=np.uint8)
    v = rng.integers(0, 256, (5, 24, 32), dtype=np.uint8)
    jfe = jbb.VisualFrontend(
        JaxVisualFeatConfig(backbone="tiny", dtype="float32"),
        variables=flax_weights["visual"], batch_size=4,
        model=jbb.TinyBackbone(4096))
    with jax.default_matmul_precision("highest"):
        want = jfe.frame_features_yuv(y, u, v)
    cfg = VisualFeatConfig(backbone="tiny", dtype="float32", batch_size=4)
    fe = VisualFrontend(cfg, make_backbone(
        cfg, state_dict=flax_weights["weights"]["visual"]), "cpu")
    got = fe.frame_features_yuv(y, u, v).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_converted_audio_frontend_matches_jax(flax_weights):
    rng = np.random.default_rng(1)
    wave = (0.3 * rng.standard_normal(40_000)).astype(np.float32)
    bounds = np.array([[0.0, 12_000.0], [12_000.0, 40_000.0]])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxAudioFrontend(
            JaxAudioFeatConfig(), flax_weights["vggish"]).shot_features(
                wave, bounds))
    vggish = VGGish()
    vggish.load_state_dict(flax_weights["weights"]["vggish"])
    got = AudioFrontend(AudioFeatConfig(), vggish, "cpu").shot_features(
        wave, bounds).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_converted_scorer_matches_jax(flax_weights):
    rng = np.random.default_rng(2)
    v = rng.standard_normal((1, 12, 4096)).astype(np.float32)
    a = rng.standard_normal((1, 12, 296)).astype(np.float32)
    m = np.ones((1, 12), np.float32)
    m[0, 10:] = 0
    with jax.default_matmul_precision("highest"):
        want = np.asarray(flax_weights["model"].apply(
            {"params": flax_weights["scorer"]}, v, a, m))
    model = make_model(ModelConfig(hidden_dim=HIDDEN),
                       state_dict=flax_weights["weights"]["scorer"])
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (v, a, m))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_one_part_alone_and_none(flax_weights, tmp_path, capsys):
    out = tmp_path / "g.pt"
    assert convert.main(["--vggish", str(flax_weights["root"] / "G.npz"),
                         "--out", str(out)]) == 0
    assert set(torch.load(out, weights_only=True)) == {"vggish"}
    with pytest.raises(SystemExit) as e:
        convert.main(["--out", str(tmp_path / "none.pt")])
    assert e.value.code == 2 and "at least one" in capsys.readouterr().err


def test_npz_keeps_batch_stats():
    """A backbone with BatchNorm statistics (a ResNet bottleneck) through
    the .npz: its params/... and batch_stats/... leaves convert as the
    variables themselves do, by the dual backbone's names."""
    x = np.zeros((1, 8, 8, 64), np.float32)
    variables = jbb.fast_init(JaxBottleneck(32, strides=2, downsample=True),
                              x, seed=1)
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(variables, sep="/").items()}
    assert any(k.startswith("batch_stats/") for k in flat)
    got = convert.backbone_from_flax(convert.unflatten(flat))
    want = convert.dual_backbone_from_flax(variables)
    assert set(got) == set(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name])


def test_refusals_name_the_command(tmp_path):
    """``visual.weights`` and ``audio.vggish_weights`` load Flax msgpack
    and ``.npz`` files (tests/test_torch_serialization.py); a directory, an
    Orbax checkpoint, is refused with the converter's ``.npz`` route."""
    orbax = str(tmp_path / "ckpt")
    os.makedirs(orbax)
    with pytest.raises(ValueError, match=r"avsum_torch\.convert --params"):
        make_backbone(VisualFeatConfig(backbone="tiny", weights=orbax))
    cfg = load_config(overrides=["visual.backbone=tiny",
                                 f"audio.vggish_weights={orbax}"])
    with pytest.raises(ValueError, match=r"avsum_torch\.convert --params"):
        build_pipeline(cfg, "cpu", with_scorer=False)
