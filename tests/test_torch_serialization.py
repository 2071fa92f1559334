"""The port reads and writes the JAX package's Flax msgpack weight files
without JAX, flax or ``msgpack`` (``avsum_torch/utils/serialization.py``).

Trees written by ``avsum_tpu.utils.serialization.save_params`` come back
bitwise equal to ``flax.serialization.msgpack_restore`` (a bfloat16 leaf
as float32, exactly), Flax's chunked leaves included; the port's
``save_params`` writes Flax's bytes. A tiny backbone and VGGish
``fast_init``-ed by JAX and saved to msgpack, loaded through
``visual.weights`` and ``audio.vggish_weights``, give JAX's features within
1e-5 (float32, CPU, highest matmul precision), and ``convert --visual
X.msgpack`` equals ``convert --visual X.npz``."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from avsum_tpu.audio.frontend import AudioFrontend as JaxAudioFrontend
from avsum_tpu.audio.vggish import VGGish as JaxVGGish
from avsum_tpu.train.config import AudioFeatConfig as JaxAudioFeatConfig
from avsum_tpu.train.config import VisualFeatConfig as JaxVisualFeatConfig
from avsum_tpu.utils import serialization as jax_serialization
from avsum_tpu.vision import backbone as jbb
from avsum_torch import convert
from avsum_torch.cli.main import build_pipeline
from avsum_torch.train.config import load_config
from avsum_torch.utils import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tiny_backbone_bf16.msgpack")
FEATURE_TOL = dict(rtol=1e-5, atol=1e-5)


def _trees():
    rng = np.random.default_rng(0)
    return {
        "float32": {"kernel": rng.standard_normal((3, 5), np.float32)},
        "bfloat16": {"w": jnp.asarray(rng.standard_normal((4, 6)),
                                      jnp.bfloat16)},
        "int32": {"ids": np.arange(12, dtype=np.int32).reshape(3, 4)},
        "zero_d": {"step": np.array(7, np.int64),
                   "scale": np.array(0.5, np.float32)},
        "nested": {"params": {"block0": {"Dense_0": {
            "kernel": rng.standard_normal((8, 4), np.float32),
            "bias": np.zeros(4, np.float32)}}, "Conv_0": {
            "kernel": rng.standard_normal((3, 3, 2, 4), np.float32)}},
            "batch_stats": {"bn": {"mean": np.ones(4, np.float32)}}},
        "scalars": {"f": np.float32(1.5), "i": np.int32(-3), "py": 2.5,
                    "n": -70000, "big": 2 ** 40, "flag": True, "c": 1 - 2j,
                    "name": "x" * 40, "none": None},
        "float16_uint8": {"h": rng.standard_normal(9).astype(np.float16),
                          "u": rng.integers(0, 256, 70000, dtype=np.uint8)},
    }


def _assert_tree_bitwise(ours, flax_tree, path=""):
    """``ours`` holds Flax's tree: the same keys, dtypes and bytes, a
    bfloat16 leaf as the float32 it widens to."""
    if isinstance(flax_tree, dict):
        assert isinstance(ours, dict) and set(ours) == set(flax_tree), path
        for key in flax_tree:
            _assert_tree_bitwise(ours[key], flax_tree[key], f"{path}/{key}")
        return
    if isinstance(flax_tree, (np.ndarray, np.generic)):
        want = np.asarray(flax_tree)
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        got = np.asarray(ours)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
        assert isinstance(ours, np.ndarray) == isinstance(flax_tree,
                                                          np.ndarray), path
        return
    assert type(ours) is type(flax_tree) and ours == flax_tree, path


@pytest.mark.parametrize("case", sorted(_trees()))
def test_load_params_reads_jax_files_as_flax_does(tmp_path, case):
    path = str(tmp_path / "p.msgpack")
    jax_serialization.save_params(path, _trees()[case])
    want = jax_serialization.load_params(path)
    _assert_tree_bitwise(serialization.load_params(path), want)


def test_chunked_leaves(tmp_path, monkeypatch):
    """Flax splits a leaf over MAX_CHUNK_SIZE bytes into chunks; both
    sides read them back whole, and the port writes Flax's bytes."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((13, 11), np.float32),
            "small": np.arange(4, dtype=np.int32),
            "deep": {"v": rng.integers(0, 9, 300).astype(np.int64)}}
    path = str(tmp_path / "c.msgpack")
    jax_serialization.save_params(path, tree)
    raw = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in raw
    ours = serialization.load_params(path)
    _assert_tree_bitwise(ours, jax_serialization.load_params(path))
    for key in ("w", "small"):
        np.testing.assert_array_equal(ours[key], tree[key])
    assert serialization.msgpack_serialize(tree) == raw


@pytest.mark.parametrize("case", sorted(set(_trees()) - {"bfloat16"}))
def test_save_params_writes_flax_bytes(tmp_path, case):
    """numpy has no bfloat16, so that tree is written only by JAX."""
    tree = _trees()[case]
    path = str(tmp_path / "ours.msgpack")
    serialization.save_params(path, tree)
    raw = open(path, "rb").read()
    assert raw == flax.serialization.msgpack_serialize(tree)
    _assert_tree_bitwise(flax.serialization.msgpack_restore(raw),
                         flax.serialization.msgpack_restore(
                             flax.serialization.msgpack_serialize(tree)))


def test_bfloat16_read_back_from_a_float32_save(tmp_path):
    """A float32 tree read back after the JAX package saved it in bfloat16
    is its bfloat16 rounding, widened exactly."""
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    path = str(tmp_path / "b.msgpack")
    jax_serialization.save_params(path, {"x": jnp.asarray(x, jnp.bfloat16)})
    got = serialization.load_params(path)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
    assert np.abs(got - x).max() <= 2.0 ** -8 * np.abs(x).max()


@pytest.mark.parametrize("data", [b"\xc1", b"\x92\x01", b"\x01\x02",
                                  b"\xd4\x07\x00"])
def test_malformed_bytes_raise(data):
    """A byte that is no value, a truncated array, trailing bytes, an ext
    type Flax never writes."""
    with pytest.raises(ValueError):
        serialization.msgpack_restore(data)


def test_fixture_is_the_jax_packages_save_params(tmp_path):
    """The committed fixture of ``chip_smoke.py`` phase 14 (c): the tiny
    backbone ``fast_init``-ed at seed 10, its leaves in bfloat16, as the
    JAX package's ``save_params`` writes it."""
    variables = jbb.fast_init(jbb.TinyBackbone(4096),
                              np.zeros((1, 64, 64, 3), np.float32), seed=10)
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(jnp.bfloat16), variables)
    path = str(tmp_path / "f.msgpack")
    jax_serialization.save_params(path, variables)
    assert open(path, "rb").read() == open(FIXTURE, "rb").read()


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """A tiny backbone and VGGish ``fast_init``-ed by JAX, saved to msgpack
    and, the backbone also, to ``.npz``."""
    root = tmp_path_factory.mktemp("weights")
    visual = jbb.fast_init(jbb.TinyBackbone(4096),
                           np.zeros((1, 64, 64, 3), np.float32), seed=4)
    vggish = jbb.fast_init(JaxVGGish(), np.zeros((1, 96, 64), np.float32),
                           seed=3)["params"]
    jax_serialization.save_params(str(root / "V.msgpack"), visual)
    jax_serialization.save_params(str(root / "G.msgpack"), vggish)
    np.savez(root / "V.npz", **{k: np.asarray(v) for k, v in
                                flatten_dict(visual, sep="/").items()})
    return root


def _pipeline(root, *extra, weights=None):
    cfg = load_config(overrides=[
        "visual.backbone=tiny", "visual.dtype=float32", "visual.batch_size=4",
        "audio.dtype=float32", f"visual.weights={root / 'V.msgpack'}",
        f"audio.vggish_weights={root / 'G.msgpack'}", *extra])
    pipeline, _ = build_pipeline(cfg, "cpu", seed=9, weights=weights,
                                 with_scorer=False)
    return pipeline


def test_visual_weights_file_matches_jax(jax_files):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (5, 48, 64), dtype=np.uint8)
    u = rng.integers(0, 256, (5, 24, 32), dtype=np.uint8)
    v = rng.integers(0, 256, (5, 24, 32), dtype=np.uint8)
    jfe = jbb.make_visual_frontend(JaxVisualFeatConfig(
        backbone="tiny", dtype="float32", batch_size=4,
        weights=str(jax_files / "V.msgpack")))
    with jax.default_matmul_precision("highest"):
        want = jfe.frame_features_yuv(y, u, v)
    got = _pipeline(jax_files).visual.frame_features_yuv(y, u, v).numpy()
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_vggish_weights_file_matches_jax(jax_files):
    rng = np.random.default_rng(1)
    wave = (0.3 * rng.standard_normal(40_000)).astype(np.float32)
    bounds = np.array([[0.0, 12_000.0], [12_000.0, 40_000.0]])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxAudioFrontend(JaxAudioFeatConfig(
            vggish_weights=str(jax_files / "G.msgpack"))).shot_features(
                wave, bounds))
    got = _pipeline(jax_files).audio.shot_features(wave, bounds).numpy()
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_explicit_weights_win_over_the_files(jax_files):
    """``--weights``' visual and vggish parts win, as JAX's ``variables=``
    and ``vggish_params=`` do."""
    other = _pipeline(jax_files, "visual.weights=", "audio.vggish_weights=")
    explicit = {"visual": other.visual.model.state_dict(),
                "vggish": other.audio.vggish.state_dict()}
    pipeline = _pipeline(jax_files, weights=explicit)
    theirs = _pipeline(jax_files)
    assert not torch.equal(theirs.visual.model.dense.weight,
                           other.visual.model.dense.weight)
    for got, want in ((pipeline.visual.model, explicit["visual"]),
                      (pipeline.audio.vggish, explicit["vggish"])):
        for name, value in got.state_dict().items():
            assert torch.equal(value, want[name]), name


def test_convert_msgpack_equals_npz(jax_files, tmp_path):
    for name in ("V.msgpack", "V.npz"):
        assert convert.main(["--visual", str(jax_files / name), "--out",
                             str(tmp_path / f"{name}.pt")]) == 0
    a, b = (torch.load(tmp_path / f"V.{ext}.pt", weights_only=True)["visual"]
            for ext in ("msgpack", "npz"))
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_msgpack_keeps_batch_stats(tmp_path):
    """A backbone with BatchNorm statistics (a ResNet bottleneck) through
    the JAX package's msgpack file: its params and batch_stats convert as
    the variables themselves do, by the dual backbone's names."""
    from avsum_tpu.vision.resnet import Bottleneck as JaxBottleneck

    x = np.zeros((1, 8, 8, 64), np.float32)
    variables = jbb.fast_init(JaxBottleneck(32, strides=2, downsample=True),
                              x, seed=1)
    path = str(tmp_path / "b.msgpack")
    jax_serialization.save_params(path, variables)
    got = convert.backbone_file(path)
    want = convert.dual_backbone_from_flax(variables)
    assert set(got) == set(want)
    assert any(name.endswith("running_var") for name in got)
    for name in want:
        assert torch.equal(got[name], want[name]), name
