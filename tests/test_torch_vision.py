"""The port's visual modules against the JAX package on the same inputs:
YUV->RGB, normalize + antialiased resize, ResNet50 and InceptionV3 (f32,
1-2 frames at small legal sizes), the tiny backbone, and the masked
per-shot pool. float32; rtol 1e-4 with an atol of 1e-4 for conv stacks
(post-ReLU zeros and values near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.ops.color import yuv420_to_rgb_device
from avsum_tpu.train.config import VisualFeatConfig as JaxVisualFeatConfig
from avsum_tpu.vision import backbone as jbb
from avsum_tpu.vision.inception import InceptionV3 as JaxInception
from avsum_tpu.vision.resnet import Bottleneck as JaxBottleneck
from avsum_tpu.vision.resnet import ResNet50 as JaxResNet50
from avsum_torch.convert import dual_backbone_from_flax, tiny_backbone_from_flax
from avsum_torch.ops.color import yuv420_to_rgb
from avsum_torch.train.config import VisualFeatConfig
from avsum_torch.vision import backbone as tbb
from avsum_torch.vision.inception import InceptionV3
from avsum_torch.vision.resnet import Bottleneck, ResNet50

TOL = dict(rtol=1e-4, atol=1e-4)


def _frames(b, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 255, (b, h, w, 3)).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_yuv420_to_rgb_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (2, 6, 10), dtype=np.uint8)
    u = rng.integers(0, 256, (2, 3, 5), dtype=np.uint8)
    v = rng.integers(0, 256, (2, 3, 5), dtype=np.uint8)
    ref = yuv420_to_rgb_device(y, u, v)
    got = yuv420_to_rgb(*(torch.from_numpy(p) for p in (y, u, v)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-4)


@pytest.mark.parametrize("hw,size", [((304, 304), 224), ((304, 304), 299),
                                     ((72, 96), 224)])
def test_normalize_then_resize_matches_jax(hw, size):
    frames = _frames(2, *hw, seed=size)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jbb.preprocess_frames(frames, size))
    got = tbb.preprocess_frames(torch.from_numpy(frames), size)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **TOL)


def _with_random_stats(variables, seed):
    """fast_init leaves BN at mean 0 / var 1 / scale 1; draw them so the
    conversion of every BN field is exercised."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        a = np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, variables)


def test_bottleneck_block_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 64))
    x = x.astype(np.float32)
    model = JaxBottleneck(32, strides=2, downsample=True)
    variables = _with_random_stats(jbb.fast_init(model, x, seed=1), 1)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply(variables, x))
    ours = Bottleneck(64, 32, stride=2, downsample=True).eval()
    ours.load_state_dict(dual_backbone_from_flax(variables))
    with torch.inference_mode():
        got = ours(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", ["resnet50", "inception_v3"])
def test_trunk_matches_jax(name):
    if name == "resnet50":
        jmodel, ours, size = JaxResNet50(), ResNet50(), 32
    else:
        jmodel, ours, size = JaxInception(), InceptionV3(), 75
    x = np.random.default_rng(2).standard_normal((2, size, size, 3))
    x = x.astype(np.float32)
    variables = _with_random_stats(jbb.fast_init(jmodel, x, seed=2), 2)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jmodel.apply)(variables, x))
    ours.load_state_dict(dual_backbone_from_flax(variables))
    with torch.inference_mode():
        got = ours.eval()(_nchw(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("hw", [(48, 64), (96, 128)])
def test_tiny_backbone_matches_jax(hw):
    frames = _frames(3, *hw, seed=hw[0])
    jmodel = jbb.TinyBackbone(256)
    variables = jbb.fast_init(jmodel, frames, seed=4)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply(variables, frames))
    ours = tbb.make_backbone(VisualFeatConfig(backbone="tiny", feature_dim=256,
                                              dtype="float32"),
                             state_dict=tiny_backbone_from_flax(variables))
    with torch.inference_mode():
        got = ours.eval()(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_pool_matches_jax_pool_on_device():
    """Masked segment mean (frames past the per-shot cap excluded), the
    pool_on_device path with run_ids=None."""
    fields = dict(backbone="tiny", feature_dim=64, dtype="float32")
    fe = jbb.VisualFrontend(JaxVisualFeatConfig(**fields),
                            model=jbb.TinyBackbone(64), batch_size=8)
    frames = np.random.default_rng(3).integers(0, 255, (20, 32, 32, 3),
                                               dtype=np.uint8)
    pending = [fe._embed(fe.variables, jnp.asarray(np.concatenate(
        [frames[i:i + 8], np.zeros((max(0, i + 8 - 20), 32, 32, 3), np.uint8)])))
        for i in range(0, 20, 8)]
    shot_ids = np.array([0] * 7 + [1] * 5 + [2] * 8)
    keep = np.ones(20, bool)
    keep[10:12] = False
    ref, ref_counts = fe.pool_on_device(pending, 20, shot_ids, keep, 3)
    feats = torch.from_numpy(np.concatenate([np.asarray(p) for p in pending])[:20])
    tfe = tbb.VisualFrontend(VisualFeatConfig(**fields), tbb.TinyBackbone(64),
                             "cpu")
    got, counts = tfe.pool(feats, shot_ids, keep, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)


def test_sample_shot_frames_matches_jax():
    bounds = np.array([[0, 10], [10, 11], [11, 400], [400, 405]])
    for stride, cap in ((3, 96), (1, 4), (7, 2)):
        for got, ref in zip(tbb.sample_shot_frames(bounds, stride, cap),
                            jbb.sample_shot_frames(bounds, stride, cap)):
            np.testing.assert_array_equal(got, ref)
