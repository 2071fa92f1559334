"""The port's dataset sweep against the JAX package's on the CPU: tiny
backbone and VGGish converted from Flax, float32 (JAX at "highest"
matmul precision, TF32 off here), three synthetic 48x64 videos in one
directory. Boundaries, fps and frame counts equal; features within 1e-4;
the cache fingerprint equal, so a cache written by either package is
recognized by the other. Also the sweep's skip, re-extract and per-item
isolation, and the classic path (pure-NumPy Y4M reader, the device shot
detector) and the frame-stride path against the JAX package's."""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import avsum_torch.pipeline as pipeline_mod
import avsum_tpu.pipeline as jax_pipeline_mod
from avsum_tpu.data.cache import FeatureCache as JaxFeatureCache
from avsum_tpu.data.cache import config_fingerprint as jax_fingerprint
from avsum_tpu.io.y4m import Y4MReader as JaxY4MReader
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.convert import tiny_backbone_from_flax, vggish_from_flax
from avsum_torch.data.cache import FeatureCache, config_fingerprint
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.io.y4m import Y4MReader
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train.config import load_config
from avsum_torch.vision.backbone import VisualFrontend, make_backbone

SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "visual.max_frames_per_shot=8"]
TOL = dict(rtol=1e-4, atol=1e-4)
VIDEOS = {"a": dict(n_scenes=3, seed=31), "b": dict(n_scenes=4, seed=32),
          "c": dict(n_scenes=2, seed=33, scene_len_frames=(20, 40))}

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


def _pipelines(overrides=()):
    jcfg = jax_load_config(overrides=SLICE + list(overrides))
    jax_pipe = JaxPipeline(jcfg)
    cfg = load_config(overrides=SLICE + list(overrides))
    backbone = make_backbone(
        cfg.visual, state_dict=tiny_backbone_from_flax(jax_pipe.visual.variables))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))
    pipe = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, "cpu"),
                      AudioFrontend(cfg.audio, vggish, "cpu"))
    return jax_pipe, pipe


@pytest.fixture(scope="module")
def pipelines():
    torch.backends.cuda.matmul.allow_tf32 = False
    return _pipelines()


@pytest.fixture(scope="module")
def sweep(tmp_path_factory, pipelines):
    """Both packages' sweeps over one directory of three videos."""
    root = tmp_path_factory.mktemp("sweep")
    videos = root / "videos"
    videos.mkdir()
    for name, kw in VIDEOS.items():
        write_scene_video(str(videos / name), height=48, width=64, **kw)
    jax_pipe, pipe = pipelines
    with jax.default_matmul_precision("highest"):
        jax_done = jax_pipe.preprocess_dataset(
            str(videos), JaxFeatureCache(str(root / "jax")))
    done = pipe.preprocess_dataset(str(videos), FeatureCache(str(root / "port")))
    return root, jax_done, done


def _assert_same_entry(got, want):
    np.testing.assert_array_equal(got.shot_boundaries, want.shot_boundaries)
    assert (got.fps, got.n_frames) == (want.fps, want.n_frames)
    np.testing.assert_allclose(got.visual, want.visual, **TOL)
    np.testing.assert_allclose(got.audio, want.audio, **TOL)


@needs_native
def test_preprocess_dataset_matches_jax(sweep, pipelines):
    root, jax_done, done = sweep
    jax_pipe, pipe = pipelines
    assert done == jax_done == sorted(VIDEOS)
    ours, theirs = FeatureCache(str(root / "port")), JaxFeatureCache(
        str(root / "jax"))
    fp = config_fingerprint(pipe.config.visual, pipe.config.audio,
                            pipe.detector)
    assert fp == jax_fingerprint(jax_pipe.config.visual,
                                 jax_pipe.config.audio, jax_pipe.detector)
    for vid in done:
        got, want = ours.get(vid), theirs.get(vid)
        _assert_same_entry(got, want)
        assert len(got.shot_boundaries) >= 2
        assert got.visual.shape[1] == 4096 and got.audio.shape[1] == 296
        assert ours.meta(vid)["fingerprint"] == theirs.meta(vid)[
            "fingerprint"] == fp
        # each package takes the other's entry as its own
        assert ours.matches(vid, fp) and theirs.matches(vid, fp)
        assert JaxFeatureCache(str(root / "port")).matches(vid, fp)
    # the materializing finish's host-clock stages
    assert set(pipe.stage_seconds) == {
        "visual_dispatch", "shot_detect", "audio_load", "prep",
        "visual_pool", "audio_pool", "finish"}


def _counting(pipe, monkeypatch):
    """The videos the sweep begins (it begins each with
    ``_begin_processed`` and finishes it one video later)."""
    calls = []
    real = pipe._begin_processed

    def begin(path):
        calls.append(os.path.basename(path))
        return real(path)

    monkeypatch.setattr(pipe, "_begin_processed", begin)
    return calls


@needs_native
def test_second_sweep_skips_and_changed_config_reextracts(
        sweep, pipelines, monkeypatch):
    root, _, _ = sweep
    _, pipe = pipelines
    cache_dir = root / "skip"
    shutil.copytree(root / "port", cache_dir)
    calls = _counting(pipe, monkeypatch)
    assert pipe.preprocess_dataset(str(root / "videos"),
                                   FeatureCache(str(cache_dir))) == sorted(VIDEOS)
    assert calls == []
    cfg = dataclasses.replace(pipe.config, visual=dataclasses.replace(
        pipe.config.visual, max_frames_per_shot=4))
    changed = AVPipeline(cfg, pipe.visual, pipe.audio)
    calls = _counting(changed, monkeypatch)
    cache = FeatureCache(str(cache_dir))
    assert changed.preprocess_dataset(str(root / "videos"), cache) == sorted(
        VIDEOS)
    assert calls == ["a.y4m", "b.y4m", "c.y4m"]
    fp = config_fingerprint(cfg.visual, cfg.audio, changed.detector)
    assert all(cache.meta(v)["fingerprint"] == fp for v in VIDEOS)


@needs_native
def test_a_corrupt_video_is_dropped_and_the_sweep_goes_on(sweep, pipelines):
    root, _, _ = sweep
    _, pipe = pipelines
    videos, cache_dir = root / "with_bad", root / "bad_cache"
    shutil.copytree(root / "videos", videos)
    shutil.copytree(root / "port", cache_dir)
    (videos / "bad.y4m").write_bytes(b"YUV4MPEG2 W64 H48 F30:1\nFRAME\n\x00")
    cache = FeatureCache(str(cache_dir))
    # a stale entry of the corrupt video from another configuration
    cache.put("bad", np.zeros((1, 4096)), np.zeros((1, 296)), [[0, 9]], 30.0,
              9, fingerprint="0" * 16)
    done = pipe.preprocess_dataset(str(videos), cache)
    assert done == sorted(VIDEOS)
    assert not cache.has("bad") and not os.path.exists(cache_dir / "bad")
    assert cache.video_ids() == sorted(VIDEOS)


def test_classic_path_matches_jax(tmp_path, pipelines, monkeypatch):
    """Readers without the native interface: the pure-NumPy Y4M reader in
    both packages, shots from the device detector."""
    jax_pipe, pipe = pipelines
    stem = str(tmp_path / "classic")
    write_scene_video(stem, n_scenes=4, seed=41, height=48, width=64,
                      scene_len_frames=(16, 40))
    monkeypatch.setattr(pipeline_mod, "open_video",
                        lambda p, prefer_native=True: Y4MReader(p))
    monkeypatch.setattr(jax_pipeline_mod, "open_video",
                        lambda p, prefer_native=True: JaxY4MReader(p))
    with jax.default_matmul_precision("highest"):
        want = jax_pipe.process_video(stem + ".y4m")
    got = pipe.process_video(stem + ".y4m")
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    assert len(got.boundaries) == 4
    assert (got.fps, got.n_frames) == (want.fps, want.n_frames)
    np.testing.assert_allclose(got.visual, want.visual, **TOL)
    np.testing.assert_allclose(got.audio, want.audio, **TOL)
    assert set(pipe.stage_seconds) == {"shot_detect", "visual_features",
                                       "audio_features"}


@needs_native
def test_frame_stride_path_matches_jax(tmp_path):
    """``visual.sample_fps=0`` on the native reader: C++ shot scores, then
    every ``frame_stride``-th frame of each shot as YUV planes."""
    jax_pipe, pipe = _pipelines(["visual.sample_fps=0",
                                 "visual.frame_stride=4"])
    stem = str(tmp_path / "stride")
    write_scene_video(stem, n_scenes=3, seed=42, height=48, width=64)
    with jax.default_matmul_precision("highest"):
        want = jax_pipe.process_video(stem + ".y4m")
    got = pipe.process_video(stem + ".y4m")
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    assert (got.fps, got.n_frames) == (want.fps, want.n_frames)
    np.testing.assert_allclose(got.visual, want.visual, **TOL)
    np.testing.assert_allclose(got.audio, want.audio, **TOL)
    assert set(pipe.stage_seconds) == {"shot_detect", "visual_features",
                                       "audio_features"}
