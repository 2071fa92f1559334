"""The port's overlapped fast path against the JAX package's (as
``tests/test_fast_paths.py`` pins JAX's): device pooling with and without
``run_ids`` and its device-resident form, packed-plane dispatch, the
begin/finish summarize against JAX's ``summarize`` on a source large
enough for packed planes and on one whose short shots need the
missing-sample repair, the device-resident scoring against the
materializing path, the overlapped dataset sweep against one video at a
time, and the join of the host threads when a dispatch fails. Tiny
backbone, VGGish and a hidden-64 BiLSTM scorer converted from JAX,
float32."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.io.video import open_video as jax_open_video
from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import VisualFeatConfig as JaxVisualFeatConfig
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_tpu.vision import backbone as jbb
from avsum_torch import pipeline as pipeline_mod
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.convert import (
    scorer_from_flax,
    tiny_backbone_from_flax,
    vggish_from_flax,
)
from avsum_torch.data.cache import FeatureCache
from avsum_torch.io.native import NativeY4MReader, native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.models.scorer import make_model
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train.config import VisualFeatConfig, load_config
from avsum_torch.utils.transfer import HostCopy, PinnedRing
from avsum_torch.vision import backbone as tbb

SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "model.hidden_dim=64", "visual.batch_size=16"]
TOL = dict(rtol=1e-4, atol=1e-4)

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


def _both(overrides=()):
    """-> (JAX pipeline, Flax scorer, params, port pipeline, port scorer)
    with the same weights."""
    jcfg = jax_load_config(overrides=SLICE + list(overrides))
    jax_pipe = JaxPipeline(jcfg)
    jmodel = jax_make_model(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4096)),
                         jnp.zeros((1, 8, 296)), jnp.ones((1, 8)))["params"]
    cfg = load_config(overrides=SLICE + list(overrides))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))
    pipe = AVPipeline(
        cfg, tbb.VisualFrontend(cfg.visual, tbb.make_backbone(
            cfg.visual, state_dict=tiny_backbone_from_flax(
                jax_pipe.visual.variables)), "cpu"),
        AudioFrontend(cfg.audio, vggish, "cpu"))
    model = make_model(cfg.model, state_dict=scorer_from_flax(params))
    return jax_pipe, jmodel, params, pipe, model


@pytest.fixture(scope="module")
def both():
    return _both()


def _assert_same_summary(got, want):
    np.testing.assert_array_equal(got["boundaries"], want["boundaries"])
    np.testing.assert_array_equal(got["segments"], want["segments"])
    np.testing.assert_array_equal(got["selected"], want["selected"])
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)


@pytest.mark.parametrize("runs", [False, True])
def test_pool_on_device_equals_jax(runs):
    """The same pending features pooled by both packages: the host result
    and the device-resident bucket with its counts."""
    fields = dict(backbone="tiny", feature_dim=64, dtype="float32")
    jfe = jbb.VisualFrontend(JaxVisualFeatConfig(**fields),
                             model=jbb.TinyBackbone(64), batch_size=8)
    tfe = tbb.VisualFrontend(VisualFeatConfig(batch_size=8, **fields),
                             tbb.TinyBackbone(64), "cpu")
    rng = np.random.default_rng(4)
    n_frames, n_emb = 20, (10 if runs else 20)
    feats = rng.standard_normal((-(-n_emb // 8) * 8, 64)).astype(np.float32)
    chunks = [feats[i:i + 8] for i in range(0, len(feats), 8)]
    shot_ids = np.array([0] * 7 + [1] * 5 + [2] * 8)
    keep = np.ones(n_frames, bool)
    keep[10:12] = False
    run_ids = (np.sort(rng.integers(0, n_emb, n_frames)).astype(np.int32)
               if runs else None)
    args = (n_frames, shot_ids, keep, 3)
    want = jfe.pool_on_device([jnp.asarray(c) for c in chunks], *args,
                              run_ids=run_ids)
    got = tfe.pool_on_device([torch.from_numpy(c) for c in chunks], *args,
                             run_ids=run_ids)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    want_d = jfe.pool_on_device([jnp.asarray(c) for c in chunks], *args,
                                run_ids=run_ids, return_device=True)
    got_d = tfe.pool_on_device([torch.from_numpy(c) for c in chunks], *args,
                               run_ids=run_ids, return_device=True)
    assert isinstance(got_d[1], HostCopy)
    assert got_d[0].shape == want_d[0].shape == (65, 64)
    np.testing.assert_allclose(got_d[0].numpy(), np.asarray(want_d[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_d[1].numpy(), np.asarray(want_d[1]))


def test_tail_bucket_equals_jax():
    jfe = jbb.VisualFrontend(JaxVisualFeatConfig(backbone="tiny"),
                             model=jbb.TinyBackbone(64), batch_size=256)
    tfe = tbb.VisualFrontend(VisualFeatConfig(backbone="tiny"),
                             tbb.TinyBackbone(64), "cpu")
    for n in (1, 31, 32, 33, 64, 65, 127, 128, 129, 255, 256):
        assert tfe.tail_bucket(n) == jfe.tail_bucket(n)


@needs_native
def test_dispatch_packed_equals_dispatch_yuv(tmp_path):
    """The reader's packed buffer (padded to the tail bucket) embeds as
    the (y, u, v) triple does; a buffer of no bucket size is refused."""
    stem = str(tmp_path / "p")
    write_scene_video(stem, n_scenes=2, seed=31, height=90, width=160)
    cfg = VisualFeatConfig(backbone="tiny", dtype="float32", batch_size=64)
    fe = tbb.VisualFrontend(cfg, tbb.make_backbone(cfg, seed=1), "cpu")
    reader = NativeY4MReader(stem + ".y4m")
    try:
        idx = np.arange(0, 40, 3, dtype=np.int64)
        bucket = fe.tail_bucket(len(idx))
        assert bucket == 32
        buf = reader.read_yuv420_packed(idx, 64, 48, bucket)
        triple = reader.read_yuv420_resized(idx, 64, 48)
    finally:
        reader.close()
    packed = fe.dispatch_packed(buf, 48, 64)
    pending, n = fe.dispatch_yuv(*triple)
    assert n == len(idx) and len(pending) == 1
    assert packed.shape == pending[0].shape == (bucket, 4096)
    torch.testing.assert_close(packed, pending[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fe.collect(pending, n),
                               fe.frame_features_yuv(*triple).numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="bucket"):
        fe.dispatch_packed(buf[:-1], 48, 64)


@needs_native
def test_summarize_begin_equals_jax_on_packed_planes(tmp_path, both):
    """640x360 is above ship_size^2: both packages read packed planes."""
    jax_pipe, jmodel, params, pipe, model = both
    stem = str(tmp_path / "wide")
    write_scene_video(stem, n_scenes=3, seed=12, height=360, width=640,
                      scene_len_frames=(30, 60))
    with jax.default_matmul_precision("highest"):
        want = jax_pipe.summarize(stem + ".y4m", jmodel, params)
    got = pipe.summarize_begin(stem + ".y4m", model)()
    _assert_same_summary(got, want)
    assert "pool" in pipe.stage_seconds  # the device-resident finish


@needs_native
def test_missing_sample_repair(tmp_path):
    """At 0.5 samples a second some shots catch no sample: their start
    frames are embedded, on the device-resident path by way of the
    materializing one. (The JAX package's repair writes into a read-only
    view of its pooled array and raises, so the port is held to its own
    primitives here: the boundaries are JAX's, each repaired row is its
    start frame's embedding.)"""
    jax_pipe, _, _, pipe, model = _both(["visual.sample_fps=0.5"])
    stem = str(tmp_path / "short_shots")
    write_scene_video(stem, n_scenes=6, seed=9, height=48, width=64,
                      scene_len_frames=(16, 70))
    path = stem + ".y4m"
    fast = pipe.summarize(path, model)
    mat = pipe._score_summary(pipe.process_video(path), model, None)
    _assert_same_summary(fast, mat)
    p = pipe.process_video(path)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_array_equal(
            p.boundaries, jax_pipe._process_video_classic(
                jax_open_video(path), "x").boundaries)
    stride = round(p.fps / 0.5)
    sampled = np.searchsorted(p.boundaries[:, 0],
                              np.arange(0, p.n_frames, stride),
                              side="right") - 1
    missing = ~np.isin(np.arange(len(p.boundaries)), sampled)
    assert missing.any() and not missing.all()
    reader = NativeY4MReader(path)
    try:
        starts = reader.read_yuv420(p.boundaries[missing, 0])
    finally:
        reader.close()
    np.testing.assert_allclose(
        p.visual[missing], pipe.visual.frame_features_yuv(*starts).numpy(),
        rtol=1e-6, atol=1e-6)


@needs_native
def test_device_resident_equals_materializing(tmp_path, both):
    _, _, _, pipe, model = both
    stem = str(tmp_path / "v")
    write_scene_video(stem, n_scenes=4, seed=23, height=48, width=64)
    shapes = []
    hook = model.register_forward_hook(
        lambda mod, args, out: shapes.append(tuple(args[0].shape)))
    try:
        fast = pipe.summarize(stem + ".y4m", model)
        mat = pipe._score_summary(pipe.process_video(stem + ".y4m"), model,
                                  None)
    finally:
        hook.remove()
    _assert_same_summary(fast, mat)
    # both paths give the scorer the shot axis padded to 32
    assert shapes[0] == shapes[1] and shapes[0][1] == 32


@needs_native
def test_overlapped_sweep_equals_one_at_a_time(tmp_path, both):
    _, _, _, pipe, _ = both
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(3):
        write_scene_video(str(videos / f"v{i}"), n_scenes=2 + i, seed=50 + i,
                          height=48, width=64)
    cache = FeatureCache(str(tmp_path / "cache"))
    assert pipe.preprocess_dataset(str(videos), cache) == ["v0", "v1", "v2"]
    for i in range(3):
        p = pipe.process_video(str(videos / f"v{i}.y4m"))
        entry = cache.get(f"v{i}")
        np.testing.assert_array_equal(entry.shot_boundaries, p.boundaries)
        assert (entry.fps, entry.n_frames) == (p.fps, p.n_frames)
        np.testing.assert_allclose(entry.visual, p.visual, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(entry.audio, p.audio, rtol=1e-6,
                                   atol=1e-6)


@needs_native
def test_failed_dispatch_joins_the_host_threads(tmp_path, both, monkeypatch):
    _, _, _, pipe, model = both
    stem = str(tmp_path / "f")
    write_scene_video(stem, n_scenes=2, seed=3, height=48, width=64)

    def broken(reader, frame_idx):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(pipe, "_dispatch_visual", broken)
    for begin in (pipe._begin_processed, lambda p: pipe.summarize_begin(
            p, model)):
        with pytest.raises(RuntimeError, match="dispatch failed"):
            begin(stem + ".y4m")
        assert not [t for t in threading.enumerate()
                    if t.name in ("avsum-detect", "avsum-wav")]


@needs_native
@pytest.mark.parametrize("entry", ["process", "summarize"])
def test_failed_audio_dispatch_joins_detect_before_close(tmp_path, both,
                                                        monkeypatch, entry):
    """A failure in the finish's audio dispatch waits for the detect
    thread, which reads the native reader, before the reader is closed."""
    _, _, _, pipe, model = both
    stem = str(tmp_path / "a")
    write_scene_video(stem, n_scenes=2, seed=4, height=48, width=64)
    real_scores, real_open = (pipeline_mod.refined_content_scores,
                              pipeline_mod.open_video)
    alive_at_close = []

    def slow_scores(*args, **kwargs):
        time.sleep(0.3)  # still reading when the audio dispatch fails
        return real_scores(*args, **kwargs)

    def opening(path):
        reader = real_open(path)
        close = reader.close

        def closing():
            alive = [t for t in threading.enumerate()
                     if t.name == "avsum-detect" and t.is_alive()]
            alive_at_close.append(bool(alive))
            for t in alive:  # fail the assertion below, not the process
                t.join()
            close()

        reader.close = closing
        return reader

    def broken(waveform):
        raise RuntimeError("audio dispatch failed")

    monkeypatch.setattr(pipeline_mod, "refined_content_scores", slow_scores)
    monkeypatch.setattr(pipeline_mod, "open_video", opening)
    monkeypatch.setattr(pipe.audio, "dispatch_full", broken)
    fin = (pipe._begin_processed(stem + ".y4m") if entry == "process"
           else pipe.summarize_begin(stem + ".y4m", model))
    with pytest.raises(RuntimeError, match="audio dispatch failed"):
        fin()
    assert alive_at_close == [False]


def test_pinned_ring_and_host_copy_on_the_cpu():
    ring = PinnedRing(torch.device("cpu"))
    outs = [ring.upload(5, lambda b, k=k: b.__setitem__(slice(None), k))
            for k in range(PinnedRing.SLOTS + 1)]
    assert [o.tolist() for o in outs] == [[k] * 5 for k in
                                          range(PinnedRing.SLOTS + 1)]
    t = torch.arange(4.0)
    np.testing.assert_array_equal(HostCopy(t).numpy(), [0, 1, 2, 3])
