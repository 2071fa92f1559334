"""The compressed-media path of the port: ``avsum_torch.io.cv2video`` (mp4v
and other codecs the native demuxer rejects, through OpenCV),
``avsum_torch.io.ffaudio`` (AAC, MP3 and Vorbis through the ffmpeg
libraries OpenCV's wheel bundles), ``io.mp4_mux`` and the pipeline's
classic path, which such media take. The counterparts of the JAX
package's ``tests/test_cv2video.py``, ``test_ffaudio.py`` and
``test_dress_rehearsal.py``, each on the port's own modules, and where a
JAX test checks behaviour alone, held to the JAX package's output on the
same file: decoded frames and 16 kHz audio equal, the pipeline's features
within rtol = atol = 1e-4 (``tests/test_torch_preprocess.py``'s bound)
given the JAX pipeline's encoder weights through ``avsum_torch.convert``.
Without imageio an MP4 still opens, through OpenCV (F9).

The dress rehearsal runs the port's CLI on the CPU over a TVSum-shaped
dataset of mp4 files (an mp4v video track and an AAC-LC audio track
each): ``preprocess`` (against the JAX package's sweep), ``splits
--kfold``, ``train``, ``evaluate --canonical``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import avsum_tpu.io.cv2video as jax_cv2video
import avsum_tpu.io.ffaudio as jax_ffaudio
from avsum_tpu.data.cache import FeatureCache as JaxFeatureCache
from avsum_tpu.io.mp4_mux import remux_video_with_aac as jax_remux
from avsum_tpu.pipeline import AVPipeline as JaxPipeline
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.audio.frontend import AudioFrontend
from avsum_torch.audio.vggish import VGGish
from avsum_torch.convert import tiny_backbone_from_flax, vggish_from_flax
from avsum_torch.data.cache import FeatureCache
from avsum_torch.io.cv2video import Cv2Reader, cv2_available
from avsum_torch.io.ffaudio import (
    FFNoAudioStream,
    aac_encode_available,
    decode_audio,
    ffmpeg_audio_available,
    load_audio_mono_16k_ff,
)
from avsum_torch.io.video import open_video
from avsum_torch.io.wav import read_wav, resample, to_mono, write_wav
from avsum_torch.pipeline import AVPipeline
from avsum_torch.train.config import load_config
from avsum_torch.vision.backbone import VisualFrontend, make_backbone

TOL = dict(rtol=1e-4, atol=1e-4)
FLOAT = ["visual.backbone=tiny", "visual.dtype=float32",
         "audio.dtype=float32"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: its work is many small CPU steps,
    and the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pygame_data(name: str) -> str:
    """A real compressed-audio clip shipped with pygame's examples."""
    spec = importlib.util.find_spec("pygame")
    if spec is None or not spec.submodule_search_locations:
        return os.path.join("missing", name)
    return os.path.join(spec.submodule_search_locations[0], "examples",
                        "data", name)


_MP3 = _pygame_data("house_lo.mp3")
_OGG = _pygame_data("house_lo.ogg")

needs_cv2 = pytest.mark.skipif(not cv2_available(),
                               reason="opencv-python not importable")
needs_ff = pytest.mark.skipif(not ffmpeg_audio_available(),
                              reason="bundled-ffmpeg libs not present")
needs_aac = pytest.mark.skipif(not aac_encode_available(),
                               reason="bundled-ffmpeg AAC encoder unavailable")
needs_mp3 = pytest.mark.skipif(not os.path.exists(_MP3),
                               reason="pygame fixture absent")
needs_ogg = pytest.mark.skipif(not os.path.exists(_OGG),
                               reason="pygame fixture absent")


def _write_mp4v(path, frames, fps=30.0):
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    assert writer.isOpened()
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def _flat_frames(n=24, h=48, w=64):
    """A per-frame constant luma ramp, which survives lossy mp4v."""
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i] = 40 + i * 8
    return frames


def _pipelines(overrides=()):
    """The JAX package's pipeline and the port's with its encoder weights,
    both float32 on the CPU."""
    jcfg = jax_load_config(overrides=FLOAT + list(overrides))
    jax_pipe = JaxPipeline(jcfg)
    cfg = load_config(overrides=FLOAT + list(overrides))
    backbone = make_backbone(cfg.visual, state_dict=tiny_backbone_from_flax(
        jax_pipe.visual.variables))
    vggish = VGGish()
    vggish.load_state_dict(vggish_from_flax(jax_pipe.audio.vggish_params))
    pipe = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, "cpu"),
                      AudioFrontend(cfg.audio, vggish, "cpu"))
    return jax_pipe, pipe


def _assert_same_processed(got, want):
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    assert (got.fps, got.n_frames) == (want.fps, want.n_frames)
    np.testing.assert_allclose(got.visual, want.visual, **TOL)
    np.testing.assert_allclose(got.audio, want.audio, **TOL)


# ---------------------------------------------------------------------------
# The OpenCV reader (tests/test_cv2video.py)
# ---------------------------------------------------------------------------


@needs_cv2
def test_open_video_dispatches_to_cv2(tmp_path):
    path = str(tmp_path / "clip.mp4")
    frames = _flat_frames()
    _write_mp4v(path, frames)
    reader = open_video(path)
    try:
        assert isinstance(reader, Cv2Reader)
        assert (reader.width, reader.height) == (64, 48)
        assert reader.n_frames == len(frames)
        assert reader.fps == pytest.approx(30.0)
    finally:
        reader.close()


@needs_cv2
def test_cv2_reader_frame_values_and_seek(tmp_path):
    """Sequential, random and batched reads agree with the source, and
    every frame equals the JAX package's reader's."""
    path = str(tmp_path / "clip.mp4")
    frames = _flat_frames()
    _write_mp4v(path, frames)
    reader = open_video(path)
    theirs = jax_cv2video.Cv2Reader(path)
    try:
        for idx in (0, 7, 3, 23):
            got = reader.read_frame(idx)
            assert got.shape == (48, 64, 3)
            assert abs(float(got.mean()) - float(frames[idx].mean())) < 4.0
            np.testing.assert_array_equal(got, theirs.read_frame(idx))
        batch = reader.read_frames([2, 10, 18])
        assert batch.shape == (3, 48, 64, 3)
        np.testing.assert_array_equal(batch, theirs.read_frames([2, 10, 18]))
        it = list(reader.iter_frames(start=20))
        assert len(it) == 4
        np.testing.assert_array_equal(
            np.stack(it), np.stack(list(theirs.iter_frames(start=20))))
        with pytest.raises(IndexError):
            reader.read_frame(len(frames))
    finally:
        reader.close()
        theirs.close()


@needs_cv2
def test_cv2_reader_rgb_channel_order(tmp_path):
    """A pure-red RGB source comes back red (the BGR -> RGB conversion)."""
    path = str(tmp_path / "red.mp4")
    frames = np.zeros((8, 48, 64, 3), np.uint8)
    frames[..., 0] = 200
    _write_mp4v(path, frames)
    reader = open_video(path)
    try:
        got = reader.read_frame(4).astype(np.float32).mean(axis=(0, 1))
        assert got[0] > 150, got
        assert got[1] < 80 and got[2] < 80, got
    finally:
        reader.close()


@needs_cv2
def test_pipeline_summarize_compressed_mp4(tmp_path):
    """Summarize of an mp4v container (a codec only the OpenCV backend
    decodes; silence-fallback audio) through the classic path, and its
    features against the JAX package's pipeline on the same file."""
    from avsum_torch.io.synthetic import make_scene_video
    from avsum_torch.models.scorer import make_model

    video, _audio, _ = make_scene_video(n_scenes=4, seed=5, height=48,
                                        width=64)
    path = str(tmp_path / "scene.mp4")
    _write_mp4v(path, video)
    sets = ["audio.silence_fallback=true", "model.hidden_dim=32",
            "model.scorer_hidden=8"]
    jax_pipe, pipe = _pipelines(sets)
    result = pipe.summarize(path, make_model(pipe.config.model, seed=0))
    assert result["n_frames"] == len(video)
    assert len(result["segments"]) >= 1
    # the scene cuts survive the lossy codec
    assert len(result["boundaries"]) >= 2
    assert set(pipe.stage_seconds) >= {"shot_detect", "visual_features",
                                       "audio_features"}
    import jax

    with jax.default_matmul_precision("highest"):
        want = jax_pipe.process_video(path)
    _assert_same_processed(pipe.process_video(path), want)


@needs_cv2
@needs_ff
@needs_aac
def test_mp4_without_imageio_falls_back_to_cv2(tmp_path, monkeypatch):
    """Without imageio (the GPU machine has none) the native MP4 reader
    refuses a track as a codec it cannot decode, so an mp4v track and an
    MJPEG one both open through OpenCV, and a sweep over mp4v + AAC files
    caches every video."""
    import sys

    from avsum_torch.io.mp4_mux import write_mjpeg_mp4

    mjpeg = str(tmp_path / "mjpeg.mp4")
    write_mjpeg_mp4(mjpeg, _flat_frames(n=8), fps=30)
    vdir = tmp_path / "videos"
    vdir.mkdir()
    _write_compressed_video(str(vdir / "cv0"), n_scenes=3, seed=11)
    for name in ("imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, name, None)
    for path in (str(vdir / "cv0.mp4"), mjpeg):
        reader = open_video(path)
        try:
            assert isinstance(reader, Cv2Reader), path
        finally:
            reader.close()
    _, pipe = _pipelines(["audio.silence_fallback=false"])
    cache = FeatureCache(str(tmp_path / "cache"))
    assert pipe.preprocess_dataset(str(vdir), cache) == ["cv0"]
    assert cache.get("cv0").visual.shape[1] == 4096


# ---------------------------------------------------------------------------
# The ffmpeg audio backend (tests/test_ffaudio.py)
# ---------------------------------------------------------------------------


@needs_ff
def test_wav_decode_bitexact(tmp_path):
    rng = np.random.RandomState(3)
    want = np.clip(rng.randn(4096, 2) * 0.3, -1, 1).astype(np.float32)
    p = str(tmp_path / "x.wav")
    write_wav(p, want, 44100)
    via_ff, rate = decode_audio(p)
    via_np, rate_np = read_wav(p)
    assert rate == rate_np == 44100
    np.testing.assert_array_equal(via_ff, via_np.astype(np.float32))


@needs_ff
def test_mono16k_matches_wav_chain(tmp_path):
    rng = np.random.RandomState(4)
    x = np.clip(rng.randn(22050, 2) * 0.3, -1, 1).astype(np.float32)
    p = str(tmp_path / "x.wav")
    write_wav(p, x, 22050)
    got = load_audio_mono_16k_ff(p)
    want = resample(to_mono(read_wav(p)[0]), 22050, 16000)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got.shape == (16000,)
    np.testing.assert_array_equal(got, jax_ffaudio.load_audio_mono_16k_ff(p))


@needs_ff
@needs_mp3
def test_real_mp3_decodes():
    x, rate = decode_audio(_MP3)
    assert rate == 11025 and x.shape[1] == 1
    assert x.shape[0] > 5 * rate
    rms = float(np.sqrt((x ** 2).mean()))
    assert 0.05 < rms < 0.9  # music, not silence or garbage
    np.testing.assert_array_equal(x, jax_ffaudio.decode_audio(_MP3)[0])
    np.testing.assert_array_equal(load_audio_mono_16k_ff(_MP3),
                                  jax_ffaudio.load_audio_mono_16k_ff(_MP3))


@needs_ff
@needs_ogg
def test_real_ogg_decodes():
    x, rate = decode_audio(_OGG)
    assert rate == 11025 and x.shape[0] > 5 * rate
    np.testing.assert_array_equal(x, jax_ffaudio.decode_audio(_OGG)[0])


@needs_ff
@needs_mp3
def test_mp3_in_mp4_track_roundtrip(tmp_path):
    """MP3 muxed as an 'mp4a' + esds track decodes as the bare stream
    does, and the native demuxer rejects it rather than misreading it."""
    from avsum_torch.io.mp3 import parse_mp3
    from avsum_torch.io.mp4 import (
        Mp4UnsupportedCodec,
        load_mp4_audio_mono_16k,
    )
    from avsum_torch.io.mp4_mux import write_mp3_mp4

    with open(_MP3, "rb") as fh:
        mp3 = fh.read()
    stream = parse_mp3(mp3)
    assert stream.sample_rate == 11025 and stream.samples_per_frame == 576
    p = str(tmp_path / "m.mp4")
    write_mp3_mp4(p, mp3)
    bare, rate_b = decode_audio(_MP3)
    muxed, rate_m = decode_audio(p)
    assert rate_b == rate_m
    n = min(len(bare), len(muxed))
    assert abs(len(bare) - len(muxed)) <= stream.samples_per_frame * 2
    np.testing.assert_allclose(bare[:n], muxed[:n], atol=1e-5)
    with pytest.raises(Mp4UnsupportedCodec):
        load_mp4_audio_mono_16k(p)


@needs_ff
@needs_aac
def test_aac_encode_mux_decode_roundtrip(tmp_path):
    """AAC-LC from the bundled encoder, muxed as 'mp4a' + esds, decoded
    back: the tone survives, the native demuxer refuses the track, and the
    access units and the decoded samples equal the JAX package's."""
    from avsum_torch.io.ffaudio import audio_specific_config, encode_aac
    from avsum_torch.io.mp4 import (
        Mp4UnsupportedCodec,
        load_mp4_audio_mono_16k,
    )
    from avsum_torch.io.mp4_mux import write_aac_mp4

    assert audio_specific_config(16000, 1) == bytes([0x14, 0x08])
    rate = 16000
    t = np.arange(rate * 2) / rate
    tone = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    packets, asc = encode_aac(tone, rate)
    assert len(packets) >= rate * 2 // 1024
    assert asc == bytes([0x14, 0x08])
    assert (packets, asc) == jax_ffaudio.encode_aac(tone, rate)

    p = str(tmp_path / "aac.mp4")
    write_aac_mp4(p, tone, rate)
    x, got_rate = decode_audio(p)
    assert got_rate == rate and x.shape[1] == 1
    assert abs(x.shape[0] - len(tone)) < 4 * 1024
    mid = x[rate // 2: rate // 2 + 8192, 0]
    spec = np.abs(np.fft.rfft(mid * np.hanning(len(mid))))
    assert abs(float(np.argmax(spec)) * rate / len(mid) - 440.0) < 4.0
    assert 0.2 < float(mid.std()) < 0.4
    np.testing.assert_array_equal(x, jax_ffaudio.decode_audio(p)[0])
    with pytest.raises(Mp4UnsupportedCodec):
        load_mp4_audio_mono_16k(p)


@needs_ff
@needs_aac
def test_aac_mp4_with_video_through_pipeline_audio(tmp_path):
    """An mp4 of MJPEG video (the native path) and AAC audio yields the
    AAC soundtrack through ``AVPipeline._load_audio``, as the JAX
    package's pipeline reads it."""
    from avsum_torch.io.mp4_mux import write_aac_mp4

    rate = 16000
    tone = (0.3 * np.sin(2 * np.pi * 220 * np.arange(rate) / rate)
            ).astype(np.float32)
    frames = (np.random.RandomState(2).rand(8, 32, 32, 3) * 255).astype(
        np.uint8)
    p = str(tmp_path / "clip.mp4")
    write_aac_mp4(p, tone, rate, frames=frames, fps=4)
    pipe = AVPipeline.__new__(AVPipeline)  # _load_audio reads config only
    pipe.config = load_config(overrides=["visual.backbone=tiny"])
    got = pipe._load_audio(p, duration_s=1.0)
    np.testing.assert_allclose(got, load_audio_mono_16k_ff(p), atol=1e-6)
    assert float(np.std(got)) > 0.1  # the soundtrack, not silence
    theirs = JaxPipeline.__new__(JaxPipeline)
    theirs.config = jax_load_config(overrides=["visual.backbone=tiny"])
    np.testing.assert_array_equal(
        got, np.asarray(theirs._load_audio(p, duration_s=1.0)))


@needs_ff
def test_no_audio_stream_distinguished(tmp_path):
    from avsum_torch.io.mp4_mux import write_mjpeg_mp4

    p = str(tmp_path / "v.mp4")
    frames = (np.random.RandomState(0).rand(4, 32, 32, 3) * 255).astype(
        np.uint8)
    write_mjpeg_mp4(p, frames, fps=4)  # video only
    with pytest.raises(FFNoAudioStream):
        decode_audio(p)


@needs_ff
@needs_mp3
def test_pipeline_falls_back_to_container_audio(tmp_path, monkeypatch):
    """``_load_audio``: the native demuxer refuses mp4a, the bundled
    ffmpeg decodes it; a .wav sidecar still wins; without the backend the
    error surfaces."""
    import avsum_torch.io.ffaudio as ffaudio_mod
    from avsum_torch.io.mp4 import Mp4UnsupportedCodec
    from avsum_torch.io.mp4_mux import write_mp3_mp4

    cfg = load_config(overrides=["visual.backbone=tiny"])
    pipe = AVPipeline.__new__(AVPipeline)
    pipe.config = cfg
    with open(_MP3, "rb") as fh:
        mp3 = fh.read()
    frames = (np.random.RandomState(1).rand(6, 32, 32, 3) * 255).astype(
        np.uint8)
    p = str(tmp_path / "clip.mp4")
    write_mp3_mp4(p, mp3, frames=frames, fps=3)
    got = pipe._load_audio(p, duration_s=2.0)
    want = load_audio_mono_16k_ff(p)
    np.testing.assert_allclose(got, want, atol=1e-6)

    sidecar = str(tmp_path / "clip.wav")
    tone = (0.25 * np.sin(np.arange(16000) / 16000 * 2 * np.pi * 440)
            ).astype(np.float32)
    write_wav(sidecar, tone, 16000)
    via_sidecar = np.asarray(pipe._load_audio(p, duration_s=1.0))
    assert via_sidecar.shape[0] == 16000
    assert not np.allclose(via_sidecar[:100], want[:100])
    os.remove(sidecar)

    monkeypatch.setattr(ffaudio_mod, "ffmpeg_audio_available", lambda: False)
    assert not cfg.audio.silence_fallback
    with pytest.raises(Mp4UnsupportedCodec):
        pipe._load_audio(p, duration_s=2.0)


# ---------------------------------------------------------------------------
# The dress rehearsal (tests/test_dress_rehearsal.py)
# ---------------------------------------------------------------------------


def _write_compressed_video(stem, n_scenes, seed, height=48, width=64):
    """One dataset file in the real formats: mp4v video + AAC audio."""
    from avsum_torch.io.mp4_mux import remux_video_with_aac
    from avsum_torch.io.synthetic import make_scene_video

    frames, audio, scenes = make_scene_video(
        n_scenes=n_scenes, seed=seed, height=height, width=width)
    tmp = stem + ".video_only.mp4"
    _write_mp4v(tmp, frames)
    remux_video_with_aac(tmp, stem + ".mp4", audio, rate=16000)
    os.remove(tmp)
    return frames, audio, scenes


@needs_cv2
@needs_aac
def test_remux_video_with_aac_round_trip(tmp_path):
    """The remuxed container's video goes through the OpenCV fallback (the
    native demuxer refuses mp4v) and its audio through the bundled ffmpeg,
    frame count and duration kept; the bytes are the JAX package's
    remux's, and so are the decoded frames and 16 kHz audio."""
    from avsum_torch.io.mp4 import Mp4UnsupportedCodec, Mp4VideoReader

    stem = str(tmp_path / "clip")
    frames, audio, _ = _write_compressed_video(stem, n_scenes=3, seed=11)
    with pytest.raises(Mp4UnsupportedCodec):
        Mp4VideoReader(stem + ".mp4")
    reader = open_video(stem + ".mp4")
    theirs = jax_cv2video.Cv2Reader(stem + ".mp4")
    try:
        assert type(reader).__module__.endswith("cv2video")
        assert reader.n_frames == frames.shape[0]
        assert (reader.height, reader.width) == frames.shape[1:3]
        got = reader.read_frame(frames.shape[0] // 2)
        assert got.shape == frames.shape[1:]
        every = range(reader.n_frames)
        np.testing.assert_array_equal(reader.read_frames(every),
                                      theirs.read_frames(every))
    finally:
        reader.close()
        theirs.close()
    decoded, rate = decode_audio(stem + ".mp4")
    # AAC pads to 1024-sample frames and adds encoder delay
    assert abs(len(decoded) / rate - len(audio) / 16000.0) < 2 * 1024 / 16000
    np.testing.assert_array_equal(
        load_audio_mono_16k_ff(stem + ".mp4"),
        jax_ffaudio.load_audio_mono_16k_ff(stem + ".mp4"))
    # the JAX package's remux of the same video track writes the same file
    _write_mp4v(stem + ".v.mp4", frames)
    jax_remux(stem + ".v.mp4", stem + ".jax.mp4", audio, rate=16000)
    with open(stem + ".mp4", "rb") as a, open(stem + ".jax.mp4", "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def compressed_tvsum_world(tmp_path_factory):
    from avsum_torch.bench.parity import (
        tvsum_user_scores,
        write_tvsum_mat,
    )

    root = tmp_path_factory.mktemp("ctvsum")
    video_dir = root / "videos"
    video_dir.mkdir()
    ids, scores, scene_lists = [], [], []
    rng = np.random.default_rng(0)
    for i in range(6):
        vid = f"cv{i:02d}"
        _, _, scenes = _write_compressed_video(str(video_dir / vid),
                                               n_scenes=4, seed=300 + i)
        frame_scores = np.zeros(scenes[-1][1], np.float32)
        for (start, end) in scenes:
            frame_scores[start:end] = rng.random()
        ids.append(vid)
        scores.append(frame_scores)
        scene_lists.append(scenes)
    mat_path = str(root / "ydata.mat")
    write_tvsum_mat(mat_path, ids, tvsum_user_scores(
        scores, scene_lists=scene_lists, scene_noise=0.05))
    return root, video_dir, mat_path


SETS = [
    "--set", "visual.backbone=tiny",
    "--set", "visual.dtype=float32",  # features held to JAX's at 1e-4
    "--set", "model.hidden_dim=32",
    "--set", "model.scorer_hidden=8",
    "--set", "data.dataset=tvsum",
    "--set", "data.batch_videos=2",
    "--set", "data.max_shots=8",
    "--set", "train.epochs=2",
    "--set", "train.eval_every_epochs=10",
]


def _sets(root):
    return SETS + [
        "--set", f"data.cache_dir={root}/cache",
        "--set", f"data.annotation_path={root}/ydata.mat",
        "--set", f"train.checkpoint_dir={root}/ckpt",
        "--device", "cpu",
    ]


@needs_cv2
@needs_aac
def test_full_protocol_on_compressed_media(compressed_tvsum_world, capsys,
                                           caplog):
    """preprocess -> kfold splits -> train -> evaluate --canonical through
    the port's CLI on mp4v + AAC files, every video through the classic
    path; the cache against the JAX package's sweep over the same files
    with the same encoder weights (``--weights`` from ``convert``)."""
    import logging

    import jax

    from avsum_torch.cli.main import main

    root, video_dir, _ = compressed_tvsum_world
    jax_pipe = JaxPipeline(jax_load_config(overrides=FLOAT))
    with jax.default_matmul_precision("highest"):
        jax_done = jax_pipe.preprocess_dataset(
            str(video_dir), JaxFeatureCache(str(root / "jax_cache")))
    weights = str(root / "w.pt")
    torch.save({"visual": tiny_backbone_from_flax(jax_pipe.visual.variables),
                "vggish": vggish_from_flax(jax_pipe.audio.vggish_params)},
               weights)

    with caplog.at_level(logging.INFO, logger="avsum_torch.pipeline"):
        assert main(["preprocess", "--input-dir", str(video_dir),
                     "--cache-dir", f"{root}/cache", "--weights", weights]
                    + _sets(root)) == 0
    cached = [d for d in os.listdir(f"{root}/cache")
              if os.path.exists(f"{root}/cache/{d}/meta.json")]
    assert len(cached) == 6, cached
    classic = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("cached ")]
    assert len(classic) == 6 and all(
        "'visual_features'" in m and "'audio_features'" in m
        for m in classic), classic
    ours = FeatureCache(f"{root}/cache")
    theirs = JaxFeatureCache(str(root / "jax_cache"))
    assert ours.video_ids() == sorted(jax_done)
    for vid in ours.video_ids():
        got, want = ours.get(vid), theirs.get(vid)
        np.testing.assert_array_equal(got.shot_boundaries,
                                      want.shot_boundaries)
        np.testing.assert_allclose(got.visual, want.visual, **TOL)
        np.testing.assert_allclose(got.audio, want.audio, **TOL)

    assert main(["splits", "--cache-dir", f"{root}/cache", "--kfold",
                 "--output", f"{root}/splits.json"] + _sets(root)) == 0
    with open(f"{root}/splits.json") as fh:
        assert len(json.load(fh)) == 5
    assert main(["train", "--splits", f"{root}/splits.json", "--fold", "0"]
                + _sets(root)) == 0
    capsys.readouterr()
    assert main(["evaluate", "--splits", f"{root}/splits.json", "--fold",
                 "0", "--canonical"] + _sets(root)) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"f1", "spearman", "kendall", "canonical_f1", "n_videos"} <= set(
        metrics)
    assert metrics["n_videos"] >= 1
    assert 0.0 <= metrics["canonical_f1"] <= 1.0
