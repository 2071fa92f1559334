"""The port stands alone: no module of ``avsum_torch`` and not
``chip_smoke.py`` imports the JAX package or JAX's libraries, and the
port's copies of the JAX package's numpy modules (config, media, feature
cache, batching) give what the originals give. ``chip_smoke.py`` gives no
result without a CUDA device."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from avsum_tpu.data import batching as jax_batching
from avsum_tpu.data.cache import FeatureCache as JaxFeatureCache
from avsum_tpu.data.synthetic import make_synthetic_videos as jax_videos
from avsum_tpu.io import mp4_mux as jax_mp4_mux
from avsum_tpu.io import synthetic as jax_synthetic
from avsum_tpu.io import video as jax_video
from avsum_tpu.io import wav as jax_wav
from avsum_tpu.io.mp4 import load_mp4_audio_mono_16k as jax_load_mp4_audio
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.data import batching
from avsum_torch.data.cache import FeatureCache
from avsum_torch.data.synthetic import make_synthetic_videos
from avsum_torch.io import mp4_mux, synthetic, video, wav
from avsum_torch.io.mp4 import load_mp4_audio_mono_16k
from avsum_torch.train.config import load_config, save_config
from torch_helpers import assert_config_equals_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")
PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "avsum_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
# msgpack too: the card has no such package (the port reads Flax msgpack
# files with avsum_torch/utils/serialization.py)
FORBIDDEN = ("avsum_tpu", "jax", "flax", "optax", "msgpack")


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_chip_smoke_names_no_module_of_the_jax_package():
    names = list(_imported_modules(SMOKE))
    assert any(n.startswith("avsum_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_nothing_of_jax(path):
    """At module level or inside a function, at any depth."""
    bad = [n for n in _imported_modules(os.path.join(ROOT, path))
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_has_modules_to_walk():
    assert len(PORT_FILES) > 40
    assert "avsum_torch/io/native.py" in PORT_FILES
    assert {"avsum_torch/models/moe.py", "avsum_torch/ops/chunked.py",
            "avsum_torch/vision/vit.py", "avsum_torch/parallel/tensor.py",
            "avsum_torch/utils/profiling.py", "avsum_torch/utils/debug.py",
            "avsum_torch/ops/dtw.py", "avsum_torch/utils/serialization.py",
            "avsum_torch/bench/e2e.py", "avsum_torch/bench/hour.py",
            "avsum_torch/bench/train_hour.py", "avsum_torch/bench/ppep.py",
            "avsum_torch/bench/pp_equality.py",
            "avsum_torch/bench/deep_pp_curve.py",
            "avsum_torch/bench/embed_sweep.py",
            "avsum_torch/bench/embed_ab.py",
            "avsum_torch/data/synthetic.py"} <= set(PORT_FILES)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                        "*.yaml"))))
def test_load_config_equals_the_jax_packages(name):
    path = os.path.join(ROOT, "configs", name)
    overrides = ["train.lr=1e-3", "model.use_pallas=false"]
    ours = load_config(path, overrides)
    theirs = jax_load_config(path, overrides)
    assert_config_equals_jax(ours, theirs)
    assert type(ours).__module__ == "avsum_torch.train.config"


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs",
                                                        "torch", "*.yaml"))))
def test_port_only_configs_load_and_roundtrip(name, tmp_path):
    """``configs/torch/`` holds the configs that name keys only the port
    has: the port loads each and reads back what it saves, and the JAX
    package refuses them."""
    path = os.path.join(ROOT, "configs", "torch", name)
    ours = load_config(path, ["train.lr=1e-3"])
    out = str(tmp_path / name)
    save_config(ours, out)
    assert load_config(out) == ours
    with pytest.raises(KeyError, match="unknown config key"):
        jax_load_config(path)


def _cache_examples(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate((5, 11)):
        ends = np.cumsum(rng.integers(10, 40, s))
        bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
        out.append((f"v{i}", rng.standard_normal((s, 12), np.float32),
                    rng.standard_normal((s, 6), np.float32), bounds, 25.0,
                    int(ends[-1])))
    return out


@pytest.mark.parametrize("writer,reader", [
    (JaxFeatureCache, FeatureCache), (FeatureCache, JaxFeatureCache)])
def test_feature_cache_reads_back_across_packages(tmp_path, writer, reader):
    examples = _cache_examples(seed=3)
    cache = writer(str(tmp_path))
    for ex in examples:
        cache.put(*ex)
    other = reader(str(tmp_path))
    assert other.video_ids() == [ex[0] for ex in examples]
    for vid, visual, audio, bounds, fps, n_frames in examples:
        got = other.get(vid)
        np.testing.assert_array_equal(got.visual, visual)
        np.testing.assert_array_equal(got.audio, audio)
        np.testing.assert_array_equal(got.shot_boundaries, bounds)
        assert (got.fps, got.n_frames) == (fps, n_frames)


def _frames(module, path):
    reader = module.open_video(path)
    try:
        return reader.fps, reader.read_frames(range(reader.n_frames))
    finally:
        reader.close()


@pytest.mark.parametrize("container", ["y4m", "mp4"])
def test_media_decodes_equal(tmp_path, container):
    """Frames through ``open_video`` and 16 kHz audio, from one seeded
    scene video, as each package writes and reads it."""
    got = {}
    for name, io_video, io_wav, io_synth, mux, load_mp4 in (
            ("ours", video, wav, synthetic, mp4_mux, load_mp4_audio_mono_16k),
            ("theirs", jax_video, jax_wav, jax_synthetic, jax_mp4_mux,
             jax_load_mp4_audio)):
        stem = str(tmp_path / name)
        io_synth.write_scene_video(stem, n_scenes=3, seed=4, height=48,
                                   width=64, scene_len_frames=(5, 9))
        audio = io_wav.load_audio_mono_16k_ship(stem + ".wav")
        if container == "y4m":
            fps, frames = _frames(io_video, stem + ".y4m")
        else:
            clip, pcm, _ = io_synth.make_scene_video(
                n_scenes=3, seed=4, height=48, width=64, scene_len_frames=(5, 9))
            mux.write_mjpeg_mp4(stem + ".mp4", clip, fps=30.0, audio=pcm)
            fps, frames = _frames(io_video, stem + ".mp4")
            audio = np.concatenate([audio, load_mp4(stem + ".mp4")])
        got[name] = (fps, frames, audio)
    (fps, frames, audio), (jfps, jframes, jaudio) = got["ours"], got["theirs"]
    assert fps == jfps and frames.shape[0] >= 15
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(audio, jaudio)


def _batches(mod):
    """``pad_batch`` of seeded examples (one longer than the bucket), then
    ``batch_iterator``'s shuffled batches of 2, the last one padded."""
    rng = np.random.default_rng(6)
    examples = [mod.VideoExample(f"v{i}", rng.standard_normal((s, 8), np.float32),
                                 rng.standard_normal((s, 4), np.float32),
                                 rng.random(s).astype(np.float32))
                for i, s in enumerate((7, 30, 12, 19, 3))]
    return [mod.pad_batch(examples, 24)] + list(
        mod.batch_iterator(examples, 2, 24, seed=7))


def test_batches_equal():
    ours, theirs = _batches(batching), _batches(jax_batching)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) == {"visual", "audio", "targets", "mask"}
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


def test_synthetic_videos_equal():
    kw = dict(n_videos=4, min_shots=3, max_shots=9, visual_dim=16,
              audio_dim=8, seed=5)
    ours, theirs = make_synthetic_videos(**kw), jax_videos(**kw)
    assert [type(v).__module__ for v in ours] == [batching.__name__] * 4
    for a, b in zip(ours, theirs):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for key, value in dataclasses.asdict(b).items():
            np.testing.assert_array_equal(getattr(a, key), value)


def test_chip_smoke_gives_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SMOKE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
