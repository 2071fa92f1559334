"""The port's measurement entry points (``python -m avsum_torch.bench
{e2e,hour,train-hour}``) against the JAX package's ``bench.py``,
``scripts/bench_hour.py`` and ``scripts/bench_train_hour.py``: the same
media bytes, the same train batch, the same config fingerprint; each
command at a small size on the CPU prints its JSON lines, in a process
where the JAX package, JAX's libraries and ``msgpack`` cannot be imported;
without a card and without ``--device cpu`` each raises."""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from avsum_tpu.data.cache import config_fingerprint as jax_fingerprint
from avsum_tpu.io import synthetic as jax_synthetic
from avsum_tpu.temporal.shots import ContentDetectorConfig as JaxDetector
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_tpu.train.config import TrainConfig as JaxTrainConfig
from avsum_tpu.train.config import load_config as jax_load_config
from avsum_torch.bench import __main__ as bench_main
from avsum_torch.bench import e2e, hour, train_hour
from avsum_torch.io import synthetic
from torch_helpers import assert_config_equals_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tiny_backbone_bf16.msgpack")
BLOCKED = ("avsum_tpu", "jax", "flax", "optax", "msgpack")
# runs the bench CLI with the JAX package, JAX's libraries and msgpack
# unimportable, and checks none was loaded
NO_JAX = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.argv = ["avsum_torch.bench", *sys.argv[1:]]
try:
    runpy.run_module("avsum_torch.bench", run_name="__main__")
finally:
    assert not [m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {BLOCKED!r}]
"""
E2E_KEYS = {
    "metric", "value", "unit", "vs_baseline", "media", "config_fingerprint",
    "backend", "device", "runs_s", "stages_s", "n_embedded_frames",
    "embed_gflops_per_frame", "mfu_lower_bound_pct",
    "embed_program_ms_per_frame", "embed_program_mfu_pct",
    "device_busy_pct", "kernels", "warmup_cold_s", "warm_probe",
    "adaptive_fps", "adaptive_identical_segments"}
TRAIN_KEYS = {"bench", "label", "seq_len", "backend", "n_devices", "step_ms",
              "steps_ms", "first_step_s", "hbm_peak_mib", "loss",
              "tokens_per_s", "kernels"}


def _bench(*argv, timeout=600):
    """The bench CLI in a process without JAX -> its JSON lines."""
    res = subprocess.run(
        [sys.executable, "-c", NO_JAX, *argv], capture_output=True, text=True,
        cwd=ROOT, timeout=timeout, env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads(line) for line in res.stdout.strip().splitlines()]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_bench_clip_bytes_equal_the_jax_packages(tmp_path):
    """bench.py's generator and seed at a small size: both packages write
    the same y4m and wav bytes."""
    kw = dict(n_scenes=2, seed=e2e.SEED, fps=e2e.FPS, height=36, width=64,
              scene_len_frames=e2e.SCENE_LEN)
    synthetic.write_scene_video(str(tmp_path / "ours"), **kw)
    jax_synthetic.write_scene_video(str(tmp_path / "theirs"), **kw)
    for ext in (".y4m", ".wav"):
        assert _read(tmp_path / f"ours{ext}") == _read(tmp_path / f"theirs{ext}")


def test_hour_media_bytes_equal_the_jax_scripts(tmp_path):
    """``hour.generate`` (threaded writes) against
    ``scripts/bench_hour.py::generate`` at 2 s: the same bytes."""
    hour.generate(str(tmp_path / "ours"), 2)
    _load_script("bench_hour").generate(str(tmp_path / "theirs"), 2)
    for ext in (".y4m", ".wav"):
        assert _read(tmp_path / f"ours{ext}") == _read(tmp_path / f"theirs{ext}")
    assert os.path.getsize(tmp_path / "ours.y4m") == (
        len(b"YUV4MPEG2 W640 H360 F30:1 Ip A1:1 C420\n")
        + 60 * hour.FRAME_BYTES)


def test_train_batch_equals_the_jax_scripts(monkeypatch):
    """The JAX script's ``measure`` builds its batch inline; catch it where
    it reaches ``create_train_state``."""
    import avsum_tpu.train.steps as jax_steps

    class Caught(Exception):
        pass

    def catch(model, cfg, batch, total_steps):
        raise Caught(batch)

    monkeypatch.setattr(jax_steps, "create_train_state", catch)
    script = _load_script("bench_train_hour")
    model_cfg = JaxModelConfig(hidden_dim=32, num_heads=4, temporal_layers=2)
    with pytest.raises(Caught) as caught:
        script.measure(None, model_cfg, JaxTrainConfig(), 48, "x",
                       batch_videos=2)
    want = caught.value.args[0]
    cfg = train_hour.bench_config(None, [], 32, True)
    got = train_hour.make_batch(cfg.model, 48, batch_videos=2)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_train_config_equals_the_jax_scripts():
    for remat in (True, False):
        cfg = train_hour.bench_config(None, [], 512, remat)
        want_model = JaxModelConfig(hidden_dim=512, num_heads=4,
                                    temporal_layers=2, remat=remat,
                                    dtype="float32")
        assert_config_equals_jax(cfg.model, want_model)
        assert_config_equals_jax(cfg.train,
                                 JaxTrainConfig(lr=1e-4, warmup_steps=5))


@pytest.fixture(scope="module")
def e2e_line(tmp_path_factory):
    media = tmp_path_factory.mktemp("bench")
    lines = _bench("e2e", "--device", "cpu", "--set", "visual.backbone=tiny",
                   "--set", f"visual.weights={FIXTURE}", "--runs", "2",
                   "--scenes", "2", "--media-dir", str(media))
    assert len(lines) == 1
    return lines[0]


def test_e2e_prints_one_line_with_the_keys(e2e_line):
    line = e2e_line
    assert E2E_KEYS <= set(line)
    assert (line["metric"], line["unit"]) == ("e2e_video_fps", "frames/sec")
    assert line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1800)
    assert line["backend"] == "cpu" and line["device"] is None
    assert len(line["runs_s"]) == 2
    assert line["value"] == pytest.approx(
        line["media"]["n_frames"] / min(line["runs_s"]))
    # a CPU run writes nothing under a device metric's name
    for key in ("mfu_lower_bound_pct", "embed_program_ms_per_frame",
                "embed_program_mfu_pct", "device_busy_pct"):
        assert line[key] is None
    assert line["embed_gflops_per_frame"] > 0
    assert set(line["warm_probe"]) == {"build_s", "warmup_s", "second_s"}
    assert line["adaptive_identical_segments"] in (True, False)
    assert line["kernels"] == {"melspec": [0, 0], "flash_fwd": [0, 0]}
    assert line["n_embedded_frames"] == len(range(
        0, line["media"]["n_frames"], 15))


def test_e2e_fingerprint_equals_the_jax_packages(e2e_line):
    """The bench config's feature fingerprint is JAX's for the same
    overrides (the feature cache is shared between the packages)."""
    cfg = jax_load_config(overrides=e2e.BENCH_SETS + [
        "visual.backbone=tiny", f"visual.weights={FIXTURE}"])
    assert e2e_line["config_fingerprint"] == jax_fingerprint(
        cfg.visual, cfg.audio, JaxDetector())


def test_train_hour_prints_two_finite_lines():
    lines = _bench("train-hour", "--device", "cpu", "--seq", "64",
                   "--hidden", "32", "--steps", "2")
    assert [x["label"] for x in lines] == ["chip_remat_flash",
                                           "chip_norematerialize"]
    for line in lines:
        assert TRAIN_KEYS <= set(line)
        assert line["seq_len"] == 64 and line["backend"] == "cpu"
        assert math.isfinite(line["loss"]) and line["hbm_peak_mib"] is None
        assert len(line["steps_ms"]) == 2
    # remat recomputes the same function
    assert lines[0]["loss"] == pytest.approx(lines[1]["loss"], rel=1e-6)


def test_train_hour_mesh_matches_one_process():
    """``--mode mesh --ranks 2``: the seq-2 ring on two gloo ranks gives
    the one-process remat step's loss."""
    one = _bench("train-hour", "--device", "cpu", "--seq", "64", "--hidden",
                 "32", "--steps", "1")[0]
    (line,) = _bench("train-hour", "--device", "cpu", "--mode", "mesh",
                     "--ranks", "2", "--seq", "64", "--hidden", "32",
                     "--steps", "1")
    assert line["label"] == "mesh_seq2_ring_remat"
    assert (line["ranks"], line["dist_backend"]) == (2, "gloo")
    assert len(line["ranks_step_ms"]) == 2
    assert line["loss"] == pytest.approx(one["loss"], rel=1e-5)


def test_hour_prints_its_line(tmp_path):
    (line,) = _bench("hour", "--device", "cpu", "--seconds", "2", "--runs",
                     "1", "--set", "visual.backbone=tiny", "--media-dir",
                     str(tmp_path))
    assert (line["metric"], line["unit"]) == ("hour_scale_wall_s",
                                             "s_per_source_hour")
    assert line["n_frames"] == 60 and line["n_shots"] >= 1
    assert line["value"] == pytest.approx(
        line["runs_s"][0] / 2 * 3600)
    assert line["vs_baseline"] == pytest.approx(60 / line["value"])
    assert line["peak_device_mib"] is None


@pytest.mark.parametrize("command", sorted(
    name for name, module in bench_main.COMMANDS.items()
    if getattr(module, "USES_DEVICE", True)))
def test_without_a_card_the_bench_raises(command, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_main.main([command])
