"""The plain references against the port at tiny sizes on the CPU, and
the reference's independence: nothing under ``benchmark/reference/``
imports the port, and nothing the benchmark runs loads JAX."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.generators import scene_clip
from benchmark.program import program_state
from benchmark.reference import media
from benchmark.reference import scorer as reference
from benchmark.tests.conftest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "avsum_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        found = _imports(path)
        assert not found & (FORBIDDEN | {"avsum_torch"}), (path, found)


def test_no_file_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_a_run_loads_no_jax_module():
    """Import everything a run imports, the drivers and the port's modules
    they use, in a fresh process, and list the top-level names."""
    code = (
        "import sys, json\n"
        "from benchmark import harness, run, counts, readers, faults, control\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    harness.find_cell(w['name'])\n"
        "import avsum_torch.pipeline, avsum_torch.train.steps\n"
        "import avsum_torch.models.scorer, avsum_torch.build\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


@pytest.mark.parametrize("encoder", ["attention", "bilstm"])
def test_the_reference_scorer_is_the_port_s_forward(encoder):
    from avsum_torch.models.scorer import AVScorer
    from avsum_torch.train.config import ModelConfig

    model = {"visual_dim": 12, "audio_dim": 6, "hidden_dim": 16,
             "num_heads": 2, "scorer_hidden": 8, "dropout": 0.3,
             "temporal_encoder": encoder, "temporal_layers": 2}
    leaves = reference.init_leaves(model, 5, "cpu")
    port = AVScorer(ModelConfig(**model))
    port.load_state_dict(program_state(leaves, model))
    gen = torch.Generator().manual_seed(1)
    v, a = torch.randn(2, 9, 12, generator=gen), torch.randn(2, 9, 6,
                                                            generator=gen)
    mask = torch.ones(2, 9)
    mask[1, 6:] = 0
    port.eval()
    with torch.no_grad():
        want = reference.forward(leaves, model, v, a, mask)
        got = port(v, a, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["tinyatt.train", "tinylstm.train"])
def test_the_reference_steps_follow_the_port_s(tiny_root, cell):
    found = harness.find_cell(cell, root=tiny_root)
    run = harness.Run(found, 2 ** 31 + 3, "cpu")
    got = found.driver.readings(run, "sound")
    assert got["loss_gap"] < 1e-5 and got["grad1_gap"] < 1e-4
    assert got["change_gap"] < 1e-2


def test_the_reference_summarize_follows_the_port_s(tiny_root):
    found = harness.find_cell("tinyclip.summarize", root=tiny_root)
    run = harness.Run(found, 9, "cpu")
    got = found.driver.readings(run, "sound")
    assert got["boundary_mismatch"] == 0 and got["segment_mismatch"] == 0
    assert got["visual_gap"] < 0.05 and got["vggish_gap"] < 0.05
    assert got["mfcc_gap"] < 1e-4 and got["logmel_gap"] < 1e-5
    assert got["scorer_gap"] < 1e-5


def test_the_reference_detector_finds_the_port_s_shots(tmp_path):
    from avsum_torch.build import ensure_native_io
    from avsum_torch.io.native import NativeY4MReader
    from avsum_torch.temporal.shots import (
        boundaries_from_cuts,
        cuts_from_scores,
        refined_content_scores,
    )

    ensure_native_io()
    clip = {"scenes": 4, "scene_frames": [16, 30], "width": 640,
            "height": 360, "fps": 30, "noise": 4.0}
    scenes = scene_clip.write(str(tmp_path / "c"), clip, 7, "cpu")
    y, u, v, fps = media.read_y4m(str(tmp_path / "c.y4m"))
    assert y.shape == (scenes[-1][1], 360, 640) and fps == 30
    want = media.boundaries(media.content_scores(y, u, v, "cpu"))
    with NativeY4MReader(str(tmp_path / "c.y4m")) as reader:
        got = boundaries_from_cuts(cuts_from_scores(
            refined_content_scores(reader, 640 // 256)), reader.n_frames)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, np.array(scenes))


def test_the_host_resize_is_the_decoder_s(tmp_path):
    from avsum_torch.build import ensure_native_io
    from avsum_torch.io.native import NativeY4MReader

    from benchmark.reference.vision import host_resize

    ensure_native_io()
    clip = {"scenes": 2, "scene_frames": [3, 4], "width": 640, "height": 360,
            "fps": 30, "noise": 4.0}
    scene_clip.write(str(tmp_path / "c"), clip, 3, "cpu")
    y, u, v, _ = media.read_y4m(str(tmp_path / "c.y4m"))
    idx = np.arange(len(y))
    with NativeY4MReader(str(tmp_path / "c.y4m")) as reader:
        gy, gu, gv = reader.read_yuv420_resized(idx, 304, 304)
    np.testing.assert_array_equal(gy, host_resize(np.asarray(y), 304, 304))
    np.testing.assert_array_equal(gu, host_resize(np.asarray(u), 152, 152))
    np.testing.assert_array_equal(gv, host_resize(np.asarray(v), 152, 152))


def test_the_clip_keeps_the_bench_clip_s_scene_model(tmp_path):
    """The scene model of ``io/synthetic.py`` on one fixed ring of scenes:
    every seed's clip has the same frames, shot lengths, colours and
    tones, started at another scene, and the port's bench clip's
    shading."""
    from avsum_torch.io.y4m import Y4MReader

    clip = {"scenes": 5, "scene_frames": [4, 8], "width": 64, "height": 48,
            "fps": 30, "noise": 4.0}
    rings = []
    for seed in (11, 12, 13):
        scenes = scene_clip.write(str(tmp_path / f"c{seed}"), clip, seed,
                                  "cpu")
        lengths, colors, tones, _ = scene_clip.layout(clip, seed)
        assert [e - s for s, e in scenes] == lengths.tolist()
        assert all(np.abs(colors[i] - colors[i - 1]).mean() >= 80
                   for i in range(5))
        start = int(np.argmax(lengths == 4))
        rings.append((np.roll(lengths, -start).tolist(),
                      np.roll(tones, -start).tolist()))
        with Y4MReader(str(tmp_path / f"c{seed}.y4m")) as reader:
            ours = reader.read_frames(np.arange(reader.n_frames)).astype(float)
        assert ours.shape == (30, 48, 64, 3)
        assert len(media.read_wav(str(tmp_path / f"c{seed}.wav"))) == 16000
        # the port's shading: a scene's mean is its colour times 0.6 plus
        # 0.4 of the gradient's mean, 0.5, give or take the drift
        assert ours[:lengths[0]].mean(axis=(0, 1, 2)) == pytest.approx(
            colors[0] * (0.6 + 0.4 * 0.5), abs=6.0)
    assert rings[0] == rings[1] == rings[2]
    assert sorted(rings[0][0]) == [4, 5, 6, 7, 8]
