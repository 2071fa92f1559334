"""chip_smoke.py reaches the JAX package's jax-free helpers only through
avsum_torch, and gives no result without a CUDA device."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


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
    bad = [n for n in names if n.split(".")[0] in ("avsum_tpu", "jax", "flax")]
    assert not bad, bad


@pytest.mark.parametrize("name,module,attr", [
    ("avsum_torch.data", "avsum_tpu.data.cache", "FeatureCache"),
    ("avsum_torch.train.config", "avsum_tpu.train.config", "load_config"),
    ("avsum_torch.train.config", "avsum_tpu.train.config", "Config"),
    ("avsum_torch.io", "avsum_tpu.io.wav", "load_audio_mono_16k_ship"),
    ("avsum_torch.io", "avsum_tpu.io.synthetic", "write_scene_video"),
])
def test_port_reexports_the_shared_helpers(name, module, attr):
    import importlib

    ours = getattr(importlib.import_module(name), attr)
    assert ours is getattr(importlib.import_module(module), attr)


def test_chip_smoke_gives_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SMOKE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
