"""``train`` and ``evaluate`` through the CLI under ``torchrun`` on the CPU:
``configs/hour_scale.yaml`` at narrow widths (hidden 16, 2 heads, 32
shots, dropout 0.3) at seq 2 in two gloo processes (``python -m
torch.distributed.run --standalone --nproc-per-node 2 -m avsum_torch.cli
train --device cpu``), 2 epochs and then ``--resume`` for a third, on a
synthetic feature cache of 4 videos; then ``evaluate`` in two processes.
Held to the same two runs in one process at seq 1: every step's loss
(1e-5), the evaluation's metrics (1e-5); the log and the checkpoints are
written once, by the primary rank, and the evaluation printed once."""

import json
import os
import subprocess
import sys

import numpy as np

from avsum_torch.cli.main import main
from avsum_torch.data.cache import FeatureCache
from avsum_torch.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "hour_scale.yaml")
NARROW = ["model.visual_dim=16", "model.audio_dim=8", "model.hidden_dim=16",
          "model.num_heads=2", "model.scorer_hidden=8", "data.max_shots=32",
          "train.warmup_steps=2", "train.log_every=1"]


def _write_cache(cache_dir: str, n: int = 4, seed: int = 2) -> None:
    rng = np.random.default_rng(seed)
    cache = FeatureCache(cache_dir)
    for i in range(n):
        s = int(rng.integers(20, 40))
        ends = np.cumsum(rng.integers(20, 60, s))
        bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
        cache.put(f"v{i}", rng.standard_normal((s, 16), np.float32),
                  rng.standard_normal((s, 8), np.float32), bounds, 30.0,
                  int(ends[-1]))


def _args(cmd: str, run: str, cache: str, seq: int, epochs: int, *extra):
    sets = NARROW + [f"data.cache_dir={cache}", f"mesh.seq={seq}",
                     f"train.epochs={epochs}",
                     f"train.checkpoint_dir={run}/ckpt",
                     f"train.log_path={run}/log.jsonl"]
    return [cmd, "--config", CONFIG, "--device", "cpu", *extra,
            *[a for s in sets for a in ("--set", s)]]


def _torchrun(args):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "avsum_torch.cli", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _losses(run: str):
    return [json.loads(line)["loss"] for line in open(f"{run}/log.jsonl")]


def test_torchrun_train_resume_evaluate_match_one_process(tmp_path, capsys):
    cache, mesh_run, one_run = (str(tmp_path / d)
                                for d in ("cache", "mesh", "one"))
    _write_cache(cache)
    for run in (mesh_run, one_run):
        os.makedirs(run)
    _torchrun(_args("train", mesh_run, cache, 2, 2))
    assert CheckpointManager(f"{mesh_run}/ckpt").steps() == [4, 8]
    _torchrun(_args("train", mesh_run, cache, 2, 3, "--resume"))
    out = _torchrun(_args("evaluate", mesh_run, cache, 2, 3))
    printed = [json.loads(line) for line in out.splitlines()
               if line.startswith("{")]
    assert len(printed) == 1  # the primary rank alone prints

    assert main(_args("train", one_run, cache, 1, 2)) == 0
    assert main(_args("train", one_run, cache, 1, 3, "--resume")) == 0
    assert main(_args("evaluate", one_run, cache, 1, 3)) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    losses = _losses(mesh_run)
    assert len(losses) == 12  # one log line a step, from one rank
    np.testing.assert_allclose(losses, _losses(one_run), rtol=1e-5,
                               atol=1e-5)
    assert CheckpointManager(f"{mesh_run}/ckpt").steps() == [4, 8, 12]
    assert not [n for n in os.listdir(f"{mesh_run}/ckpt")
                if n.startswith(".")]
    assert printed[0].keys() == want.keys()
    for k, v in want.items():
        assert abs(printed[0][k] - v) <= 1e-5, (k, printed[0][k], v)
