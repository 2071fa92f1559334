"""Train steps on a mesh (``avsum_torch/train/steps.py``,
``make_train_step(model, mesh)``) and mesh-portable checkpoints, on a
world of 4 gloo CPU ranks.

Port against port (dropout 0.1, so the masks drawn at the global shape
and sliced must be the one-device masks): 3 steps at data 4 (B = 3, one
padded row), seq 4 (S = 14, two padded shots; ring attention), data 2 x
seq 2, the MoE encoder at data 2 x model 2 and at seq 2 x model 2 (the
gathered shot axis into the sharded experts), and the staged encoder at
data 2 x model 2 (GPipe), each against the one-process steps on the same
padded batches: the losses (relative 1e-5), the first step's gradients
gathered to the one-device layout (1e-5 of each tensor's max |g|) and the
parameters after 3 steps (5e-5, JAX's bound for PP against sequential,
``tests/test_pp_trainer.py``; 3e-4 where the ring reorders the softmax,
JAX's bound for the same comparison, ``tests/test_ring_in_model.py``).
The key third of each qkv bias has a zero exact gradient, so Adam turns
rounding noise there into steps: those entries are held by the other
parameters (``tests/test_torch_train.py``).

Port against JAX (dropout 0, the same weights through
``avsum_torch.convert``): 3 steps at data 2 x seq 2 (ring) and with the
MoE encoder at data 2 x model 2, against JAX's ``make_train_step(model,
mesh)`` on the host CPU mesh: losses relative 1e-4, parameters 3e-4.

Checkpoints: trained at data 2 x model 2 (MoE, staged) and restored in one
process, and the reverse; parameters and Adam moments equal exactly.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.models.scorer import AVScorer, to_mesh
from avsum_torch.parallel.mesh import (
    MeshConfig,
    gather_tensors,
    host_cpu_mesh,
    pad_batch_for_mesh,
    shard_batch,
)
from avsum_torch.parallel.multihost import Ranks
from avsum_torch.train import steps
from avsum_torch.train.checkpoint import CheckpointManager
from avsum_torch.train.config import ModelConfig, TrainConfig

BASE = dict(visual_dim=12, audio_dim=6, hidden_dim=16, num_heads=2,
            scorer_hidden=8)
TRAIN = dict(lr=3e-3, warmup_steps=1, seed=3)
ATTENTION = dict(temporal_encoder="attention")
MOE = dict(temporal_encoder="moe", moe_experts=4)
STAGED = dict(temporal_encoder="attention", temporal_layers=4, pp_stages=2)
CASES = {  # name: (model fields, mesh fields, B, S, parameter tolerance)
    "data4": (ATTENTION, dict(data=4), 3, 16, 5e-5),
    "seq4": (ATTENTION, dict(seq=4), 2, 14, 3e-4),
    "data2_seq2": (ATTENTION, dict(seq=2), 4, 16, 3e-4),
    "moe_data2_model2": (MOE, dict(model=2), 4, 16, 5e-5),
    "moe_seq2_model2": (MOE, dict(data=1, seq=2, model=2, auto_data=False),
                        2, 16, 5e-5),
    "staged_data2_model2": (STAGED, dict(model=2), 4, 16, 5e-5),
}


def _batches(b: int, s: int, n: int = 3, seed: int = 7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones((b, s), np.float32)
        mask[0, s - 3 - i:] = 0.0
        mask[-1, s // 2:] = 0.0
        out.append({"visual": rng.standard_normal((b, s, 12)).astype(np.float32),
                    "audio": rng.standard_normal((b, s, 6)).astype(np.float32),
                    "targets": rng.random((b, s)).astype(np.float32) * mask,
                    "mask": mask})
    return out


def _weights(fields, dropout: float, seed: int = 0):
    from avsum_torch.models.scorer import make_model

    model = make_model(ModelConfig(**BASE, dropout=dropout, **fields), seed)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _model(fields, dropout, weights) -> AVScorer:
    model = AVScorer(ModelConfig(**BASE, dropout=dropout, **fields))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def _steps(model, mesh, batches, total_steps: int = 20):
    """3 steps -> (state, losses, the first step's gradients by name)."""
    state = steps.create_train_state(model, TrainConfig(**TRAIN), total_steps)
    first = []
    update = state.optimizer.step

    def recording(grads, g_norm=None):
        if not first:
            first.extend(g.detach().clone() for g in grads)
        return update(grads, g_norm)

    state.optimizer.step = recording
    step = steps.make_train_step(model, mesh, seed=TRAIN["seed"])
    losses = []
    for batch in batches:
        batch = (steps.batch_to_device(batch, "cpu") if mesh is None
                 else shard_batch(batch, mesh))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    names = [n for n, _ in model.named_parameters()]
    return state, losses, dict(zip(names, first))


def _train_rank(fields, mesh_fields, dropout, weights, batches):
    mesh = host_cpu_mesh(MeshConfig(**mesh_fields))
    model = to_mesh(_model(fields, dropout, weights), mesh)
    _, losses, grads = _steps(model, mesh, batches)
    full = AVScorer(model.config)
    p_names = [n for n, _ in full.named_parameters()]
    split = model.split_names()
    grads = gather_tensors(grads, split, mesh, p_names)
    params = gather_tensors(model.state_dict(), split, mesh,
                            list(full.state_dict()))
    numpy = {k: v.numpy() for k, v in params.items()}
    return losses, {k: v.numpy() for k, v in grads.items()}, numpy


def _without_key_bias(name, value):
    if name.endswith("qkv.bias"):
        q, _, v = np.split(value, 3)
        return np.concatenate([q, v])
    return value


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4) as r:
        yield r


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_steps_match_one_process(ranks, case):
    fields, mesh_fields, b, s, param_tol = CASES[case]
    weights = _weights(fields, 0.1)
    cfg = MeshConfig(**mesh_fields).resolved(4)
    batches = [pad_batch_for_mesh(x, cfg.data, cfg.seq)
               for x in _batches(b, s)]
    model = _model(fields, 0.1, weights)
    _, want_losses, want_grads = _steps(model, None, batches)
    results = ranks.run(_train_rank, fields, mesh_fields, 0.1, weights,
                        batches)
    for losses, grads, params in results:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, g in grads.items():
            w = want_grads[k].numpy()
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(
                _without_key_bias(k, params[k]),
                _without_key_bias(k, v.numpy()), atol=param_tol, rtol=0,
                err_msg=k)


@pytest.mark.parametrize("case", ["data2_seq2", "moe_data2_model2"])
def test_mesh_steps_match_jax(ranks, case):
    import jax

    from avsum_tpu.models import make_model as jax_make_model
    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh
    from avsum_tpu.train import steps as jax_steps
    from avsum_tpu.train.config import ModelConfig as JaxModelConfig
    from avsum_tpu.train.config import TrainConfig as JaxTrainConfig
    from avsum_torch.convert import scorer_from_flax

    fields, mesh_fields, b, s, _ = CASES[case]
    batches = _batches(b, s)
    jm = jax_make_model(JaxModelConfig(**BASE, dropout=0.0, **fields))
    mesh = build_mesh(JaxMeshConfig(**mesh_fields), jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        state = jax_steps.create_train_state(jm, JaxTrainConfig(**TRAIN),
                                             batches[0], total_steps=20)
        weights = {k: v.numpy() for k, v in
                   scorer_from_flax(jax.device_get(state.params)).items()}
        jstep = jax_steps.make_train_step(jm, mesh, seed=TRAIN["seed"])
        want_losses = []
        for batch in batches:
            state, metrics = jstep(state, jax_steps.shard_batch_dict(batch,
                                                                     mesh))
            want_losses.append(float(metrics["loss"]))
        want = scorer_from_flax(jax.device_get(state.params))
    losses, _, params = ranks.run(_train_rank, fields, mesh_fields, 0.0,
                                  weights, batches)[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    for k, v in want.items():
        np.testing.assert_allclose(_without_key_bias(k, params[k]),
                                   _without_key_bias(k, v.numpy()),
                                   atol=3e-4, rtol=0, err_msg=k)


def _checkpoint_rank(fields, weights, batches, directory, save: bool):
    """Train 2 steps and save at data 2 x model 2, or restore there; ->
    this rank's parameters and Adam moments."""
    mesh = host_cpu_mesh(MeshConfig(model=2))
    model = to_mesh(_model(fields, 0.1, weights), mesh)
    manager = CheckpointManager(directory, mesh=mesh)
    if save:
        state, _, _ = _steps(model, mesh, batches[:2])
        manager.save(state.step, state, {"epoch": 0})
    else:
        state = steps.create_train_state(model, TrainConfig(**TRAIN), 20)
        manager.restore(state)
    opt = state.optimizer.state_dict()
    names = [n for n, _ in model.named_parameters()]
    return (mesh.coords, {k: v.detach().numpy()
                          for k, v in model.state_dict().items()},
            {k: {n: t.numpy() for n, t in zip(names, opt[k])}
             for k in ("mu", "nu")}, opt["count"])


@pytest.mark.parametrize("encoder", ["moe", "staged"])
@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_checkpoint_portability(ranks, tmp_path, encoder, direction):
    fields = MOE if encoder == "moe" else STAGED
    weights = _weights(fields, 0.1)
    batches = _batches(4, 16)
    directory = str(tmp_path / "ckpt")
    one = _model(fields, 0.1, weights)
    if direction == "mesh_to_one":
        results = ranks.run(_checkpoint_rank, fields, weights, batches,
                            directory, True)
        state = steps.create_train_state(one, TrainConfig(**TRAIN), 20)
        assert CheckpointManager(directory).restore(state)[1] == {"epoch": 0}
    else:
        state, _, _ = _steps(one, None, batches[:2])
        CheckpointManager(directory).save(state.step, state, {"epoch": 0})
        results = ranks.run(_checkpoint_rank, fields, weights, batches,
                            directory, False)
    assert CheckpointManager(directory).steps() == [2]
    full = {k: v.numpy() for k, v in one.state_dict().items()}
    names = [n for n, _ in one.named_parameters()]
    opt = state.optimizer.state_dict()
    split = {f"{e}_temporal.blocks.{i}.moe_ffn.{p}"
             for e in ("visual", "audio") for i in range(2)
             for p in ("w1", "b1", "w2", "b2")} if encoder == "moe" else set()
    for coords, params, moments, count in results:
        assert count == 2
        m = coords["model"]
        for k, v in params.items():
            want = full[k]
            if k in split:
                want = np.split(want, 2)[m]
            np.testing.assert_array_equal(v, want, err_msg=k)
        for key in ("mu", "nu"):
            for n, v in moments[key].items():
                want = opt[key][names.index(n)].numpy()
                if n in split:
                    want = np.split(want, 2)[m]
                np.testing.assert_array_equal(v, want, err_msg=n)
