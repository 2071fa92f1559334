"""Tensor parallelism over ``model`` (``avsum_torch/parallel/tensor.py``;
``param_partition_spec``, ``state_shardings``, ``shard_state`` and
``make_train_step(..., state_sharding=...)`` in
``avsum_torch/train/steps.py``), on a world of 4 gloo CPU ranks and
against the JAX package's placement on the host CPU mesh.

Placement, against JAX's ``state_shardings`` at model 2 and 4 for the
attention + self-fusion, BiLSTM, MoE + cross-fusion and staged scorers
(and the TCN): every JAX leaf filled with distinct ids and converted by
``avsum_torch.convert``, so each port tensor names its JAX leaf; the
port's decision equals JAX's on that leaf, in JAX's layout (the JAX
shape ``jax_layouts`` gives, ``param_partition_spec``, the stage rule);
a rank's block of a split parameter holds the ids of JAX's shard on the
device of that ``model`` coordinate (the experts under expert parallelism:
the same count, split along the expert axis); a rank's element count equals JAX's per-device
shard size, both as computed and in the scorer the ranks build.

Steps (3, dropout 0.1) against one process on the same padded batches:
the attention scorer at data 2 x model 2 and at seq 2 x model 2 with
padded shots (ring attention under TP), the MoE + cross scorer, the MoE
with 3 experts, the BiLSTM, the TCN and the staged scorer: losses 1e-5 relative, the first
step's gradients gathered to the one-device layout 1e-5 of each
tensor's max |g|, parameters 5e-5 (3e-4 behind the ring), the key third
of each qkv bias (and cross fusion's kv bias) excluded as in
``tests/test_torch_train.py``; the split
parameters still split after the steps. With dropout 0, against JAX's
``make_train_step(model, mesh, state_sharding=state_shardings(...))`` at
data 2 x model 2: losses 1e-4 relative, parameters 5e-4
(``tests/test_model_axis.py``'s bounds).

Checkpoints: trained under TP and restored in one process, and the
reverse, exactly. ``comm.gather_from``'s backward keeps the rank's block
of the cotangent and sums nothing.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.models.scorer import AVScorer
from avsum_torch.parallel.comm import gather_from
from avsum_torch.parallel.mesh import (
    AXIS_MODEL,
    MeshConfig,
    Split,
    gather_tensors,
    host_cpu_mesh,
    pad_batch_for_mesh,
    shard_batch,
)
from avsum_torch.parallel.multihost import Ranks
from avsum_torch.parallel.tensor import STAGES, jax_layouts, one_device
from avsum_torch.train import steps
from avsum_torch.train.checkpoint import CheckpointManager
from avsum_torch.train.config import ModelConfig, TrainConfig

BASE = dict(visual_dim=12, audio_dim=6, hidden_dim=16, num_heads=2,
            scorer_hidden=8)
TRAIN = dict(lr=3e-3, warmup_steps=1, seed=3)
ATTENTION = dict(temporal_encoder="attention")
BILSTM = dict(temporal_encoder="bilstm")
MOE_CROSS = dict(temporal_encoder="moe", moe_experts=4, fusion="cross")
MOE3 = dict(temporal_encoder="moe", moe_experts=3)  # experts not dividing
TCN = dict(temporal_encoder="tcn")


def staged(m: int) -> dict:
    return dict(temporal_encoder="attention", temporal_layers=4, pp_stages=m)


SCORERS = {"attention": lambda m: ATTENTION, "bilstm": lambda m: BILSTM,
           "moe_cross": lambda m: MOE_CROSS, "moe3": lambda m: MOE3,
           "staged": staged, "tcn": lambda m: TCN}
STEP_CASES = {  # name: (model fields, mesh fields, B, S, parameter tol)
    "attention_data2_model2": (ATTENTION, dict(model=2), 4, 16, 5e-5),
    "attention_seq2_model2": (ATTENTION, dict(data=1, seq=2, model=2,
                                              auto_data=False), 2, 14, 3e-4),
    "moe_cross_data2_model2": (MOE_CROSS, dict(model=2), 4, 16, 5e-5),
    "moe3_data2_model2": (MOE3, dict(model=2), 4, 16, 5e-5),
    "bilstm_model4": (BILSTM, dict(model=4), 2, 12, 5e-5),
    "tcn_data2_model2": (TCN, dict(model=2), 4, 16, 5e-5),
    "staged_data2_model2": (staged(2), dict(model=2), 4, 16, 5e-5),
}


def _batches(b: int, s: int, n: int = 3, seed: int = 7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones((b, s), np.float32)
        mask[0, s - 3 - i:] = 0.0
        mask[-1, s // 2:] = 0.0
        out.append({"visual": rng.standard_normal((b, s, 12)).astype(
                        np.float32),
                    "audio": rng.standard_normal((b, s, 6)).astype(np.float32),
                    "targets": rng.random((b, s)).astype(np.float32) * mask,
                    "mask": mask})
    return out


def _config(fields, dropout: float = 0.1) -> ModelConfig:
    return ModelConfig(**BASE, dropout=dropout, **fields)


def _weights(fields, dropout: float, seed: int = 0):
    from avsum_torch.models.scorer import make_model

    model = make_model(_config(fields, dropout), seed)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _model(fields, dropout, weights) -> AVScorer:
    model = AVScorer(_config(fields, dropout))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def _recording(state):
    first, update = [], state.optimizer.step

    def recording(grads, g_norm=None):
        if not first:
            first.extend(g.detach().clone() for g in grads)
        return update(grads, g_norm)

    state.optimizer.step = recording
    return first


def _one_process(fields, dropout, weights, batches):
    model = _model(fields, dropout, weights)
    state = steps.create_train_state(model, TrainConfig(**TRAIN), 20)
    first = _recording(state)
    step = steps.make_train_step(model, seed=TRAIN["seed"])
    losses = [float(step(state, steps.batch_to_device(b, "cpu"))[1]["loss"])
              for b in batches]
    names = [n for n, _ in model.named_parameters()]
    return model, losses, dict(zip(names, first))


def _tp_state(fields, dropout, weights, mesh):
    model = _model(fields, dropout, weights)
    state = steps.create_train_state(model, TrainConfig(**TRAIN), 20)
    return model, steps.shard_state(state, mesh)


def _tp_rank(fields, mesh_fields, dropout, weights, batches):
    """3 TP steps -> (losses, first gradients and parameters in the
    one-device layout, whether every split parameter is still a block)."""
    mesh = host_cpu_mesh(MeshConfig(**mesh_fields))
    model, state = _tp_state(fields, dropout, weights, mesh)
    sharding = steps.state_shardings(model, mesh)
    first = _recording(state)
    step = steps.make_train_step(model, mesh, seed=TRAIN["seed"],
                                 state_sharding=sharding)
    losses = [float(step(state, shard_batch(b, mesh))[1]["loss"])
              for b in batches]
    local = state.model
    split = local.split_names()
    n = mesh.size(AXIS_MODEL)
    full_shapes = {k: v.shape for k, v in model.state_dict().items()}
    still_split = all(
        tuple(p.shape) == place.local_shape(full_shapes[name], n)
        and tuple(p.shape) != tuple(full_shapes[name])
        for name, p in local.named_parameters()
        for place in [sharding[name]] if isinstance(place, Split))
    p_names = [k for k, _ in model.named_parameters()]
    grads = gather_tensors(dict(zip([k for k, _ in local.named_parameters()],
                                    first)), split, mesh, p_names)
    params = gather_tensors(local.state_dict(), split, mesh,
                            list(model.state_dict()))
    return (losses, {k: v.numpy() for k, v in grads.items()},
            {k: v.numpy() for k, v in params.items()}, still_split,
            any(isinstance(v, Split) for v in sharding.values()))


def _count_rank(fields, mesh_fields):
    """-> (model coordinate, the element count of this rank's TP scorer)."""
    mesh = host_cpu_mesh(MeshConfig(**mesh_fields))
    model = AVScorer(_config(fields))
    state = steps.shard_state(
        steps.create_train_state(model, TrainConfig(**TRAIN), 20), mesh)
    return (mesh.index(AXIS_MODEL),
            sum(p.numel() for p in state.model.parameters()),
            sum(t.numel() for t in state.optimizer.mu))


def _without_key_bias(name, value):
    """The bias without its key part, whose exact gradient is zero."""
    if name.endswith("qkv.bias"):
        q, _, v = np.split(value, 3)
        return np.concatenate([q, v])
    if name.endswith(".kv.bias"):  # cross fusion's keys and values
        return np.split(value, 2)[1]
    return value


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4) as r:
        yield r


# ---------------------------------------------------------------------------
# Placement against JAX's state_shardings.
# ---------------------------------------------------------------------------


def _jax_placement(fields, m: int):
    """(JAX's params with distinct ids, their shardings, the mesh, the
    converted state_dict) for the scorer of ``fields`` at model ``m``."""
    import jax

    from avsum_tpu.models import make_model as jax_make_model
    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh
    from avsum_tpu.train import steps as jax_steps
    from avsum_tpu.train.config import ModelConfig as JaxModelConfig
    from avsum_torch.convert import scorer_from_flax

    jm = jax_make_model(JaxModelConfig(**BASE, **fields))
    batch = _batches(2, 8, n=1)[0]
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(0), batch["visual"], batch["audio"],
        batch["mask"])["params"])
    leaves, treedef = jax.tree_util.tree_flatten(params)
    offsets = np.cumsum([0] + [np.size(x) for x in leaves])
    assert offsets[-1] < 2 ** 24  # ids exact in float32
    ids = [np.arange(o, o + np.size(x), dtype=np.float64).reshape(
        np.shape(x)) for o, x in zip(offsets, leaves)]
    mesh = build_mesh(JaxMeshConfig(data=8 // m, seq=1, model=m,
                                    auto_data=False))
    shardings = jax.tree_util.tree_leaves(jax_steps.state_shardings(
        jax.tree_util.tree_unflatten(treedef, ids), mesh))
    sd = {k: v.numpy().astype(np.int64) for k, v in scorer_from_flax(
        jax.tree_util.tree_unflatten(treedef, ids)).items()}
    return ids, shardings, mesh, sd, offsets


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("family", sorted(SCORERS))
def test_placement_matches_jax_state_shardings(family, m):
    from avsum_tpu.train.steps import param_partition_spec as jax_spec

    fields = SCORERS[family](m)
    ids, shardings, mesh, sd, offsets = _jax_placement(fields, m)
    model = AVScorer(_config(fields))
    layouts = jax_layouts(one_device(model))
    placed = steps.state_shardings(model, MeshConfig(model=m))
    assert set(placed) == set(sd) == {n for n, _ in model.named_parameters()}
    by_leaf = {}
    for name, value in sd.items():
        leaf = int(np.searchsorted(offsets, value.flat[0], side="right")) - 1
        by_leaf.setdefault(leaf, []).append(name)
        jax_shape, _ = layouts[name]
        spec = tuple(shardings[leaf].spec)
        if placed[name] == STAGES:
            assert jax_shape == ids[leaf].shape and spec[0] == AXIS_MODEL
            continue
        assert jax_shape == ids[leaf].shape, name
        assert steps.param_partition_spec(jax_shape, m) == tuple(
            jax_spec(ids[leaf], mesh)) == spec, name
        assert (placed[name] is None) == (spec == ()), name
    per_device = {i: 0 for i in range(m)}
    for leaf, names in by_leaf.items():
        index_map = shardings[leaf].devices_indices_map(ids[leaf].shape)
        for i in range(m):
            want = ids[leaf][index_map[mesh.devices[0, 0, i]]].astype(np.int64)
            per_device[i] += want.size
            held = []
            for name in names:
                place = placed[name]
                if place == STAGES:
                    if f".stages.{i}." in name:
                        held.append(sd[name].ravel())
                elif isinstance(place, Split):
                    held.append(place.shard(torch.from_numpy(sd[name]), m,
                                            i).numpy().ravel())
                else:
                    held.append(sd[name].ravel())
            held = np.concatenate(held)
            if placed[names[0]] == Split() and (".moe_ffn.w" in names[0]
                                                or ".moe_ffn.b" in names[0]):
                assert held.size == want.size, names  # the expert axis
            else:
                np.testing.assert_array_equal(np.sort(held),
                                              np.sort(want.ravel()),
                                              err_msg=str(names))
    local = {i: sum(
        (np.prod(p.local_shape(sd[n].shape, m)) if isinstance(p, Split)
         else sd[n].size if p is None or f".stages.{i}." in n else 0)
        for n, p in placed.items()) for i in range(m)}
    assert local == per_device


def test_param_partition_spec_on_test_model_axis_shapes():
    mesh = MeshConfig(data=4, model=2, auto_data=False)
    assert steps.param_partition_spec(np.zeros((48, 32)), mesh) == (
        None, AXIS_MODEL)
    assert steps.param_partition_spec(np.zeros((48, 33)), mesh) == ()
    assert steps.param_partition_spec(np.zeros((32,)), mesh) == ()


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("family", ["attention", "bilstm", "moe_cross",
                                    "moe3", "staged"])
def test_rank_element_count_is_jax_shard_size(ranks, family, m):
    fields = SCORERS[family](m)
    ids, shardings, mesh, _, _ = _jax_placement(fields, m)
    device = mesh.devices[0, 0, 0]
    want = sum(int(np.prod(s.shard_shape(x.shape)))
               for x, s in zip(ids, shardings))
    assert all(s.shard_shape(x.shape) == tuple(
        np.shape(x[s.devices_indices_map(x.shape)[device]]))
        for x, s in zip(ids, shardings))
    results = ranks.run(_count_rank, fields, dict(model=m))
    total = sum(x.size for x in ids)
    assert want < total
    for coord, n_params, n_moments in results:
        assert n_params == n_moments == want, (coord, n_params, want)


# ---------------------------------------------------------------------------
# Steps.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_tp_steps_match_one_process(ranks, case):
    fields, mesh_fields, b, s, param_tol = STEP_CASES[case]
    weights = _weights(fields, 0.1)
    cfg = MeshConfig(**mesh_fields).resolved(4)
    batches = [pad_batch_for_mesh(x, cfg.data, cfg.seq)
               for x in _batches(b, s)]
    model, want_losses, want_grads = _one_process(fields, 0.1, weights,
                                                  batches)
    results = ranks.run(_tp_rank, fields, mesh_fields, 0.1, weights,
                        batches)
    for losses, grads, params, still_split, any_split in results:
        assert still_split and any_split
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, g in grads.items():
            w = want_grads[k].numpy()
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(
                _without_key_bias(k, params[k]),
                _without_key_bias(k, v.numpy()), atol=param_tol, rtol=0,
                err_msg=k)


def test_tp_steps_match_jax(ranks):
    import jax

    from avsum_tpu.models import make_model as jax_make_model
    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh
    from avsum_tpu.train import steps as jax_steps
    from avsum_tpu.train.config import ModelConfig as JaxModelConfig
    from avsum_tpu.train.config import TrainConfig as JaxTrainConfig
    from avsum_torch.convert import scorer_from_flax

    batches = _batches(4, 16)
    jm = jax_make_model(JaxModelConfig(**BASE, dropout=0.0, **ATTENTION))
    mesh = build_mesh(JaxMeshConfig(data=2, seq=1, model=2, auto_data=False),
                      jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        state = jax_steps.create_train_state(jm, JaxTrainConfig(**TRAIN),
                                             batches[0], total_steps=20)
        weights = {k: v.numpy() for k, v in
                   scorer_from_flax(jax.device_get(state.params)).items()}
        state = jax_steps.shard_state(state, mesh)
        jstep = jax_steps.make_train_step(
            jm, mesh, seed=TRAIN["seed"],
            state_sharding=jax_steps.state_shardings(state, mesh))
        want_losses = []
        for batch in batches:
            state, metrics = jstep(state, jax_steps.shard_batch_dict(batch,
                                                                     mesh))
            want_losses.append(float(metrics["loss"]))
        want = scorer_from_flax(jax.device_get(state.params))
    losses, _, params, still_split, _ = ranks.run(
        _tp_rank, ATTENTION, dict(model=2), 0.0, weights, batches)[0]
    assert still_split
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    for k, v in want.items():
        np.testing.assert_allclose(_without_key_bias(k, params[k]),
                                   _without_key_bias(k, v.numpy()),
                                   atol=5e-4, rtol=0, err_msg=k)


def test_step_refuses_a_state_not_placed_by_state_sharding(ranks):
    results = ranks.run(_unplaced_rank)
    assert all("shard_state" in r for r in results)


def _unplaced_rank():
    from avsum_torch.models.scorer import to_mesh

    mesh = host_cpu_mesh(MeshConfig(model=2))
    model = AVScorer(_config(ATTENTION))
    replicated = to_mesh(model, mesh)
    state = steps.create_train_state(replicated, TrainConfig(**TRAIN), 20)
    step = steps.make_train_step(
        replicated, mesh, state_sharding=steps.state_shardings(model, mesh))
    try:
        step(state, shard_batch(_batches(4, 16, n=1)[0], mesh))
    except ValueError as e:
        return str(e)
    return "no error"


# ---------------------------------------------------------------------------
# Checkpoints and the gather's backward.
# ---------------------------------------------------------------------------


def _checkpoint_rank(fields, weights, batches, directory, save: bool):
    mesh = host_cpu_mesh(MeshConfig(model=2))
    model, state = _tp_state(fields, 0.1, weights, mesh)
    manager = CheckpointManager(directory, mesh=mesh)
    if save:
        step = steps.make_train_step(model, mesh, seed=TRAIN["seed"],
                                     state_sharding=steps.state_shardings(
                                         model, mesh))
        for batch in batches[:2]:
            step(state, shard_batch(batch, mesh))
        manager.save(state.step, state, {"epoch": 0})
    else:
        manager.restore(state)
    local = state.model
    opt = state.optimizer.state_dict()
    names = [n for n, _ in local.named_parameters()]
    return (mesh.coords, local.split_names(),
            {k: v.detach().numpy() for k, v in local.state_dict().items()},
            {k: {n: t.numpy() for n, t in zip(names, opt[k])}
             for k in ("mu", "nu")}, opt["count"])


@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_checkpoint_portability(ranks, tmp_path, direction):
    fields = MOE_CROSS
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
        state = steps.create_train_state(one, TrainConfig(**TRAIN), 20)
        step = steps.make_train_step(one, seed=TRAIN["seed"])
        for batch in batches[:2]:
            step(state, steps.batch_to_device(batch, "cpu"))
        CheckpointManager(directory).save(state.step, state, {"epoch": 0})
        results = ranks.run(_checkpoint_rank, fields, weights, batches,
                            directory, False)
    assert CheckpointManager(directory).steps() == [2]
    full = {k: v.detach().numpy() for k, v in one.state_dict().items()}
    names = [n for n, _ in one.named_parameters()]
    opt = state.optimizer.state_dict()
    for coords, split, params, moments, count in results:
        assert count == 2 and len(split) > 8
        m = coords["model"]

        def block(name, value):
            if name not in split:
                return value
            return split[name].shard(torch.from_numpy(value), 2, m).numpy()

        for k, v in params.items():
            np.testing.assert_array_equal(v, block(k, full[k]), err_msg=k)
        for key in ("mu", "nu"):
            for n, v in moments[key].items():
                want = opt[key][names.index(n)].numpy()
                np.testing.assert_array_equal(v, block(n, want), err_msg=n)


def _gather_rank(dim: int):
    mesh = host_cpu_mesh(MeshConfig(model=4))
    i = mesh.index(AXIS_MODEL)
    x = torch.full((2, 3), float(i + 1)).requires_grad_()
    y = gather_from(x, mesh, AXIS_MODEL, dim)
    weight = torch.arange(y.numel(), dtype=torch.float32).view_as(y)
    (y * weight).sum().backward()
    n = x.shape[dim]
    return (y.detach().numpy(), x.grad.numpy(),
            weight.narrow(dim, i * n, n).numpy())


@pytest.mark.parametrize("dim", [0, -1])
def test_gather_from_backward_narrows_without_a_sum(ranks, dim):
    for y, grad, own in ranks.run(_gather_rank, dim):
        blocks = np.split(y, 4, axis=dim)
        assert all((blk == r + 1).all() for r, blk in enumerate(blocks))
        np.testing.assert_array_equal(grad, own)
