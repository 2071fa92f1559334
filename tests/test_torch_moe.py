"""The port's mixture-of-experts encoder (``avsum_torch/models/moe.py``)
against ``avsum_tpu/models/moe.py``, weights carried by
``avsum_torch.convert``: the gated expert FFN, including a tie at the
k-th probability (the threshold keeps three experts for top-2), the MoE
encoder's values and gradients on a padded mask, two train steps of the
MoE scorer against ``avsum_tpu.train.steps``, and the ``torch.export``
round trip of the MoE scorer with cross fusion at two shot counts.
float32, JAX at "highest" precision, TF32 off: rtol = atol = 1e-5
(the train step's grad norm 1e-4 relative, as in test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.models.moe import MoEEncoder as JaxMoEEncoder
from avsum_tpu.models.moe import MoEFFN as JaxMoEFFN
from avsum_tpu.train import steps as jax_steps
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_tpu.train.config import TrainConfig as JaxTrainConfig
from avsum_torch.convert import (
    moe_encoder_from_flax,
    moe_ffn_from_flax,
    scorer_from_flax,
)
from avsum_torch.models.moe import MoEEncoder, MoEFFN
from avsum_torch.models.scorer import make_model
from avsum_torch.serve.export import export_scorer, load_scorer
from avsum_torch.train import steps
from avsum_torch.train.config import ModelConfig, TrainConfig

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tie", [False, True])
def test_expert_ffn_matches_jax(tie):
    b, s, f, e = 2, 12, 8, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    jm = JaxMoEFFN(f, n_experts=e, top_k=2)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x)["params"])
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    if tie:  # experts 1 and 2 tie for second place on every token
        params["gate"]["kernel"] = np.zeros((f, e), np.float32)
        params["gate"]["bias"] = np.array([1.0, 0.5, 0.5, 0.0], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jm.apply({"params": params}, x))
    ours = MoEFFN(f, n_experts=e, top_k=2)
    ours.load_state_dict(moe_ffn_from_flax(params))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
        kept = (ours.combine_weights(torch.from_numpy(x)) > 0).sum(-1)
    np.testing.assert_allclose(got, ref, **TOL)
    assert (kept == (3 if tie else 2)).all()


def test_moe_encoder_values_and_grads_match_jax():
    b, s, f = 2, 16, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, s - 4:] = 0.0
    cot = rng.standard_normal((b, s, f)).astype(np.float32) / (b * s)
    jm = JaxMoEEncoder(f, num_layers=2, num_heads=2, n_experts=4, top_k=2)
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), x, mask)["params"])
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)

    def apply(p, x_):
        return jm.apply({"params": p}, x_, mask)

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(apply)(params, x))
        g_params, g_x = jax.jit(jax.grad(
            lambda p, x_: jnp.sum(apply(p, x_) * cot), argnums=(0, 1)))(
                params, x)
    ours = MoEEncoder(f, num_layers=2, num_heads=2, n_experts=4, top_k=2)
    ours.load_state_dict(moe_encoder_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = ours(xt, torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **TOL)
    want = moe_encoder_from_flax(jax.device_get(g_params))
    got = {k: p.grad for k, p in ours.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def _without_key_bias(name, value):
    """The key third of a self-attention's qkv bias has a zero exact
    gradient (test_torch_train.py): compared through the outputs."""
    if name.endswith("qkv.bias"):
        q, _, v = value.view(3, -1)
        return torch.cat([q, v])
    return value


def test_moe_scorer_train_steps_match_jax():
    model_fields = dict(visual_dim=48, audio_dim=24, hidden_dim=32,
                        num_heads=2, scorer_hidden=16, dropout=0.0,
                        temporal_encoder="moe", moe_experts=4, moe_topk=2)
    train_fields = dict(lr=3e-3, warmup_steps=1, seed=3)
    rng = np.random.default_rng(7)
    batches = []
    for i in range(2):
        mask = np.ones((2, 24), np.float32)
        mask[0, 24 - 5 - i:] = 0.0
        batches.append({
            "visual": rng.standard_normal((2, 24, 48)).astype(np.float32),
            "audio": rng.standard_normal((2, 24, 24)).astype(np.float32),
            "targets": rng.random((2, 24)).astype(np.float32) * mask,
            "mask": mask})
    jm = jax_make_model(JaxModelConfig(**model_fields))
    tcfg = TrainConfig(**train_fields)
    with jax.default_matmul_precision("highest"):
        state = jax_steps.create_train_state(
            jm, JaxTrainConfig(**train_fields), batches[0], total_steps=20)
        model = make_model(ModelConfig(**model_fields),
                           state_dict=scorer_from_flax(
                               jax.device_get(state.params)))
        jstep = jax_steps.make_train_step(jm, mesh=None, seed=tcfg.seed)
        ours = steps.create_train_state(model, tcfg, total_steps=20)
        tstep = steps.make_train_step(model, seed=tcfg.seed)
        for batch in batches:
            state, jmetrics = jstep(state, batch)
            ours, metrics = tstep(ours, steps.batch_to_device(batch, "cpu"))
            assert float(metrics["loss"]) == pytest.approx(
                float(jmetrics["loss"]), rel=1e-5, abs=1e-5)
            assert float(metrics["grad_norm"]) == pytest.approx(
                float(jmetrics["grad_norm"]), rel=1e-4)
        want = scorer_from_flax(jax.device_get(state.params))
        probe = batches[0]
        ref = np.asarray(jm.apply({"params": state.params}, probe["visual"],
                                  probe["audio"], probe["mask"]))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(_without_key_bias(name, value).numpy(),
                                   _without_key_bias(name, want[name]).numpy(),
                                   err_msg=name, **TOL)
    model.eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(probe[k])
                      for k in ("visual", "audio", "mask")))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_moe_cross_scorer_export_round_trip(tmp_path):
    cfg = ModelConfig(visual_dim=40, audio_dim=24, hidden_dim=32, num_heads=4,
                      scorer_hidden=8, temporal_encoder="moe", moe_experts=4,
                      moe_topk=2, fusion="cross")
    model = make_model(cfg, seed=5)
    path = tmp_path / "moe_cross.pt2"
    path.write_bytes(export_scorer(model, cfg.visual_dim, cfg.audio_dim,
                                   device="cpu"))
    scorer = load_scorer(str(path), "cpu")
    rng = np.random.default_rng(8)
    for b, s in ((1, 40), (2, 96)):
        v = rng.standard_normal((b, s, 40)).astype(np.float32)
        a = rng.standard_normal((b, s, 24)).astype(np.float32)
        m = np.ones((b, s), np.float32)
        m[-1, s - s // 3:] = 0.0
        with torch.no_grad():
            want = model(*(torch.from_numpy(x) for x in (v, a, m)))
        got = scorer(v, a, m)
        assert got.shape == (b, s)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
