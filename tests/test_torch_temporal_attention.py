"""The port's attention encoder against the Flax modules, with converted
params: sinusoidal positions, ``AttentionBlock`` and ``AttentionEncoder``
(remat off and on) on a padded mask, values and the gradients w.r.t. the
input and every parameter in eval mode; and the AVScorer with the
attention encoder on both sides of the 512-position threshold. float32
(JAX at "highest" precision); rtol = atol = 1e-5 on values and
gradients, the loss being the cotangent-weighted mean of the output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.models.temporal import AttentionBlock as JaxBlock
from avsum_tpu.models.temporal import AttentionEncoder as JaxEncoder
from avsum_tpu.models.temporal import sinusoidal_positions as jax_positions
from avsum_tpu.train.config import ModelConfig
from avsum_torch.convert import (
    attention_block_from_flax,
    attention_encoder_from_flax,
    scorer_from_flax,
)
from avsum_torch.models.scorer import make_model
from avsum_torch.models.temporal import (
    AttentionBlock,
    AttentionEncoder,
    sinusoidal_positions,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(b, s, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, s - 5:] = 0.0
    # a mean over positions, as the training loss is, keeps the gradients
    # at the scale training sees
    cot = rng.standard_normal((b, s, f)).astype(np.float32) / (b * s)
    return x, mask, cot


def _perturbed(params, seed):
    """Flax's init leaves LayerNorm at identity and biases at 0; move
    every leaf so the test sees each parameter's role."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32)
        for p in leaves])


def _grads_vs_jax(jax_module, params, ours, x, mask, cot, to_torch_names):
    """Values and grads (input, params) of ``ours`` vs the Flax module."""
    def loss(p, x_):
        return jnp.sum(jax_module.apply({"params": p}, x_, mask) * cot)

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_module.apply({"params": params}, x, mask))
        g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    out = ours(xt, torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **TOL)
    want = to_torch_names(g_params)
    got = {k: p.grad for k, p in ours.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("seq,dim", [(7, 16), (600, 33)])
def test_sinusoidal_positions_match_jax(seq, dim):
    got = sinusoidal_positions(seq, dim).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_positions(seq, dim)),
                               **TOL)
    assert got.shape == (seq, dim)


def test_attention_block_matches_flax():
    b, s, dim, heads = 2, 24, 32, 2
    x, mask, cot = _data(b, s, dim, seed=0)
    jm = JaxBlock(dim, heads)
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(0), x, mask)["params"]
    params = _perturbed(params, 1)
    ours = AttentionBlock(dim, heads)
    ours.load_state_dict(attention_block_from_flax(params))
    _grads_vs_jax(jm, params, ours.eval(), x, mask, cot,
                  attention_block_from_flax)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("s", [24, 520])
def test_attention_encoder_matches_flax(remat, s):
    b, dim, heads = 2, 32, 2
    x, mask, cot = _data(b, s, dim, seed=s)
    jm = JaxEncoder(dim, num_layers=2, num_heads=heads, remat=remat)
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(1), x[:, :8], mask[:, :8])[
            "params"]
    params = _perturbed(params, 2)
    ours = AttentionEncoder(dim, num_layers=2, num_heads=heads, remat=remat)
    ours.load_state_dict(attention_encoder_from_flax(params))
    _grads_vs_jax(jm, params, ours.eval(), x, mask, cot,
                  attention_encoder_from_flax)


@pytest.mark.parametrize("s", [40, 520])
def test_attention_scorer_matches_jax(s):
    cfg = ModelConfig(hidden_dim=32, num_heads=2, visual_dim=48,
                      audio_dim=24, scorer_hidden=16,
                      temporal_encoder="attention")
    rng = np.random.default_rng(s)
    visual = rng.standard_normal((2, s, 48)).astype(np.float32)
    audio = rng.standard_normal((2, s, 24)).astype(np.float32)
    mask = np.ones((2, s), np.float32)
    mask[0, s - 3:] = 0.0
    mask[1, s // 2:] = 0.0
    jm = jax_make_model(cfg)
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(3), visual[:, :8], audio[:, :8],
                         mask[:, :8])["params"]
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, visual, audio,
                                           mask))
    model = make_model(cfg, state_dict=scorer_from_flax(params))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (visual, audio, mask)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert not got.numpy()[mask == 0].any()
