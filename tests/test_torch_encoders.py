"""The port's new encoder modules against the Flax ones, weights carried by
``avsum_torch.convert``: the dilated temporal convolutions (dilations 1,
2 and 4 on a padded mask), the staged attention encoder (4 layers in 2
stages against JAX's sequential scan, remat off and on), cross-attention
and the chunked attention; values and the gradients w.r.t. the input
and every parameter. float32, JAX at "highest" precision: rtol = atol =
1e-5.

F7: the fusion attention with ``model.chunk_size`` > 0 in bfloat16. JAX
takes its chunked attention there (float32 probabilities); an inline
softmax that ignores ``chunk_size`` rounds the probabilities to bfloat16.
At the attention's float32 context (bfloat16 q, k, v, chunk 16, S = 40)
that inline path parts from JAX's by 2.2e-3 (context values up to 1.26)
and the chunked path agrees within 3.6e-7: a real difference of math.
At the scorer's output (bfloat16, chunk_size 16, S = 40, Flax's init
weights) it hides under the bfloat16 rounding the two packages do in
different places: max |d| 9.4e-3 (mean 1.8e-3) with the inline path on
the port's side, 8.0e-3 (mean 1.9e-3) with the chunked one, 1.2e-2 with
the inline path on both sides; the scorer test holds either within
``F7_TOL`` and ``F7_MEAN_TOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models import make_model as jax_make_model
from avsum_tpu.models.attention import MultiHeadCrossAttention as JaxCross
from avsum_tpu.models.temporal import PipelinedAttentionEncoder as JaxStaged
from avsum_tpu.models.temporal import TemporalConvEncoder as JaxTCN
from avsum_tpu.ops.chunked import chunked_attention as jax_chunked
from avsum_tpu.train.config import ModelConfig as JaxModelConfig
from avsum_torch.convert import (
    cross_attention_from_flax,
    scorer_from_flax,
    staged_encoder_from_flax,
    tcn_from_flax,
)
from avsum_torch.models import attention as attention_module
from avsum_torch.models.attention import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
)
from avsum_torch.models.scorer import make_model
from avsum_torch.models.temporal import (
    PipelinedAttentionEncoder,
    TemporalConvEncoder,
)
from avsum_torch.ops.attention import attention_plain
from avsum_torch.train.config import ModelConfig

TOL = dict(rtol=1e-5, atol=1e-5)
F7_TOL = 2e-2  # bfloat16 scorer vs JAX: max |d| of the scores
F7_MEAN_TOL = 4e-3  # and mean |d|


def _data(b, s, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, f)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, s - 5:] = 0.0
    cot = rng.standard_normal((b, s, f)).astype(np.float32) / (b * s)
    return x, mask, cot


def _perturbed(params, seed):
    """Move every leaf off Flax's identity init (LayerNorm 1 / 0, zero
    biases) so the test sees each parameter's role."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32)
        for p in leaves])


def _values_and_grads(apply, params, ours, inputs, cot, convert):
    """``apply(params, *inputs)`` (JAX) against ``ours(*inputs)``: the
    output, the gradient w.r.t. the first input and every parameter, for
    the loss sum(out * cot)."""
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(apply)(params, *inputs))
        g_params, g_x = jax.jit(jax.grad(
            lambda p, x: jnp.sum(apply(p, x, *inputs[1:]) * cot),
            argnums=(0, 1)))(params, inputs[0])
    xt = torch.from_numpy(inputs[0]).requires_grad_()
    out = ours(xt, *(torch.from_numpy(a) for a in inputs[1:]))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **TOL)
    want = convert(jax.device_get(g_params))
    got = {k: p.grad for k, p in ours.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_tcn_dilations_1_2_4_on_a_padded_mask():
    b, s, f = 2, 24, 16
    x, mask, cot = _data(b, s, f, seed=1)
    jm = JaxTCN(f, num_layers=3)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), x, mask)["params"], 2)
    ours = TemporalConvEncoder(f, num_layers=3)
    ours.load_state_dict(tcn_from_flax(params))
    assert [c.dilation[0] for c in ours.convs] == [1, 2, 4]
    _values_and_grads(lambda p, x_, m: jm.apply({"params": p}, x_, m),
                      params, ours, (x, mask), cot, tcn_from_flax)
    with torch.no_grad():  # padded rows leak nothing into real ones
        moved = torch.from_numpy(x).clone()
        moved[1, s - 5:] = 100.0
        a = ours(torch.from_numpy(x), torch.from_numpy(mask))
        c = ours(moved, torch.from_numpy(mask))
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_staged_encoder_matches_jax_scan(remat):
    b, s, f = 2, 20, 16
    x, mask, cot = _data(b, s, f, seed=3)
    jm = JaxStaged(f, num_layers=4, n_stages=2, num_heads=2)
    params = _perturbed(jm.init(jax.random.PRNGKey(1), x, mask)["params"], 4)
    assert params["stages"]["layer0"]["Dense_0"]["kernel"].shape[0] == 2
    ours = PipelinedAttentionEncoder(f, num_layers=4, n_stages=2,
                                     num_heads=2, remat=remat)
    ours.load_state_dict(staged_encoder_from_flax(params))
    _values_and_grads(lambda p, x_, m: jm.apply({"params": p}, x_, m),
                      params, ours, (x, mask), cot, staged_encoder_from_flax)


def test_staged_encoder_refuses_uneven_stages():
    with pytest.raises(ValueError, match="equal stages"):
        PipelinedAttentionEncoder(16, num_layers=6, n_stages=4)


def test_cross_attention_matches_jax():
    b, s, e = 2, 18, 16
    x, mask, cot = _data(b, s, e, seed=5)
    y = np.random.default_rng(6).standard_normal((b, s, e)).astype(np.float32)
    jm = JaxCross(e, num_heads=4)
    params = _perturbed(jm.init(jax.random.PRNGKey(2), x, y, mask)["params"],
                        7)
    ours = MultiHeadCrossAttention(e, num_heads=4)
    ours.load_state_dict(cross_attention_from_flax(params))
    _values_and_grads(lambda p, x_, y_, m: jm.apply({"params": p}, x_, y_, m),
                      params, ours, (x, y, mask), cot,
                      cross_attention_from_flax)


@pytest.mark.parametrize("s,chunk", [(40, 16), (37, 512), (64, 32)])
def test_chunked_attention_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, s), np.float32)
    mask[0, s // 3:] = 0.0
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_chunked(q, k, v, mask, chunk_size=chunk))
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                          chunk=chunk)
    assert got.shape == (2, s, 2, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _bf16(*shape, seed):
    """A float32 array of bfloat16-exact values (the inputs a bfloat16
    attention sees)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(torch.from_numpy(x).bfloat16().float())


def test_f7_chunked_context_keeps_float32_probabilities(monkeypatch):
    """The fusion attention's context at bfloat16 q, k, v with chunk_size
    16, S = 40: the port's dispatch reaches its chunked path, which
    equals JAX's (float32 probabilities); the inline path rounds the
    probabilities to bfloat16 and parts from it."""
    q, k, v = (_bf16(2, 40, 4, 8, seed=i) for i in range(3))
    mask = np.ones((2, 40), np.float32)
    mask[1, 31:] = 0.0
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_chunked(jnp.asarray(q, jnp.bfloat16),
                                     jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16), mask,
                                     chunk_size=16))
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mt = torch.from_numpy(mask)
    chunked = attention_plain(qt, kt, vt, mt, chunk=16).numpy()
    inline = attention_plain(qt, kt, vt, mt, torch.bfloat16).numpy()
    np.testing.assert_allclose(chunked, ref, **TOL)
    assert np.abs(inline - ref).max() > 1e-3  # F7

    calls = []

    def counted(*a, chunk=0, **kw):
        calls.append(chunk)
        return attention_plain(*a, chunk=chunk, **kw)

    monkeypatch.setattr(attention_module, "attention_plain", counted)
    mhsa = MultiHeadSelfAttention(32, 4, torch.bfloat16, use_kernel=False,
                                  chunk_size=16).to(torch.bfloat16)
    with torch.no_grad():
        mhsa(torch.from_numpy(_bf16(2, 40, 32, seed=4)), mt)
    assert calls == [16]


def test_f7_bfloat16_chunked_fusion_matches_jax():
    """The whole scorer at bfloat16, chunk_size 16, S = 40, Flax's init
    weights: within ``F7_TOL`` of JAX's scores."""
    fields = dict(hidden_dim=32, num_heads=4, temporal_encoder="attention",
                  visual_dim=48, audio_dim=24, scorer_hidden=16,
                  dtype="bfloat16", chunk_size=16, use_pallas=False)
    rng = np.random.default_rng(40)
    visual = rng.standard_normal((2, 40, 48)).astype(np.float32)
    audio = rng.standard_normal((2, 40, 24)).astype(np.float32)
    mask = np.ones((2, 40), np.float32)
    mask[1, 31:] = 0.0
    jm = jax_make_model(JaxModelConfig(**fields))
    with jax.default_matmul_precision("highest"):
        params = jax.jit(jm.init)(jax.random.PRNGKey(5), visual[:, :8],
                                  audio[:, :8], mask[:, :8])["params"]
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, visual, audio,
                                           mask))
    model = make_model(ModelConfig(**fields),
                       state_dict=scorer_from_flax(params))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (visual, audio, mask)))
    err = np.abs(got.float().numpy() - ref)
    assert err.max() < F7_TOL and err.mean() < F7_MEAN_TOL, (err.max(),
                                                              err.mean())
