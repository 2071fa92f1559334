"""The differentiable flash attention of the port (``avsum_torch.ops.attention``)
against the JAX package, on the CPU: gradients of the port's
``flash_attention`` (its plain route, differentiated by autograd) and of
its ``FlashAttention`` Function (run on CPU tensors, so with the plain
versions of K2, B3 and B4: LSE, delta and the recomputed probabilities
as the kernels use them) against ``jax.grad`` of the JAX
``flash_attention`` through its custom VJP (the B3 / B4 Pallas kernels in
interpret mode, 32 x 32 blocks) and of ``reference_attention``. The
cotangent is zeroed at masked queries, as the scorer's output mask does.
float32 (JAX at "highest" precision); atol = rtol = 1e-4 on gradients,
1e-5 on values.

Also the dispatch of ``model.use_pallas`` to the kernel route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.ops.attention import flash_attention as jax_flash
from avsum_tpu.ops.attention import reference_attention
from avsum_torch.models import attention as mha
from avsum_torch.models.scorer import AVScorer
from avsum_torch.ops.attention import FlashAttention, flash_attention
from avsum_tpu.train.config import ModelConfig

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)

# (b, s, h, d, mask case): unaligned S (70, 200), S >= 512 (520), a
# padded tail, and a fully masked batch row (32-aligned S there: the JAX
# kernel pads S to its block and would average the padded keys into such
# a row's values; the gradients are 0 there either way)
CASES = [
    (1, 70, 2, 128, "tail"),
    (2, 200, 1, 256, "tail"),
    (1, 520, 1, 128, "tail"),
    (1, 520, 1, 256, "none"),
    (2, 64, 2, 128, "all_masked"),
    (2, 96, 1, 256, "all_masked"),
]


def _inputs(b, s, h, d, case):
    rng = np.random.default_rng(s * 7 + d)
    q, k, v, cot = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                    for _ in range(4))
    mask = np.ones((b, s), np.float32)
    if case == "tail":
        mask[0, s - s // 5:] = 0.0
    elif case == "all_masked":
        mask[0, s - 9:] = 0.0
        mask[1] = 0.0
    cot = cot * mask[:, :, None, None]  # zero cotangent at masked queries
    return q, k, v, (None if case == "none" else mask), cot


@pytest.mark.parametrize("b,s,h,d,case", CASES)
def test_flash_attention_grads_match_jax(b, s, h, d, case):
    q, k, v, mask, cot = _inputs(b, s, h, d, case)

    def loss(fn):
        return lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * cot)

    with jax.default_matmul_precision("highest"):
        kernel = loss(lambda q_, k_, v_: jax_flash(
            q_, k_, v_, mask=mask, block_q=32, block_k=32, interpret=True))
        out_ref = np.asarray(reference_attention(q, k, v, mask=mask))
        g_kernel = jax.grad(kernel, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(loss(lambda q_, k_, v_: reference_attention(
            q_, k_, v_, mask=mask)), argnums=(0, 1, 2))(q, k, v)

    m = None if mask is None else torch.from_numpy(mask)
    for route in (flash_attention, FlashAttention.apply):
        t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = route(*t, m)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), out_ref, **VALUE_TOL)
        for name, got, a, r in zip("qkv", t, g_kernel, g_ref):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(a),
                                       err_msg=f"d{name} vs the JAX kernels",
                                       **GRAD_TOL)
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(r),
                                       err_msg=f"d{name} vs the reference",
                                       **GRAD_TOL)
    assert flash_attention.launches == 0


@pytest.mark.parametrize("use_pallas,takes_kernel",
                         [(None, True), (True, True), (False, False)])
@pytest.mark.parametrize("s", [40, 512])
def test_use_pallas_reaches_every_attention(monkeypatch, use_pallas,
                                            takes_kernel, s):
    """``model.use_pallas`` None / True send S >= 512 to the kernel route
    in every self-attention of the scorer, False sends nothing there;
    S < 512 never goes there."""
    calls = []
    real = mha.flash_attention

    def spy(q, k, v, mask=None):
        calls.append(q.shape[-1])
        return real(q, k, v, mask)

    monkeypatch.setattr(mha, "flash_attention", spy)
    cfg = ModelConfig(visual_dim=8, audio_dim=4, hidden_dim=32, num_heads=2,
                      scorer_hidden=8, temporal_layers=2,
                      temporal_encoder="attention", use_pallas=use_pallas)
    model = AVScorer(cfg).eval()
    attns = [m for m in model.modules()
             if isinstance(m, mha.MultiHeadSelfAttention)]
    assert len(attns) == 5
    assert all(m.use_kernel is takes_kernel for m in attns)
    with torch.no_grad():
        model(torch.zeros(1, s, 8), torch.zeros(1, s, 4), torch.ones(1, s))
    expected = [16] * 4 + [32] if takes_kernel and s >= 512 else []
    assert sorted(calls) == sorted(expected)
