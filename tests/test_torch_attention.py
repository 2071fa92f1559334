"""Kernel K2's modules (avsum_torch.ops.attention, models.attention) against
the JAX package: the plain version and the wrapper vs the Pallas flash
kernel in interpret mode (32 x 32 blocks) and the materialized reference;
the port's MultiHeadSelfAttention vs the JAX module on both sides of the
512-position dispatch threshold. float32; atol = rtol = 1e-5. The route
``models.attention.attend`` takes for each attention module, recorded
through its module's names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models.attention import MultiHeadSelfAttention as JaxMHSA
from avsum_tpu.ops.attention import flash_attention as jax_flash
from avsum_tpu.ops.attention import reference_attention
from avsum_torch.convert import attention_from_flax
from avsum_torch.models import attention as attention_module
from avsum_torch.models.attention import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
)
from avsum_torch.models.decoder import LatentAttention, rope_table
from avsum_torch.ops.attention import attention_plain, flash_attention
from avsum_torch.train.config import ModelConfig

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _mask(b, s, case):
    if case == "none":
        return None
    mask = np.ones((b, s), np.float32)
    if case == "padding":
        mask[:, s - s // 4:] = 0.0
    else:  # "all_masked": batch 1 has no valid key at all
        mask[1] = 0.0
    return mask


# fully masked rows use a 32-aligned S: the JAX kernel pads S to its block
# and would average the padded zero keys into such a row
CASES = [
    (1, 64, 2, 128, "none"),
    (1, 64, 2, 256, "none"),
    (1, 200, 2, 128, "padding"),
    (1, 72, 2, 256, "padding"),
    (2, 64, 2, 128, "all_masked"),
    (2, 64, 1, 256, "all_masked"),
]


@pytest.mark.parametrize("b,s,h,d,mask_case", CASES)
def test_plain_and_wrapper_match_jax_flash(b, s, h, d, mask_case):
    q, k, v = _qkv(b, s, h, d, seed=s + d)
    mask = _mask(b, s, mask_case)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_flash(q, k, v, mask=mask, block_q=32,
                                   block_k=32, interpret=True))
        ref_mat = np.asarray(reference_attention(q, k, v, mask=mask))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    plain = attention_plain(*t, m).numpy()
    before = flash_attention.launches
    wrapped = flash_attention(*t, m).numpy()
    assert flash_attention.launches == before == 0
    assert plain.shape == (b, s, h, d) and plain.dtype == np.float32
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(plain, ref_mat, **TOL)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("s", [40, 520])
def test_mhsa_matches_jax_both_sides_of_threshold(s):
    b, e, h = 2, 64, 2
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, s - 7:] = 0.0
    jm = JaxMHSA(e, h)
    with jax.default_matmul_precision("highest"):
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]),
                         jnp.asarray(mask[:, :8]))["params"]
        ref = np.asarray(jm.apply({"params": params}, x, mask))
    ours = MultiHeadSelfAttention(e, h)
    ours.load_state_dict(attention_from_flax(params))
    with torch.inference_mode():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _self(s, kernel, chunk=0, ring=False, dtype=torch.float32):
    mod = MultiHeadSelfAttention(16, 2, dtype, use_kernel=kernel,
                                 chunk_size=chunk,
                                 ring_mesh="mesh" if ring else None)
    return lambda x, m: mod.to(dtype)(x, m)


def _cross(s, dtype=torch.bfloat16):
    mod = MultiHeadCrossAttention(16, 2, dtype).to(dtype)
    return lambda x, m: mod(x, x.flip(1), m)


def _latent(s, kernel):
    cfg = ModelConfig(hidden_dim=16, num_heads=2, kv_lora_rank=8,
                      qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=6)
    mod = LatentAttention(cfg, kernel)
    rope = rope_table(s, 4, cfg.rope_theta, "cpu")
    return lambda x, m: mod(x, m, rope)


# (case, S, module, the route attend takes: "ring", "kernel", or
# ("plain", chunk, probabilities' dtype))
ROUTES = [
    ("self_ring", 16, lambda s: _self(s, True, 8, ring=True), "ring"),
    ("self_kernel", 512, lambda s: _self(s, True), "kernel"),
    ("self_kernel_over_chunk", 512, lambda s: _self(s, True, 64), "kernel"),
    ("self_short_chunked", 40, lambda s: _self(s, True, 16),
     ("plain", 16, torch.float32)),
    ("self_no_kernel_chunked", 520, lambda s: _self(s, False, 64),
     ("plain", 64, torch.float32)),
    ("self_no_kernel_inline", 520,
     lambda s: _self(s, False, dtype=torch.bfloat16),
     ("plain", 0, torch.bfloat16)),
    ("self_short_inline", 40, lambda s: _self(s, True),
     ("plain", 0, torch.float32)),
    ("latent_short", 40, lambda s: _latent(s, True),
     ("plain", 0, torch.float32)),
    ("latent_kernel", 512, lambda s: _latent(s, True), "kernel"),
    ("latent_no_kernel", 512, lambda s: _latent(s, False),
     ("plain", 0, torch.float32)),
    ("cross", 520, _cross, ("plain", 0, torch.bfloat16)),
]


@pytest.mark.parametrize("case,s,make,route", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_attend_takes_one_route(monkeypatch, case, s, make, route):
    """Each attention module reaches exactly one route of ``attend``: the
    ring before the kernel, the kernel at a concrete S >= 512 before the
    chunked softmax, the chunked softmax (float32 probabilities) before
    the one rounded to the compute dtype."""
    taken = []

    def ring(q, k, v, mesh, mask):
        taken.append("ring")
        return attention_plain(q, k, v, mask)

    def kernel(q, k, v, mask):
        taken.append("kernel")
        return flash_attention(q, k, v, mask)

    def plain(q, k, v, mask, probs_dtype=torch.float32, chunk=0):
        taken.append(("plain", chunk, probs_dtype))
        return attention_plain(q, k, v, mask, probs_dtype, chunk)

    monkeypatch.setattr(attention_module, "ring_attention", ring)
    monkeypatch.setattr(attention_module, "flash_attention", kernel)
    monkeypatch.setattr(attention_module, "attention_plain", plain)
    forward = make(s)
    x = torch.randn(2, s, 16, generator=torch.Generator().manual_seed(s))
    mask = torch.ones(2, s)
    mask[1, s - 5:] = 0
    with torch.no_grad():
        out = forward(x, mask)
    assert out.shape == (2, s, 16)
    assert taken == [route]
