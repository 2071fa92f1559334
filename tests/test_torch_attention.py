"""Kernel K2's modules (avsum_torch.ops.attention, models.attention) against
the JAX package: the plain version and the wrapper vs the Pallas flash
kernel in interpret mode (32 x 32 blocks) and the materialized reference;
the port's MultiHeadSelfAttention vs the JAX module on both sides of the
512-position dispatch threshold. float32; atol = rtol = 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsum_tpu.models.attention import MultiHeadSelfAttention as JaxMHSA
from avsum_tpu.ops.attention import flash_attention as jax_flash
from avsum_tpu.ops.attention import reference_attention
from avsum_torch.convert import attention_from_flax
from avsum_torch.models.attention import MultiHeadSelfAttention
from avsum_torch.ops.attention import attention_plain, flash_attention

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
