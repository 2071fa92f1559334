"""Ring attention over the shot axis (``avsum_torch/parallel/ring.py``) on
a world of 4 gloo CPU ranks, against the port's plain attention in one
process and JAX's ``ring_attention`` on the host CPU mesh.

seq 2 runs as data 2 x seq 2 (the batch split too), seq 4 as 1 x 4. The
masks: none, padded tails, and a batch row whose keys are all masked (the
uniform average of every key's value, in both packages). Tolerances:
the output 2e-5 (JAX's own, ``tests/test_ring_in_model.py``); dq, dk, dv
1e-5 of each tensor's max |.| against autograd of the plain attention.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.ops.attention import attention_plain
from avsum_torch.parallel.mesh import MeshConfig, block_slices, host_cpu_mesh
from avsum_torch.parallel.multihost import Ranks
from avsum_torch.parallel.ring import ring_attention

B, S, H, D = 2, 16, 2, 8
CASES = [(2, "none"), (2, "padded"), (2, "masked_row"),
         (4, "none"), (4, "padded"), (4, "masked_row")]


def _inputs(masking: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                    for _ in range(4))
    mask = None
    if masking != "none":
        mask = np.ones((B, S), np.float32)
        mask[0, S - 5:] = 0.0
        mask[1, S // 2 + 1:] = 0.0
        if masking == "masked_row":
            mask[1] = 0.0
    return q, k, v, cot, mask


def _ring_rank(seq: int, masking: str):
    """One rank: its blocks through the ring, forward and backward."""
    mesh = host_cpu_mesh(MeshConfig(seq=seq))
    q, k, v, cot, mask = _inputs(masking)
    idx = block_slices(q.shape, mesh.config, mesh.coords)
    qt, kt, vt = (torch.from_numpy(a[idx].copy()).requires_grad_()
                  for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask[idx].copy())
    out = ring_attention(qt, kt, vt, mesh, m)
    out.backward(torch.from_numpy(cot[idx].copy()))
    return (mesh.coords, out.detach().numpy(),
            *(t.grad.numpy() for t in (qt, kt, vt)))


def _assemble(blocks, seq: int):
    """The global [B, S, ...] arrays from the ranks' blocks."""
    cfg = MeshConfig(seq=seq).resolved(4)
    outs = []
    for part in range(1, 5):
        full = np.zeros((B, S, H, D), np.float32)
        for coords, *arrays in blocks:
            full[block_slices(full.shape, cfg, coords)] = arrays[part - 1]
        outs.append(full)
    return outs


@pytest.fixture(scope="module")
def ring_runs():
    with Ranks(4) as ranks:
        yield {case: _assemble(ranks.run(_ring_rank, *case), case[0])
               for case in CASES}


def _plain(masking: str):
    q, k, v, cot, mask = _inputs(masking)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    out = attention_plain(qt, kt, vt, m, torch.float32)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), *(t.grad.numpy() for t in (qt, kt, vt))


@pytest.mark.parametrize("seq,masking", CASES)
def test_ring_forward(ring_runs, seq, masking):
    import jax

    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh
    from avsum_tpu.parallel.ring import ring_attention as jax_ring

    got = ring_runs[(seq, masking)][0]
    want = _plain(masking)[0]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    q, k, v, _, mask = _inputs(masking)
    mesh = build_mesh(JaxMeshConfig(seq=seq), jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax_ring(q, k, v, mesh, mask=mask, batch_axis="data"))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    if masking == "masked_row":  # the uniform average of every key's value
        np.testing.assert_allclose(got[1], np.broadcast_to(
            v[1].mean(0), got[1].shape), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seq,masking", CASES)
def test_ring_grads(ring_runs, seq, masking):
    got = ring_runs[(seq, masking)][1:]
    want = _plain(masking)[1:]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)
