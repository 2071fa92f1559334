"""Expert parallelism (``avsum_torch/models/moe.py`` with ``ep_mesh``) on a
world of 4 gloo CPU ranks: model 2 with 4 experts (as data 2 x model 2)
and model 4 with 8, each rank holding E / n experts. The output, the
input's gradient and every parameter's gradient (the gate's whole, the
experts' as the rank's slice) against the dense ``MoEFFN`` in one process;
the output against JAX's ``MoEFFN(ep_mesh=...)`` on the host CPU mesh
with the same weights (``avsum_torch.convert``). 1e-5.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.models.moe import EXPERT_PARAMS, MoEFFN
from avsum_torch.parallel.mesh import (
    AXIS_MODEL,
    MeshConfig,
    host_cpu_mesh,
    shard_tensors,
)
from avsum_torch.parallel.multihost import Ranks

B, S, F = 2, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [(2, 4), (4, 8)]


def _inputs(seed: int = 2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, F)).astype(np.float32)
                 for _ in range(2))


def _weights(e: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ffn = MoEFFN(F, e, top_k=2)
    return {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in ffn.state_dict().items()}


def _run(ffn, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    out = ffn(xt)
    out.backward(torch.from_numpy(cot))
    return (out.detach().numpy(), xt.grad.numpy(),
            {k: p.grad.numpy() for k, p in ffn.named_parameters()})


def _ep_rank(n: int, e: int, weights):
    mesh = host_cpu_mesh(MeshConfig(model=n))
    ffn = MoEFFN(F, e, top_k=2, ep_mesh=mesh)
    assert ffn.w1.shape[0] == e // n
    shapes = {k: tuple(v.shape) for k, v in ffn.state_dict().items()}
    full = {k: torch.from_numpy(v) for k, v in weights.items()}
    ffn.load_state_dict(shard_tensors(full, shapes, EXPERT_PARAMS, mesh))
    return (mesh.index(AXIS_MODEL), *_run(ffn, *_inputs()))


@pytest.fixture(scope="module")
def runs():
    with Ranks(4) as ranks:
        yield {case: ranks.run(_ep_rank, *case, _weights(case[1]))
               for case in CASES}


@pytest.mark.parametrize("n,e", CASES)
def test_expert_parallel_equals_dense(runs, n, e):
    dense = MoEFFN(F, e, top_k=2)
    dense.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _weights(e).items()})
    want_out, want_dx, want_grads = _run(dense, *_inputs())
    per = e // n
    for m, out, dx, grads in runs[(n, e)]:
        np.testing.assert_allclose(out, want_out, **TOL)
        np.testing.assert_allclose(dx, want_dx, **TOL)
        for k, g in grads.items():
            w = want_grads[k]
            if k in EXPERT_PARAMS:
                w = w[m * per:(m + 1) * per]
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)


@pytest.mark.parametrize("n,e", CASES)
def test_expert_parallel_matches_jax(runs, n, e):
    import jax

    from avsum_tpu.models.moe import MoEFFN as JaxMoEFFN
    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh

    x, _ = _inputs()
    w = _weights(e)
    params = {k: w[k] for k in EXPERT_PARAMS}
    params["gate"] = {"kernel": w["gate.weight"].T, "bias": w["gate.bias"]}
    mesh = build_mesh(JaxMeshConfig(model=n), jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxMoEFFN(F, n_experts=e, top_k=2, ep_mesh=mesh)
                          .apply({"params": params}, x))
    for _, out, _, _ in runs[(n, e)]:
        np.testing.assert_allclose(out, want, **TOL)
