"""The GPipe schedule (``avsum_torch/parallel/pipeline.py``) on a world of
4 gloo CPU ranks: model 2 (as data 2 x model 2) and model 4, 2 and 4
microbatches, with and without remat, against the stages applied in turn
in one process (the output and the input's gradient to 1e-6, JAX's
pipeline being exact; every stage's gradients, summed over the
microbatches in another order, to 1e-6 of each tensor's max |g|), and
against JAX's ``pipeline_apply`` of the
same stages on the host CPU mesh (1e-5). A batch that the microbatches do
not divide, and a stage count other than the axis size, raise.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.temporal import StageBlocks
from avsum_torch.parallel.mesh import AXIS_MODEL, MeshConfig, host_cpu_mesh
from avsum_torch.parallel.multihost import Ranks
from avsum_torch.parallel.pipeline import pipeline_apply

B, S, F, HEADS, LAYERS = 4, 8, 16, 2, 2
TOL = dict(rtol=1e-6, atol=1e-6)
CASES = [(2, 2, False), (2, 4, False), (4, 2, False), (4, 4, True)]


class Stack(nn.Module):
    def __init__(self, n_stages: int):
        super().__init__()
        self.stages = nn.ModuleList(StageBlocks(F, HEADS, LAYERS)
                                    for _ in range(n_stages))


def _weights(n_stages: int, seed: int = 0):
    stack = fast_init_(Stack(n_stages), seed)
    with torch.no_grad():  # LayerNorms off their identity init
        for p in stack.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(seed + p.numel())))
    return {k: v.numpy() for k, v in stack.state_dict().items()}


def _inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    x, cot = (rng.standard_normal((B, S, F)).astype(np.float32)
              for _ in range(2))
    mask = np.ones((B, S), np.float32)
    mask[1, 5:] = 0.0
    mask[3, 2:] = 0.0
    return x, mask, cot


def _stack(n_stages: int, weights) -> Stack:
    stack = Stack(n_stages)
    stack.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return stack


def _pipeline_rank(n_stages: int, n_micro: int, remat: bool, weights):
    mesh = host_cpu_mesh(MeshConfig(model=n_stages))
    m = mesh.index(AXIS_MODEL)
    stage = _stack(n_stages, weights).stages[m]
    x, mask, cot = _inputs()
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(stage, xt, mesh, torch.from_numpy(mask),
                         n_stages=n_stages, num_microbatches=n_micro,
                         remat=remat)
    out.backward(torch.from_numpy(cot))
    return (m, out.detach().numpy(), xt.grad.numpy(),
            {k: p.grad.numpy() for k, p in stage.named_parameters()})


def _refusals_rank():
    mesh = host_cpu_mesh(MeshConfig(model=2))
    stage = StageBlocks(F, HEADS, 1)
    x = torch.zeros(3, S, F)
    said = []
    for kwargs in (dict(n_stages=2, num_microbatches=2), dict(n_stages=4)):
        try:
            pipeline_apply(stage, x, mesh, **kwargs)
        except ValueError as e:
            said.append(str(e))
    return said


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4) as r:
        yield r


@pytest.fixture(scope="module")
def sequential():
    """-> n_stages -> (out, dx, per-stage grads) of the stages in turn."""
    def run(n_stages):
        stack = _stack(n_stages, _weights(n_stages))
        x, mask, cot = _inputs()
        xt = torch.from_numpy(x).requires_grad_()
        y = xt
        for stage in stack.stages:
            y = stage(y, torch.from_numpy(mask))
        y.backward(torch.from_numpy(cot))
        return (y.detach().numpy(), xt.grad.numpy(),
                [{k: p.grad.numpy() for k, p in st.named_parameters()}
                 for st in stack.stages])
    return run


@pytest.mark.parametrize("n_stages,n_micro,remat", CASES)
def test_pipeline_equals_stages_in_turn(ranks, sequential, n_stages, n_micro,
                                        remat):
    want_out, want_dx, want_grads = sequential(n_stages)
    results = ranks.run(_pipeline_rank, n_stages, n_micro, remat,
                        _weights(n_stages))
    for m, out, dx, grads in results:
        np.testing.assert_allclose(out, want_out, **TOL)
        np.testing.assert_allclose(dx, want_dx, **TOL)
        assert grads.keys() == want_grads[m].keys()
        for k, g in grads.items():
            w = want_grads[m][k]
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), k


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_matches_jax(ranks, n_stages):
    import jax

    from avsum_tpu.models.temporal import StageBlocks as JaxStageBlocks
    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh
    from avsum_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
    from avsum_tpu.parallel.pipeline import stack_stage_params
    from avsum_torch.convert import staged_encoder_from_flax

    x, mask, _ = _inputs()
    core = JaxStageBlocks(F, HEADS, LAYERS)
    per_stage = [core.init(jax.random.PRNGKey(s), x, mask)["params"]
                 for s in range(n_stages)]
    stacked = stack_stage_params(per_stage)
    mesh = build_mesh(JaxMeshConfig(model=n_stages), jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_pipeline(
            lambda p, xx, mm: core.apply({"params": p}, xx, mm), stacked,
            x, mesh, mask, num_microbatches=2))
    weights = {k: v.numpy() for k, v in staged_encoder_from_flax(
        {"stages": jax.device_get(stacked)}).items()}
    for _, out, _, _ in ranks.run(_pipeline_rank, n_stages, 2, False,
                                  weights):
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_pipeline_refusals(ranks):
    for said in ranks.run(_refusals_rank):
        assert "batch 3 not divisible by 2 microbatches" in said[0]
        assert "4 stages must equal the 'model' mesh axis size 2" in said[1]
