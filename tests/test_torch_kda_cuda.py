"""Kimi Delta Attention's kernel (``csrc/kda.cu``, ``ops/kda.py``) on the
card: the forward and backward passes over chunks against their plain
version (``pass_plain``, the CPU route's arithmetic) on the same inputs,
and the whole chunked op at an hour of shots, [1, 7168, 32, 128], against
the reference's token recurrence (``tests/reference_kimi_linear.py``),
forward and every input gradient; with one TF32 pass in the chunked
products the same comparison fails.

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. The card machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kda_cuda.py

float32 with TF32 off. Tolerances: the kernel against its plain version,
both float32 sums of 64 or 128 products in other orders, 1e-5 of the
largest entry; the chunked op against the recurrence, which sums 7168
steps one by one, 1e-5 of the largest entry forward and 1e-4 for the
gradients (the backward runs the recurrence in reverse through the
reference's checkpointed blocks); one TF32 pass errs ~1e-3.
"""

import pytest
import torch

import reference_kimi_linear as ref
from avsum_torch.ops import kda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("b,h,n,dv", [(2, 3, 5, 64), (1, 32, 112, 128)])
def test_the_passes_match_their_plain_version(cuda, b, h, n, dv):
    gen = torch.Generator(device=cuda).manual_seed(n)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=cuda) * scale

    c, dk = kda.CHUNK, kda.KEY_DIM
    w, kt = rand(b, h, n, c, dk, scale=0.05), rand(b, h, n, c, dk, scale=0.05)
    u0 = rand(b, h, n, c, dv)
    gamma = torch.rand(b, h, n, dk, generator=gen, device=cuda)
    before = kda.kda_fwd.launches, kda.kda_bwd.launches
    states, u = kda.kda_fwd(w, u0, kt, gamma)
    want = kda.pass_plain(w.transpose(-1, -2), kt, u0, gamma, None, 1.0,
                          reverse=False)
    assert gap(states, want[0]) < 1e-5 and gap(u, want[1]) < 1e-5
    d_states, d_u = rand(b, h, n, dk, dv), rand(b, h, n, c, dv)
    d_next, du = kda.kda_bwd(w, kt, gamma, d_states, d_u)
    want = kda.pass_plain(kt.transpose(-1, -2), w, d_u, gamma, d_states,
                          -1.0, reverse=True)
    assert gap(d_next, want[0]) < 1e-5 and gap(du, want[1]) < 1e-5
    assert (kda.kda_fwd.launches, kda.kda_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def hour_inputs(device, s=7168, h=32, d=128):
    gen = torch.Generator(device=device).manual_seed(7)
    q = ref.l2_norm(torch.randn(1, s, h, d, generator=gen, device=device))
    k = ref.l2_norm(torch.randn(1, s, h, d, generator=gen, device=device))
    v = torch.randn(1, s, h, d, generator=gen, device=device)
    # the gates at the layer's init: A in [1, 16], softplus ~ dt in
    # [1e-3, 0.1] beside projections of unit size
    a = 1 + 15 * torch.rand(h, generator=gen, device=device)
    g = -a[:, None] * torch.nn.functional.softplus(
        torch.randn(1, s, h, d, generator=gen, device=device) - 4.0)
    beta = torch.sigmoid(torch.randn(1, s, h, generator=gen, device=device))
    return q * d ** -0.5, k, v, g, beta


def test_the_chunked_op_matches_the_recurrence_at_an_hour(cuda):
    inputs = hour_inputs(cuda)
    mine = [t.clone().requires_grad_(True) for t in inputs]
    before = kda.kda_fwd.launches, kda.kda_bwd.launches
    got = kda.chunk_kda(*mine)
    theirs = [t.clone().requires_grad_(True) for t in inputs]
    want = ref.kda_recurrence(*theirs)
    forward_gap = gap(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator(
        device=cuda).manual_seed(8), device=cuda)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    grads = [gap(a.grad, b.grad) for a, b in zip(mine, theirs)]
    print(f"chunked against the recurrence: forward {forward_gap:.3e}, "
          f"gradients {['%.3e' % x for x in grads]}")
    assert (kda.kda_fwd.launches, kda.kda_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert forward_gap < 1e-5
    assert max(grads) < 1e-4
    # one TF32 pass in the chunk-parallel products fails the same check
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32 = gap(kda.chunk_kda(*inputs), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"one TF32 pass: forward {tf32:.3e}")
    assert tf32 > 1e-5
