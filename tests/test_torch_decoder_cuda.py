"""The decoder encoder's card paths (``models/decoder.py``) against their
plain versions: MLA's attention through K2 and the fused backward,
zero-padded from q/k 192 and v 128 to 256
(``ops/attention.py::flash_attention_padded``), against the materialized
``attention_plain`` at S >= 512, values and gradients; a whole latent
attention layer at its published widths through the kernels and
materialized; and the sparse dispatch of an MoE layer holding 16 of 64
experts against the reference's held share (``tests/reference_decoder.py``).

Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere. The card machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decoder_cuda.py

float32 with TF32 off. Tolerances as for the kernels
(``test_torch_kernels_cuda.py``): rtol = atol = 1e-5 on attention's
values, 1e-4 on its gradients; the layers, whose products sum 2048 terms
in another order than the reference's, 1e-4 on values.
"""

import dataclasses

import pytest
import torch

import reference_decoder as ref
from avsum_torch.models.decoder import LatentAttention, SparseMoE, rope_table
from avsum_torch.ops.attention import (
    attention_plain,
    flash_attention,
    flash_attention_padded,
)
from avsum_torch.train.config import ModelConfig

pytestmark = pytest.mark.cuda

MOONLIGHT = ModelConfig(hidden_dim=2048, num_heads=16, moe_experts_held=16,
                        temporal_encoder="mla_moe")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("s,real", [(512, 512), (1024, 901), (2049, 2049)])
def test_padded_flash_matches_plain_at_latent_widths(cuda, s, real):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k = (torch.randn(1, s, 16, 192, generator=gen, device=cuda)
            for _ in range(2))
    v = torch.randn(1, s, 16, 128, generator=gen, device=cuda)
    mask = (torch.arange(s, device=cuda) < real).float()[None]
    ours = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_attention.launches,)
    got = flash_attention_padded(*ours, mask)
    assert flash_attention.launches == before[0] + 1
    want = attention_plain(*plain, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    cot = torch.randn(got.shape, generator=gen, device=cuda)
    cot = cot * mask[..., None, None]
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


def test_latent_attention_layer_kernel_against_materialized(cuda):
    torch.manual_seed(0)
    kernel = LatentAttention(MOONLIGHT, use_kernel=True).to(cuda)
    plain = LatentAttention(MOONLIGHT, use_kernel=False).to(cuda)
    plain.load_state_dict(kernel.state_dict())
    s = 1024
    x = torch.randn(1, s, 2048, device=cuda) * 0.5
    mask = (torch.arange(s, device=cuda) < 1000).float()[None]
    rope = rope_table(s, 64, MOONLIGHT.rope_theta, cuda)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    before = flash_attention.launches
    got = kernel(xk, mask, rope)
    assert flash_attention.launches == before + 1
    want = plain(xp, mask, rope)
    real = mask[0].bool()
    torch.testing.assert_close(got[:, real], want[:, real], rtol=1e-4,
                               atol=1e-4)
    cot = torch.randn_like(got) * mask[..., None]
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kernel.q_proj.weight.grad,
                               plain.q_proj.weight.grad, rtol=1e-4, atol=1e-4)


def test_sparse_dispatch_matches_the_reference_share(cuda):
    """16 of 64 experts held, 7168 tokens: the port's sorted dispatch
    against the reference's gather per held expert, values and the
    gradients of the tokens and of the experts."""
    model = dataclasses.asdict(MOONLIGHT)
    torch.manual_seed(1)
    layer = SparseMoE(MOONLIGHT).to(cuda)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=p.shape[-1] ** -0.5)
    bias = torch.linspace(-0.05, 0.05, 64, device=cuda)
    layer.gate.e_score_correction_bias.copy_(bias)
    e = layer.experts
    width = model["moe_intermediate_size"]
    p = {"l.router": layer.gate.weight,
         "l.experts.gate": e.gate_up[:, :width], "l.experts.up": e.gate_up[:, width:],
         "l.experts.down": e.down,
         "l.shared.gate": layer.shared_experts.gate_up.weight[:2 * width],
         "l.shared.up": layer.shared_experts.gate_up.weight[2 * width:],
         "l.shared.down": layer.shared_experts.down.weight}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = torch.randn(1, 7168, 2048, device=cuda)
    mask = torch.ones(1, 7168, device=cuda)
    xo, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = layer(xo, mask)
    want = ref.moe(xr, mask, p, "l", model, bias, None, False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    cot = torch.randn_like(got)
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    torch.testing.assert_close(xo.grad, xr.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(e.down.grad, p["l.experts.down"].grad,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(layer.gate.weight.grad, p["l.router"].grad,
                               rtol=1e-4, atol=1e-4)
