"""Kimi Linear's hybrid decoder in the port (``avsum_torch/ops/kda.py``,
``models/kda.py``, ``models/decoder.py`` with ``model.kda_layers``)
against the plain reference (``tests/reference_kimi_linear.py``) on the
CPU, at small sizes with seeded weights: the chunked op against the token
recurrence, forward and every input gradient (S not a multiple of 64, a
padded tail, decays strong enough that -G leaves float32's range within
a chunk); the pass over chunks' hand-written backward against autograd;
the chunk-parallel parts' plain backward (``parts_bwd_plain``) against
autograd through ``chunk_parts`` in float64, their autograd Function's
CPU route, what it keeps, and the shapes its kernels refuse; the KDA
layer; NoPE latent attention; a two-decoder scorer of KDA, KDA,
MLA layers with MoE (forward, loss, gradients and one training step);
``configs/torch/kimi_linear_hour.yaml`` at its published widths on the
meta device; and ``moonlight_hour``'s modules and parameters, unchanged.

Tolerances. The chunked op computes in float32 against a float64
recurrence: forward and gradients within 1e-6 of the largest entry
(about eight float32 ulps; the chunked sums and the forward
substitution round in other places than the recurrence). The layer and
the scorer, float32 on both sides in different orders (chunks against
tokens, sorted experts against gathered ones): values to rtol = atol =
1e-5, gradients to 1e-4, as ``test_torch_decoder.py``'s.
"""

import dataclasses
import hashlib
import os

import pytest
import torch

import reference_kimi_linear as ref
from avsum_torch.models.decoder import DecoderEncoder, LatentAttention
from avsum_torch.models.kda import KimiDeltaAttention
from avsum_torch.models.scorer import AVScorer, make_model, make_temporal
from avsum_torch.ops import kda
from avsum_torch.parallel.mesh import build_mesh, mesh_config
from avsum_torch.train import steps
from avsum_torch.train.config import load_config
from benchmark.drivers.train_hybrid import program_leaf_map, program_state
from benchmark.reference import decoder as plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "torch", "kimi_linear_hour.yaml")
MOONLIGHT = os.path.join(ROOT, "configs", "torch", "moonlight_hour.yaml")
OP = 1e-6
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
TINY = ["model.hidden_dim=32", "model.num_heads=2", "model.kv_lora_rank=8",
        "model.qk_nope_head_dim=8", "model.qk_rope_head_dim=4",
        "model.v_head_dim=6", "model.intermediate_size=24",
        "model.moe_intermediate_size=12", "model.n_routed_experts=8",
        "model.num_experts_per_tok=3", "model.moe_experts_held=8",
        "model.temporal_layers=3", "model.kda_layers=[1,2]",
        "model.kda_num_heads=2", "model.kda_head_dim=8",
        "model.fusion_heads=4", "model.visual_dim=10", "model.audio_dim=6",
        "model.scorer_hidden=8"]


def tiny_config(*extra):
    return load_config(YAML, TINY + list(extra)).model


def model_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def leaves_and_scorer(cfg, seed: int = 0):
    model = model_dict(cfg)
    leaves = ref.init_leaves(model, seed, "cpu")
    scorer = AVScorer(cfg)
    state = scorer.state_dict()
    state.update(program_state(leaves, model))
    scorer.load_state_dict(state)
    return leaves, scorer


def op_inputs(b, s, h, dk, dv, decay, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = ref.l2_norm(torch.randn(b, s, h, dk, generator=gen)) * dk ** -0.5
    k = ref.l2_norm(torch.randn(b, s, h, dk, generator=gen))
    v = torch.randn(b, s, h, dv, generator=gen)
    g = -decay * torch.nn.functional.softplus(
        torch.randn(b, s, h, dk, generator=gen))
    beta = torch.sigmoid(torch.randn(b, s, h, generator=gen))
    return q, k, v, g, beta


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach().double() - want.detach()).abs().max()
                 / want.detach().abs().max())


@pytest.mark.parametrize("s,decay", [(64, 0.5), (150, 0.01), (150, 3.0),
                                     (131, 30.0)])
def test_the_chunked_op_matches_the_token_recurrence(s, decay):
    """Forward and the gradients of q, k, v, g and beta, against the
    recurrence in float64; at decay 30 a chunk's -G reaches thousands."""
    inputs = op_inputs(2, s, 3, 16, 8, decay)
    mine = [t.clone().requires_grad_(True) for t in inputs]
    theirs = [t.double().requires_grad_(True) for t in inputs]
    got = kda.chunk_kda(*mine)
    want = ref.kda_recurrence(*theirs)
    assert got.dtype == torch.float32 and got.shape == (2, s, 3, 8)
    assert rel(got, want) < OP
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    (got.double() * cot).sum().backward()
    (want * cot).sum().backward()
    for name, a, b in zip("qkvgb", mine, theirs):
        assert rel(a.grad, b.grad) < OP, name


def test_a_padded_tail_changes_nothing_before_it():
    """Shots after the real ones, whatever they hold, leave the real
    shots' outputs and gradients as they are without them."""
    q, k, v, g, beta = op_inputs(1, 100, 2, 16, 8, 1.0)
    junk = op_inputs(1, 40, 2, 16, 8, 5.0, seed=3)
    short = [t.clone().requires_grad_(True) for t in (q, k, v, g, beta)]
    long = [torch.cat([a, b], 1).requires_grad_(True)
            for a, b in zip((q, k, v, g, beta), junk)]
    got_short, got_long = kda.chunk_kda(*short), kda.chunk_kda(*long)
    torch.testing.assert_close(got_long[:, :100], got_short, rtol=0,
                               atol=1e-6)
    cot = torch.randn(1, 100, 2, 8, generator=torch.Generator().manual_seed(2))
    (got_short * cot).sum().backward()
    (got_long[:, :100] * cot).sum().backward()
    for a, b in zip(short, long):
        torch.testing.assert_close(b.grad[:, :100], a.grad, rtol=0,
                                   atol=1e-6)
        assert b.grad[:, 100:].abs().max() == 0


def test_the_pass_over_chunks_has_the_gradient_of_its_plain_loop():
    """The hand-written backward (the reverse pass over dS and the batched
    products after it) against torch's own gradient, in float64."""
    gen = torch.Generator().manual_seed(4)
    shapes = [(1, 2, 3, 64, 8), (1, 2, 3, 64, 4), (1, 2, 3, 64, 8),
              (1, 2, 3, 8)]
    w, u0, kt, gamma = (torch.randn(*s, generator=gen, dtype=torch.float64)
                        * 0.3 for s in shapes)
    args = [t.requires_grad_(True) for t in (w, u0, kt, gamma.abs())]
    assert torch.autograd.gradcheck(kda.StatePass.apply, args)


@pytest.mark.parametrize("s,decay", [(64, 0.5), (150, 1.0), (131, 30.0)])
def test_the_plain_backward_matches_autograd_through_the_parts(s, decay):
    """``parts_bwd_plain`` (the backward kernel's arithmetic) against
    torch's gradient of ``chunk_parts``, both float64, every input: random
    chunks, S not a multiple of 64, and at decay 30 -G in the thousands
    within a chunk."""
    inputs = [t.double() for t in op_inputs(2, s, 3, 16, 8, decay, seed=13)]
    leaves = [t.requires_grad_(True) for t in kda.chunk_inputs(*inputs)]
    outs = kda.chunk_parts(*leaves)
    gen = torch.Generator().manual_seed(14)
    grads = [torch.randn(t.shape, generator=gen, dtype=torch.float64)
             for t in outs]
    want = torch.autograd.grad(outs, leaves, grads)
    got = kda.parts_bwd_plain(*(t.detach() for t in leaves), *grads)
    for name, a, b in zip("qkvgb", got, want):
        assert a.shape == b.shape and rel(a, b) < 1e-12, name


def test_the_chunk_parts_function_keeps_the_plain_route():
    """On the CPU ``ChunkParts`` gives ``chunk_parts``' outputs, bit for
    bit, and autograd's gradients through it."""
    inputs = op_inputs(1, 150, 2, 16, 8, 3.0, seed=15)
    mine = [t.clone().requires_grad_(True) for t in inputs]
    theirs = [t.clone().requires_grad_(True) for t in inputs]
    got = kda.ChunkParts.apply(*mine)
    want = kda.chunk_parts(*kda.chunk_inputs(*theirs))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(16)
    grads = [torch.randn(t.shape, generator=gen) for t in want]
    torch.autograd.backward(got, grads)
    torch.autograd.backward(want, grads)
    for name, a, b in zip("qkvgb", mine, theirs):
        assert a.grad.shape == b.grad.shape and rel(a.grad, b.grad) < 1e-6, (
            name)


def test_the_chunk_parts_keep_only_their_inputs():
    """Autograd keeps the five inputs of the chunk-parallel parts and
    nothing they compute (no decay ratios, no A_kk)."""
    inputs = [t.requires_grad_(True)
              for t in op_inputs(1, 150, 2, 16, 8, 1.0, seed=17)]
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        kda.ChunkParts.apply(*inputs)
    assert [t.data_ptr() for t in saved] == [t.data_ptr() for t in inputs]


@pytest.mark.parametrize("dk,dv", [(64, 128), (128, 48), (128, 256)])
def test_the_chunk_kernels_refuse_what_they_do_not_take(dk, dv):
    """Keys of 128 and values a multiple of 32 up to 128, else a
    ValueError before any launch."""
    q, k, v, g = (torch.zeros(1, 70, 2, w) for w in (dk, dk, dv, dk))
    with pytest.raises(ValueError):
        kda._intra_args(q, k, v, g, torch.zeros(1, 70, 2))


def test_the_kda_layer_matches_the_reference():
    cfg = tiny_config()
    leaves, scorer = leaves_and_scorer(cfg, seed=5)
    layer = scorer.visual_temporal.layers[1].self_attn
    assert isinstance(layer, KimiDeltaAttention)
    x = torch.randn(2, 70, 32, generator=torch.Generator().manual_seed(6))
    p = {k: v.clone().requires_grad_(True) for k, v in leaves.items()
         if k.startswith("visual_enc.1.")}
    xr, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want = ref.kda(xr, p, "visual_enc.1", model_dict(cfg))
    got = layer(xp)
    torch.testing.assert_close(got, want, **VAL)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(7))
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    torch.testing.assert_close(xp.grad, xr.grad, **GRAD)
    for name, leaf in (("q_proj.weight", "q"), ("k_conv1d.weight", "k_conv"),
                       ("f_b_proj.weight", "f_b"), ("A_log", "A_log"),
                       ("dt_bias", "dt_bias"), ("b_proj.weight", "b"),
                       ("g_b_proj.bias", "g_b.b"),
                       ("o_norm.weight", "o_norm.g"),
                       ("o_proj.weight", "o")):
        got_grad = layer.get_parameter(name).grad
        torch.testing.assert_close(got_grad, p[f"visual_enc.1.{leaf}"].grad,
                                   **GRAD, msg=name)


def test_nope_latent_attention_matches_the_reference():
    """MLA without rotary positions: the reference's ``mla`` at cos = 1,
    sin = 0 (a permutation of the rope columns of q and k alike)."""
    cfg = tiny_config()
    leaves, scorer = leaves_and_scorer(cfg, seed=8)
    layer = scorer.audio_temporal.layers[2].self_attn
    assert isinstance(layer, LatentAttention)
    assert not scorer.audio_temporal.uses_rope
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(9))
    mask = torch.ones(2, 9)
    mask[1, 6:] = 0
    got = layer(x, mask, None)
    want = plain.mla(x, mask, leaves, "audio_enc.2", model_dict(cfg),
                     (torch.ones(9, 4), torch.zeros(9, 4)), False)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], **VAL)
    # rotated, the scores differ
    rotated = layer(x, mask, plain.rope_cos_sin(9, 4, 10000.0, "cpu"))
    assert not torch.allclose(rotated[real], want[real], **VAL)


@pytest.mark.parametrize("s,pad", [(9, False), (70, True)])
def test_the_scorer_matches_the_reference(s, pad):
    """A train-mode forward (dropout on the modality Linears), the masked
    MSE and every leaf's gradient, then one AdamW step of the port's
    train step against the reference's."""
    cfg = tiny_config()
    leaves, scorer = leaves_and_scorer(cfg, seed=11)
    model = model_dict(cfg)
    gen = torch.Generator().manual_seed(12)
    v = torch.randn(2, s, 10, generator=gen)
    a = torch.randn(2, s, 6, generator=gen)
    mask = torch.ones(2, s)
    if pad:
        mask[1, s * 2 // 3:] = 0
    v, a = v * mask[..., None], a * mask[..., None]
    targets = torch.rand(2, s, generator=gen) * mask
    scorer.train()
    preds = scorer(v, a, mask, generator=steps.dropout_generator(5, 0))
    loss = steps.masked_mse(preds, targets, mask)
    names = [n for n, _ in scorer.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        scorer.parameters()))))
    p = {k: t.clone().requires_grad_(True) for k, t in leaves.items()}
    want = ref.forward(p, model, v, a, mask, ref.step_seeds(5, 0))
    want_loss = ref.masked_mse(want, targets, mask)
    want_grads = torch.autograd.grad(want_loss, list(p.values()))
    torch.testing.assert_close(loss, want_loss, **VAL)
    want_state = program_state(dict(zip(p, want_grads)), model)
    for name in names:
        torch.testing.assert_close(grads[name], want_state[name], **GRAD,
                                   msg=name)
    # one step of each: the parameters after it
    batch = {"visual": v.numpy(), "audio": a.numpy(),
             "targets": targets.numpy(), "mask": mask.numpy()}
    full = load_config(YAML, TINY)
    train = full.train
    mesh = build_mesh(mesh_config(full.mesh), "cpu")
    state = steps.create_train_state(scorer, train, total_steps=10)
    step = steps.make_train_step(scorer, mesh, 5)
    state, _ = step(state, steps.shard_batch_dict(batch, mesh))
    after = dict(ref.init_leaves(model, 11, "cpu"))
    ref.train_steps(after, model, dataclasses.asdict(train), 10,
                    [{k: torch.as_tensor(x) for k, x in batch.items()}], 5)
    want_state = program_state(after, model)
    for name, value in zip(names, state.optimizer.params):
        torch.testing.assert_close(value.detach(), want_state[name], **GRAD,
                                   msg=name)


def test_the_leaf_map_covers_every_parameter_once():
    cfg = tiny_config()
    scorer = AVScorer(cfg)
    leaves = ref.init_leaves(model_dict(cfg), 0, "cpu")
    mapped = program_leaf_map(model_dict(cfg))
    assert set(mapped) == {n for n, _ in scorer.named_parameters()}
    assert sorted(r for refs, _ in mapped.values() for r in refs) == sorted(
        leaves)


def test_fast_init_draws_the_gates_by_their_rule():
    cfg = tiny_config("model.kda_num_heads=64")
    layer = make_model(cfg, seed=3).visual_temporal.layers[0].self_attn
    a = layer.A_log.detach().exp()
    assert a.min() >= 1.0 and a.max() <= 16.0 and a.std() > 2.0
    dt = torch.nn.functional.softplus(layer.dt_bias.detach())
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    assert layer.g_b_proj.bias.abs().max() == 0


def test_the_configuration_builds_at_its_published_widths():
    """configs/torch/kimi_linear_hour.yaml on the meta device: layers 1-5
    (KDA + the dense SwiGLU of 9216, KDA, KDA, MLA, KDA); a KDA layer
    39.5 M, the MLA 29.1 M, an MoE layer 16 experts of 7.08 M, one shared
    expert and the 256-way router; each decoder 734.6 M, the scorer
    1.56 B; the fusion at 18 heads of 256."""
    cfg = load_config(YAML)
    with torch.device("meta"):
        encoder = make_temporal(cfg.model, True)
        scorer = AVScorer(cfg.model)

    def count(module):
        return sum(p.numel() for p in module.parameters())

    assert isinstance(encoder, DecoderEncoder) and not encoder.uses_rope
    kinds = [type(layer.self_attn) for layer in encoder.layers]
    assert kinds == [KimiDeltaAttention] * 3 + [LatentAttention,
                                                KimiDeltaAttention]
    assert count(encoder.layers[0].self_attn) == 39_518_368
    assert count(encoder.layers[3].self_attn) == 29_114_880
    moe = encoder.layers[1].mlp
    assert count(moe.experts) == 16 * 3 * 2304 * 1024
    assert count(moe.shared_experts) == 3 * 2304 * 1024
    assert moe.gate.weight.shape == (256, 2304) and moe.gate.top_k == 8
    assert count(encoder.layers[0].mlp) == 3 * 2304 * 9216
    assert count(encoder) == 734_570_368
    assert round(count(scorer) / 1e7) == 156
    assert scorer.cross_attention.num_heads == 18


def _signature(path: str) -> str:
    """A hash of the scorer's modules (by type) and parameters (by name
    and shape) that the YAML builds on the meta device."""
    cfg = load_config(path)
    with torch.device("meta"):
        scorer = AVScorer(cfg.model)
    text = "\n".join([f"{n} {type(m).__name__}"
                      for n, m in scorer.named_modules()]
                     + [f"{n} {tuple(p.shape)}"
                        for n, p in scorer.named_parameters()])
    return hashlib.sha256(text.encode()).hexdigest()


def test_moonlight_builds_what_it_built_before():
    """``moonlight_hour``'s modules and parameters are those the port built
    before the hybrid decoder came (the hash taken at that commit), and
    its latent attention still rotates."""
    assert _signature(MOONLIGHT) == (
        "5402a10d5301a79e93d350bcb06f2840bd875c5604a9a142c4c0a2ae3416a372")
    with torch.device("meta"):
        encoder = make_temporal(load_config(MOONLIGHT).model, True)
    assert encoder.uses_rope
