"""The port's Moonlight-16B-A3B decoder encoder (``temporal_encoder:
mla_moe``, ``avsum_torch/models/decoder.py``) against the plain reference
(``tests/reference_decoder.py``) at a small size with seeded random
weights, on the CPU: MLA's output and gradients, the router (biased
choice, unbiased weights, normalization, scale), the four shares of the
experts summing to the uncut layer, padded shots, the whole scorer's
loss and gradients (materialized and through the padded flash path),
``Trainer.fit`` from ``configs/torch/moonlight_hour.yaml`` shrunk, with a
checkpoint saved and restored, and the configuration's sizes at full
width on the meta device.

float32 on both sides; the two compute in different orders (the
reference gathers each expert's tokens, the port sorts the pairs), so
values agree to rtol = atol = 1e-5 and gradients to 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import reference_decoder as ref
from avsum_torch.data.batching import batch_iterator
from avsum_torch.data.synthetic import make_synthetic_videos
from avsum_torch.init import fast_init_
from avsum_torch.models.decoder import (
    DecoderEncoder,
    HeldExperts,
    SparseMoE,
    rope_table,
)
from avsum_torch.models.scorer import AVScorer, make_model, make_temporal
from avsum_torch.ops.attention import (
    FlashAttention,
    attention_plain,
    flash_attention,
)
from avsum_torch.train import steps
from avsum_torch.train.config import ModelConfig, load_config
from avsum_torch.train.trainer import Trainer
from benchmark.drivers.train_decoder import program_leaf_map, program_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "torch", "moonlight_hour.yaml")
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
TINY = ["model.hidden_dim=32", "model.num_heads=2", "model.kv_lora_rank=8",
        "model.qk_nope_head_dim=8", "model.qk_rope_head_dim=4",
        "model.v_head_dim=6", "model.intermediate_size=24",
        "model.moe_intermediate_size=12", "model.n_routed_experts=8",
        "model.num_experts_per_tok=3", "model.moe_experts_held=8",
        "model.temporal_layers=3", "model.visual_dim=10",
        "model.audio_dim=6", "model.scorer_hidden=8"]


def tiny_config(*extra) -> ModelConfig:
    return load_config(YAML, TINY + list(extra)).model


def model_dict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def leaves_and_scorer(cfg: ModelConfig, seed: int = 0):
    """Reference leaves from ``seed`` and the port's scorer holding them."""
    model = model_dict(cfg)
    leaves = ref.init_leaves(model, seed, "cpu")
    scorer = AVScorer(cfg)
    state = scorer.state_dict()
    state.update(program_state(leaves, model))
    scorer.load_state_dict(state)
    return leaves, scorer


def layer_leaves(leaves, prefix: str):
    return {k: v for k, v in leaves.items() if k.startswith(prefix)}


def inputs(b=2, s=9, seed=1, pad=True):
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(b, s, 10, generator=gen)
    a = torch.randn(b, s, 6, generator=gen)
    mask = torch.ones(b, s)
    if pad:
        mask[1, s * 2 // 3:] = 0
    return v * mask[..., None], a * mask[..., None], mask


def test_leaf_map_covers_every_parameter_once():
    cfg = tiny_config()
    scorer = AVScorer(cfg)
    leaves = ref.init_leaves(model_dict(cfg), 0, "cpu")
    mapped = program_leaf_map(model_dict(cfg))
    assert set(mapped) == {n for n, _ in scorer.named_parameters()}
    used = [r for refs, _ in mapped.values() for r in refs]
    assert sorted(used) == sorted(leaves)
    state = program_state(leaves, model_dict(cfg))
    for name, p in scorer.named_parameters():
        assert state[name].shape == p.shape, name


@pytest.mark.parametrize("pad", [False, True])
def test_mla_matches_reference(pad):
    cfg = tiny_config()
    leaves, scorer = leaves_and_scorer(cfg)
    layer = scorer.visual_temporal.layers[1].self_attn
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(3))
    _, _, mask = inputs(pad=pad)
    rope = rope_table(9, 4, cfg.rope_theta, "cpu")
    p = {k: v.clone().requires_grad_(True)
         for k, v in layer_leaves(leaves, "visual_enc.1.").items()}
    xr = x.clone().requires_grad_(True)
    want = ref.mla(xr, mask, p, "visual_enc.1", model_dict(cfg),
                   ref.rope_cos_sin(9, 4, cfg.rope_theta, "cpu"), False)
    xp = x.clone().requires_grad_(True)
    got = layer(xp, mask, rope)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], **VAL)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(4))
    cot = cot * mask[..., None]
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    torch.testing.assert_close(xp.grad, xr.grad, **GRAD)
    for prog, ref_name in (("q_proj", "q"), ("kv_a_proj_with_mqa", "kv_a"),
                           ("kv_b_proj", "kv_b"), ("o_proj", "o")):
        torch.testing.assert_close(getattr(layer, prog).weight.grad,
                                   p[f"visual_enc.1.{ref_name}"].grad, **GRAD)
    torch.testing.assert_close(layer.kv_a_layernorm.weight.grad,
                               p["visual_enc.1.kv_norm.g"].grad, **GRAD)


def test_padded_flash_attention_is_exact_at_latent_widths():
    """Attention at latent attention's own widths, q/k 192 and v 128:
    ``flash_attention`` and its autograd Function (K2's and the fused
    backward's plain versions on the CPU: the LSE saved, delta at Dv, the
    scale Dqk^-1/2) against autograd of the materialized attention, with a
    padded tail, the cotangent zero there as the scorer leaves it."""
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.randn(1, 40, 3, 192, generator=gen) for _ in range(2))
    v = torch.randn(1, 40, 3, 128, generator=gen)
    mask = torch.ones(1, 40)
    mask[0, 31:] = 0
    cot = torch.randn(1, 40, 3, 128, generator=gen) * mask[..., None, None]
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = attention_plain(*qs, mask)
    (want * cot).sum().backward()
    for route in (flash_attention, FlashAttention.apply):
        qp = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = route(*qp, mask)
        assert got.shape == (1, 40, 3, 128)
        torch.testing.assert_close(got, want, **VAL)
        (got * cot).sum().backward()
        for a, b in zip(qp, qs):
            assert a.grad.shape == b.grad.shape
            torch.testing.assert_close(a.grad, b.grad, **GRAD)


def test_router_matches_reference_with_a_correction_bias():
    cfg = tiny_config()
    leaves, scorer = leaves_and_scorer(cfg)
    moe = scorer.audio_temporal.layers[2].mlp
    bias = torch.linspace(-0.3, 0.4, 8)
    moe.gate.e_score_correction_bias.copy_(bias)
    x = torch.randn(30, 32, generator=torch.Generator().manual_seed(6))
    choice, weights = moe.gate(x)
    want_c, want_w = ref.route(x, leaves, "audio_enc.2", model_dict(cfg), bias)
    got = torch.zeros(30, 8).scatter_(1, choice, weights)
    want = torch.zeros(30, 8).scatter_(1, want_c, want_w)
    torch.testing.assert_close(got, want, **VAL)
    # the bias chose, the unbiased scores weigh: sum to the scale
    unbiased = torch.topk(torch.sigmoid(x @ leaves["audio_enc.2.router"].T),
                          3).indices
    assert not torch.equal(unbiased.sort().values, choice.sort().values)
    torch.testing.assert_close(weights.sum(-1), torch.full((30,), 2.446),
                               **VAL)
    scores = torch.sigmoid(x @ leaves["audio_enc.2.router"].T)
    torch.testing.assert_close(
        weights / weights.sum(-1, keepdim=True),
        scores.gather(1, choice) / scores.gather(1, choice).sum(-1, True),
        **VAL)


def test_the_four_expert_shares_sum_to_the_uncut_layer():
    """Each of four chips holds 2 of 8 experts; rank r's share is the
    port's layer holding experts 0-1 after the experts are renumbered so
    that r's block comes first. The shares' routed parts plus the shared
    experts once give the uncut reference layer."""
    cfg = tiny_config()
    model = model_dict(cfg)
    leaves = ref.init_leaves(model, 7, "cpu")
    p = layer_leaves(leaves, "visual_enc.1.")
    bias = torch.linspace(0.2, -0.2, 8)
    x = torch.randn(1, 12, 32, generator=torch.Generator().manual_seed(8))
    mask = torch.ones(1, 12)
    want = ref.moe(x, mask, p, "visual_enc.1", model,
                   bias, None, False)
    shared = ref.swiglu(x.reshape(12, 32), p, "visual_enc.1.shared")
    share_cfg = dataclasses.replace(cfg, moe_experts_held=2)
    total = shared.clone()
    for rank in range(4):
        order = torch.roll(torch.arange(8), -2 * rank)  # r's block first
        layer = SparseMoE(share_cfg)
        with torch.no_grad():
            layer.gate.weight.copy_(p["visual_enc.1.router"][order])
            layer.gate.e_score_correction_bias.copy_(bias[order])
            layer.experts.gate_up.copy_(torch.cat(
                [p["visual_enc.1.experts.gate"][order[:2]],
                 p["visual_enc.1.experts.up"][order[:2]]], dim=1))
            layer.experts.down.copy_(p["visual_enc.1.experts.down"][order[:2]])
            layer.shared_experts.gate_up.weight.copy_(torch.cat(
                [p["visual_enc.1.shared.gate"], p["visual_enc.1.shared.up"]]))
            layer.shared_experts.down.weight.copy_(p["visual_enc.1.shared.down"])
            total += layer(x, mask).reshape(12, 32) - shared
    torch.testing.assert_close(total.view(1, 12, 32), want, **VAL)


def test_dispatch_counts_its_pairs_and_skips_padded_shots():
    cfg = tiny_config("model.moe_experts_held=3")
    _, scorer = leaves_and_scorer(cfg)
    moe = scorer.visual_temporal.layers[1].mlp
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(9))
    _, _, mask = inputs()
    names = ("routed_held", "routed_total", "host_syncs")
    before = {k: getattr(HeldExperts, k) for k in names}
    choice, _ = moe.gate(x.reshape(-1, 32))
    moe(x, mask)
    real = mask.reshape(-1) > 0
    diff = {k: getattr(HeldExperts, k) - before[k] for k in names}
    assert diff == {"routed_held": int((choice[real] < 3).sum()),
                    "routed_total": 3 * int(real.sum()),
                    "host_syncs": 1}


def test_padded_shots_change_nothing_on_real_ones():
    cfg = tiny_config()
    _, scorer = leaves_and_scorer(cfg)
    scorer.eval()
    v, a, mask = inputs()
    noisy_v, noisy_a = v.clone(), a.clone()
    noisy_v[mask == 0] = 5.0
    noisy_a[mask == 0] = -3.0
    with torch.no_grad():
        base = scorer(v, a, mask)
        noisy = scorer(noisy_v, noisy_a, mask)
    assert (base[mask == 0] == 0).all() and (noisy[mask == 0] == 0).all()
    torch.testing.assert_close(noisy, base, **VAL)


@pytest.mark.parametrize("s,pad", [(9, False), (9, True), (512, True)])
def test_scorer_loss_and_gradients_match_reference(s, pad):
    """A train-mode forward (dropout on the modality Linears), the masked
    MSE and every leaf's gradient; at S = 512 the MLA and the fusion
    attention take the padded flash path (its plain version here)."""
    cfg = tiny_config()
    leaves, scorer = leaves_and_scorer(cfg, seed=11)
    model = model_dict(cfg)
    bias = {"visual_enc.2": torch.linspace(-0.2, 0.2, 8)}
    scorer.visual_temporal.layers[2].mlp.gate.e_score_correction_bias.copy_(
        bias["visual_enc.2"])
    v, a, mask = inputs(s=s, pad=pad, seed=12)
    targets = torch.rand(2, s, generator=torch.Generator().manual_seed(13))
    targets = targets * mask
    scorer.train()
    preds = scorer(v, a, mask, generator=steps.dropout_generator(5, 0))
    loss = steps.masked_mse(preds, targets, mask)
    names = [n for n, _ in scorer.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        scorer.parameters()))))
    p = {k: t.clone().requires_grad_(True) for k, t in leaves.items()}
    want = ref.forward(p, model, v, a, mask, ref.step_seeds(5, 0),
                       biases=bias)
    want_loss = ref.masked_mse(want, targets, mask)
    want_grads = torch.autograd.grad(want_loss, list(p.values()))
    torch.testing.assert_close(loss, want_loss, **VAL)
    want_state = program_state(dict(zip(p, want_grads)), model)
    for name in names:
        torch.testing.assert_close(grads[name], want_state[name], **GRAD,
                                   msg=name)


def test_trainer_fits_two_steps_and_restores_its_checkpoint(tmp_path):
    cfg = load_config(YAML, TINY + [
        "model.visual_dim=16", "model.audio_dim=8", "data.max_shots=24",
        "data.batch_videos=2", "train.epochs=1", "train.log_every=1",
        f"train.checkpoint_dir={tmp_path}/ckpt"])
    videos = make_synthetic_videos(4, min_shots=8, max_shots=20,
                                   visual_dim=16, audio_dim=8, seed=0)

    def batches(epoch):
        return batch_iterator(videos, 2, 24, seed=epoch)

    trainer = Trainer(make_model(cfg.model, seed=0), cfg, total_steps=2,
                      device="cpu")
    state = trainer.fit(batches)
    assert state.step == 2
    params = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    fresh = Trainer(make_model(cfg.model, seed=1), cfg, total_steps=2,
                    device="cpu")
    fresh.init_state()
    assert fresh.maybe_restore() == 2
    for name, value in fresh.model.named_parameters():
        torch.testing.assert_close(value.detach(), params[name], rtol=0,
                                   atol=0)
    assert fresh.state.optimizer.count == state.optimizer.count


def test_fast_init_fills_norms_and_experts_by_their_fan_in():
    cfg = tiny_config()
    scorer = make_model(cfg, seed=3)
    layer = scorer.visual_temporal.layers[1]
    assert torch.equal(layer.input_layernorm.weight, torch.ones(32))
    assert torch.equal(scorer.visual_temporal.norm.weight, torch.ones(32))
    experts = layer.mlp.experts
    assert abs(float(experts.gate_up.detach().std()) * 32 ** 0.5 - 1) < 0.15
    assert abs(float(experts.down.detach().std()) * 12 ** 0.5 - 1) < 0.15


def test_the_configuration_builds_at_its_published_widths():
    """configs/torch/moonlight_hour.yaml on the meta device: each modality's
    decoder holds 761 M parameters (the dense layer 83.0 M; an MoE layer
    13.8 M of MLA, 16 experts of 8.65 M, 17.3 M shared, the 64-way
    router), the scorer about 1.60 B."""
    cfg = load_config(YAML)
    with torch.device("meta"):
        encoder = make_temporal(cfg.model, True)
        scorer = AVScorer(cfg.model)

    def count(module):
        return sum(p.numel() for p in module.parameters())

    assert isinstance(encoder, DecoderEncoder)
    dense, moe = encoder.layers[0], encoder.layers[1]
    assert count(dense.self_attn) == 13_763_072
    assert count(dense.mlp) == 3 * 2048 * 11264
    assert count(moe.mlp.experts) == 16 * 3 * 2048 * 1408
    assert count(moe.mlp.shared_experts) == 3 * 2048 * 2816
    assert moe.mlp.gate.weight.shape == (64, 2048)
    assert moe.mlp.gate.top_k == 6
    assert round(count(encoder) / 1e6) == 761
    assert round(count(scorer) / 1e8) == 16
    assert len(encoder.layers) == 5


@pytest.mark.parametrize("axis", ["seq", "model"])
def test_the_decoder_refuses_a_split_mesh(axis):
    class Mesh:
        def size(self, name):
            return 2 if name == axis else 1

    with pytest.raises(ValueError, match="mla_moe"):
        DecoderEncoder(tiny_config(), False, Mesh())


def test_the_scorer_refuses_tensor_parallelism():
    with pytest.raises(ValueError, match="tensor-parallel"):
        AVScorer(tiny_config(), mesh=object(), tensor_parallel=True)


def test_the_encoder_takes_no_dropout_seed():
    """The decoder has no dropout: the generator leaves it unchanged, and
    train mode gives eval mode's output."""
    cfg = tiny_config()
    enc = make_temporal(cfg, False)
    fast_init_(enc, 0)
    x = torch.randn(2, 9, 32)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    enc.train()
    out = enc(x, None, gen)
    assert torch.equal(gen.get_state(), state)
    enc.eval()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  enc(x, None, None).detach().numpy())
