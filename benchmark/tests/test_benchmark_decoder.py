"""The decoder scorer's cell on the CPU: the leaf map between the
reference and the port, ``counts_decoder`` against ``FlopCounterMode``
over the whole reference, the readers on a synthetic trace, a tiny cell
through the harness with each of its faults."""

from __future__ import annotations

import copy
import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, counts_decoder, harness
from benchmark.drivers import train_decoder
from benchmark.reference import decoder
from benchmark.tests.conftest import HERE, TRAIN_E2E, add_cell, make_root
from benchmark.trace import DeviceOp, Trace

TINY = {"visual_dim": 10, "audio_dim": 6, "hidden_dim": 32, "num_heads": 2,
        "scorer_hidden": 8, "kv_lora_rank": 8, "qk_nope_head_dim": 8,
        "qk_rope_head_dim": 4, "v_head_dim": 6, "intermediate_size": 24,
        "moe_intermediate_size": 12, "n_routed_experts": 8,
        "num_experts_per_tok": 3, "moe_experts_held": 2, "temporal_layers": 3}
CELL = "moonlight_hour.train_s7168_moe"
LAYER = ["step_mfu_pct.train_moe", "mla_forward_ms.train_moe",
         "moe_forward_ms.train_moe", "flash_fwd_roofline_pct.train_moe",
         "flash_bwd_roofline_pct.train_moe"]


def tiny_model() -> dict:
    config = json.loads((HERE / "configs" / "moonlight_hour.json").read_text())
    return {**config["program"]["model"], **TINY}


def test_the_leaf_map_round_trips():
    from avsum_torch.models.scorer import AVScorer
    from avsum_torch.train.config import load_config

    model = tiny_model()
    leaves = decoder.init_leaves(model, 3, "cpu")
    state = train_decoder.program_state(leaves, model)
    cfg = load_config(None, [f"model.{k}={json.dumps(v)}"
                             for k, v in model.items()])
    names = {n: p.shape for n, p in AVScorer(cfg.model).named_parameters()}
    assert {n: t.shape for n, t in state.items()} == names
    norms = train_decoder.leaf_norms(state, model)
    assert norms == pytest.approx(
        {k: float(v.double().norm()) for k, v in leaves.items()}, rel=1e-12)


@pytest.mark.parametrize("shots", [9, 24])
def test_counts_agree_with_flop_counter_mode(shots):
    """The whole reference, materialized and routed, on the CPU: its
    counted FLOPs are the dense count plus the MLA's and the routed
    pairs' from their shapes."""
    model = tiny_model()
    leaves = {k: v.requires_grad_(True)
              for k, v in decoder.init_leaves(model, 5, "cpu").items()}
    gen = torch.Generator().manual_seed(6)
    visual = torch.randn(1, shots, 10, generator=gen)
    audio = torch.randn(1, shots, 6, generator=gen)
    mask = torch.ones(1, shots)
    routes = []
    with FlopCounterMode(display=False) as counter:
        preds = decoder.forward(leaves, model, visual, audio, mask,
                                routes=routes)
        loss = decoder.masked_mse(preds, torch.zeros_like(preds), mask)
        torch.autograd.grad(loss, list(leaves.values()))
    pairs = sum(int((r < model["moe_experts_held"]).sum()) for r in routes)
    assert len(routes) == 2 * (model["temporal_layers"] - 1) and pairs > 0
    assert counts_decoder.window_flops(model, [shots], pairs) == float(
        counter.get_total_flops())


def test_attention_counts_by_hand():
    f, b = counts_decoder.attention_fwd_counts(2, 10, 3, 6, 4)
    assert f == 2 * 2 * 3 * 10 * 10 * (6 + 4)
    assert b == 4 * (2 * 10 * 3 * (12 + 8) + 2 * 10 + 2 * 3 * 10)
    f, b = counts_decoder.attention_bwd_counts(2, 10, 3, 6, 4)
    assert f == 2 * 2 * 3 * 10 * 10 * (18 + 8)
    assert b == 4 * (2 * 10 * 3 * (24 + 12) + 2 * 10 + 2 * 2 * 3 * 10)
    # at equal widths they are the attention scorer's counts
    assert counts_decoder.attention_fwd_counts(1, 64, 4, 128, 128) == (
        counts.flash_fwd_counts(1, 64, 4, 128))
    assert counts_decoder.attention_bwd_counts(1, 64, 4, 128, 128) == (
        counts.flash_bwd_counts(1, 64, 4, 128))
    model = tiny_model()
    assert counts_decoder.mla_calls(model, 1, 511) == []
    assert counts_decoder.mla_calls(model, 1, 7168) == (
        [(1, 7168, 2, 12, 6)] * 6 + [(1, 7168, 2, 32, 32)])


def _run(model, counts_, device_ops, window_ns):
    cell = types.SimpleNamespace(
        config={"program": {"model": model}},
        traffic={"batches": {"videos": 1, "bucket": 7168}})
    run = types.SimpleNamespace(cell=cell, trace=Trace(
        (0, window_ns), device_ops, []),
        window_result=types.SimpleNamespace(counts=counts_))
    return run


def test_the_readers_on_a_synthetic_trace():
    model = json.loads((HERE / "configs" / "moonlight_hour.json").read_text(
        ))["program"]["model"]
    calls = counts_decoder.mla_calls(model, 1, 7168)
    assert len(calls) == 11
    fwd = [DeviceOp("flash_fwd_kernel", 0, 2_000_000, "kernel", i)
           for i in range(22)]
    run = _run(model, {"steps": 2, "video_shots": [7168, 7168],
                       "moe.routed_held": 21_000}, fwd, 4_000_000_000)
    got = harness.load_module(
        HERE / "metrics" / "flash_fwd_roofline_pct.train_moe.py").read(run)
    bound = 2 * sum(counts.bound_s(*counts_decoder.attention_fwd_counts(*c),
                                   495e12) for c in calls)
    assert got == pytest.approx(100 * bound / (22 * 2e-3))
    # a launch too many: no roofline
    run.trace.device.append(fwd[0])
    assert harness.load_module(
        HERE / "metrics" / "flash_fwd_roofline_pct.train_moe.py").read(run) is None
    mfu = harness.load_module(
        HERE / "metrics" / "step_mfu_pct.train_moe.py").read(run)
    flops = counts_decoder.window_flops(model, [7168, 7168], 21_000)
    assert mfu == pytest.approx(100 * flops / 4.0 / 495e12)
    # the MLA cores at their true widths, forward and twice backward
    assert counts_decoder.mla_step_flops(model, 1, 7168) == (
        3 * 10 * 2 * 16 * 7168 ** 2 * (192 + 128))
    run.window_result.counts.pop("moe.routed_held")
    assert harness.load_module(
        HERE / "metrics" / "step_mfu_pct.train_moe.py").read(run) is None


@pytest.fixture
def moon_root(tmp_path):
    root = make_root(tmp_path)
    config = json.loads((HERE / "configs" / "moonlight_hour.json").read_text())
    config["program"]["model"].update(TINY)
    traffic = {"why": "a test", "driver": "train_decoder",
               "trace_seconds": 0.5,
               "batches": {"videos": 2, "bucket": 12, "shots": [5, 12],
                           "pool": 4}}
    limits = {"loss_gap": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-2,
              "route_miss_share": 0.0}
    add_cell(root, "tinymoon.train_moe", config, traffic, limits, TRAIN_E2E,
             LAYER)
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_on_the_cpu(moon_root, trace):
    found = harness.find_cell("tinymoon.train_moe", root=moon_root)
    result, compared = harness.execute(found, 2 ** 31 + 19, 0.5, trace, "cpu")
    assert result["correct"], compared
    assert result["compared"]["route_miss_share"]["value"] == 0.0
    if trace:
        assert "step_mfu_pct.train_moe" in result["metrics"]
    else:
        assert "train_shots_per_s" in result["metrics"]


def test_the_faults_break_the_check(moon_root):
    found = harness.find_cell("tinymoon.train_moe", root=moon_root)
    run = harness.Run(found, 2 ** 31 + 23, "cpu")
    sound = found.driver.readings(run, "sound")
    assert all(sound[k] <= v for k, v in found.limits.items())
    top5 = found.driver.readings(run, "top5")
    # each real shot keeps k - 1 of the reference's k experts
    assert top5["route_miss_share"] == pytest.approx(1 / 3)
    half = found.driver.readings(run, "half_batch")
    assert half["loss_gap"] > found.limits["loss_gap"]
    control = found.driver.readings(run, "control")  # TF32 is off on the CPU
    assert control == {k: 0.0 for k in control}


def test_the_route_share_counts_every_step_and_only_real_shots():
    """A choice that differs in a later step counts as much as one in the
    first; a padded shot's choice counts in no step."""
    ref = [[torch.tensor([[0, 1], [2, 3], [4, 5]])] for _ in range(3)]
    same = [[r.clone() for r in step] for step in ref]
    masks = [[[1, 1, 0]]] * 3
    assert train_decoder.route_miss_share(same, ref, masks, 6) == 0.0
    later = [[r.clone() for r in step] for step in ref]
    later[2][0][1] = torch.tensor([3, 2])  # the same pair, in another order
    assert train_decoder.route_miss_share(later, ref, masks, 6) == 0.0
    later[2][0][0] = torch.tensor([0, 5])  # step 3 misses one of 12 pairs
    assert train_decoder.route_miss_share(later, ref, masks, 6) == (
        pytest.approx(1 / 12))
    padded = [[r.clone() for r in step] for step in ref]
    padded[1][0][2] = torch.tensor([1, 0])  # the padded shot of step 2
    assert train_decoder.route_miss_share(padded, ref, masks, 6) == 0.0
    with pytest.raises(RuntimeError):
        train_decoder.route_miss_share(same[:2] + [[]], ref, masks, 6)


def test_the_cell_is_declared():
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    found = harness.find_cell(CELL)
    assert found.entry["chips"] == 1
    assert [m["name"] for m in found.end_to_end] == [
        "train_shots_per_s", "setup_s"]
    assert sorted(m["name"] for m in found.per_layer) == sorted(LAYER)
    assert set(found.limits) == {"loss_gap", "grad1_gap", "change_gap",
                                 "route_miss_share"}
    config = copy.deepcopy(found.config)
    assert config["num_hidden_layers"] == 5
    assert config["program"]["model"]["temporal_layers"] == 5
    assert config["moe_experts_held"] == 16 == config["program"]["model"][
        "moe_experts_held"]
    entry = next(c for c in spec["configs"] if c["name"] == "moonlight_hour")
    assert sorted(entry["reduced"]) == sorted(config["reduced"])


def test_replay_takes_the_given_choices_and_keeps_its_own():
    """The reference's MoE layers take another run's choices when given
    them, weighed by their own scores, and still report their own."""
    model = tiny_model()
    leaves = decoder.init_leaves(model, 8, "cpu")
    gen = torch.Generator().manual_seed(9)
    visual = torch.randn(1, 11, 10, generator=gen)
    audio = torch.randn(1, 11, 6, generator=gen)
    mask = torch.ones(1, 11)
    own = []
    base = decoder.forward(leaves, model, visual, audio, mask, routes=own)
    again = []
    same = decoder.forward(leaves, model, visual, audio, mask, routes=again,
                           replay=own)
    assert torch.equal(same, base)
    other = [(r + 1) % model["n_routed_experts"] for r in own]
    mine = []
    moved = decoder.forward(leaves, model, visual, audio, mask, routes=mine,
                            replay=other)
    assert not torch.allclose(moved, base)
    assert torch.equal(mine[0], own[0])  # the first layer's input is unmoved
