"""The hybrid decoder's cell on the CPU: the cell and its files,
``counts_kda`` against hand-reckoned values and against ``FlopCounterMode``
over the whole reference, the readers on a synthetic trace, and a tiny
cell through the harness, sound and with each fault."""

from __future__ import annotations

import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts_decoder, counts_kda, harness
from benchmark.reference import kimi_linear
from benchmark.tests.conftest import HERE, TRAIN_E2E, add_cell, make_root
from benchmark.trace import DeviceOp, Trace

TINY = {"visual_dim": 10, "audio_dim": 6, "hidden_dim": 32, "num_heads": 2,
        "fusion_heads": 4, "scorer_hidden": 8, "kv_lora_rank": 8,
        "qk_nope_head_dim": 8, "qk_rope_head_dim": 4, "v_head_dim": 6,
        "intermediate_size": 24, "moe_intermediate_size": 12,
        "n_routed_experts": 8, "num_experts_per_tok": 3,
        "moe_experts_held": 2, "temporal_layers": 3, "kda_layers": [1, 2],
        "kda_num_heads": 2, "kda_head_dim": 8}
CELL = "kimi_linear_hour.train_s7168_kda"
LAYER = ["kda_forward_ms.train_kda", "kda_fwd_roofline_pct.train_kda",
         "kda_bwd_roofline_pct.train_kda", "step_mfu_pct.train_kda"]
CHECKED = {"loss_gap", "grad1_gap", "change_gap", "route_miss_share",
           "kda_out_gap"}


def full_model() -> dict:
    return json.loads((HERE / "configs" / "kimi_linear_hour.json"
                       ).read_text())["program"]["model"]


def tiny_model() -> dict:
    return {**full_model(), **TINY}


def test_the_cell_is_declared():
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    found = harness.find_cell(CELL)
    assert found.entry["chips"] == 1
    assert found.traffic["driver"] == "train_hybrid"
    assert [m["name"] for m in found.end_to_end] == [
        "train_shots_per_s", "setup_s"]
    assert sorted(m["name"] for m in found.per_layer) == sorted(LAYER)
    assert set(found.limits) == CHECKED
    config = found.config
    catalog = {"hidden_size": 2304, "num_attention_heads": 32,
               "intermediate_size": 9216, "moe_intermediate_size": 1024,
               "num_experts": 256, "num_experts_per_token": 8,
               "num_shared_experts": 1, "kv_lora_rank": 512,
               "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
               "v_head_dim": 128, "mla_use_nope": True}
    assert {k: config[k] for k in catalog} == catalog
    assert config["linear_attn_config"]["kda_layers"][:4] == [1, 2, 3, 5]
    assert config["num_hidden_layers"] == 5 and config["moe_experts_held"] == 16
    model = config["program"]["model"]
    assert model["kda_layers"] == [1, 2, 3, 5]
    assert model["temporal_layers"] == 5 and model["moe_experts_held"] == 16
    assert 2 * model["hidden_dim"] // model["fusion_heads"] == 256
    entry = next(c for c in spec["configs"] if c["name"] == "kimi_linear_hour")
    assert sorted(entry["reduced"]) == sorted(config["reduced"])


def test_the_pass_counts_by_hand():
    """Two heads of 100 shots: two chunks each (the second padded), four
    in all."""
    f, b = counts_kda.pass_fwd_counts(1, 100, 2, 16, 8)
    assert f == 4 * 4 * 64 * 16 * 8
    assert b == 4 * 4 * (2 * 64 * 16 + 64 * 8 + 16 + 16 * 8 + 64 * 8)
    f2, b2 = counts_kda.pass_bwd_counts(1, 100, 2, 16, 8)
    assert f2 == f and b2 == b + 4 * 4 * 16 * 8
    assert counts_kda.kda_core_flops(1, 100, 2, 16, 8) == 4 * (
        4 * 64 * 64 * 16 + 64 * 64 * 24 + 6 * 64 * 16 * 8 + 2 * 64 * 64 * 8)
    model = full_model()
    assert counts_kda.kda_calls(model, 1, 7168) == [(1, 7168, 32, 128, 128)] * 8
    # the hour's cores: 112 chunks of 32 heads, a forward of ~37.6 GFLOP
    # a KDA layer
    one = counts_kda.kda_core_flops(1, 7168, 32, 128, 128)
    assert one == 112 * 32 * (4 * 64 * 64 * 128 + 64 * 64 * 256
                              + 6 * 64 * 128 * 128 + 2 * 64 * 64 * 128)
    mla = counts_decoder.attention_fwd_counts(1, 7168, 32, 192, 128)[0]
    assert counts_kda.core_step_flops(model, 1, 7168) == 3 * (
        8 * one + 2 * mla)


@pytest.mark.parametrize("shots", [9, 60])
def test_the_step_count_agrees_with_flop_counter_mode(shots):
    """The reference with its recurrence's products counted by
    ``FlopCounterMode`` differs from the window's count by the chunked
    core alone: the dense parts, latent attention's cores and the routed
    pairs are counted alike."""
    model = tiny_model()
    leaves = {k: v.requires_grad_(True)
              for k, v in kimi_linear.init_leaves(model, 5, "cpu").items()}
    gen = torch.Generator().manual_seed(6)
    visual = torch.randn(1, shots, 10, generator=gen)
    audio = torch.randn(1, shots, 6, generator=gen)
    mask = torch.ones(1, shots)
    routes = []
    with FlopCounterMode(display=False) as counter:
        preds = kimi_linear.forward(leaves, model, visual, audio, mask,
                                    routes=routes)
        loss = kimi_linear.masked_mse(preds, torch.zeros_like(preds), mask)
        torch.autograd.grad(loss, list(leaves.values()))
    pairs = sum(int((r < model["moe_experts_held"]).sum()) for r in routes)
    # the recurrence's einsums, k^T S and q^T S (2 K V each) a token a
    # head in every KDA layer of both decoders, forward and twice that
    # backward (no block is checkpointed at 64 shots or fewer)
    h, d = model["kda_num_heads"], model["kda_head_dim"]
    layers = 2 * counts_kda.kda_layers(model)
    recurrence = 3 * layers * shots * h * 4 * d * d
    kda_cores = 3 * layers * counts_kda.kda_core_flops(1, shots, h, d, d)
    got = counts_kda.window_flops(model, [shots], pairs)
    assert got - kda_cores + recurrence == float(counter.get_total_flops())


def _run(model, counts_, device_ops, window_ns):
    cell = types.SimpleNamespace(
        config={"program": {"model": model}},
        traffic={"batches": {"videos": 1, "bucket": 7168}})
    return types.SimpleNamespace(cell=cell, trace=Trace(
        (0, window_ns), device_ops, []),
        window_result=types.SimpleNamespace(counts=counts_))


def test_the_readers_on_a_synthetic_trace():
    model = full_model()
    fwd = [DeviceOp("(anonymous namespace)::kda_fwd_kernel(float const*)", 0,
                    700_000, "kernel", i) for i in range(16)]
    run = _run(model, {"steps": 2, "video_shots": [7168, 7168],
                       "moe.routed_held": 7_000}, fwd, 3_000_000_000)
    reader = harness.load_module(
        HERE / "metrics" / "kda_fwd_roofline_pct.train_kda.py")
    got = reader.read(run)
    flops, nbytes = counts_kda.pass_fwd_counts(1, 7168, 32, 128, 128)
    bound = 16 * max(flops / 495e12, nbytes / 3.35e12)
    assert got == pytest.approx(100 * bound / (16 * 7e-4))
    assert 0 < got < 100
    run.trace.device.append(fwd[0])  # a launch too many: no roofline
    assert reader.read(run) is None
    assert harness.load_module(
        HERE / "metrics" / "kda_bwd_roofline_pct.train_kda.py").read(
            run) is None
    mfu = harness.load_module(
        HERE / "metrics" / "step_mfu_pct.train_kda.py").read(run)
    flops = counts_kda.window_flops(model, [7168, 7168], 7_000)
    assert mfu == pytest.approx(100 * flops / 3.0 / 495e12)
    run.window_result.counts.pop("moe.routed_held")
    assert harness.load_module(
        HERE / "metrics" / "step_mfu_pct.train_kda.py").read(run) is None


@pytest.fixture
def kimi_root(tmp_path):
    root = make_root(tmp_path)
    config = json.loads((HERE / "configs" / "kimi_linear_hour.json"
                         ).read_text())
    config["program"]["model"].update(TINY)
    traffic = {"why": "a test", "driver": "train_hybrid",
               "trace_seconds": 0.5,
               "batches": {"videos": 2, "bucket": 70, "shots": [30, 70],
                           "pool": 4}}
    limits = {"loss_gap": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-2,
              "route_miss_share": 0.0, "kda_out_gap": 1e-5}
    add_cell(root, "tinykimi.train_kda", config, traffic, limits, TRAIN_E2E,
             LAYER)
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_on_the_cpu(kimi_root, trace):
    found = harness.find_cell("tinykimi.train_kda", root=kimi_root)
    result, compared = harness.execute(found, 2 ** 31 + 29, 0.5, trace, "cpu")
    assert result["correct"], compared
    assert set(result["compared"]) == CHECKED
    if trace:
        assert "step_mfu_pct.train_kda" in result["metrics"]
    else:
        assert "train_shots_per_s" in result["metrics"]


@pytest.mark.parametrize("mode", ["no_decay", "no_delta", "noncausal_conv",
                                  "unnormalized_qk", "half_batch",
                                  "top_k_less"])
def test_each_fault_breaks_the_check(kimi_root, mode):
    found = harness.find_cell("tinykimi.train_kda", root=kimi_root)
    run = harness.Run(found, 2 ** 31 + 31, "cpu")
    got = found.driver.readings(run, mode)
    assert set(got) == CHECKED
    assert any(got[k] > v for k, v in found.limits.items()), got


def test_the_sound_run_and_the_control_pass_on_the_cpu(kimi_root):
    found = harness.find_cell("tinykimi.train_kda", root=kimi_root)
    run = harness.Run(found, 2 ** 31 + 37, "cpu")
    sound = found.driver.readings(run, "sound")
    assert all(sound[k] <= v for k, v in found.limits.items()), sound
    control = found.driver.readings(run, "control")  # TF32 is off on the CPU
    assert control == {k: 0.0 for k in control}


def test_the_gradient_witness_reads_the_checks_gap_on_the_cpu(kimi_root):
    """``benchmark/grad_witness.py`` on a tiny cell: its float32 reading of
    the worst leaf is the check's ``grad1_gap`` (to the rounding of the
    clipped norm's two orders), and the float32 and float64 references
    agree within the limit."""
    from benchmark import grad_witness

    found = harness.find_cell("tinykimi.train_kda", root=kimi_root)
    seed = 2 ** 31 + 37
    sound = found.driver.readings(harness.Run(found, seed, "cpu"), "sound")
    (line,) = grad_witness.witness(found, seed, "cpu", [])
    assert abs(line["port_vs_reference32"] - sound["grad1_gap"]) < 1e-6
    assert line["reference32_vs_reference64"] < found.limits["grad1_gap"]
    assert line["reference64"] > 0
