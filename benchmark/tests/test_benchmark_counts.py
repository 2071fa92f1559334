"""The yardstick's arithmetic against hand counts at small shapes."""

from __future__ import annotations

import pytest
import torch

from benchmark import counts, trace
from benchmark.reference import scorer

MODEL = {"visual_dim": 6, "audio_dim": 4, "hidden_dim": 8, "num_heads": 2,
         "scorer_hidden": 3, "dropout": 0.0, "temporal_layers": 1}


def test_flash_counts_by_hand():
    f, b = counts.flash_fwd_counts(2, 10, 3, 4)
    assert f == 2 * (2 * 3 * 10 * 10 * 4) * 2
    assert b == 4 * (4 * 2 * 10 * 3 * 4 + 2 * 10 + 2 * 3 * 10)
    f, b = counts.flash_bwd_counts(2, 10, 3, 4)
    assert f == 5 * (2 * 2 * 3 * 10 * 10 * 4)
    assert b == 4 * (7 * 2 * 10 * 3 * 4 + 2 * 10 + 2 * 2 * 3 * 10)
    assert counts.bound_s(495e12, 1.0, 495e12) == 1.0
    assert counts.bound_s(0.0, 3.35e12, 495e12) == 1.0


def test_attention_calls_follow_the_kernel_threshold():
    model = {**MODEL, "temporal_encoder": "attention", "temporal_layers": 2,
             "hidden_dim": 512, "num_heads": 4}
    assert counts.attention_calls(model, 1, 511) == []
    assert counts.attention_calls(model, 1, 7168) == (
        [(1, 7168, 4, 128)] * 4 + [(1, 7168, 4, 256)])
    bilstm = {**model, "temporal_encoder": "bilstm"}
    assert counts.attention_calls(bilstm, 4, 1024) == [(4, 1024, 4, 256)]
    assert counts.attention_calls({**model, "use_pallas": False}, 1, 7168) == []


def _linear(n, i, o, grad_in=True):
    """forward, the weight's gradient and, where the input needs one, the
    input's"""
    return (3 if grad_in else 2) * 2 * n * i * o


def _attention(b, s, e):
    return 4 * _linear(b * s, e, e) + 3 * 2 * (2 * b * s * s * e)


@pytest.mark.parametrize("encoder", ["attention", "bilstm"])
def test_step_flops_match_the_hand_count(encoder):
    b, s, h = 2, 5, MODEL["hidden_dim"]
    model = {**MODEL, "temporal_encoder": encoder}
    want = _linear(b * s, 6, h, False) + _linear(b * s, 4, h, False)
    if encoder == "attention":
        want += 2 * (_attention(b, s, h) + _linear(b * s, h, 4 * h)
                     + _linear(b * s, 4 * h, h))
    else:
        half = h // 2
        # per direction: the input projection, then s products h @ wh; the
        # first step's h is zeros, a constant, whose weight gets no
        # product in the backward of the input
        per_dir = _linear(b * s, h, 4 * half) + 3 * 2 * s * b * half * 4 * half
        per_dir -= 2 * b * half * 4 * half  # no grad for the first h
        want += 2 * 2 * per_dir
    want += _attention(b, s, 2 * h) + _linear(b * s, 2 * h, 3) + _linear(b * s, 3, 1)
    got = counts.step_flops(model, b, s)
    assert got == want


def test_video_flops_is_the_step_count_at_every_length():
    model = {**MODEL, "temporal_encoder": "attention"}
    flops = counts.video_flops(model)
    for n in (2, 7, 24, 77):
        assert flops(n) == counts.step_flops(model, 1, n)


def test_union_counts_overlapping_streams_once():
    busy, gaps = trace.union([(0, 10), (5, 15), (20, 30), (25, 26)], 0, 40)
    assert busy == 25
    assert gaps == [(15, 20), (30, 40)]
    busy, gaps = trace.union([(-5, 5), (35, 50)], 0, 40)
    assert busy == 10 and gaps == [(5, 35)]


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    host = [trace.HostOp("outer", 0, 100, 0), trace.HostOp("inner", 10, 30, 0),
            trace.HostOp("later", 60, 70, 0)]
    t = trace.Trace((0, 100), [], host, 0, [(12, 20), (40, 50), (62, 64)])
    named = dict(trace.idle_by_host(t))
    assert named == {"inner": 8e-9, "outer": 10e-9, "later": 2e-9}


def test_leaf_specs_cover_the_scorer():
    specs = scorer.leaf_specs({**MODEL, "temporal_encoder": "attention"})
    names = [n for n, _, _ in specs]
    assert len(names) == len(set(names))
    leaves = scorer.init_leaves({**MODEL, "temporal_encoder": "attention"}, 3,
                                "cpu")
    assert torch.equal(leaves["fusion.k.b"], torch.zeros(2 * 8))
    again = scorer.init_leaves({**MODEL, "temporal_encoder": "attention"}, 3,
                               "cpu")
    assert all(torch.equal(leaves[k], again[k]) for k in leaves)
