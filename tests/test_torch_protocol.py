"""The port's canonical summary protocol and the metrics it adds against
``avsum_tpu`` on seeded inputs: ``evaluate_canonical`` (TVSum mean over
users, SumMe max over users), ``binary_f1``, ``frame_summary_mask``,
``segment_f1`` and ``expand_shot_scores_to_frames`` are NumPy on both
sides, so they must agree to 1e-12; ``rank_correlations`` is jnp float32
there, so 1e-6 as the other metric tests."""

import numpy as np
import pytest

from avsum_tpu.summary import knapsack as jax_knapsack
from avsum_tpu.summary import metrics as jax_metrics
from avsum_tpu.summary import protocol as jax_protocol
from avsum_tpu.temporal import align as jax_align
from avsum_torch import summary
from avsum_torch.summary import knapsack, metrics, protocol
from avsum_torch.temporal import align

EXACT = dict(rtol=0, atol=1e-12)


def _video(rng, n_frames, n_users, dataset):
    cuts = np.sort(rng.choice(np.arange(5, n_frames - 5), 9, replace=False))
    edges = np.concatenate([[0], cuts, [n_frames]])
    bounds = np.stack([edges[:-1], edges[1:]], 1)
    v = {"pred_shot_scores": rng.random(len(bounds)).astype(np.float32),
         "boundaries": bounds, "n_frames": n_frames}
    if dataset == "tvsum":
        v["user_frame_scores"] = 1 + 4 * rng.random((n_users, n_frames))
    else:
        v["user_masks"] = (rng.random((n_frames, n_users)) < 0.15).astype(
            np.float32)
    return v


@pytest.mark.parametrize("dataset", ["tvsum", "summe"])
@pytest.mark.parametrize("budget", [0.15, 0.3])
def test_evaluate_canonical_equals_jax(dataset, budget):
    rng = np.random.default_rng(7 if dataset == "tvsum" else 8)
    videos = [_video(rng, int(n), 5, dataset)
              for n in rng.integers(120, 600, 4)]
    got = protocol.evaluate_canonical(videos, dataset, budget)
    want = jax_protocol.evaluate_canonical(videos, dataset, budget)
    assert set(got) == set(want) == {"canonical_f1", "n_videos"}
    assert got["n_videos"] == want["n_videos"] == 4
    assert got["canonical_f1"] == pytest.approx(want["canonical_f1"], abs=1e-12)
    assert 0.0 < got["canonical_f1"] <= 1.0
    one = {k: v for k, v in videos[0].items()}
    fn, jfn, users = ((protocol.canonical_f1_tvsum,
                       jax_protocol.canonical_f1_tvsum, "user_frame_scores")
                      if dataset == "tvsum" else
                      (protocol.canonical_f1_summe,
                       jax_protocol.canonical_f1_summe, "user_masks"))
    for agg in ("mean", "max"):
        args = (one["pred_shot_scores"], one["boundaries"], one["n_frames"],
                one[users], budget, agg)
        assert fn(*args) == pytest.approx(jfn(*args), abs=1e-12)
    with pytest.raises(ValueError):
        protocol.evaluate_canonical(videos, "other")
    assert protocol.evaluate_canonical([], dataset) == {
        "canonical_f1": 0.0, "n_videos": 0}


def test_binary_f1_and_masks_equal_jax():
    rng = np.random.default_rng(11)
    for _ in range(5):
        a, b = rng.random(300) < 0.2, rng.random(300) < 0.3
        assert protocol.binary_f1(a, b) == pytest.approx(
            jax_protocol.binary_f1(a, b), abs=1e-12)
    assert protocol.binary_f1(np.zeros(9, bool), np.zeros(9, bool)) == 0.0
    segments = np.array([[-3, 4], [10, 12], [15, 40], [38, 70]])
    np.testing.assert_array_equal(knapsack.frame_summary_mask(segments, 50),
                                  jax_knapsack.frame_summary_mask(segments, 50))
    v = _video(rng, 400, 1, "tvsum")
    np.testing.assert_array_equal(
        protocol.summary_mask_from_shot_scores(
            v["pred_shot_scores"], v["boundaries"], 400),
        jax_protocol.summary_mask_from_shot_scores(
            v["pred_shot_scores"], v["boundaries"], 400))


def test_segment_f1_and_frame_expansion_equal_jax():
    rng = np.random.default_rng(12)
    for _ in range(5):
        pred = np.sort(rng.integers(0, 500, (6, 2)), axis=1)
        gt = np.sort(rng.integers(0, 500, (4, 2)), axis=1)
        assert metrics.segment_overlap(pred, gt) == pytest.approx(
            jax_metrics.segment_overlap(pred, gt), abs=1e-12)
        assert metrics.segment_f1(pred, gt) == pytest.approx(
            jax_metrics.segment_f1(pred, gt), abs=1e-12)
    assert metrics.segment_f1([], [[0, 5]]) == 0.0
    v = _video(rng, 300, 1, "tvsum")
    got = align.expand_shot_scores_to_frames(v["pred_shot_scores"],
                                             v["boundaries"], 310)
    want = jax_align.expand_shot_scores_to_frames(v["pred_shot_scores"],
                                                  v["boundaries"], 310)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **EXACT)


@pytest.mark.parametrize("n", [40, 3000])
def test_rank_correlations_match_jax(n):
    rng = np.random.default_rng(n)
    pred, target = rng.random(n).astype(np.float32), rng.random(n).astype(
        np.float32)
    got = metrics.rank_correlations(pred, target)
    want = jax_metrics.rank_correlations(pred, target)
    assert set(got) == set(want) == {"spearman", "kendall"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6)


def test_summary_package_exports_the_jax_packages_names():
    from avsum_tpu import summary as jax_summary

    assert sorted(summary.__all__) == sorted(jax_summary.__all__)
    rng = np.random.default_rng(2)
    values, weights = rng.random(12), rng.integers(1, 30, 12)
    np.testing.assert_array_equal(
        summary.knapsack_select(values, weights, 60),
        np.asarray(jax_summary.knapsack_select(values, weights, 60)))
