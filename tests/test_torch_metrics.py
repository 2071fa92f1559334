"""The port's NumPy metrics and alignment against ``avsum_tpu`` (jnp) and
scipy: keyframe F1, Spearman rho and Kendall tau-b on ties, masks and
n > 2048 (Knight's form), and the shot <-> annotation alignment.
Tolerances: 1e-6 on the metrics (float32 sums in another order), 1e-5
on the alignment (segment means from float32 cumulative sums that reach
~20, where one ulp is 2e-6)."""

import numpy as np
import pytest
from scipy import stats

from avsum_tpu.summary import metrics as jax_metrics
from avsum_tpu.temporal import align as jax_align
from avsum_torch.summary import metrics
from avsum_torch.temporal import align

TOL = dict(rel=1e-6, abs=1e-6)
ALIGN_TOL = dict(rtol=1e-5, atol=1e-5)


def _case(kind, n, seed):
    rng = np.random.default_rng(seed)
    pred = rng.random(n).astype(np.float32)
    target = rng.random(n).astype(np.float32)
    mask = None
    if kind == "ties":
        pred = np.round(pred * 4) / 4  # a handful of tied levels
        target = np.round(target * 5) / 5
    elif kind == "mask":
        mask = np.ones(n, np.float32)
        mask[n - n // 3:] = 0.0
    return pred, target, mask


@pytest.mark.parametrize("kind,n", [("plain", 40), ("ties", 57),
                                    ("mask", 90), ("ties", 2500),
                                    ("plain", 3000)])
def test_evaluate_scores_match_jax_and_scipy(kind, n):
    pred, target, mask = _case(kind, n, seed=n)
    got = metrics.evaluate_scores(pred, target, mask)
    want = jax_metrics.evaluate_scores(pred, target, mask)
    assert set(got) == {"f1", "spearman", "kendall"}
    for key in got:
        assert got[key] == pytest.approx(want[key], **TOL), key
    m = slice(None) if mask is None else mask > 0
    assert got["spearman"] == pytest.approx(
        stats.spearmanr(pred[m], target[m])[0], abs=1e-5)
    assert got["kendall"] == pytest.approx(
        stats.kendalltau(pred[m], target[m])[0], abs=1e-6)


def test_keyframe_f1_with_a_mask_matches_jax():
    pred, target, _ = _case("plain", 30, seed=3)
    mask = np.ones(30, np.float32)
    mask[::4] = 0.0
    assert metrics.keyframe_f1(pred, target, mask) == pytest.approx(
        float(jax_metrics.keyframe_f1(pred, target, mask)), **TOL)


def test_rankdata_matches_scipy():
    x = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], np.float32)
    np.testing.assert_array_equal(metrics.rankdata(x),
                                  stats.rankdata(x).astype(np.float32))


def test_alignment_matches_jax():
    rng = np.random.default_rng(1)
    ends = np.cumsum(rng.integers(20, 200, 30))
    bounds = np.stack([np.concatenate([[0], ends[:-1]]), ends], 1)
    bounds[-1] = (ends[-2], ends[-1] + 5000)  # past the annotations
    annotations = rng.random(40).astype(np.float32)
    mask = np.ones(30, np.float32)
    mask[-4:] = 0.0
    np.testing.assert_allclose(
        align.align_shots_to_annotations(bounds, annotations, 29.97,
                                         mask=mask),
        np.asarray(jax_align.align_shots_to_annotations(
            bounds, annotations, 29.97, mask=mask)), **ALIGN_TOL)
    frames = rng.random(int(ends[-1]) - 100).astype(np.float32)
    np.testing.assert_allclose(
        align.frame_scores_to_shot_scores(frames, bounds),
        jax_align.frame_scores_to_shot_scores(frames, bounds), **ALIGN_TOL)
