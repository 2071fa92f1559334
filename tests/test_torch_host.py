"""The port's numpy copies of host-side JAX-package functions (shot
boundaries, refined content scores, knapsack selection) against their
originals, which import jax at module top."""

import numpy as np
import pytest

from avsum_tpu.io.native import NativeY4MReader as JaxNativeY4MReader
from avsum_tpu.summary import knapsack as jks
from avsum_tpu.temporal import shots as jshots
from avsum_torch.io.native import NativeY4MReader, native_available
from avsum_torch.io.synthetic import make_scene_video
from avsum_torch.io.y4m import write_y4m
from avsum_torch.summary import knapsack as tks
from avsum_torch.temporal import shots as tshots


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuts_and_boundaries_match(seed):
    rng = np.random.default_rng(seed)
    scores = rng.exponential(10.0, 300).astype(np.float32)
    for threshold, min_len in ((27.0, 15), (10.0, 3)):
        cuts = tshots.cuts_from_scores(scores, threshold, min_len)
        assert cuts == jshots.cuts_from_scores(scores, threshold, min_len)
        np.testing.assert_array_equal(
            tshots.boundaries_from_cuts(cuts, 300),
            jshots.boundaries_from_cuts(cuts, 300))
    assert (tshots.ContentDetectorConfig()
            == tshots.ContentDetectorConfig(**vars(jshots.ContentDetectorConfig())))


def test_refined_content_scores_match(tmp_path):
    if not native_available():
        pytest.skip("native library not built")
    video, _, _ = make_scene_video(n_scenes=5, seed=12, height=96, width=128,
                                   scene_len_frames=(20, 40))
    path = str(tmp_path / "r.y4m")
    write_y4m(path, video, fps=30.0)
    reader, jax_reader = NativeY4MReader(path), JaxNativeY4MReader(path)
    try:
        for scale in (1, 2):
            np.testing.assert_array_equal(
                tshots.refined_content_scores(reader, scale),
                jshots.refined_content_scores(jax_reader, scale))
    finally:
        reader.close()
        jax_reader.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_knapsack_and_select_summary_match(seed):
    rng = np.random.default_rng(seed)
    n = 30
    values = rng.random(n) * 5
    weights = rng.integers(0, 50, n)
    mask = rng.random(n) > 0.2
    cap = int(weights.sum() * 0.3)
    np.testing.assert_array_equal(
        tks.knapsack_select_np(values, weights, cap, mask),
        jks.knapsack_select_np(values, weights, cap, mask))
    bounds = np.cumsum(np.r_[0, rng.integers(1, 60, n)])
    bounds = np.stack([bounds[:-1], bounds[1:]], axis=1)
    scores = rng.random(n).astype(np.float32)
    for budget in (0.05, 0.15, 0.5):
        for got, ref in zip(tks.select_summary(scores, bounds, bounds[-1, 1], budget),
                            jks.select_summary(scores, bounds, bounds[-1, 1], budget)):
            np.testing.assert_array_equal(got, ref)


def test_select_summary_refuses_device_sized_problems():
    bounds = np.array([[0, 10**8]])
    with pytest.raises(NotImplementedError, match="not ported"):
        tks.select_summary(np.ones(1), bounds, 10**8 * 2, 0.5)
