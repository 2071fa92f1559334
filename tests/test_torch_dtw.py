"""Dynamic time warping (``avsum_torch/ops/dtw.py``) against the JAX
package's ``avsum_tpu/ops/dtw.py``: ``tests/test_dtw.py``'s cases on the
port's functions, the host functions equal to JAX's on the same inputs,
and the device wavefront cost within 1e-5 relative of JAX's
``dtw_cost_device`` on the same matrices (plain PyTorch on the CPU
here)."""

import numpy as np
import pytest

from avsum_tpu.ops import dtw as jax_dtw
from avsum_torch.ops.dtw import (
    _pairwise_dist,
    aligned_mean,
    alignment_fidelity,
    dtw_cost_device,
    dtw_host,
)


def test_pairwise_dist_matches_direct_and_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((5, 3)), rng.standard_normal((7, 3))
    d = _pairwise_dist(a, b)
    for i in range(5):
        for j in range(7):
            assert d[i, j] == pytest.approx(np.linalg.norm(a[i] - b[j]),
                                            abs=1e-9)
    np.testing.assert_array_equal(d, jax_dtw._pairwise_dist(a, b))


def test_dtw_identical_sequences_zero_cost():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((10, 4))
    cost, path = dtw_host(a, a)
    assert cost == pytest.approx(0.0, abs=1e-5)
    assert path == [(i, i) for i in range(10)]


def test_dtw_path_monotone_complete_and_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((8, 4)), rng.standard_normal((13, 4))
    cost, path = dtw_host(a, b)
    assert path[0] == (0, 0) and path[-1] == (7, 12)
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        assert (i1 - i0, j1 - j0) in {(0, 1), (1, 0), (1, 1)}
    assert cost > 0
    assert (cost, path) == jax_dtw.dtw_host(a, b)


def test_dtw_warp_invariance():
    """A time-warped copy (repeated frames) aligns at ~zero cost."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 4))
    cost, _ = dtw_host(a, np.repeat(a, 2, axis=0))
    assert cost == pytest.approx(0.0, abs=1e-5)


@pytest.mark.parametrize("n,m", [(6, 6), (8, 13), (1, 5), (5, 1), (37, 20)])
def test_device_cost_matches_host_and_jax(n, m):
    rng = np.random.default_rng(n * 100 + m)
    a, b = rng.standard_normal((n, 4)), rng.standard_normal((m, 4))
    dist = _pairwise_dist(a, b)
    host_cost, _ = dtw_host(a, b)
    dev_cost = float(dtw_cost_device(dist))
    assert dev_cost == pytest.approx(host_cost, rel=1e-5)
    assert dev_cost == pytest.approx(float(jax_dtw.dtw_cost_device(dist)),
                                     rel=1e-5)


def test_alignment_fidelity_small_for_similar_rates():
    """For feature streams at comparable rates, DTW-aligned mean pooling is
    close to plain mean pooling; the same number as JAX's."""
    rng = np.random.default_rng(5)
    base = np.cumsum(rng.standard_normal((40, 8)), axis=0) * 0.1
    a = base + 0.01 * rng.standard_normal((40, 8))
    b = base + 0.01 * rng.standard_normal((40, 8))
    rel = alignment_fidelity(a, b)
    assert rel < 0.15, rel
    assert rel == jax_dtw.alignment_fidelity(a, b)


def test_aligned_mean_shape_and_jax():
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((5, 3)), rng.standard_normal((9, 3))
    assert aligned_mean(a, b).shape == (3,)
    np.testing.assert_array_equal(aligned_mean(a, b),
                                  jax_dtw.aligned_mean(a, b))
