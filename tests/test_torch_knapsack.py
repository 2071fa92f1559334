"""The port's knapsack DP for problems of 5e7 cells or more against the JAX
package's jitted DP (``avsum_tpu/summary/knapsack.py::knapsack_select``):
both keep float32 values, so on seeded continuous values the selections
are equal; ``select_summary`` past ``MAX_DP_CELLS`` answers as JAX's does.
Run here on the CPU, the device the DP is given."""

import numpy as np
import pytest
import torch

from avsum_torch.summary import knapsack as tks
from avsum_tpu.summary import knapsack as jks


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The DP is a loop of small ops per item: on a CPU shared with other
    test workers, intra-op threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n=60):
    """Seeded continuous values, weights with zero-length and oversize
    items, a capacity of ~30% of the total weight, a validity mask."""
    rng = np.random.default_rng(seed)
    values = (rng.random(n) * 5).astype(np.float32)
    weights = rng.integers(1, 60, n)
    weights[rng.choice(n, 4, replace=False)] = 0
    cap = int(weights.sum() * 0.3)
    weights[rng.choice(n, 3, replace=False)] = cap + 1 + rng.integers(0, 9, 3)
    mask = rng.random(n) > 0.15
    return values, weights, cap, mask


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_device_dp_equals_jax(seed, masked):
    values, weights, cap, mask = _problem(seed)
    mask = mask if masked else None
    got = tks.knapsack_select(values, weights, cap, mask, device="cpu")
    want = np.asarray(jks.knapsack_select(values, weights.astype(np.int32),
                                          cap, mask))
    np.testing.assert_array_equal(got, want)
    assert weights[got].sum() <= cap
    assert not got[weights == 0].any() and not got[weights > cap].any()
    if masked:
        assert not got[~mask].any()
    # the float64 NumPy DP reaches the same total value
    ref = tks.knapsack_select_np(values, weights, cap, mask)
    np.testing.assert_allclose(values[got].sum(dtype=np.float64),
                               values[ref].sum(dtype=np.float64), rtol=1e-6)


def test_select_summary_past_max_cells_equals_jax():
    """1000 shots x capacity 50000: the size where the JAX package leaves
    its NumPy DP for the jitted one, and the port for its torch DP."""
    rng = np.random.default_rng(5)
    n = 1000
    lengths = rng.integers(100, 567, n)
    ends = np.cumsum(lengths)
    bounds = np.stack([ends - lengths, ends], 1)
    scores = rng.random(n).astype(np.float32)
    total = int(ends[-1])
    budget = 50000 / total
    cap = int(budget * total)
    assert n * (cap + 1) >= tks.MAX_DP_CELLS
    got = tks.select_summary(scores, bounds, total, budget, device="cpu")
    want = jks.select_summary(scores, bounds, total, budget)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert lengths[got[0]].sum() <= cap


def test_small_problems_stay_on_the_host():
    """Below MAX_DP_CELLS the NumPy DP answers; the device is not used
    (here a CUDA device that this machine need not have)."""
    values, weights, cap, _ = _problem(7, n=20)
    bounds = np.stack([np.r_[0, np.cumsum(weights)[:-1]], np.cumsum(weights)],
                      1)
    got = tks.select_summary(values, bounds, int(bounds[-1, 1]), 0.3,
                             device="cuda")
    want = jks.select_summary(values, bounds, int(bounds[-1, 1]), 0.3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
