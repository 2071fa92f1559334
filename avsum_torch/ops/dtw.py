"""Dynamic time warping (``avsum_tpu/ops/dtw.py``): the alignment check
behind the pipeline's fixed-rate segment pooling, which replaced the
reference's DTW alignment of the audio streams.

- ``dtw_host``: exact O(N*M) DTW in NumPy with the full path;
- ``dtw_cost_device``: the total cost on the tensor's device as a
  wavefront over the N+M-1 anti-diagonals, each a vectorized three-way
  min (JAX's is a ``lax.scan``, not a Pallas kernel, so this is plain
  PyTorch);
- ``aligned_mean`` / ``alignment_fidelity``: DTW-aligned against plain
  mean pooling.

The NumPy functions are copies of the JAX package's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

INF = 3e38  # JAX's float32 "infinity" of an unreachable cell


def _pairwise_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Euclidean distance matrix [N, M] (scipy.cdist semantics)."""
    a2 = (a * a).sum(-1)[:, None]
    b2 = (b * b).sum(-1)[None, :]
    d2 = np.maximum(a2 + b2 - 2.0 * a @ b.T, 0.0)
    return np.sqrt(d2)


def dtw_host(a: np.ndarray, b: np.ndarray
             ) -> Tuple[float, List[Tuple[int, int]]]:
    """Exact DTW between feature sequences a [N, D], b [M, D] -> (total
    cost, path as (i, j) pairs), the contract of ``fastdtw(a, b,
    dist=cdist)`` with an exact search."""
    dist = _pairwise_dist(
        np.asarray(a, np.float64).reshape(len(a), -1),
        np.asarray(b, np.float64).reshape(len(b), -1),
    )
    n, m = dist.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            acc[i, j] = dist[i - 1, j - 1] + min(
                acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1]
            )
    path = [(n - 1, m - 1)]
    i, j = n, m
    while (i, j) != (1, 1):
        steps = [(i - 1, j - 1), (i - 1, j), (i, j - 1)]
        i, j = min(steps, key=lambda ij: acc[ij])
        path.append((i - 1, j - 1))
    return float(acc[n, m]), path[::-1]


def dtw_cost_device(dist) -> torch.Tensor:
    """Total DTW cost of a [N, M] distance matrix (a tensor, on its device,
    or an array, on the CPU) -> a float32 scalar tensor.

    Step k updates anti-diagonal k (cells i + j = k) from diagonals k - 1
    and k - 2, held in buffers of M + 2 slots indexed by j + 1: up (i - 1,
    j) is slot j + 1 of diagonal k - 1, left (i, j - 1) slot j, and the
    diagonal (i - 1, j - 1) slot j of diagonal k - 2."""
    dist = torch.as_tensor(dist, dtype=torch.float32)
    n, m = dist.shape
    width = m + 2
    j = torch.arange(width, device=dist.device) - 1
    prev2 = torch.full((width,), INF, device=dist.device)
    prev1 = prev2.clone()
    for k in range(n + m - 1):
        i = k - j
        valid = (j >= 0) & (j < m) & (i >= 0) & (i < n)
        d = dist[i.clamp(0, n - 1), j.clamp(0, m - 1)]
        best = torch.minimum(torch.minimum(prev1, prev1.roll(1)),
                             prev2.roll(1))
        cur = torch.where((i == 0) & (j == 0), d, d + best)
        prev2, prev1 = prev1, torch.where(valid, cur, INF)
    return prev1[m]


def aligned_mean(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mean of b along a DTW path against a (the reference's
    ``aligned_mfcc.mean(0)``)."""
    _, path = dtw_host(a, b)
    return np.stack([b[j] for _, j in path]).mean(axis=0)


def alignment_fidelity(a: np.ndarray, b: np.ndarray) -> float:
    """Relative L2 difference between DTW-aligned mean pooling of ``b``
    against ``a`` and plain mean pooling."""
    dtw_pool = aligned_mean(a, b)
    plain_pool = np.asarray(b).mean(axis=0)
    denom = np.linalg.norm(plain_pool) + 1e-12
    return float(np.linalg.norm(dtw_pool - plain_pool) / denom)
