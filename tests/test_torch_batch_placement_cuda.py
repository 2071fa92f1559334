"""The batch placement on the card (``parallel/mesh.py::shard_batch``
through ``utils/transfer.py::StagedUpload``): pinned slots in a ring, the
copies on a stream of the mesh's own, the current stream ordered after
them.

- More placements than the ring has slots, of distinct contents and
  sizes, each behind a sleep on the current stream and one on the copy
  stream: every placed tensor, copied on the current stream, equals its
  NumPy source bit for bit. A slot refilled before its copy ran, or a
  device block handed to a later copy before the current stream had read
  it, would show as another batch's bytes.
- ``shard_batch.staged`` rises by one a placement, ``staged_bytes`` by
  the blocks' bytes.
- A kernel enqueued right after a placement whose copy runs late reads
  the new data.

Needs an NVIDIA GPU; skips elsewhere. The card machine has no JAX, so
this file imports none and runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batch_placement_cuda.py
"""

import numpy as np
import pytest
import torch

from avsum_torch.parallel.mesh import MeshConfig, build_mesh, shard_batch
from avsum_torch.utils.transfer import StagedUpload

pytestmark = pytest.mark.cuda

SLEEP = 200_000_000  # cycles of torch.cuda._sleep: about 0.1 s on an H100


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return build_mesh(MeshConfig(), "cuda")


def _batch(b: int, s: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    return {"visual": rng.standard_normal((b, s, d)).astype(np.float32),
            "audio": rng.standard_normal((b, s, d // 2 + 1)).astype(np.float32),
            "targets": rng.random((b, s)).astype(np.float32) * mask,
            "mask": mask}


def _assert_bitwise(tensors, batch):
    for k, v in batch.items():
        got = tensors[k].cpu().numpy()
        assert got.dtype == v.dtype and got.shape == v.shape
        assert got.tobytes() == v.tobytes(), k


# (B, S, D): repeated sizes, so the caching allocator has freed blocks of
# the right size to hand out, beside sizes that grow and shrink the slots
SIZES = [(1, 4096, 64), (1, 4096, 64), (2, 700, 24), (1, 9000, 32),
         (1, 4096, 64), (3, 64, 8), (1, 9000, 32), (2, 700, 24)]


def test_placements_past_the_ring_keep_their_bytes(mesh):
    assert len(SIZES) > 2 * StagedUpload.SLOTS
    batches = [_batch(*size, seed=i) for i, size in enumerate(SIZES)]
    copies = []
    for batch in batches:
        torch.cuda._sleep(SLEEP)  # the current stream reads late
        with torch.cuda.stream(mesh.staging.stream):
            torch.cuda._sleep(SLEEP // 4)  # the copy runs late
        placed = shard_batch(batch, mesh)
        copies.append({k: t.clone() for k, t in placed.items()})
        del placed  # freed while the current stream has not read it
    for got, batch in zip(copies, batches):
        _assert_bitwise(got, batch)


def test_each_placement_counts_once(mesh):
    batches = [_batch(1, 300 + 100 * i, 16, seed=10 + i) for i in range(3)]
    staged, nbytes = shard_batch.staged, shard_batch.staged_bytes
    for batch in batches:
        shard_batch(batch, mesh)
    assert shard_batch.staged == staged + len(batches)
    assert shard_batch.staged_bytes == nbytes + sum(
        v.nbytes for batch in batches for v in batch.values())
    torch.cuda.synchronize()


def test_the_current_stream_waits_for_the_copy(mesh):
    batch = _batch(1, 8192, 64, seed=20)
    want = {k: torch.from_numpy(v).to(mesh.device) for k, v in batch.items()}
    torch.cuda.synchronize()
    with torch.cuda.stream(mesh.staging.stream):
        torch.cuda._sleep(SLEEP)  # the copy runs late
    placed = shard_batch(batch, mesh)
    same = {k: torch.equal(placed[k], want[k]) for k in batch}
    assert all(same.values()), same
    _assert_bitwise(placed, batch)
