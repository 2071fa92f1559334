"""The batch placement of the port (``parallel/mesh.py::shard_batch``,
``train/steps.py::shard_batch_dict``) off the card, and the staging
layout it fills on the card (``utils/transfer.py::stage_arrays``).

On a CPU device, one process and a world of 4 gloo CPU ranks, each rank's
tensors equal its block of the batch padded for the mesh (the conversion
of that block as it is), and the staging is not engaged: the mesh makes
no ring and ``shard_batch.staged`` does not move. ``stage_arrays`` puts
arrays of any strides, dtypes and sizes into one byte buffer, each at an
aligned offset of its own, bit for bit. The card's side (the copy
stream, the ring's slots, the current stream's wait) is in
``tests/test_torch_batch_placement_cuda.py``.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.parallel.mesh import (
    MeshConfig,
    block_slices,
    build_mesh,
    host_cpu_mesh,
    pad_batch_for_mesh,
    rank_coords,
    shard_batch,
)
from avsum_torch.parallel.multihost import Ranks
from avsum_torch.train import steps
from avsum_torch.utils.transfer import ALIGN, stage_arrays, staged_nbytes


def _batch(b: int, s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    mask[-1, s // 2:] = 0.0
    return {"visual": rng.standard_normal((b, s, 12)).astype(np.float32),
            "audio": rng.standard_normal((b, s, 6)).astype(np.float32),
            "targets": rng.random((b, s)).astype(np.float32) * mask,
            "mask": mask}


def _check_blocks(placed, batch, cfg: MeshConfig, rank: int):
    """Each placed tensor is the rank's block of the padded batch,
    contiguous, in its array's dtype."""
    padded = pad_batch_for_mesh(batch, cfg.data, cfg.seq)
    assert set(placed) == set(batch)
    for k, v in padded.items():
        want = v[block_slices(v.shape, cfg, rank_coords(rank, cfg))]
        got = placed[k]
        assert got.dtype == torch.from_numpy(want).dtype
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# One process, CPU device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(1, 9), (3, 16), (2, 1)])
@pytest.mark.parametrize("placement", ["shard_batch", "shard_batch_dict"])
def test_cpu_placement_converts_the_blocks(b, s, placement):
    place = shard_batch if placement == "shard_batch" else steps.shard_batch_dict
    mesh = build_mesh(MeshConfig(), "cpu")
    batch = _batch(b, s, seed=b * 100 + s)
    staged, nbytes = shard_batch.staged, shard_batch.staged_bytes
    placed = place(batch, mesh)
    _check_blocks(placed, batch, mesh.config, 0)
    assert all(t.device.type == "cpu" for t in placed.values())
    assert (shard_batch.staged, shard_batch.staged_bytes) == (staged, nbytes)
    assert mesh._staging is None


def test_cpu_placement_takes_lists_and_other_dtypes():
    mesh = build_mesh(MeshConfig(), "cpu")
    batch = {"mask": np.array([[1, 1, 0]], np.float32),
             "targets": [[0.5, 0.25, 0.0]],
             "ids": np.arange(6, dtype=np.int64).reshape(1, 3, 2),
             "valid": np.array([[True, False, True]])}
    placed = shard_batch(batch, mesh)
    assert placed["targets"].tolist() == [[0.5, 0.25, 0.0]]
    assert placed["ids"].dtype == torch.int64
    assert placed["ids"].tolist() == [[[0, 1], [2, 3], [4, 5]]]
    assert placed["valid"].dtype == torch.bool
    assert mesh._staging is None


# ---------------------------------------------------------------------------
# A world of 4 gloo CPU ranks
# ---------------------------------------------------------------------------

CASES = {  # name: (MeshConfig fields, B, S); the first three need padding
    "data4_pad_b": (dict(data=4), 3, 16),
    "seq4_pad_s": (dict(seq=4), 2, 14),
    "data2_seq2_pad_both": (dict(seq=2), 3, 7),
    "data2_seq2": (dict(seq=2), 4, 8),
    "data2_model2": (dict(model=2), 4, 6),
}


def _place_rank(fields, batch):
    mesh = host_cpu_mesh(MeshConfig(**fields))
    staged = shard_batch.staged
    placed = shard_batch(batch, mesh)
    return {"rank": mesh.rank, "placed": placed,
            "staged": shard_batch.staged - staged,
            "ring": mesh._staging is not None}


@pytest.fixture(scope="module")
def ranks():
    with Ranks(4) as r:
        yield r


@pytest.mark.parametrize("case", list(CASES))
def test_gloo_ranks_place_their_padded_blocks(ranks, case):
    fields, b, s = CASES[case]
    cfg = MeshConfig(**fields).resolved(4)
    batch = _batch(b, s, seed=len(case))
    if case.endswith(("pad_b", "pad_s", "pad_both")):
        assert pad_batch_for_mesh(batch, cfg.data, cfg.seq) is not batch
    for r, out in enumerate(ranks.run(_place_rank, fields, batch)):
        assert out["rank"] == r
        _check_blocks(out["placed"], batch, cfg, r)
        assert out["staged"] == 0 and not out["ring"]


# ---------------------------------------------------------------------------
# The staging layout (a plain byte buffer stands in for a pinned slot)
# ---------------------------------------------------------------------------


def _arrays(kind: str):
    rng = np.random.default_rng(len(kind))
    base = rng.standard_normal((2, 8, 5)).astype(np.float32)
    return {
        "contiguous": [base, base[:, :, 0].copy()],
        "seq_block": [base[:, 4:8], base[1:, 2:6, 0]],  # a rank's slices
        "negative_strides": [base[:, ::-1], base[::-1, :, 1]],
        "odd_sizes": [rng.standard_normal(3).astype(np.float32),
                      np.arange(5, dtype=np.int8),
                      rng.standard_normal((3, 7)).astype(np.float64)],
        "other_dtypes": [np.arange(12, dtype=np.int64).reshape(3, 4),
                         rng.random((4, 3)) > 0.5,
                         rng.standard_normal((2, 3)).astype(np.float16)],
        "empty_and_scalar": [np.zeros((0, 4), np.float32),
                             np.array(7.5, np.float32),
                             np.ones((1, 1), np.float32)],
    }[kind]


KINDS = ["contiguous", "seq_block", "negative_strides", "odd_sizes",
         "other_dtypes", "empty_and_scalar"]


@pytest.mark.parametrize("kind", KINDS)
def test_stage_arrays_holds_each_array_at_an_aligned_offset(kind):
    arrays = _arrays(kind)
    n = staged_nbytes(arrays)
    assert n % ALIGN == 0 and n >= sum(a.nbytes for a in arrays)
    host = torch.full((n + 64,), 0xAB, dtype=torch.uint8)
    views = stage_arrays(host, arrays)
    end = 0
    for a, v in zip(arrays, views):
        offset = v.storage_offset() * v.element_size()  # bytes into host
        assert offset % ALIGN == 0 and offset >= end
        end = offset + a.nbytes
        assert v.is_contiguous() and tuple(v.shape) == a.shape
        assert v.dtype == torch.from_numpy(np.ascontiguousarray(a)).dtype
        assert v.numpy().tobytes() == np.ascontiguousarray(a).tobytes()
    assert end <= n
    assert host[n:].eq(0xAB).all()  # nothing past the slot's bytes


def test_stage_arrays_refills_a_slot_with_smaller_arrays():
    big = [np.full((4, 100), 3.0, np.float32), np.arange(40, dtype=np.int32)]
    small = [np.full((2, 10), -1.0, np.float32), np.arange(5, dtype=np.int32)]
    host = torch.zeros(staged_nbytes(big), dtype=torch.uint8)
    stage_arrays(host, big)
    views = stage_arrays(host[:staged_nbytes(small)], small)
    for a, v in zip(small, views):
        np.testing.assert_array_equal(v.numpy(), a)
