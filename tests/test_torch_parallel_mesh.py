"""The mesh and process startup of the port (``avsum_torch/parallel/mesh.py``,
``multihost.py``) against ``avsum_tpu/parallel/mesh.py``: the resolution
rules of ``MeshConfig`` at world 1, 2, 4 and 8 (``tests/test_mesh_config.py``'s
cases), each rank's coordinates against JAX's device array, each rank's
block of a padded batch against the shard JAX's ``NamedSharding`` puts on
that device, ``pad_batch_for_mesh`` against JAX's, and the process groups
of every axis on a world of 4 gloo CPU ranks (exact). A mesh larger than
the world raises, naming ``torchrun``; ``initialize`` without a launcher
leaves one process alone.

The rank functions import no JAX: each rank imports this module."""

import numpy as np
import pytest
import torch

from avsum_torch.parallel import multihost
from avsum_torch.parallel.comm import all_gather, all_reduce
from avsum_torch.parallel.mesh import (
    AXES,
    REPLICA,
    MeshConfig,
    block_slices,
    build_mesh,
    host_cpu_mesh,
    pad_batch_for_mesh,
    rank_coords,
    shard_batch,
)

SHAPES = [  # (world, MeshConfig fields)
    (1, dict()), (2, dict()), (2, dict(seq=2)), (4, dict(seq=2)),
    (4, dict(model=2)), (4, dict(data=1, seq=2, model=2, auto_data=False)),
    (8, dict(data=4, seq=2, model=1, auto_data=False)), (8, dict(model=4)),
    (8, dict(seq=2, model=2)),
]


def _jax_mesh(world, fields):
    import jax

    from avsum_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh

    return build_mesh(JaxMeshConfig(**fields), jax.devices()[:world])


@pytest.mark.parametrize("world,fields", SHAPES)
def test_resolved_and_coords_match_jax(world, fields):
    import jax

    mesh = _jax_mesh(world, fields)
    cfg = MeshConfig(**fields).resolved(world)
    assert (cfg.data, cfg.seq, cfg.model) == tuple(mesh.devices.shape)
    ids = [d.id for d in mesh.devices.flat]
    for rank, dev in enumerate(jax.devices()[:world]):
        pos = np.unravel_index(ids.index(dev.id), mesh.devices.shape)
        assert tuple(rank_coords(rank, cfg).values()) == tuple(pos)


@pytest.mark.parametrize("world,fields", [(w, f) for w, f in SHAPES if w > 1])
@pytest.mark.parametrize("b,s", [(8, 16), (3, 14)])
def test_rank_blocks_match_jax_shards(world, fields, b, s):
    import jax

    from avsum_tpu.parallel import shard_batch as jax_shard_batch
    from avsum_tpu.train.steps import pad_batch_for_mesh as jax_pad

    mesh = _jax_mesh(world, fields)
    cfg = MeshConfig(**fields).resolved(world)
    rng = np.random.default_rng(b * s)
    batch = {"visual": rng.standard_normal((b, s, 3)).astype(np.float32),
             "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    ours = pad_batch_for_mesh(batch, cfg.data, cfg.seq)
    theirs = jax_pad(batch, mesh)
    for k in batch:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
    placed = jax_shard_batch(np.asarray(theirs["visual"]), mesh)
    shards = {sh.device.id: np.asarray(sh.data)
              for sh in placed.addressable_shards}
    for rank, dev in enumerate(jax.devices()[:world]):
        idx = block_slices(ours["visual"].shape, cfg, rank_coords(rank, cfg))
        np.testing.assert_array_equal(ours["visual"][idx], shards[dev.id])


def test_resolution_rules():
    assert MeshConfig(seq=2).resolved(8) == MeshConfig(4, 2, 1, False)
    assert MeshConfig(model=4).resolved(8).data == 2
    with pytest.raises(ValueError, match="does not divide"):
        MeshConfig(seq=3).resolved(8)
    with pytest.raises(ValueError, match="!= 4 ranks"):
        MeshConfig(data=2, seq=1, auto_data=False).resolved(4)


def test_one_process_refuses_a_larger_mesh():
    """hour_scale.yaml's seq 4 in one process names the command."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4 -m "
                                         "avsum_torch.cli"):
        build_mesh(MeshConfig(seq=4, auto_data=False), "cpu")
    mesh = build_mesh(MeshConfig(), "cpu")
    assert mesh.world == 1 and all(mesh.size(a) == 1 for a in AXES)


def test_initialize_without_a_launcher(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize("127.0.0.1:1", 1, 0) is False
    assert multihost.is_primary() and multihost.process_count() == 1
    assert multihost.local_batch_slice(8) == slice(0, 8)


def _groups_rank(fields):
    """Each axis's group: the sum and the gather of the coordinates."""
    mesh = host_cpu_mesh(MeshConfig(**fields))
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for axis in AXES + (REPLICA,):
        x = torch.tensor([float(mesh.rank)])
        out[axis] = (mesh.ranks[axis], all_reduce(x, mesh, axis).item(),
                     all_gather(x, mesh, axis, 0).tolist())
    batch = {"mask": np.arange(3 * 6, dtype=np.float32).reshape(3, 6)}
    out["block"] = shard_batch(batch, mesh)["mask"].numpy()
    return out


@pytest.fixture(scope="module")
def ranks():
    with multihost.Ranks(4) as r:
        yield r


@pytest.mark.parametrize("fields", [w[1] for w in SHAPES if w[0] == 4]
                         + [dict(data=4)])
def test_axis_groups_on_ranks(ranks, fields):
    cfg = MeshConfig(**fields).resolved(4)
    padded = pad_batch_for_mesh(
        {"mask": np.arange(18, dtype=np.float32).reshape(3, 6)},
        cfg.data, cfg.seq)["mask"]
    for r, out in enumerate(ranks.run(_groups_rank, fields)):
        coords = rank_coords(r, cfg)
        assert out["rank"] == r and out["coords"] == coords
        for axis in AXES + (REPLICA,):
            members = [q for q in range(4) if all(
                rank_coords(q, cfg)[a] == coords[a] for a in AXES
                if a not in ((axis,) if axis != REPLICA
                             else ("data", "seq")))]
            got_ranks, total, gathered = out[axis]
            assert got_ranks == members
            assert total == sum(members) and gathered == members
        np.testing.assert_array_equal(
            out["block"], padded[block_slices(padded.shape, cfg, coords)])
