"""The device mesh over ``torch.distributed`` ranks
(``avsum_tpu/parallel/mesh.py``).

One process per rank. The mesh has the JAX package's three named axes:

- ``data``:  data parallelism over videos (the batch axis);
- ``seq``:   context parallelism over the shot axis (ring attention,
  :mod:`avsum_torch.parallel.ring`);
- ``model``: the experts of the MoE encoder (expert parallelism), the
  stages of the staged encoder (GPipe, :mod:`avsum_torch.parallel.pipeline`)
  and, under ``state_sharding``, the matrices of every other module
  (tensor parallelism, :mod:`avsum_torch.parallel.tensor`).

Rank order is the JAX reshape of the device list to ``(data, seq,
model)``: ``model`` varies fastest. Each axis is one process group per
line of ranks along it, and ``replica`` is the group of the ranks that
share this rank's ``model`` coordinate (``data x seq``), over which the
gradients of every parameter are summed. Every collective is explicit
(:mod:`avsum_torch.parallel.comm`). A rank holds the block ``[B / data,
S / seq]`` of the batch padded for the mesh (:func:`pad_batch_for_mesh`).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avsum_torch.utils.profiling import annotate
from avsum_torch.utils.transfer import StagedUpload

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXES = (AXIS_DATA, AXIS_SEQ, AXIS_MODEL)
REPLICA = "replica"  # data x seq: the ranks that share a model coordinate


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``data * seq * model`` must equal the world
    size; with ``auto_data`` the data axis takes up what is left."""

    data: int = 1
    seq: int = 1
    model: int = 1
    auto_data: bool = True

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model

    def resolved(self, world: int) -> "MeshConfig":
        """A config whose size equals ``world`` (the JAX rules, against
        the number of ranks)."""
        fixed = self.seq * self.model
        need = fixed if self.auto_data else self.size
        if world % fixed != 0:
            raise ValueError(
                f"seq*model={fixed} does not divide the world size {world}"
                f"{launch_hint(need)}")
        data = world // fixed if self.auto_data else self.data
        if data * fixed != world:
            raise ValueError(
                f"mesh {data}x{self.seq}x{self.model} != {world} ranks"
                f"{launch_hint(need)}")
        return dataclasses.replace(self, data=data, auto_data=False)


def launch_hint(n: int) -> str:
    return (f"; run one process per rank: `torchrun --nproc-per-node {n} "
            "-m avsum_torch.cli ...`")


def mesh_config(shape) -> MeshConfig:
    """``config.mesh`` (a ``MeshShape``) -> :class:`MeshConfig`."""
    return MeshConfig(shape.data, shape.seq, shape.model, shape.auto_data)


def rank_coords(rank: int, cfg: MeshConfig) -> Dict[str, int]:
    """The (data, seq, model) coordinates of ``rank``; model fastest."""
    d, rest = divmod(rank, cfg.seq * cfg.model)
    s, m = divmod(rest, cfg.model)
    return {AXIS_DATA: d, AXIS_SEQ: s, AXIS_MODEL: m}


def _rank_of(coords: Dict[str, int], cfg: MeshConfig) -> int:
    return ((coords[AXIS_DATA] * cfg.seq + coords[AXIS_SEQ]) * cfg.model
            + coords[AXIS_MODEL])


def axis_groups(cfg: MeshConfig, axes: Sequence[str]) -> List[List[int]]:
    """Every group of ranks along ``axes`` (the others fixed), in a fixed
    order: each rank must create every group, in the same order."""
    sizes = {AXIS_DATA: cfg.data, AXIS_SEQ: cfg.seq, AXIS_MODEL: cfg.model}
    fixed = [a for a in AXES if a not in axes]
    groups = []
    for rest in itertools.product(*(range(sizes[a]) for a in fixed)):
        base = dict(zip(fixed, rest))
        groups.append(sorted(
            _rank_of({**base, **dict(zip(axes, inner))}, cfg)
            for inner in itertools.product(*(range(sizes[a]) for a in axes))))
    return groups


_GROUP_AXES = {AXIS_DATA: (AXIS_DATA,), AXIS_SEQ: (AXIS_SEQ,),
               AXIS_MODEL: (AXIS_MODEL,), REPLICA: (AXIS_DATA, AXIS_SEQ)}


class Mesh:
    """This rank's view of the mesh: its coordinates, its device, and per
    axis (and ``replica``) the process group and the ranks in it (None and
    ``[rank]`` along an axis of size 1, or when there is one rank)."""

    def __init__(self, config: MeshConfig, rank: int, device: torch.device,
                 backend: Optional[str] = None):
        self.config = config
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.coords = rank_coords(rank, config)
        self.ranks: Dict[str, List[int]] = {}
        self.groups: Dict[str, Optional[object]] = {}
        for name, axes in _GROUP_AXES.items():
            for ranks in axis_groups(config, axes):
                # every rank creates every group of more than one rank
                group = (dist.new_group(ranks, backend=backend)
                         if len(ranks) > 1 else None)
                if rank in ranks:
                    self.ranks[name], self.groups[name] = ranks, group
        self._staging: Optional[StagedUpload] = None

    @property
    def world(self) -> int:
        return self.config.size

    def size(self, axis: str) -> int:
        return len(self.ranks[axis])

    def index(self, axis: str) -> int:
        """This rank's position in its group along ``axis``."""
        return self.ranks[axis].index(self.rank)

    @property
    def staging(self) -> StagedUpload:
        """The pinned ring and copy stream that :func:`shard_batch` places
        batches through on a CUDA device, made at first use."""
        if self._staging is None:
            self._staging = StagedUpload(self.device)
        return self._staging

    @property
    def staged(self) -> bool:
        """gloo on CUDA tensors: the transport copies through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh({self.config.data}x{self.config.seq}x"
                f"{self.config.model}, rank {self.rank} {self.coords}, "
                f"{self.device}, {self.backend})")


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU. Ranks that share one card
    need gloo, which the caller asks for explicitly."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """``cuda`` -> ``cuda:{LOCAL_RANK % device_count}`` (the global rank
    where no launcher set ``LOCAL_RANK``); anything else as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def build_mesh(config: MeshConfig = MeshConfig(), device="cuda",
               backend: Optional[str] = None) -> Mesh:
    """The mesh over the initialized world (one rank without one):
    ``config`` resolved against the world size, a group per axis, this
    rank's device. A mesh larger than the world raises, naming the
    ``torchrun`` command that starts one process per rank."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    cfg = config.resolved(world)
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if initialized:
        backend = backend or dist.get_backend()
    return Mesh(cfg, rank, device, backend)


def host_cpu_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over an initialized gloo world of CPU processes (the
    counterpart of JAX's host-CPU device mesh, for tests without a card;
    :class:`avsum_torch.parallel.multihost.Ranks` starts such a world)."""
    return build_mesh(config or MeshConfig(), "cpu", "gloo")


def pad_batch_for_mesh(batch: Dict[str, np.ndarray], data: int, seq: int
                       ) -> Dict[str, np.ndarray]:
    """Pad the batch and shot axes with mask-0 rows so they divide the
    ``data`` and ``seq`` axes (``avsum_tpu/train/steps.py``)."""
    b, s = batch["mask"].shape
    pad_b, pad_s = (-b) % data, (-s) % seq
    if pad_b == 0 and pad_s == 0:
        return batch
    return {k: np.pad(np.asarray(v), [(0, pad_b), (0, pad_s)]
                      + [(0, 0)] * (np.ndim(v) - 2))
            for k, v in batch.items()}


def block_slices(shape: Tuple[int, ...], cfg: MeshConfig,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index of a rank's block of a [B, S, ...] array whose B and S
    divide the data and seq axes (``batch_spec``'s layout)."""
    b, s = shape[0] // cfg.data, shape[1] // cfg.seq
    d, q = coords[AXIS_DATA], coords[AXIS_SEQ]
    return slice(d * b, (d + 1) * b), slice(q * s, (q + 1) * s)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """Pad a host batch for the mesh and put this rank's block of each
    array on its device (``shard_batch`` / ``shard_batch_dict``), inside
    an ``avsum.place_batch`` span.

    On a CUDA device each block is copied from its array straight into a
    pinned slot of ``mesh.staging`` and uploaded on that ring's copy
    stream (:class:`~avsum_torch.utils.transfer.StagedUpload`): the call
    returns before the copy has run, and the current stream is ordered
    after it, so whatever runs on the current stream afterwards reads the
    batch. Each such placement adds one to ``shard_batch.staged`` and the
    blocks' bytes to ``shard_batch.staged_bytes``. On any other device
    (the CPU of the gloo ranks) each block is converted as it is."""
    with annotate("avsum.place_batch"):
        batch = pad_batch_for_mesh(batch, mesh.config.data, mesh.config.seq)
        blocks = {}
        for k, v in batch.items():
            v = np.asarray(v)
            blocks[k] = v[block_slices(v.shape, mesh.config, mesh.coords)]
        if mesh.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(b)).to(
                mesh.device) for k, b in blocks.items()}
        placed = mesh.staging.upload_arrays(list(blocks.values()))
        shard_batch.staged += 1
        shard_batch.staged_bytes += sum(b.nbytes for b in blocks.values())
    return dict(zip(blocks, placed))


shard_batch.staged = 0
shard_batch.staged_bytes = 0


def seq_offset(mesh: Optional[Mesh], local_len: int) -> int:
    """The global index of this rank's first shot."""
    return 0 if mesh is None else mesh.index(AXIS_SEQ) * local_len


def global_block(mesh: Optional[Mesh], shape: Sequence[int],
                 seq_sharded: bool = True
                 ) -> Tuple[Tuple[int, ...], Tuple[slice, ...]]:
    """(the global shape, this rank's index in it) of a local [B, S, ...]
    activation: the batch axis is split over ``data``, and the shot axis
    over ``seq`` when ``seq_sharded``."""
    shape = tuple(shape)
    if mesh is None:
        return shape, tuple(slice(None) for _ in shape)
    nd, ns = mesh.size(AXIS_DATA), mesh.size(AXIS_SEQ) if seq_sharded else 1
    gshape = (shape[0] * nd, shape[1] * ns) + shape[2:]
    d = mesh.index(AXIS_DATA)
    q = mesh.index(AXIS_SEQ) if seq_sharded else 0
    return gshape, (slice(d * shape[0], (d + 1) * shape[0]),
                    slice(q * shape[1], (q + 1) * shape[1]))


# ---------------------------------------------------------------------------
# Parameter layouts: the one-device layout <-> a rank's shard.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """Where a parameter is split over ``model``: dimension ``dim`` of the
    port's tensor, viewed as ``parts`` (None: as it is), cut into equal
    blocks along ``parts[at]``; rank i of the model group holds block i.
    The experts split their leading axis (``Split(0)``); a fused qkv
    weight [3E, E] splits its head width (``Split(0, (3, H, d), 2)``)."""

    dim: int = 0
    parts: Optional[Tuple[int, ...]] = None
    at: int = 0

    def _view(self, shape: Sequence[int], n: int = 1) -> Tuple[int, ...]:
        """``shape`` with ``dim`` expanded into its parts (the split one
        divided by ``n``)."""
        parts = list(self.parts or (shape[self.dim],))
        parts[self.at] //= n
        return (*shape[:self.dim], *parts, *shape[self.dim + 1:])

    def local_shape(self, shape: Sequence[int], n: int) -> Tuple[int, ...]:
        """A rank's shape of a one-device ``shape`` over ``n`` ranks."""
        shape = tuple(shape)
        if shape[self.dim] % n or (self.parts and self.parts[self.at] % n):
            raise ValueError(f"{self} of {shape} does not divide by {n}")
        return (*shape[:self.dim], shape[self.dim] // n, *shape[self.dim + 1:])

    def shard(self, full, n: int, i: int):
        """Block ``i`` of ``n`` of the one-device tensor ``full``."""
        local = self.local_shape(full.shape, n)
        view = self._view(full.shape)
        size = view[self.dim + self.at] // n
        return full.reshape(view).narrow(self.dim + self.at, i * size,
                                         size).reshape(local)

    def join(self, blocks: Sequence):
        """The one-device tensor from the blocks of every rank, in rank
        order (torch tensors or numpy arrays)."""
        n, first = len(blocks), blocks[0]
        shape = list(first.shape)
        shape[self.dim] *= n
        views = [b.reshape(self._view(shape, n)) for b in blocks]
        axis = self.dim + self.at
        cat = (np.concatenate(views, axis) if isinstance(first, np.ndarray)
               else torch.cat(views, axis))
        return cat.reshape(shape)


def splits(split) -> Dict[str, Split]:
    """``split`` as {name: Split}: a mapping as it is, an iterable of names
    each split along its leading axis (the experts' layout)."""
    if isinstance(split, Mapping):
        return dict(split)
    return {name: Split() for name in split}


def shard_tensors(full: Dict[str, torch.Tensor],
                  local_shapes: Dict[str, Tuple[int, ...]],
                  split, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This rank's tensors from the one-device layout ``full``: every name
    of ``local_shapes`` is taken whole, except those in ``split`` ({name:
    :class:`Split`}, or names split along their leading axis), of which
    the rank takes its block along ``model``. Names ``full`` holds and the
    rank does not (other ranks' stages) are left out."""
    split = splits(split)
    out = {}
    for name, shape in local_shapes.items():
        t = full[name]
        if name in split and mesh is not None:
            t = split[name].shard(t, mesh.size(AXIS_MODEL),
                                  mesh.index(AXIS_MODEL))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {tuple(t.shape)} does not fit this "
                             f"rank's {tuple(shape)}")
        out[name] = t
    return out


def gather_tensors(local: Dict[str, torch.Tensor], split,
                   mesh: Optional[Mesh], order: Sequence[str]
                   ) -> Dict[str, torch.Tensor]:
    """The one-device layout (names in ``order``) from each rank's tensors
    along ``model``: the ``split`` ones joined in rank order, every other
    name from the first rank that holds it. A collective over the model
    group; CPU tensors out."""
    local = {k: v.detach().cpu() for k, v in local.items()}
    if mesh is None or mesh.size(AXIS_MODEL) == 1:
        return {k: local[k] for k in order}
    parts: List[Optional[dict]] = [None] * mesh.size(AXIS_MODEL)
    dist.all_gather_object(parts, local, group=mesh.groups[AXIS_MODEL])
    return merge_shards(parts, split, order)


def merge_shards(parts: Sequence[dict], split, order: Sequence[str]) -> dict:
    """The one-device layout from the tensors of the ranks of one ``model``
    group, in rank order (:func:`gather_tensors`)."""
    split = splits(split)
    out = {}
    for name in order:
        held = [p[name] for p in parts if name in p]
        if not held:
            raise ValueError(f"no rank holds {name}")
        out[name] = split[name].join(held) if name in split else held[0]
    return out
