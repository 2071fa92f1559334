"""Tensor parallelism over ``model``: JAX's placement of the train state
(``avsum_tpu/train/steps.py``: ``param_partition_spec``,
``state_shardings``) and the compute that GSPMD derives from it, written
out.

**Placement.** JAX's rule, applied to each parameter in JAX's layout (the
converter's name map, :mod:`avsum_torch.convert`): a leaf of two or more
dimensions whose last dimension divides by the ``model`` axis is split
along it; vectors are whole; every leaf under ``stages`` splits its
leading stage axis instead (a rank holds its stage). In the port's own
tensors that is (:class:`~avsum_torch.parallel.mesh.Split`):

- a Dense kernel [in, out] is Linear's weight [out, in]: rows;
- the attention's ``qkv`` kernel [E, 3, H, d] and bias [3, H, d] split
  d: Linear(E, 3E)'s rows viewed as [3, H, d] (strided); cross fusion's
  ``q`` [E, H, d] and ``kv`` [E, 2, H, d] likewise; ``out`` [H, d, E]
  splits E, its rows;
- the LSTM's ``wi`` [F, 4H] and ``wh`` [H, 4H] split 4H, across the
  gate boundaries; the TCN's kernel [K, Cin, Cout] splits Cout, the
  Conv1d weight's dimension 0; the MoE gate [D, E] splits E;
- the experts keep the leading-axis split of expert parallelism (the same
  bytes as JAX's split of their last axis) and the stages stay one a
  rank, as without this module.

The state is the parameters with AdamW's moments and the EMA, which
mirror them, as JAX's opt state does.

**Compute** (every ``model`` rank computes the same loss from the same,
replicated activations):

- a product with a split weight (:class:`ColumnLinear`: the modality
  MLPs, q/k/v and the attention output, the blocks' MLPs, the scorer's
  hidden layer, the MoE gate; the LSTM's input projection) runs
  column-parallel: the input enters through ``comm.copy_to`` (its
  gradient is summed over ``model``), each rank multiplies by its block
  of the weight, and the output features are gathered with
  ``comm.gather_from``, whose backward keeps the rank's block of the
  cotangent without a sum;
- a weight used inside a recurrence or a convolution (the LSTM's ``wh``,
  the TCN's kernels; :class:`GatheredConv1d`) is gathered before use,
  once a layer a step, by the same ``gather_from``;
- the attention core runs on the gathered q, k, v at full heads on every
  rank: the flash kernels (K2 forward, B3 and B4 backward) at S >= 512,
  the ring before them when ``seq`` > 1. GSPMD gathers around a
  ``pallas_call`` the same way.

The one-device module names are kept, so checkpoints stay in the
one-device layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.models.attention import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
)
from avsum_torch.models.moe import EXPERT_PARAMS, MoEFFN
from avsum_torch.models.temporal import LSTMCellScan
from avsum_torch.parallel.comm import copy_to, gather_from
from avsum_torch.parallel.mesh import AXIS_MODEL, Split

STAGES = "stages"  # the placement of a stage's parameter: its rank's whole
EXPERTS = "experts"  # an expert's layout mark in jax_layouts
Placement = Union[Split, str, None]


def model_size(mesh) -> int:
    """The ``model`` axis of a :class:`Mesh`, a :class:`MeshConfig` or an
    int (1 for None)."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    if hasattr(mesh, "groups"):
        return mesh.size(AXIS_MODEL)
    return mesh.model


def param_partition_spec(x, mesh) -> Tuple[Optional[str], ...]:
    """JAX's decision for one parameter or optimizer leaf given in JAX's
    layout (a tensor, an array or a shape): ``(None, ..., "model")`` when
    it has two or more dimensions and the last divides by the ``model``
    axis, else ``()`` (replicated)."""
    shape = tuple(getattr(x, "shape", x))
    m = model_size(mesh)
    if m > 1 and len(shape) >= 2 and shape[-1] % m == 0:
        return (None,) * (len(shape) - 1) + (AXIS_MODEL,)
    return ()


def _attention_layouts(prefix: str, mod: nn.Module) -> Dict:
    """{name: (JAX shape, the port's Split of JAX's last axis)} of an
    attention module's parameters."""
    e, h = mod.out.in_features, mod.num_heads
    d = e // h
    fused = ({"qkv": 3} if isinstance(mod, MultiHeadSelfAttention)
             else {"q": None, "kv": 2})
    out = {}
    for name, k in fused.items():
        heads = (h, d) if k is None else (k, h, d)
        split = Split(0, heads, len(heads) - 1)
        out[f"{prefix}{name}.weight"] = ((e, *heads), split)
        out[f"{prefix}{name}.bias"] = (heads, split)
    out[f"{prefix}out.weight"] = ((h, d, e), Split(0))
    out[f"{prefix}out.bias"] = ((e,), None)
    return out


def jax_layouts(model: nn.Module) -> Dict[str, Tuple[Tuple[int, ...],
                                                     Placement]]:
    """{parameter name: (its shape in JAX's layout, where the port splits
    it when JAX splits that layout's last axis)} over a one-device scorer
    (or module). A stage's parameter carries JAX's stacked [n_stages,
    ...] shape and ``STAGES``, an expert's ``EXPERTS``."""
    out: Dict = {}
    for path, mod in model.named_modules():
        pre = f"{path}." if path else ""
        if ".stages." in f".{pre}":
            continue
        if isinstance(mod, (MultiHeadSelfAttention, MultiHeadCrossAttention)):
            out.update(_attention_layouts(pre, mod))
        elif isinstance(mod, nn.Linear) and f"{pre}weight" not in out:
            out[f"{pre}weight"] = ((mod.in_features, mod.out_features),
                                   Split(0))
            if mod.bias is not None:
                out[f"{pre}bias"] = ((mod.out_features,), None)
        elif isinstance(mod, LSTMCellScan):
            out[f"{pre}wi"] = (tuple(mod.wi.shape), Split(1))
            out[f"{pre}wh"] = (tuple(mod.wh.shape), Split(1))
            out[f"{pre}b"] = (tuple(mod.b.shape), None)
        elif isinstance(mod, nn.Conv1d):
            cout, cin, k = mod.weight.shape
            out[f"{pre}weight"] = ((k, cin, cout), Split(0))
            out[f"{pre}bias"] = ((cout,), None)
        elif isinstance(mod, nn.LayerNorm):
            out[f"{pre}weight"] = (tuple(mod.weight.shape), None)
            out[f"{pre}bias"] = (tuple(mod.bias.shape), None)
        elif isinstance(mod, MoEFFN):
            for name in EXPERT_PARAMS:
                out[f"{pre}{name}"] = (tuple(getattr(mod, name).shape),
                                       EXPERTS)
        elif hasattr(mod, "stages"):
            n = len(mod.stages)
            for name, (shape, _) in jax_layouts(mod.stages[0]).items():
                for s in range(n):
                    out[f"{pre}stages.{s}.{name}"] = ((n, *shape), STAGES)
    return out


def one_device(model: nn.Module) -> nn.Module:
    """A one-device scorer of ``model``'s config on the meta device."""
    with torch.device("meta"):
        return type(model)(model.config)


def state_shardings(model: nn.Module, mesh) -> Dict[str, Placement]:
    """{parameter name of the one-device layout: its :class:`Split` in the
    port's tensor, ``STAGES`` (held whole by its stage's rank) or None
    (whole on every rank)}: JAX's ``state_shardings`` on the same config
    and ``model`` axis. Adam's moments and the EMA follow the parameters.

    Where JAX splits an expert's last axis the port splits its leading
    (expert) axis, as expert parallelism holds it; with experts that do
    not divide by the axis the port keeps them whole."""
    m = model_size(mesh)
    out: Dict[str, Placement] = {}
    for name, (shape, place) in jax_layouts(one_device(model)).items():
        if place == STAGES:
            out[name] = STAGES if m > 1 and shape[0] % m == 0 else None
        elif place == EXPERTS:  # MoEFFN's rule for expert parallelism
            out[name] = Split(0) if m > 1 and shape[0] % m == 0 else None
        else:
            out[name] = place if param_partition_spec(shape, m) else None
    return out


def _param(shape, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=like.dtype,
                                    device=like.device))


class ColumnLinear(nn.Module):
    """A Linear whose weight rows (its output features, viewed as
    ``split.parts``) are split over ``model``: the input enters through
    ``copy_to``, the rank's block of the output is computed and the
    blocks are gathered. The bias is split with the rows when JAX's bias
    has two or more dimensions (the attention's); else it is whole on
    every rank, which adds its block in the same product (as the
    one-device Linear adds it: the same rounding, so a ReLU after it cuts
    where the one-device one does) and sums the bias's gradient over
    ``model``. Same parameter names as the Linear it replaces."""

    def __init__(self, linear: nn.Linear, mesh, split: Split,
                 split_bias: bool):
        super().__init__()
        n = mesh.size(AXIS_MODEL)
        self.mesh, self.split_bias, self.split = mesh, split_bias, split
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self.parts = split._view((linear.out_features,), n)
        self.at = split.at
        self.weight = _param(split.local_shape(linear.weight.shape, n),
                             linear.weight)
        self.bias = None
        if linear.bias is not None:
            shape = ((linear.out_features // n,) if split_bias
                     else linear.bias.shape)
            self.bias = _param(shape, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh, bias = self.mesh, self.bias
        x = copy_to(x, mesh, AXIS_MODEL)
        if bias is not None and not self.split_bias:
            bias = self.split.shard(copy_to(bias, mesh, AXIS_MODEL),
                                    mesh.size(AXIS_MODEL),
                                    mesh.index(AXIS_MODEL))
        y = F.linear(x, self.weight, bias)
        lead = y.shape[:-1]
        return gather_from(y.reshape(*lead, *self.parts), mesh, AXIS_MODEL,
                           len(lead) + self.at).reshape(*lead,
                                                        self.out_features)


class GatheredConv1d(nn.Conv1d):
    """A Conv1d whose kernel's output channels are split over ``model``
    and gathered before use (a convolution mixes the shot axis, so it runs
    whole on every rank); the bias is whole."""

    def __init__(self, conv: nn.Conv1d, mesh):
        super().__init__(conv.in_channels, conv.out_channels,
                         conv.kernel_size, conv.stride, conv.padding,
                         conv.dilation, conv.groups, conv.bias is not None,
                         conv.padding_mode, device="meta")
        self.mesh = mesh
        self.weight = _param(Split(0).local_shape(
            conv.weight.shape, mesh.size(AXIS_MODEL)), conv.weight)
        if conv.bias is not None:
            self.bias = _param(conv.bias.shape, conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = gather_from(self.weight, self.mesh, AXIS_MODEL, 0)
        return self._conv_forward(x, weight, self.bias)


def parallelize(model: nn.Module, mesh) -> Dict[str, Split]:
    """Turn ``model`` (a scorer built for ``mesh``) into its tensor-parallel
    form in place: each module with a split weight is replaced by its
    column-parallel or gathered form holding the rank's block (values
    uninitialized: load them with ``shard_tensors``) -> {name: Split} of
    every split parameter, the experts' included."""
    if model_size(mesh) == 1:
        return {}
    tp = {name: place for name, place in state_shardings(model, mesh).items()
          if isinstance(place, Split)}
    n = mesh.size(AXIS_MODEL)
    for path, mod in list(model.named_modules()):
        pre = f"{path}." if path else ""
        weight = tp.get(f"{pre}weight")
        parent, _, leaf = path.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        if isinstance(mod, nn.Linear) and weight is not None:
            setattr(owner, leaf, ColumnLinear(
                mod, mesh, weight, f"{pre}bias" in tp))
        elif isinstance(mod, nn.Conv1d) and weight is not None:
            setattr(owner, leaf, GatheredConv1d(mod, mesh))
        elif isinstance(mod, LSTMCellScan) and f"{pre}wi" in tp:
            mod.tp_mesh = mesh
            for name in ("wi", "wh"):
                p = getattr(mod, name)
                setattr(mod, name, _param(tp[f"{pre}{name}"].local_shape(
                    p.shape, n), p))
    return tp
