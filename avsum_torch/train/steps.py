"""Train and eval steps (``avsum_tpu/train/steps.py``).

- masked MSE: padded shots contribute nothing;
- the optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
  adamw(warmup_cosine_decay_schedule, weight_decay))`` written out:
  the schedule is read at the update count *before* the update (so the
  first update has lr 0 when warming up from 0), clipping scales by
  ``max_norm / g_norm`` only when ``g_norm >= max_norm`` (no epsilon),
  Adam has b1 0.9, b2 0.999, eps 1e-8 with bias correction, and weight
  decay applies to every parameter, biases and LayerNorms included;
- ``grad_norm`` is the global norm before clipping;
- EMA (``train.ema_decay`` > 0) of the parameters after each update;
- dropout masks come from a CPU generator seeded from (``train.seed``,
  step), the counterpart of ``fold_in(PRNGKey(seed), step)``, so a resumed
  run draws the masks an uninterrupted one would.

On a mesh (:mod:`avsum_torch.parallel.mesh`) each rank steps on its block
of the padded batch (:func:`shard_batch_dict`) and the step computes what
the one-device step computes on that padded batch: the loss divides each
rank's sum of squared errors by the mask count of the whole batch, the
gradients of every parameter are summed over the ranks that share its
``model`` coordinate (``data`` x ``seq``), and the global norm counts each
parameter once: the replicated ones on this rank, the ones split over
``model`` (experts, pipeline stages, the matrices under tensor
parallelism) summed over it. Every ``model`` rank computes the same
loss, so nothing is summed over ``model`` but those squares.

Tensor parallelism (JAX's ``param_partition_spec`` / ``state_shardings``
/ ``shard_state`` and ``make_train_step(..., state_sharding=...)``):
:func:`shard_state` gives each rank its block of every parameter JAX's
rule splits over ``model`` (:mod:`avsum_torch.parallel.tensor`), with
the same blocks of Adam's moments and of the EMA; the step over such a
state runs the split products column-parallel. Without it, as the JAX
trainer does, the parameters are whole on every rank but the experts'
and the stages'.

PyTorch runs eagerly and updates parameters in place; the JAX step is a
pure function of the state. A step opens the spans ``avsum.forward`` (the
model put in train mode, its call and the loss), ``avsum.backward`` (the
gradients and, on a mesh, their sum over the replicas) and
``avsum.optimizer`` (the global norm, the update and the EMA), in that
order; the batch's placement opens ``avsum.place_batch``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from avsum_torch.parallel.comm import all_reduce
from avsum_torch.parallel.mesh import (  # noqa: F401  (the JAX names)
    AXIS_MODEL,
    REPLICA,
    pad_batch_for_mesh,
    shard_batch as shard_batch_dict,
    shard_tensors,
)
from avsum_torch.parallel.tensor import (  # noqa: F401  (the JAX names)
    param_partition_spec,
    state_shardings,
)
from avsum_torch.train.config import TrainConfig
from avsum_torch.utils.profiling import annotate

Batch = Dict[str, torch.Tensor]  # visual, audio, targets, mask

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults

# train.matmul_precision -> torch's float32 matmul precision; "default"
# leaves the process's settings alone, as the JAX Trainer does
_PRECISION = {"highest": "highest", "float32": "highest",
              "high": "high", "tensorfloat32": "high", "bfloat16": "medium"}


def apply_matmul_precision(name: str) -> None:
    """Map ``train.matmul_precision`` onto the TF32 switches (process-wide,
    as the JAX setting is): "highest"/"float32" turn TF32 off for matmuls
    and cuDNN, "high"/"tensorfloat32" turn it on, "bfloat16" lets float32
    matmuls run in bfloat16."""
    if name == "default":
        return
    if name not in _PRECISION:
        raise ValueError(f"unknown train.matmul_precision {name!r}")
    torch.set_float32_matmul_precision(_PRECISION[name])
    torch.backends.cudnn.allow_tf32 = _PRECISION[name] != "highest"


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over valid positions only."""
    m = mask.float()
    se = (pred.float() - target.float()) ** 2
    return (se * m).sum() / m.sum().clamp_min(1.0)


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0 -> cfg.lr over warmup_steps,
    then cosine to 0.1 * lr at max(total_steps, warmup_steps + 1))."""
    peak, warm = cfg.lr, cfg.warmup_steps
    decay = max(total_steps, warm + 1) - warm
    alpha = 0.0 if peak == 0.0 else (0.1 * peak) / peak

    def schedule(count: int) -> float:
        if count < warm:  # optax's linear_schedule from 0 to peak
            return (0.0 - peak) * (1.0 - count / warm) + peak
        c = min(count - warm, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                       + alpha)

    return schedule


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` over ``params``, which it
    updates in place. ``count`` is optax's update count."""

    def __init__(self, params: Sequence[torch.Tensor], cfg: TrainConfig,
                 total_steps: int):
        self.params = list(params)
        self.schedule = lr_schedule(cfg, total_steps)
        self.max_norm = cfg.grad_clip
        self.weight_decay = cfg.weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update; -> the global norm of ``grads`` (unclipped),
        or ``g_norm`` when the caller gives it (the mesh's global norm).

        Multi-tensor (``torch._foreach_*``) ops, so an update is a few
        launches whatever the number of parameters, and no value is read
        back to the host."""
        grads = list(grads)
        if g_norm is None:
            g_norm = torch.stack(torch._foreach_norm(grads)).square().sum(
                ).sqrt()
        scale = torch.where(g_norm < self.max_norm, 1.0,
                            self.max_norm / g_norm)
        grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads),
                            alpha=1 - B2)
        update = torch._foreach_div(self.mu, 1.0 - B1 ** self.count)
        denom = torch._foreach_div(self.nu, 1.0 - B2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return g_norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the EMA of the
    parameters (name -> tensor; None when ``train.ema_decay`` is 0)."""

    model: nn.Module
    optimizer: AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None

    @property
    def step(self) -> int:
        return self.optimizer.count

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       total_steps: int = 10_000) -> TrainState:
    ema = None
    if cfg.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model, AdamW(model.parameters(), cfg, total_steps), ema)


def dropout_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's dropout seeds, from (seed, step)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(mixed[0]))


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Batch:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def shard_state(state: TrainState, mesh) -> TrainState:
    """``state`` (its model in the one-device layout) placed on ``mesh``
    with tensor parallelism over ``model``: a scorer built for the mesh
    whose matrices are split by :func:`state_shardings`, holding this
    rank's block of every parameter, and the same blocks of Adam's
    moments and of the EMA, on the mesh's device. The optimizer keeps its
    update count and schedule."""
    from avsum_torch.models.scorer import to_mesh

    full = state.model
    if getattr(full, "mesh", None) is not None:
        raise ValueError("shard_state takes a state in the one-device "
                         "layout (a model built without a mesh)")
    local = to_mesh(full, mesh, tensor_parallel=mesh.world > 1)
    split = local.split_names() if mesh.world > 1 else {}
    shapes = {n: tuple(p.shape) for n, p in local.named_parameters()}
    names = [n for n, _ in full.named_parameters()]

    def placed(tensors: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        part = shard_tensors(tensors, shapes, split, mesh)
        return [part[n].to(mesh.device).clone() for n in shapes]

    optimizer = copy.copy(state.optimizer)
    optimizer.params = list(local.parameters())
    optimizer.mu = placed(dict(zip(names, state.optimizer.mu)))
    optimizer.nu = placed(dict(zip(names, state.optimizer.nu)))
    ema = None
    if state.ema is not None:
        ema = dict(zip(shapes, placed(state.ema)))
    return TrainState(local, optimizer, ema)


def _model_split(model: nn.Module) -> set:
    """Names of the parameters split over ``model``: the experts, the
    stages this rank holds and the tensor-parallel matrices."""
    names = set(getattr(model, "split_names", dict)())
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.size(AXIS_MODEL) > 1:
        names |= {n for n, _ in model.named_parameters() if ".stages." in n}
    return names


def _check_placement(model: nn.Module, state_sharding: dict) -> None:
    """Raise unless ``model`` holds the layout ``state_sharding`` gives."""
    want = {n for n, _ in model.named_parameters()
            if state_sharding.get(n) is not None}
    have = _model_split(model)
    if want != have:
        raise ValueError(
            "the state is not placed by state_sharding (make it with "
            f"shard_state): split {sorted(want ^ have)[:4]} differ")


def _sum_over(tensors: List[torch.Tensor], mesh, axis: str
              ) -> List[torch.Tensor]:
    """Each tensor summed over ``axis``, one collective per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          mesh, axis)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view_as(tensors[i])
            at += n
    return out


def global_norm(grads: Sequence[torch.Tensor], split: Sequence[bool],
                mesh=None) -> torch.Tensor:
    """The norm of the whole model's gradient: the squares of the
    replicated gradients here, those of the ``split`` ones summed over
    ``model``."""
    sq = [g.float().square().sum() for g in grads]
    zero = torch.zeros((), device=grads[0].device)
    rep = sum((q for q, s in zip(sq, split) if not s), zero)
    shard = sum((q for q, s in zip(sq, split) if s), zero)
    return (rep + all_reduce(shard, mesh, AXIS_MODEL)).sqrt()


def _mesh_loss(preds, batch, mesh):
    """(this rank's share of the global masked MSE, the global count)."""
    m = batch["mask"].float()
    count = all_reduce(m.sum(), mesh, REPLICA).clamp_min(1.0)
    se = (preds.float() - batch["targets"].float()) ** 2
    return (se * m).sum() / count


def make_train_step(model: nn.Module, mesh=None, seed: int = 0,
                    state_sharding: Optional[dict] = None,
                    ema_decay: float = 0.0
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """-> ``train_step(state, batch) -> (state, metrics)``; metrics are
    device scalars (loss, grad_norm, pred_mean), read by the caller when
    it needs them. With ``mesh`` the batch is this rank's block and the
    metrics are those of the whole batch. The step runs ``state.model``.

    ``state_sharding`` (:func:`state_shardings` of the model on ``mesh``):
    the state is tensor-parallel over ``model`` (:func:`shard_state`); a
    state placed otherwise raises. None: the model as built for the mesh
    (``to_mesh``), matrices whole. ``model`` is taken for JAX's
    signature."""
    if mesh is not None and mesh.world == 1:
        mesh = None

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        if mesh is not None and state_sharding is not None:
            _check_placement(model, state_sharding)
        params: List[torch.Tensor] = state.optimizer.params
        with annotate("avsum.forward"):
            model.train()
            preds = model(batch["visual"], batch["audio"], batch["mask"],
                          generator=dropout_generator(seed, state.step))
            loss = (masked_mse(preds, batch["targets"], batch["mask"])
                    if mesh is None else _mesh_loss(preds, batch, mesh))
        with annotate("avsum.backward"):
            grads = torch.autograd.grad(loss, params)
            if mesh is not None:
                grads = _sum_over(list(grads), mesh, REPLICA)
        with annotate("avsum.optimizer"):
            g_norm = None
            if mesh is not None:
                split_names = _model_split(model)
                g_norm = global_norm(grads, [
                    n in split_names for n, _ in model.named_parameters()],
                    mesh)
            grad_norm = state.optimizer.step(grads, g_norm)
            if ema_decay > 0:
                with torch.no_grad():
                    ema = [state.ema[name]
                           for name, _ in model.named_parameters()]
                    torch._foreach_mul_(ema, ema_decay)
                    torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        if mesh is None:
            pred_mean = preds.detach().mean()
        else:
            loss = all_reduce(loss.detach(), mesh, REPLICA)
            pred_mean = all_reduce(preds.detach().sum(), mesh, REPLICA) / (
                preds.numel() * mesh.size(REPLICA))
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "pred_mean": pred_mean}
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, mesh=None
                   ) -> Callable[[Dict[str, torch.Tensor], Batch], Dict]:
    """-> ``eval_step(params, batch) -> {"preds", "loss"}``: the model in
    eval mode with ``params`` (name -> tensor) in place of its own. With
    ``mesh``: this rank's block of the predictions, the whole batch's
    loss."""
    if mesh is not None and mesh.world == 1:
        mesh = None

    @torch.no_grad()
    def eval_step(params: Dict[str, torch.Tensor], batch: Batch):
        model.eval()
        preds = torch.func.functional_call(
            model, params, (batch["visual"], batch["audio"], batch["mask"]))
        if mesh is None:
            loss = masked_mse(preds, batch["targets"], batch["mask"])
        else:
            loss = all_reduce(_mesh_loss(preds, batch, mesh), mesh, REPLICA)
        return {"preds": preds, "loss": loss}

    return eval_step
