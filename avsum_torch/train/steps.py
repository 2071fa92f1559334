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

PyTorch runs eagerly and updates parameters in place; the JAX step is a
pure function of the state. Only one device is supported: a mesh of more
than one raises (``ROADMAP.md`` A10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from avsum_torch.train.config import MeshShape, TrainConfig

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


def check_single_device(mesh: MeshShape) -> None:
    """The port trains on one device: a mesh with more raises."""
    sizes = {"seq": mesh.seq, "model": mesh.model}
    if not mesh.auto_data:
        sizes["data"] = mesh.data
    big = {k: n for k, n in sizes.items() if n > 1}
    if big:
        raise ValueError(
            f"mesh {big} needs more than one device; avsum_torch trains on "
            "one (parallelism is ROADMAP.md A10): set mesh.seq=1, "
            "mesh.model=1 and mesh.data=1")


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
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update; -> the global norm of ``grads`` (unclipped).

        Multi-tensor (``torch._foreach_*``) ops, so an update is a few
        launches whatever the number of parameters, and no value is read
        back to the host."""
        grads = list(grads)
        g_norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
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


def make_train_step(model: nn.Module, seed: int = 0, ema_decay: float = 0.0
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """-> ``train_step(state, batch) -> (state, metrics)``; metrics are
    device scalars (loss, grad_norm, pred_mean), read by the caller when
    it needs them."""

    def train_step(state: TrainState, batch: Batch):
        model.train()
        preds = model(batch["visual"], batch["audio"], batch["mask"],
                      generator=dropout_generator(seed, state.step))
        loss = masked_mse(preds, batch["targets"], batch["mask"])
        params: List[torch.Tensor] = state.optimizer.params
        grads = torch.autograd.grad(loss, params)
        grad_norm = state.optimizer.step(grads)
        if ema_decay > 0:
            with torch.no_grad():
                ema = [state.ema[name] for name, _ in model.named_parameters()]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "pred_mean": preds.detach().mean()}
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module
                   ) -> Callable[[Dict[str, torch.Tensor], Batch], Dict]:
    """-> ``eval_step(params, batch) -> {"preds", "loss"}``: the model in
    eval mode with ``params`` (name -> tensor) in place of its own."""

    @torch.no_grad()
    def eval_step(params: Dict[str, torch.Tensor], batch: Batch):
        model.eval()
        preds = torch.func.functional_call(
            model, params, (batch["visual"], batch["audio"], batch["mask"]))
        return {"preds": preds,
                "loss": masked_mse(preds, batch["targets"], batch["mask"])}

    return eval_step
