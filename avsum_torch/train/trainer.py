"""The trainer (``avsum_tpu/train/trainer.py``): epochs over padded
batches, a per-epoch reshuffle, JSONL scalars every ``log_every`` steps,
an eval hook, checkpoints, and scoring of whole videos.

The train step's metrics stay on the device except at ``log_every``
steps and once per epoch, where the host reads them. With
``train.debug_nans`` the train and eval steps run under
:func:`avsum_torch.utils.debug.debug_nans` (every operation checked for
NaNs, forward and backward, as ``jax_debug_nans`` does in the JAX
trainer).

The mesh comes from ``config.mesh`` and the world (``torchrun`` starts
one process per rank; a mesh larger than the world raises, naming that
command). Every rank reads the same shuffled batches and keeps its block;
the primary rank alone logs and writes checkpoints; ``score_video`` and
``evaluate_videos`` gather the predictions over ``data`` x ``seq``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from avsum_torch.data.batching import pad_batch
from avsum_torch.models.scorer import to_mesh
from avsum_torch.parallel.comm import all_gather
from avsum_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_SEQ,
    build_mesh,
    mesh_config,
)
from avsum_torch.summary.metrics import evaluate_scores
from avsum_torch.train.checkpoint import CheckpointManager
from avsum_torch.train.config import Config
from avsum_torch.train.steps import (
    TrainState,
    apply_matmul_precision,
    create_train_state,
    make_eval_step,
    make_train_step,
    shard_batch_dict,
)
from avsum_torch.utils.debug import debug_nans
from avsum_torch.utils.logging import JsonlLogger

log = logging.getLogger("avsum_torch.train")


def _checking_nans(step: Callable) -> Callable:
    def checking(*args):
        with debug_nans():
            return step(*args)

    return checking


class Trainer:
    """Drives (model, config) over padded numpy batches on ``device``
    (the card unless the caller asks for the CPU; ``cuda`` is
    ``cuda:{LOCAL_RANK % device_count}`` on a mesh).

    ``model`` is a one-device scorer; on a mesh of more than one rank the
    trainer keeps this rank's share of it (``self.model``,
    :func:`avsum_torch.models.scorer.to_mesh`). ``mesh``: default, the
    mesh of ``config.mesh`` over the world, with ``backend`` (default
    NCCL on the card, gloo on the CPU; ranks that share one card need
    gloo).

    ``batches_fn(epoch)`` yields dicts with visual [B,S,Dv], audio
    [B,S,Da], targets [B,S] and mask [B,S] (``avsum_torch.data.batching``).
    """

    def __init__(self, model: nn.Module, config: Config,
                 total_steps: int = 10_000, device="cuda", mesh=None,
                 backend: Optional[str] = None):
        self.mesh = mesh if mesh is not None else build_mesh(
            mesh_config(config.mesh), device, backend)
        apply_matmul_precision(config.train.matmul_precision)
        self.config = config
        self.device = self.mesh.device
        self.model = to_mesh(model, self.mesh)
        self.total_steps = total_steps
        self.train_step = make_train_step(self.model, self.mesh,
                                          config.train.seed,
                                          ema_decay=config.train.ema_decay)
        self.eval_step = make_eval_step(self.model, self.mesh)
        if config.train.debug_nans:
            # every operation of the steps checked, forward and backward,
            # as jax_debug_nans checks every primitive; anomaly mode adds
            # the forward's traceback to an error in the backward
            torch.autograd.set_detect_anomaly(True)
            self.train_step = _checking_nans(self.train_step)
            self.eval_step = _checking_nans(self.eval_step)
        self.state: Optional[TrainState] = None
        self.ckpt = CheckpointManager(config.train.checkpoint_dir,
                                      config.train.keep_checkpoints,
                                      self.mesh)
        self.logger = JsonlLogger(config.train.log_path
                                  if self.mesh.is_primary else None)
        self.last_meta: Dict = {}

    def init_state(self) -> TrainState:
        self.state = create_train_state(self.model, self.config.train,
                                        self.total_steps)
        return self.state

    def maybe_restore(self) -> Optional[int]:
        """Resume from the latest checkpoint if there is one; its meta
        (with the epoch it was written at) lands in ``last_meta``."""
        if self.state is None:
            raise RuntimeError("call init_state() before restore")
        restored, meta = self.ckpt.restore(self.state)
        if restored is None:
            return None
        self.last_meta = meta or {}
        log.info("restored checkpoint at step %d (epoch %s)",
                 self.state.step, self.last_meta.get("epoch"))
        return self.state.step

    def fit(self, batches_fn: Callable[[int], Iterable[Dict]],
            epochs: Optional[int] = None,
            eval_fn: Optional[Callable[[], Dict[str, float]]] = None,
            start_epoch: int = 0) -> TrainState:
        cfg = self.config.train
        epochs = cfg.epochs if epochs is None else epochs
        if self.state is None:
            self.init_state()
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            losses: List[torch.Tensor] = []
            for batch in batches_fn(epoch):
                batch = shard_batch_dict(batch, self.mesh)
                self.state, metrics = self.train_step(self.state, batch)
                if self.state.step % cfg.log_every == 0:
                    record = self.logger.log(
                        self.state.step, epoch=epoch,
                        **{k: v.item() for k, v in metrics.items()})
                    log.info("step %d epoch %d loss %.5f grad %.3f",
                             self.state.step, epoch, record["loss"],
                             record["grad_norm"])
                losses.append(metrics["loss"])
            mean_loss = torch.stack(losses).mean().item() if losses else 0.0
            log.info("epoch %d done: mean loss %.5f (%.2fs)", epoch,
                     mean_loss, time.perf_counter() - t0)
            if eval_fn is not None and (epoch + 1) % cfg.eval_every_epochs == 0:
                scores = eval_fn()
                self.logger.log(self.state.step, epoch=epoch, **scores)
                log.info("eval @ epoch %d: %s", epoch, scores)
            if (epoch + 1) % cfg.save_every_epochs == 0 or epoch == epochs - 1:
                self.ckpt.save(self.state.step, self.state, {"epoch": epoch})
        return self.state

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The EMA of the parameters when ``train.ema_decay`` > 0, the
        trained parameters otherwise."""
        if self.state.ema is not None:
            return self.state.ema
        return self.state.params()

    def score_video(self, example, base_bucket: Optional[int] = None
                    ) -> np.ndarray:
        """Score every shot of one video: the shot axis is padded up a
        power-of-two ladder from ``base_bucket`` (``data.max_shots``), so
        no shot past the training bucket is dropped."""
        bucket = base_bucket or self.config.data.max_shots
        s = example.n_shots
        while bucket < s:
            bucket *= 2
        return self.predict(pad_batch([example], bucket))[0, :s]

    def predict(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """The eval step's [B, S] predictions for a host batch: each
        rank's block gathered over ``data`` x ``seq``, the mesh's padding
        cut off."""
        out = self.eval_step(self.eval_params,
                             shard_batch_dict(batch, self.mesh))
        preds = all_gather(all_gather(out["preds"], self.mesh, AXIS_SEQ, 1),
                           self.mesh, AXIS_DATA, 0)
        b, s = batch["mask"].shape
        return preds.cpu().numpy()[:b, :s]

    def evaluate_videos(self, batches: Iterable[Dict]) -> Dict[str, float]:
        """Per-video metric means (each video with >= 2 valid shots
        contributes one F1 / rho / tau)."""
        per_video: List[Dict[str, float]] = []
        for batch in batches:
            preds = self.predict(batch)
            for i in range(preds.shape[0]):
                m = batch["mask"][i] > 0
                if m.sum() < 2:
                    continue
                per_video.append(evaluate_scores(preds[i], batch["targets"][i],
                                                 m))
        if not per_video:
            return {"f1": 0.0, "spearman": 0.0, "kendall": 0.0}
        return {k: float(np.nanmean([v[k] for v in per_video]))
                for k in per_video[0]}
