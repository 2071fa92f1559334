"""The trainer (``avsum_tpu/train/trainer.py``): epochs over padded
batches, a per-epoch reshuffle, JSONL scalars every ``log_every`` steps,
an eval hook, checkpoints, and scoring of whole videos.

The train step's metrics stay on the device except at ``log_every``
steps and once per epoch, where the host reads them.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from avsum_torch.data.batching import pad_batch
from avsum_torch.summary.metrics import evaluate_scores
from avsum_torch.train.checkpoint import CheckpointManager
from avsum_torch.train.config import Config
from avsum_torch.train.steps import (
    TrainState,
    apply_matmul_precision,
    batch_to_device,
    check_single_device,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from avsum_torch.utils.logging import JsonlLogger

log = logging.getLogger("avsum_torch.train")


class Trainer:
    """Drives (model, config) over padded numpy batches on ``device``.

    ``batches_fn(epoch)`` yields dicts with visual [B,S,Dv], audio
    [B,S,Da], targets [B,S] and mask [B,S] (``avsum_torch.data.batching``).
    """

    def __init__(self, model: nn.Module, config: Config,
                 total_steps: int = 10_000, device="cpu"):
        check_single_device(config.mesh)
        apply_matmul_precision(config.train.matmul_precision)
        if config.train.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.total_steps = total_steps
        self.train_step = make_train_step(self.model, config.train.seed,
                                          config.train.ema_decay)
        self.eval_step = make_eval_step(self.model)
        self.state: Optional[TrainState] = None
        self.ckpt = CheckpointManager(config.train.checkpoint_dir,
                                      keep=config.train.keep_checkpoints)
        self.logger = JsonlLogger(config.train.log_path)
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
                batch = batch_to_device(batch, self.device)
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
        batch = batch_to_device(pad_batch([example], bucket), self.device)
        out = self.eval_step(self.eval_params, batch)
        return out["preds"].cpu().numpy()[0, :s]

    def evaluate_videos(self, batches: Iterable[Dict]) -> Dict[str, float]:
        """Per-video metric means (each video with >= 2 valid shots
        contributes one F1 / rho / tau)."""
        per_video: List[Dict[str, float]] = []
        for batch in batches:
            preds = self.eval_step(self.eval_params,
                                   batch_to_device(batch, self.device))
            preds = preds["preds"].cpu().numpy()
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
