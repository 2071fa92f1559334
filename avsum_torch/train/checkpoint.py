"""Checkpoints of a :class:`TrainState` (``avsum_tpu/train/checkpoint.py``,
which uses Orbax).

``DIR/<step>/state.pt`` holds ``torch.save`` of the model's state_dict,
the optimizer (update count, Adam moments), the step and the EMA;
``DIR/<step>/meta.json`` the caller's meta (the epoch). A checkpoint is
written under a temporary name and renamed into place, so a reader never
sees half of one; the newest ``keep`` are kept. The learning-rate
schedule is a function of the step, so restoring the step restores it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Tuple

import torch

from avsum_torch.train.steps import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             meta: Optional[dict] = None) -> str:
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "ema": state.ema},
                   os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as fh:
            json.dump(meta or {}, fh)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def load(self, step: Optional[int] = None) -> Tuple[Optional[dict], dict]:
        """-> (the saved payload on the CPU, meta); (None, {}) when the
        directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, {}
        path = os.path.join(self.directory, str(step))
        payload = torch.load(os.path.join(path, STATE_FILE),
                             map_location="cpu", weights_only=True)
        with open(os.path.join(path, META_FILE)) as fh:
            return payload, json.load(fh)

    def restore(self, template: TrainState, step: Optional[int] = None
                ) -> Tuple[Optional[TrainState], Optional[dict]]:
        """Load the latest (or ``step``'s) checkpoint into ``template`` in
        place; -> (template, meta), or (None, None) if there is none."""
        payload, meta = self.load(step)
        if payload is None:
            return None, None
        template.model.load_state_dict(payload["model"])
        template.optimizer.load_state_dict(payload["optimizer"])
        if (payload["ema"] is None) != (template.ema is None):
            raise ValueError("the checkpoint and train.ema_decay disagree "
                             "on whether an EMA is kept")
        if template.ema is not None:
            with torch.no_grad():
                for name, value in payload["ema"].items():
                    template.ema[name].copy_(value)
        return template, meta
