"""Checkpoints of a :class:`TrainState` (``avsum_tpu/train/checkpoint.py``,
which uses Orbax).

``DIR/<step>/state.pt`` holds ``torch.save`` of the model's state_dict,
the optimizer (update count, Adam moments), the step and the EMA;
``DIR/<step>/meta.json`` the caller's meta (the epoch). A checkpoint is
written under a temporary name and renamed into place, so a reader never
sees half of one; the newest ``keep`` are kept. The learning-rate
schedule is a function of the step, so restoring the step restores it.

A checkpoint is always in the one-device layout, so it restores at any
mesh and placement ("restore works across mesh layouts", as Orbax's does
in JAX). On a mesh every rank gathers the experts, the stages and the
tensor-parallel blocks of its ``model`` group
(:func:`avsum_torch.parallel.mesh.gather_tensors`), the primary rank
writes, and the others wait at a barrier; a restore takes each rank's
share of the template's layout
(:func:`~avsum_torch.parallel.mesh.shard_tensors`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from avsum_torch.parallel.mesh import (
    AXIS_MODEL,
    Split,
    gather_tensors,
    shard_tensors,
)
from avsum_torch.parallel.tensor import one_device
from avsum_torch.train.steps import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _split(model) -> Dict[str, Split]:
    return dict(getattr(model, "split_names", dict)())


def _one_device_names(model, mesh) -> Tuple[List[str], List[str]]:
    """(state_dict names, parameter names) of ``model``'s one-device
    layout, in its order."""
    full = model
    if mesh is not None and mesh.size(AXIS_MODEL) > 1:
        full = one_device(model)
    return list(full.state_dict()), [n for n, _ in full.named_parameters()]


def _by_name(model, tensors) -> Dict[str, torch.Tensor]:
    return {n: t for (n, _), t in zip(model.named_parameters(), tensors)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        """``mesh``: the training mesh (None: one device)."""
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None

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
        """Write ``state`` at ``step`` (on a mesh: every rank calls it)."""
        payload = self._one_device_payload(state)
        final = os.path.join(self.directory, str(step))
        if self.mesh is None or self.mesh.is_primary:
            os.makedirs(self.directory, exist_ok=True)
            tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, META_FILE), "w") as fh:
                json.dump(meta or {}, fh)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        if self.mesh is not None:
            dist.barrier()
        return final

    def _one_device_payload(self, state: TrainState) -> dict:
        model, mesh = state.model, self.mesh
        split = _split(model)
        sd_names, p_names = _one_device_names(model, mesh)
        opt = state.optimizer.state_dict()
        moments = {k: gather_tensors(_by_name(model, opt[k]), split, mesh,
                                     p_names) for k in ("mu", "nu")}
        ema = state.ema
        if ema is not None:
            ema = gather_tensors(ema, split, mesh, p_names)
        return {"model": gather_tensors(model.state_dict(), split, mesh,
                                        sd_names),
                "optimizer": {"count": opt["count"],
                              "mu": list(moments["mu"].values()),
                              "nu": list(moments["nu"].values())},
                "step": state.step, "ema": ema}

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
        model, mesh = template.model, self.mesh
        split = _split(model)
        _, p_names = _one_device_names(model, mesh)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        model.load_state_dict(shard_tensors(payload["model"], shapes, split,
                                            mesh))
        p_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        opt = payload["optimizer"]
        template.optimizer.load_state_dict({"count": opt["count"], **{
            k: list(shard_tensors(dict(zip(p_names, opt[k])), p_shapes,
                                  split, mesh).values())
            for k in ("mu", "nu")}})
        if (payload["ema"] is None) != (template.ema is None):
            raise ValueError("the checkpoint and train.ema_decay disagree "
                             "on whether an EMA is kept")
        if template.ema is not None:
            ema = shard_tensors(payload["ema"], p_shapes, split, mesh)
            with torch.no_grad():
                for name, value in ema.items():
                    template.ema[name].copy_(value)
        return template, meta
