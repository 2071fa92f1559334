"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that patches the port while it is open
and restores it on exit. The tests drive a whole run on the CPU under
each; ``benchmark.control`` reads them on the card at a cell's size.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def _patched(module, name: str, value) -> Iterator[None]:
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def unchanged_state() -> Iterator[None]:
    """Every train step returns its state unchanged: the update is taken
    back, parameters and moments alike."""
    from avsum_torch.train import steps

    make = steps.make_train_step

    def make_unchanged(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state, batch):
            opt = state.optimizer
            keep = [t.detach().clone() for t in opt.params + opt.mu + opt.nu]
            count = opt.count
            state, metrics = step(state, batch)
            with torch.no_grad():
                for dst, src in zip(opt.params + opt.mu + opt.nu, keep):
                    dst.copy_(src)
            opt.count = count
            return state, metrics

        return train_step

    with _patched(steps, "make_train_step", make_unchanged):
        yield


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    """Half of each batch is left out and the mean taken over the rest:
    the second half of the videos masked out, or of the shots where the
    batch holds one video."""
    from avsum_torch.train import steps

    place = steps.shard_batch_dict

    def place_half(batch, mesh):
        out = place(batch, mesh)
        mask = out["mask"].clone()
        if mask.shape[0] > 1:
            mask[mask.shape[0] // 2:] = 0
        else:
            mask[:, mask.shape[1] // 2:] = 0
        return {**out, "mask": mask}

    with _patched(steps, "shard_batch_dict", place_half):
        yield


@contextlib.contextmanager
def altered_scores(factor: float = 1.01) -> Iterator[None]:
    """Every summary's scores altered where they are produced: the
    scorer's output scaled by ``factor``."""
    from avsum_torch.models import scorer

    forward = scorer.AVScorer.forward

    def scaled(self, *args, **kwargs):
        return forward(self, *args, **kwargs) * factor

    with _patched(scorer.AVScorer, "forward", scaled):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_scores": altered_scores}
