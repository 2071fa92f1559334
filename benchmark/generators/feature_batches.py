"""Batches of per-shot features, the input of a training job.

Parameters (a traffic file's ``batches``):

- ``videos``: videos a batch;
- ``bucket``: the shot axis every batch is padded to;
- ``shots``: ``[low, high]``: the videos' shot counts are the pool's
  ``pool * videos`` counts spread evenly over that range, in an order
  drawn from the seed, so every seed trains on the same set of lengths;
- ``pool``: distinct batches, cycled through in order.

Each video's visual and audio rows are standard normal and its targets
uniform in [0, 1) on its shots, zero past them, with a mask of ones on
its shots; the batch is host NumPy, as a loader hands it to a trainer.
The numbers are drawn on ``device`` from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def shot_counts(batches: dict, seed: int) -> np.ndarray:
    """[pool, videos] shot counts."""
    n = batches["pool"] * batches["videos"]
    low, high = batches["shots"]
    counts = np.rint(np.linspace(low, high, n)).astype(np.int64)
    order = np.random.default_rng(seed % 2 ** 63).permutation(n)
    return counts[order].reshape(batches["pool"], batches["videos"])


def make(batches: dict, model: dict, seed: int, device
         ) -> List[Dict[str, np.ndarray]]:
    """The pool of host batches {visual, audio, targets, mask}."""
    counts = shot_counts(batches, seed)
    pool, b, s = batches["pool"], batches["videos"], batches["bucket"]
    if counts.max() > s:
        raise ValueError(f"shot counts up to {counts.max()} exceed the "
                         f"bucket {s}")
    mixed = np.random.SeedSequence([seed % 2 ** 63, 1]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device).manual_seed(int(mixed[0]) % 2 ** 63)
    mask = (torch.arange(s, device=device)[None, None, :]
            < torch.as_tensor(counts, device=device)[..., None]).float()
    out = []
    for i in range(pool):
        m = mask[i]
        visual = torch.randn((b, s, model["visual_dim"]), generator=gen,
                             device=device) * m[..., None]
        audio = torch.randn((b, s, model["audio_dim"]), generator=gen,
                            device=device) * m[..., None]
        targets = torch.rand((b, s), generator=gen, device=device) * m
        out.append({"visual": visual.cpu().numpy(),
                    "audio": audio.cpu().numpy(),
                    "targets": targets.cpu().numpy(),
                    "mask": m.cpu().numpy()})
    return out
