"""Scorer export (``avsum_tpu/serve/export.py``): ``torch.export`` of the
scorer with its weights in the artifact and symbolic batch and shot axes,
so one artifact scores every padded bucket without any model code.

The JAX package exports StableHLO for a list of platforms; here the
program is exported on one device, and :func:`load_scorer` moves it to
another with ``torch.export.passes.move_to_device_pass``. Inside the
artifact every attention takes the materialized softmax (the chunked
attention's float32 math as one chunk, when ``model.chunk_size`` > 0)
and the BiLSTM the scan operator (``models/attention.py``,
``models/temporal.py``), as the JAX artifact runs its plain attention:
the hand-written kernels are not traced into it. The MoE gate's
threshold top-k, the staged encoder's stages and the TCN's convolutions
trace as they run.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Callable, Union

import torch
from torch import nn

__all__ = ["MAX_EXPORT_SHOTS", "export_scorer", "load_scorer"]

MAX_EXPORT_SHOTS = 16384  # the shot axis's upper bound in the artifact
_EXAMPLE = (2, 40)  # example batch and shots (not 0 or 1: those specialize)


def export_scorer(model: nn.Module, visual_dim: int, audio_dim: int,
                  device="cuda") -> bytes:
    """Export ``model`` (an ``AVScorer``) on ``device`` -> the artifact's
    bytes. The program takes (visual [B, S, visual_dim], audio [B, S,
    audio_dim], mask [B, S]) float32 and returns the [B, S] scores, for
    any B up to 1024 and S from 2 to ``MAX_EXPORT_SHOTS``."""
    dev = torch.device(device)
    model = copy.deepcopy(model).to(dev).eval()
    b, s = _EXAMPLE
    args = (torch.zeros(b, s, visual_dim, device=dev),
            torch.zeros(b, s, audio_dim, device=dev),
            torch.ones(b, s, device=dev))
    batch = torch.export.Dim("batch", min=1, max=1024)
    shots = torch.export.Dim("shots", min=2, max=MAX_EXPORT_SHOTS)
    dims = {"visual": {0: batch, 1: shots}, "audio": {0: batch, 1: shots},
            "mask": {0: batch, 1: shots}}
    with torch.no_grad():
        program = torch.export.export(model, args, dynamic_shapes=dims)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_scorer(path_or_bytes: Union[str, os.PathLike, bytes],
                device="cuda") -> Callable[..., torch.Tensor]:
    """An :func:`export_scorer` artifact (a path or its bytes) -> a
    callable ``(visual, audio, mask) -> scores [B, S]`` on ``device``
    (inputs are arrays or tensors, placed there as float32). It needs
    none of the package's model code."""
    dev = torch.device(device)
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    program = torch.export.load(src)
    where = {t.device.type for t in program.state_dict.values()}
    if where != {dev.type}:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    fn = program.module()

    def call(visual, audio, mask) -> torch.Tensor:
        args = [torch.as_tensor(x, dtype=torch.float32).to(dev)
                for x in (visual, audio, mask)]
        with torch.no_grad():
            return fn(*args)

    return call
