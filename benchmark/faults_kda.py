"""Faults planted in Kimi Delta Attention (``avsum_torch/models/kda.py``,
``avsum_torch/ops/kda.py``), to show that the hybrid decoder's check
catches each: context managers that patch the port while open, as
``benchmark/faults.py``'s do.

- ``no_decay``: the decay dropped, every alpha 1 (g = 0);
- ``no_delta``: the delta correction dropped, plain gated linear
  attention (S_t = Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T): the chunks'
  W = 0 and U' = beta V;
- ``noncausal_conv``: the short convolution centred, so that each shot
  sees the shots after it;
- ``unnormalized_qk``: q and k left without their L2 norm.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

from benchmark.faults import _patched


@contextlib.contextmanager
def no_decay() -> Iterator[None]:
    from avsum_torch.ops import kda

    chunk = kda.chunk_kda

    def undecayed(q, k, v, g, beta):
        # g times 0, so that the gates' parameters keep a (zero) gradient
        return chunk(q, k, v, g * 0, beta)

    with _patched(kda, "chunk_kda", undecayed):
        yield


@contextlib.contextmanager
def no_delta() -> Iterator[None]:
    from avsum_torch.ops import kda

    def plain(a_kk, k_decayed, v, beta):
        return torch.zeros_like(k_decayed), v * beta[..., None]

    with _patched(kda, "wy_representation", plain):
        yield


@contextlib.contextmanager
def noncausal_conv() -> Iterator[None]:
    from avsum_torch.models import kda

    def centred(x, weight):
        k, s = weight.shape[-1], x.shape[1]
        padded = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
        return sum(padded[:, i:i + s] * weight[:, 0, i] for i in range(k))

    with _patched(kda, "short_conv", centred):
        yield


@contextlib.contextmanager
def unnormalized_qk() -> Iterator[None]:
    from avsum_torch.models import kda

    with _patched(kda, "l2_norm", lambda x: x):
        yield


FAULTS = {"no_decay": no_decay, "no_delta": no_delta,
          "noncausal_conv": noncausal_conv,
          "unnormalized_qk": unnormalized_qk}
