"""Kernel K2: flash-attention forward (``csrc/flash_fwd.cu``) and its plain
version.

Counterpart of ``avsum_tpu/ops/attention.py::flash_attention`` (forward):
softmax(Q K^T / sqrt(D) + key-mask bias) V over [B, S, H, D] inputs with a
[B, S] key-validity mask, float32 out. The kernel reads q, k and v
through their strides (the scorer passes slices of one fused qkv
projection) and needs no padding of S.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`attention_plain` for CPU tensors; it never falls back from one to
the other. ``flash_attention.launches`` counts kernel launches. The
kernel has no backward yet (the TPU backward kernels are still to be
ported), so the wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from avsum_torch.build import load_kernel

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128, 256)


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: the materialized softmax of
    ``avsum_tpu/ops/attention.py::reference_attention``."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if mask is not None:
        bias = torch.where(mask.bool(), 0.0, NEG_INF).to(logits.dtype)
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernel("flash_fwd")
    p = ctypes.c_void_p
    strides = ctypes.POINTER(ctypes.c_long)
    lib.avsum_flash_fwd.restype = ctypes.c_int
    lib.avsum_flash_fwd.argtypes = [
        p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, strides, strides, strides, p,
    ]
    return lib


def _check(q, k, v, mask) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, S, H, D] shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be float32 on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on D")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel takes D in {KERNEL_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if mask is not None and (tuple(mask.shape) != tuple(q.shape[:2])
                             or mask.device != q.device):
        raise ValueError(f"mask must be [B, S] on {q.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the attention kernel is forward-only: call it under "
            "torch.inference_mode() or torch.no_grad()")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: -> (out [B, S, H, D] f32, lse [B, H, S] f32)."""
    _check(q, k, v, mask)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), device=q.device, dtype=torch.float32)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()

    def strides(t):
        return (ctypes.c_long * 3)(*t.stride()[:3])

    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.avsum_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, s, h, d,
            strides(q), strides(k), strides(v),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D) + mask bias) V: [B, S, H, D] -> [B, S, H, D]
    float32; ``mask`` is an optional [B, S] key-validity mask."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    return flash_attention_fwd(q, k, v, mask)[0]


flash_attention.launches = 0
