"""Flash attention, forward and backward: kernel K2 (``csrc/flash_fwd.cu``)
and kernels B3 / B4 (``csrc/flash_bwd.cu``), with their plain version.

Counterpart of ``avsum_tpu/ops/attention.py::flash_attention`` and its
custom VJP (``_flash_core``): softmax(Q K^T / sqrt(D) + key-mask bias) V
over [B, S, H, D] inputs with a [B, S] key-validity mask, float32 out,
differentiable in q, k and v. The kernels read q, k, v (and the
cotangent) through their strides, since the scorer passes slices of one
fused qkv projection, and need no padding of S.

:func:`flash_attention` runs :class:`FlashAttention` for CUDA tensors: its
forward launches K2 and saves the LSE, its backward computes
delta = rowsum(dO * O) in torch (as the TPU code does outside its
kernels), then launches B3 (dK, dV) and B4 (dQ). For CPU tensors it runs
:func:`attention_plain`, differentiated by ordinary autograd. Each
kernel's wrapper (``flash_attention_fwd``, ``flash_bwd_dkv``,
``flash_bwd_dq``) launches it for CUDA tensors and runs its plain version
(``attention_fwd_plain``, ``flash_bwd_dkv_plain``, ``flash_bwd_dq_plain``:
the same recomputation, materialized) for CPU tensors; none falls back
from one to the other. Each counts its launches:
``flash_attention.launches`` (K2), ``flash_bwd_dkv.launches`` (B3) and
``flash_bwd_dq.launches`` (B4).

A query row whose keys are all masked has LSE = -1e30, so the backward
kernels recompute its probabilities as 1 rather than 1/S, as the TPU
kernels do. Its gradient terms are still right when its cotangent is 0,
which holds in the scorer: every attention output is multiplied by the
mask there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from avsum_torch.build import load_kernel

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128, 256)


def _logits(q, k, mask):
    """[B, H, S, S] float32 scores + key bias."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if mask is not None:
        bias = torch.where(mask.bool(), 0.0, NEG_INF).to(logits.dtype)
        logits = logits + bias[:, None, None, :]
    return logits


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of the whole op: the materialized softmax of
    ``avsum_tpu/ops/attention.py::reference_attention``."""
    probs = torch.softmax(_logits(q, k, mask), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def attention_fwd_plain(q, k, v, mask=None):
    """K2's plain version: -> (out [B, S, H, D], lse [B, H, S])."""
    logits = _logits(q, k, mask)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out, torch.logsumexp(logits, dim=-1)


def _bwd_plain(q, k, v, do, mask, lse, delta):
    """P recomputed as exp(S - LSE) and dS = P (dO V^T - delta), as the
    backward kernels compute them: -> (P, dS) [B, H, S, S]."""
    p = torch.exp(_logits(q, k, mask) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkv_plain(q, k, v, do, mask, lse, delta):
    """B3's plain version: -> (dk, dv) [B, S, H, D]."""
    p, ds = _bwd_plain(q, k, v, do, mask, lse, delta)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * q.shape[-1] ** -0.5
    return dk, torch.einsum("bhqk,bqhd->bkhd", p, do.float())


def flash_bwd_dq_plain(q, k, v, do, mask, lse, delta):
    """B4's plain version: -> dq [B, S, H, D]."""
    _, ds = _bwd_plain(q, k, v, do, mask, lse, delta)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * q.shape[-1] ** -0.5


_PTR = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_long)
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = load_kernel("flash_fwd")
    lib.avsum_flash_fwd.restype = _INT
    lib.avsum_flash_fwd.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
        _STRIDES, _STRIDES, _STRIDES, _PTR,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = load_kernel("flash_bwd")
    lib.avsum_flash_bwd_dkv.restype = _INT
    lib.avsum_flash_bwd_dkv.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _INT, _INT, _INT, _INT, _STRIDES, _STRIDES, _STRIDES, _STRIDES, _PTR,
    ]
    lib.avsum_flash_bwd_dq.restype = _INT
    lib.avsum_flash_bwd_dq.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _INT, _INT, _INT, _INT, _STRIDES, _STRIDES, _STRIDES, _STRIDES, _PTR,
    ]
    return lib


def _check(mask, *named) -> None:
    """Raise on inputs the kernels do not take: ``named`` is (name,
    tensor) pairs of [B, S, H, D] float32 views with a unit stride on D,
    all on one CUDA device."""
    ref = named[0][1]
    if ref.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {ref.device}")
    if ref.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(ref.shape)}")
    for name, t in named:
        if t.shape != ref.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {tuple(ref.shape)}")
        if t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"{name} must be float32 on {ref.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on D")
    if ref.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernels take D in {KERNEL_HEAD_DIMS}, "
                         f"got {ref.shape[-1]}")
    if mask is not None and (tuple(mask.shape) != tuple(ref.shape[:2])
                             or mask.device != ref.device):
        raise ValueError(f"mask must be [B, S] on {ref.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")


def _strides(t: torch.Tensor):
    return (ctypes.c_long * 3)(*t.stride()[:3])


def _mask_ptr(mask: Optional[torch.Tensor]):
    """-> (float32 contiguous mask or None, its pointer or None); the
    caller keeps the tensor alive across the launch."""
    if mask is None:
        return None, None
    mask = mask.to(torch.float32).contiguous()
    return mask, mask.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: -> (out [B, S, H, D] f32, lse [B, H, S] f32); the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, mask)
    q, k, v = map(_vec4, (q, k, v))
    _check(mask, ("q", q), ("k", k), ("v", v))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), device=q.device, dtype=torch.float32)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    mask, mask_ptr = _mask_ptr(mask)
    with torch.cuda.device(q.device):
        err = _fwd_lib().avsum_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            out.data_ptr(), lse.data_ptr(), b, s, h, d,
            _strides(q), _strides(k), _strides(v),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "attention forward")
    flash_attention.launches += 1
    return out, lse


def _bwd_args(q, k, v, do, mask, lse, delta):
    """Check the backward's inputs and -> (mask tensor kept alive, the
    leading pointer arguments, the trailing shape/stride/stream ones)."""
    _check(mask, ("q", q), ("k", k), ("v", v), ("dout", do))
    b, s, h, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != (b, h, s) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 [B, H, S]")
    mask, mask_ptr = _mask_ptr(mask)
    lead = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), mask_ptr,
            lse.data_ptr(), delta.data_ptr())
    tail = (b, s, h, d, _strides(q), _strides(k), _strides(v), _strides(do),
            torch.cuda.current_stream(q.device).cuda_stream)
    return mask, lead, tail


def _vec4(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its base address is 16-byte aligned and its
    (b, s, h) strides are multiples of 4 floats, as the kernels' 16-byte
    copies need (slices of the fused qkv projection are); a contiguous
    copy otherwise."""
    if t.data_ptr() % 16 == 0 and all(
            st % 4 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_bwd_dkv(q, k, v, do, mask, lse, delta):
    """B3: -> (dk, dv) [B, S, H, D] f32 contiguous; ``do`` is read through
    its strides, ``lse`` and ``delta`` are [B, H, S]. The plain version for
    CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, mask, lse, delta)
    q, k, v, do = map(_vec4, (q, k, v, do))
    mask, lead, tail = _bwd_args(q, k, v, do, mask, lse, delta)
    dk = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        err = _bwd_lib().avsum_flash_bwd_dkv(*lead, dk.data_ptr(),
                                             dv.data_ptr(), *tail)
    _raise_on(err, "attention dK/dV")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, mask, lse, delta):
    """B4: -> dq [B, S, H, D] f32 contiguous; the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, mask, lse, delta)
    q, k, v, do = map(_vec4, (q, k, v, do))
    mask, lead, tail = _bwd_args(q, k, v, do, mask, lse, delta)
    dq = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _bwd_lib().avsum_flash_bwd_dq(*lead, dq.data_ptr(), *tail)
    _raise_on(err, "attention dQ")
    flash_bwd_dq.launches += 1
    return dq


class FlashAttention(torch.autograd.Function):
    """K2 forward, B3 + B4 backward; no gradient for the mask. On CPU
    tensors it runs the three plain versions (the CPU tests use that)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = flash_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        # delta[b, h, s] = rowsum(dO * O): a small reduction, left to torch
        delta = (do * out).sum(-1).transpose(1, 2).contiguous()
        if do.stride(-1) != 1:
            do = do.contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, do, mask, lse, delta)
        dq = flash_bwd_dq(q, k, v, do, mask, lse, delta)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D) + mask bias) V: [B, S, H, D] -> [B, S, H, D]
    float32, differentiable in q, k, v; ``mask`` is an optional [B, S]
    key-validity mask."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    return FlashAttention.apply(q, k, v, mask)


flash_attention.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
