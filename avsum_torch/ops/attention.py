"""Flash attention, forward and backward: kernel K2 (``csrc/flash_fwd.cu``)
and the fused backward (``csrc/flash_bwd.cu``), with their plain versions.

Counterpart of ``avsum_tpu/ops/attention.py::flash_attention`` and its
custom VJP (``_flash_core``): softmax(Q K^T / sqrt(Dqk) + key-mask bias) V
over q and k [B, S, H, Dqk] and v [B, S, H, Dv] with a [B, S]
key-validity mask, float32 out [B, S, H, Dv], differentiable in q, k and
v. The kernels take the width pairs of ``KERNEL_HEAD_DIMS``: the square
(128, 128) and (256, 256), and latent attention's (192, 128), each at its
own widths. They read q, k, v (and the cotangent) through their strides,
since the scorer passes slices of one fused qkv projection and latent
attention passes v as a slice of its kv_b projection, and need no padding
of S.

:func:`flash_attention` runs :class:`FlashAttention` for CUDA tensors: its
forward launches K2 and saves the LSE, its backward computes
delta = rowsum(dO * O) in torch (as the TPU code does outside its
kernels), then launches the backward kernel once for dQ, dK and dV. For
CPU tensors it runs :func:`attention_plain`, differentiated by ordinary
autograd. Each kernel's wrapper (``flash_attention_fwd``, ``flash_bwd``)
launches it for CUDA tensors and runs its plain version
(``attention_fwd_plain``, ``flash_bwd_plain``: the same recomputation,
materialized) for CPU tensors; none falls back from one to the other.
Each counts its launches: ``flash_attention.launches`` (K2) and
``flash_bwd.launches`` (the backward); ``flash_attention.widths`` counts
K2's launches by their (Dqk, Dv).

The backward kernel sums dQ over its key blocks by float32 reductions in
the order the blocks run, so its dQ is not bitwise the same from run to
run (as the pooling's ``index_add_``).

A query row whose keys are all masked has LSE = -1e30, so the backward
kernel recomputes its probabilities as 1 rather than 1/S, as the TPU
kernels do. Its gradient terms are still right when its cotangent is 0,
which holds in the scorer: every attention output is multiplied by the
mask there.

This module owns the kernels' tiling, K2's (:func:`fwd_layout`, with the
block size the launcher picks, :func:`fwd_rows`) and the backward's
(:func:`bwd_layout`): the library reports its own
(``avsum_flash_fwd_layout``, ``avsum_flash_bwd_layout``), and each wrapper
checks the two agree before its first launch at a width pair.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from avsum_torch.build import load_kernel

NEG_INF = -1e30
# (Dqk, Dv): the head widths of q and k, and of v, the kernels take
KERNEL_HEAD_DIMS = ((128, 128), (256, 256), (192, 128))
BWD_KEYS = 64  # the backward: resident keys a cluster owns, wgmma's N
BWD_TILE = 64  # streamed rows per tile: wgmma's M
BWD_CHUNK = 64  # a CTA's columns of Dqk (and Dv): two 128-byte TMA boxes
BWD_STAGES = 4  # TMA ring stages: a tile's Q and dO chunks by turns
BWD_PLANES = 10  # K, K^T, V, P and dS, big and small
FWD_ROWS = (32, 64)  # K2: queries a block owns: wgmma N
FWD_TILE = 64  # keys per streamed tile: wgmma's M
SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may opt into
SM_SMEM = 233_472  # an H100 SM's shared memory; a block also reserves 1 KB


def _logits(q, k, mask):
    """[B, H, S, T] float32 scores + key bias."""
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
    probs_dtype: torch.dtype = torch.float32,
    chunk: int = 0,
) -> torch.Tensor:
    """The port's materialized softmax (``avsum_tpu/ops/attention.py::
    reference_attention``): q [B, S, H, Dqk], k [B, T, H, Dqk], v [B, T,
    H, Dv], ``mask`` an optional [B, T] key validity -> [B, S, H, Dv]
    float32. Float32 logits and softmax, the probabilities rounded to
    ``probs_dtype``, their product with V summed in float32.

    With ``chunk`` > 0 the query axis is walked in chunks of that many
    rows, as the JAX package's blockwise attention walks it, so the
    largest live score block is [B, H, chunk, T]: S padded up to a
    multiple of ``chunk`` and the pad sliced off again; the real rows
    are exact. A symbolic S (``torch.export``) cannot be cut into a
    Python count of chunks and is taken as one."""
    k, v = k.float(), v.float()

    def one_chunk(qc: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(_logits(qc, k, mask), dim=-1).to(probs_dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v)

    s = q.shape[1]
    if chunk <= 0 or not isinstance(s, int):
        return one_chunk(q)
    qp = F.pad(q.float(), (0, 0, 0, 0, 0, (-s) % chunk))
    return torch.cat([one_chunk(qc) for qc in qp.split(chunk, dim=1)],
                     dim=1)[:, :s]


def attention_fwd_plain(q, k, v, mask=None):
    """K2's plain version: -> (out [B, S, H, D], lse [B, H, S])."""
    logits = _logits(q, k, mask)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out, torch.logsumexp(logits, dim=-1)


def flash_bwd_plain(q, k, v, do, mask, lse, delta):
    """The backward kernel's plain version, the same recomputation
    materialized: P = exp(S - LSE), dS = P (dO V^T - delta), then
    -> (dq, dk [B, S, H, Dqk], dv [B, S, H, Dv])."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_logits(q, k, mask) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, torch.einsum("bhqk,bqhd->bkhd", p, do.float())


_PTR = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_long)
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = load_kernel("flash_fwd")
    lib.avsum_flash_fwd.restype = _INT
    lib.avsum_flash_fwd.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
        _STRIDES, _STRIDES, _STRIDES, _PTR,
    ]
    lib.avsum_flash_fwd_layout.restype = _INT
    lib.avsum_flash_fwd_layout.argtypes = [
        _INT, _INT, _INT, ctypes.POINTER(ctypes.c_long)]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = load_kernel("flash_bwd")
    lib.avsum_flash_bwd.restype = _INT
    lib.avsum_flash_bwd.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _INT, _INT, _INT, _INT, _INT, _STRIDES, _STRIDES, _STRIDES, _STRIDES,
        _PTR,
    ]
    lib.avsum_flash_bwd_layout.restype = _INT
    lib.avsum_flash_bwd_layout.argtypes = [
        _INT, _INT, ctypes.POINTER(ctypes.c_long)]
    lib.avsum_flash_bwd_max_clusters.restype = _INT
    lib.avsum_flash_bwd_max_clusters.argtypes = [
        _INT, _INT, ctypes.POINTER(ctypes.c_int)]
    return lib


def _widths(dqk: int, dv: int) -> None:
    if (dqk, dv) not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernels take (Dqk, Dv) in "
                         f"{KERNEL_HEAD_DIMS}, got {(dqk, dv)}")


def fwd_layout(dqk: int, dv: int, rows: int) -> dict:
    """K2's tiling at head widths (``dqk``, ``dv``) for blocks of ``rows``
    queries, in the order ``avsum_flash_fwd_layout`` reports it: queries a
    block owns, keys per streamed tile, TMA stages of [FWD_TILE x
    BWD_CHUNK] floats (as many as fit), dynamic shared memory in bytes (1
    KB to align the ring, the queries' big and small B planes, R Dqk floats
    each, P's, the softmax's float a warpgroup, warp and half of the
    queries, alpha's float a query, and a stage's ring slot and two
    mbarriers) and blocks an SM holds by shared memory."""
    _widths(dqk, dv)
    if rows not in FWD_ROWS:
        raise ValueError(f"K2 takes blocks of {FWD_ROWS} queries, got {rows}")
    fixed = (1024 + 4 * 2 * rows * dqk + 4 * 2 * rows * FWD_TILE
             + 4 * 5 * rows)
    stage = 4 * FWD_TILE * BWD_CHUNK + 8 + 8
    stages = (SMEM_LIMIT - fixed) // stage
    smem = fixed + stages * stage
    layout = dict(block_rows=rows, tile_rows=FWD_TILE, stages=stages,
                  smem=smem, blocks_per_sm=SM_SMEM // (smem + 1024))
    assert smem <= SMEM_LIMIT, layout
    return layout


def fwd_rows(b: int, s: int, h: int, sms: int) -> int:
    """The queries a K2 block owns at [b, s, h, D] on a card of ``sms``
    SMs, as ``avsum_flash_fwd``'s launcher picks them: 64 where the
    64-query blocks cover the SMs, else 32."""
    return 64 if b * h * -(-s // 64) >= sms else 32


def check_fwd_layout(reported, dqk: int, dv: int, rows: int) -> None:
    """Raises unless the library's tiling at (``dqk``, ``dv``) and
    ``rows`` (the 5 numbers of ``avsum_flash_fwd_layout``) is
    :func:`fwd_layout`'s."""
    ours = fwd_layout(dqk, dv, rows)
    if list(reported) != list(ours.values()):
        raise RuntimeError(
            f"attention forward's layout {list(reported)} is not the "
            f"wrapper's {ours} at (Dqk, Dv) = {(dqk, dv)}, {rows} queries "
            f"a block: csrc/flash_fwd.cu and ops/attention.py disagree")


@functools.lru_cache(maxsize=None)
def _checked_fwd_lib(dqk: int, dv: int) -> ctypes.CDLL:
    """The forward library, once its tiling at (``dqk``, ``dv``) is
    checked against ours at both block sizes."""
    lib = _fwd_lib()
    for rows in FWD_ROWS:
        out = (ctypes.c_long * 5)()
        _raise_on(lib.avsum_flash_fwd_layout(dqk, dv, rows, out),
                  "attention forward layout")
        check_fwd_layout(out, dqk, dv, rows)
    return lib


def bwd_layout(dqk: int, dv: int) -> dict:
    """The backward's tiling at head widths (``dqk``, ``dv``), in the order
    ``avsum_flash_bwd_layout`` reports it: keys a cluster owns, CTAs a
    cluster (one a 64-column chunk of Dqk; the first ``dv / 64`` of them
    also one of Dv), streamed rows per tile, TMA stages of [BWD_TILE x
    BWD_CHUNK] floats, a CTA's dynamic shared memory in bytes (1 KB to
    align the ring, the ring, ten [64 x 64] planes: K, K^T, V, P and dS,
    big and small, and in a cluster of 3 an eleventh; the ring's two
    mbarriers a stage and each group's four for the cluster's exchange)
    and CTAs an SM holds by shared memory."""
    _widths(dqk, dv)
    cluster = dqk // BWD_CHUNK
    # a cluster of 3 trades a ring stage for an eleventh plane, the second
    # slot of its all-to-all S exchange
    stages = BWD_STAGES - (cluster == 3)
    planes = BWD_PLANES + (cluster == 3)
    smem = (1024 + 4 * stages * BWD_TILE * BWD_CHUNK
            + 4 * planes * BWD_KEYS * BWD_CHUNK + 8 * (2 * stages + 8))
    layout = dict(block_keys=BWD_KEYS, cluster=cluster,
                  tile_rows=BWD_TILE, stages=stages, smem=smem,
                  blocks_per_sm=SM_SMEM // (smem + 1024))
    assert smem <= SMEM_LIMIT, layout
    return layout


def check_bwd_layout(reported, dqk: int, dv: int) -> None:
    """Raises unless the library's tiling at (``dqk``, ``dv``) (the 6
    numbers of ``avsum_flash_bwd_layout``) is :func:`bwd_layout`'s."""
    ours = bwd_layout(dqk, dv)
    if list(reported) != list(ours.values()):
        raise RuntimeError(
            f"attention backward's layout {list(reported)} is not the "
            f"wrapper's {ours} at (Dqk, Dv) = {(dqk, dv)}: "
            f"csrc/flash_bwd.cu and ops/attention.py disagree")


@functools.lru_cache(maxsize=None)
def _checked_bwd_lib(dqk: int, dv: int) -> ctypes.CDLL:
    """The backward library, once its tiling at (``dqk``, ``dv``) is
    checked against ours."""
    lib = _bwd_lib()
    out = (ctypes.c_long * 6)()
    _raise_on(lib.avsum_flash_bwd_layout(dqk, dv, out),
              "attention backward layout")
    check_bwd_layout(out, dqk, dv)
    return lib


def bwd_max_clusters(dqk: int, dv: int) -> int:
    """How many of the backward's clusters at head widths (``dqk``,
    ``dv``) the current card runs at once
    (``cudaOccupancyMaxActiveClusters``): a cluster needs ``dqk / 64``
    free SMs of one GPC."""
    out = ctypes.c_int()
    _raise_on(_checked_bwd_lib(dqk, dv).avsum_flash_bwd_max_clusters(
        dqk, dv, ctypes.byref(out)), "attention backward occupancy")
    return out.value


def _check(mask, *named) -> None:
    """Raise on inputs the kernels do not take: ``named`` is (name,
    tensor) pairs of float32 views with a unit stride on the head width,
    all on one CUDA device: q, k [B, S, H, Dqk], then v (and the
    cotangent) [B, S, H, Dv]."""
    ref = named[0][1]
    if ref.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {ref.device}")
    if ref.dim() != 4:
        raise ValueError(f"expected [B, S, H, D], got {tuple(ref.shape)}")
    dqk, dv = ref.shape[-1], named[2][1].shape[-1]
    for i, (name, t) in enumerate(named):
        want = (*ref.shape[:3], dqk if i < 2 else dv)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} != {want}")
        if t.dtype != torch.float32 or t.device != ref.device:
            raise ValueError(f"{name} must be float32 on {ref.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on D")
    _widths(dqk, dv)
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
    """K2: -> (out [B, S, H, Dv] f32, lse [B, H, S] f32); the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, mask)
    q, k, v = map(_vec4, (q, k, v))
    _check(mask, ("q", q), ("k", k), ("v", v))
    b, s, h, dqk = q.shape
    dv = v.shape[-1]
    out = torch.empty((b, s, h, dv), device=q.device, dtype=torch.float32)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    mask, mask_ptr = _mask_ptr(mask)
    with torch.cuda.device(q.device):
        err = _checked_fwd_lib(dqk, dv).avsum_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            out.data_ptr(), lse.data_ptr(), b, s, h, dqk, dv,
            _strides(q), _strides(k), _strides(v),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "attention forward")
    flash_attention.launches += 1
    flash_attention.widths[dqk, dv] += 1
    return out, lse


def _bwd_args(q, k, v, do, mask, lse, delta):
    """Check the backward's inputs and -> (mask tensor kept alive, the
    leading pointer arguments, the trailing shape/stride/stream ones)."""
    _check(mask, ("q", q), ("k", k), ("v", v), ("dout", do))
    b, s, h, dqk = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != (b, h, s) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 [B, H, S]")
    mask, mask_ptr = _mask_ptr(mask)
    lead = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), mask_ptr,
            lse.data_ptr(), delta.data_ptr())
    tail = (b, s, h, dqk, v.shape[-1], _strides(q), _strides(k), _strides(v),
            _strides(do), torch.cuda.current_stream(q.device).cuda_stream)
    return mask, lead, tail


def _vec4(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its base address is 16-byte aligned and its
    (b, s, h) strides are multiples of 4 floats, as the kernels' 16-byte
    copies and TMA loads need (slices of the fused qkv projection are); a
    contiguous copy otherwise."""
    if t.data_ptr() % 16 == 0 and all(
            st % 4 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_bwd(q, k, v, do, mask, lse, delta):
    """The backward kernel: -> (dq, dk [B, S, H, Dqk], dv [B, S, H, Dv])
    f32 contiguous; ``do`` is read through its strides, ``lse`` and
    ``delta`` are
    [B, H, S]. dq is zeroed here, on the launch's stream, and the kernel
    adds each key block's share to it. The plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, mask, lse, delta)
    q, k, v, do = map(_vec4, (q, k, v, do))
    mask, lead, tail = _bwd_args(q, k, v, do, mask, lse, delta)
    dq = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
    dk = torch.empty_like(dq)
    dv = torch.empty(v.shape, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _checked_bwd_lib(q.shape[-1], v.shape[-1]).avsum_flash_bwd(
            *lead, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail)
    _raise_on(err, "attention backward")
    flash_bwd.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 forward, the fused kernel backward; no gradient for the mask. On
    CPU tensors it runs the two plain versions (the CPU tests use that)."""

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
        dq, dk, dv = flash_bwd(q, k, v, do, mask, lse, delta)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(Q K^T / sqrt(Dqk) + mask bias) V: q, k [B, S, H, Dqk], v
    [B, S, H, Dv] -> [B, S, H, Dv] float32, differentiable in q, k, v;
    ``mask`` is an optional [B, S] key-validity mask. On CUDA tensors
    (Dqk, Dv) is one of ``KERNEL_HEAD_DIMS``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    return FlashAttention.apply(q, k, v, mask)


flash_attention.launches = 0
flash_attention.widths = collections.Counter()
flash_bwd.launches = 0
