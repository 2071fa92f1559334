"""Float32 Linear layers on the tensor cores: the hand-written 3xTF32 GEMM
(``csrc/gemm_tf32x3.cu``) with its plain version.

:func:`linear` is ``F.linear``'s counterpart, y = x W^T (+ b), for the
port's models (``Linear`` keeps ``nn.Linear``'s parameters, names and
initialization and calls it). A product :func:`route` leaves to the
plain version (a CPU tensor, another dtype, an empty product, a trace)
runs :func:`linear_plain`, differentiated by ordinary autograd; every
other runs :class:`LinearFunction`, whose forward and the backward's
dX = dY W and dW = dY^T X each go through :func:`product`; db is summed
over the rows by torch.

:func:`product` chooses, by what it can observe of the call, between the
kernel and the plain product (cuBLAS on the card, the port's products
before the kernel): the kernel takes a CUDA float32 product when torch's
float32 matmul precision is "highest" (under "high" cuBLAS's one-pass
TF32 is what was asked for) and :func:`kernel_takes` holds for its shape
(the rule read off ``chip_smoke.py``'s ``time_linear``: the kernel where
it beat cuBLAS on the card). The kernel then launches, or raises:
nothing falls back. A product with no rows or no columns launches
nothing; one with no contraction (an expert that was routed no shot) is
zeros. Counters, plain integers read by no metric: ``linear.launches``
(kernel launches) and ``linear.bypassed`` (CUDA float32 products the
rule left to cuBLAS).

The kernel reads A by rows or by columns and B likewise, so dY's and
X's transposes cost no copy; a tile cut along K (:func:`plan_splits`,
where the tiles alone would leave SMs idle) writes its parts to a
workspace that the launch's last part sums in order, with one counter a
tile kept per stream and set back to zero by the launch.

Inside ``torch.export`` or ``torch.compile`` the products trace as the
plain ones: the kernel is not traced into an artifact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.build import load_kernel

TILE_M = 128  # rows of C a tile: two consumer warpgroups of 64
TILE_N = 128  # columns of C a tile: wgmma's N
TILE_K = 32  # K a pipeline stage
STAGES = 5  # TMA ring stages
# dynamic shared memory: 1 KB to align the ring, the ring of A and B
# tiles, two pairs of B planes (big, small), two mbarriers a stage, a flag
SMEM = (1024 + STAGES * 2 * 4 * TILE_M * TILE_K + 2 * 2 * 4 * TILE_N * TILE_K
        + 8 * 2 * STAGES + 16)
MAX_SPLITS = 16
MIN_SPLIT_K_TILES = 8  # k-tiles a part keeps at least
COUNTERS = 1024  # tiles of a launch cut into parts: fewer than the SMs
MIN_KERNEL_FLOP = 1.5e9  # the smallest product the kernel takes


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain version and every product it does not take:
    x [..., K] times weight [N, K] transposed, plus the bias [N]
    (``F.linear``; cuBLAS on the card)."""
    return F.linear(x, weight, bias)


def kernel_takes(m: int, n: int, k: int, a_rows: bool = True,
                 b_rows: bool = True) -> bool:
    """The shape rule: C [m, n] over a contraction of k (A and B read as
    :func:`product` says) goes to the kernel. Every stored row must be a
    whole number of 16-byte groups, as TMA reads it (C's n; A's k by rows,
    its m by columns; B's k by rows, its n by columns); C must span a
    whole tile each way (m, n >= 128) and the product must hold
    MIN_KERNEL_FLOP. Read off ``chip_smoke.py``'s ``time_linear`` on an
    H100 (PERF.md): the kernel beat cuBLAS at every main-path product
    above that line (1.06-2.5x) and lost below it, where a launch's fixed
    cost (~35-40 us of host and pipeline fill) outweighs the work, and
    where C is a half-empty tile (the router's dW [64, 2048] over 7168
    shots: 0.68x)."""
    aligned = (n % 4 == 0 and (k if a_rows else m) % 4 == 0
               and (k if b_rows else n) % 4 == 0)
    return (aligned and min(m, n) >= TILE_M
            and 2 * m * n * k >= MIN_KERNEL_FLOP)


def plan_splits(m: int, n: int, k: int, sms: int) -> int:
    """Parts along K a tile of C [m, n] over k is cut into on a card of
    ``sms`` SMs: 1 where the tiles fill the SMs, else the count that fills
    them best (fewest waves of work a part, a small charge a part for its
    workspace pass), each part keeping MIN_SPLIT_K_TILES k-tiles."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    k_tiles = -(-k // TILE_K)
    if tiles >= sms:
        return 1
    best, cost = 1, float(-(-tiles // sms))
    for s in range(2, min(MAX_SPLITS, k_tiles // MIN_SPLIT_K_TILES) + 1):
        c = -(-tiles * s // sms) / s + 0.02 * (s - 1)
        if c < cost:
            best, cost = s, c
    return best


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernel("gemm_tf32x3")
    ptr, long_, int_ = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    lib.avsum_gemm_tf32x3.restype = int_
    lib.avsum_gemm_tf32x3.argtypes = [
        ptr, long_, int_, ptr, long_, int_, ptr, ptr, ptr, ptr,
        int_, int_, int_, int_, ptr]
    lib.avsum_gemm_tf32x3_layout.restype = None
    lib.avsum_gemm_tf32x3_layout.argtypes = [ctypes.POINTER(ctypes.c_long)]
    out = (ctypes.c_long * 5)()
    lib.avsum_gemm_tf32x3_layout(out)
    ours = [TILE_M, TILE_N, TILE_K, STAGES, SMEM]
    if list(out) != ours:
        raise RuntimeError(
            f"GEMM tiling {list(out)} is not the wrapper's {ours}: "
            f"csrc/gemm_tf32x3.cu and ops/linear.py disagree")
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """One zero a tile for launches cut into parts on ``stream``: each
    launch leaves them zero again."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _tracing() -> bool:
    compiler = torch.compiler
    exporting = getattr(compiler, "is_exporting", lambda: False)
    return compiler.is_compiling() or exporting()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows are unit-strided, 16-byte aligned and
    a multiple of 4 floats apart, as TMA reads them; a contiguous copy
    otherwise."""
    if (t.stride(1) == 1 and t.stride(0) % 4 == 0
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _launch(a, a_rows, b, b_rows, bias, m, n, k) -> torch.Tensor:
    a, b = _rows(a), _rows(b)
    dev = a.device
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    splits = plan_splits(m, n, k, _sms(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, m, n), device=dev, dtype=torch.float32)
        counters = _counters(dev, stream)
    if bias is not None:
        bias = bias.contiguous()
    with torch.cuda.device(dev):
        err = _lib().avsum_gemm_tf32x3(
            a.data_ptr(), a.stride(0), int(a_rows), b.data_ptr(),
            b.stride(0), int(b_rows),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, n, k, splits, stream)
    if err:
        raise RuntimeError(f"GEMM kernel launch failed: CUDA error {err} "
                           f"(C [{m}, {n}] over {k}, A by "
                           f"{'rows' if a_rows else 'columns'}, B by "
                           f"{'rows' if b_rows else 'columns'})")
    linear.launches += 1
    return out


def route(device: torch.device, dtype: Optional[torch.dtype], m: int,
          n: int, k: int, a_rows: bool = True, b_rows: bool = True) -> str:
    """Where a product of C [m, n] over k runs, from what the call can
    observe: "kernel"; "cublas" for a CUDA float32 product the rule leaves
    to the library (torch's float32 matmul precision other than "highest",
    or a shape :func:`kernel_takes` refuses); "plain" for everything else
    (a CPU tensor, another dtype or mixed ones (``dtype`` None), an empty
    product, a trace)."""
    if (device.type != "cuda" or dtype != torch.float32 or not (m and n and k)
            or _tracing()):
        return "plain"
    if (torch.get_float32_matmul_precision() == "highest"
            and kernel_takes(m, n, k, a_rows, b_rows)):
        return "kernel"
    return "cublas"


def product(a: torch.Tensor, b: torch.Tensor, a_rows: bool = True,
            b_rows: bool = True,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C [M, N] = A B^T (+ bias [N]) over K: A is ``a`` [M, K] where
    ``a_rows``, else ``a`` [K, M] read by columns; B is ``b`` [N, K]
    where ``b_rows``, else ``b`` [K, N]. The kernel where :func:`route`
    says so, else the plain product (cuBLAS on the card); the pairs
    (rows, rows), (rows, columns) and (columns, columns) are the
    forward's, dX's and dW's."""
    m, k = a.shape if a_rows else a.shape[::-1]
    n = b.shape[0] if b_rows else b.shape[1]
    where = route(a.device, a.dtype if a.dtype == b.dtype else None, m, n, k,
                  a_rows, b_rows)
    if where == "kernel":
        return _launch(a, a_rows, b, b_rows, bias, m, n, k)
    if where == "cublas":
        linear.bypassed += 1
    return linear_plain(a if a_rows else a.t(), b if b_rows else b.t(),
                        bias)


class LinearFunction(torch.autograd.Function):
    """y = x W^T (+ b) over x [M, K]: each of the forward, dX and dW one
    :func:`product`; db = dY summed over the rows."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return product(x, weight, bias=bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = product(dy, weight, b_rows=False)
        if ctx.needs_input_grad[1]:
            dw = product(dy, x, a_rows=False, b_rows=False)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] -> [..., N] = x W^T (+ b), W [N, K], b [N]:
    :func:`linear_plain` where :func:`route` leaves the forward to it,
    else :class:`LinearFunction` (the kernel where the route takes each
    of its products)."""
    rows = x.reshape(-1, x.shape[-1])
    dtype = x.dtype if x.dtype == weight.dtype else None
    if route(x.device, dtype, rows.shape[0], *weight.shape) == "plain":
        return linear_plain(x, weight, bias)
    y = LinearFunction.apply(rows, weight, bias)
    return y.reshape(*x.shape[:-1], weight.shape[0])


linear.launches = 0
linear.bypassed = 0


class Linear(nn.Linear):
    """``nn.Linear`` (its parameters, names, initialization and
    ``state_dict`` keys) whose forward is :func:`linear`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)
