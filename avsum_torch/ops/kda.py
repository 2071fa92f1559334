"""Kimi Delta Attention's core (arXiv:2510.26692): the gated delta rule
with a decay a key channel, over a sequence, in 64-shot chunks.

Per head, with the state S_t [K, V], a key and query k_t, q_t [K], a
value v_t [V], the decay alpha_t = exp(g_t) [K] (g_t <= 0) and beta_t:

    S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

:func:`chunk_kda` computes it in chunks of ``CHUNK`` shots with the WY
(UT) representation. Within a chunk, G_i = g_1 + .. + g_i (a channel's
log decay since the chunk began) and

    A_kk[i, j] = beta_i sum_c k_i[c] k_j[c] exp(G_i[c] - G_j[c]),  j < i
    A_qk[i, j] = sum_c q_i[c] k_j[c] exp(G_i[c] - G_j[c]),          j <= i
    T = (I + A_kk)^-1 (forward substitution)
    W = T (beta K exp(G)),  U' = T (beta V)

and over the chunks, S_0 = 0:

    U_c = U'_c - W_c S_c
    S_{c+1} = Diag(gamma_c) S_c + K~_c^T U_c,  gamma_c = exp(G_C),
              K~_c = K exp(G_C - G)
    O_c = (Q exp(G)) S_c + A_qk U_c

A decay ratio is always exp(G_i - G_j) with i >= j, never exp(G_i)
exp(-G_j): within 64 shots -G passes float32's range at the gates' init.
Each exponent is summed over the shots between (g_{j+1} + .. + g_i, all
of one sign), never taken as a difference of two prefix sums, which
would cancel. Inside sub-blocks of ``SUB`` shots the ratios are taken
pair by pair; between sub-blocks through the last shot r before the
later one, exp(G_i - G_r) exp(G_r - G_j), both factors at most 1 (a
factor that underflows stands for a product below float32's range).

The parts that are parallel over the chunks (G, the pairwise decays,
A_qk, A_kk, the forward substitution, Q exp(G), K~, gamma) and their
gradient are :class:`ChunkParts`: for CUDA tensors two kernels of
``csrc/kda.cu``, one CTA a chunk of a head, which read the layer's
[B, S, H, .] tensors by strides and recompute everything in the
backward from those inputs alone; on the CPU :func:`chunk_parts`
forward and :func:`parts_bwd_plain`, the backward kernel's arithmetic
as torch products. The pass over the chunks (U_c and S_c, and in the
backward the reverse pass over dS) is sequential; :class:`StatePass`
runs it, by the CUDA kernel for CUDA tensors and by :func:`pass_plain`,
the same arithmetic as a loop of torch products, on the CPU. Everything
is float32.

Counters, plain integers read by no metric: ``kda_fwd.launches`` and
``kda_bwd.launches``, the pass kernel's forward and backward launches,
and ``kda_intra_fwd.launches`` and ``kda_intra_bwd.launches``, the
chunk-parallel kernels' (one each a call of :func:`chunk_kda` and its
backward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from avsum_torch.build import load_kernel

CHUNK = 64  # shots a chunk
SUB = 8  # shots a sub-block whose decay ratios are taken pairwise
KEY_DIM = 128  # the kernel's key width
V_SPLIT = 32  # value columns of the state a CTA holds: the grid's third axis


def _chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, H, ...] -> [B, H, n, CHUNK, ...], zero-padded past S."""
    b, s, h = x.shape[:3]
    pad = n * CHUNK - s
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    x = x.reshape(b, n, CHUNK, h, *x.shape[3:])
    return x.transpose(1, 3).transpose(2, 3)


def chunk_inputs(q, k, v, g, beta) -> list:
    """The layer's q, k, v, g [B, S, H, .] and beta [B, S, H] as chunks
    [B, H, N, CHUNK, .] and [B, H, N, CHUNK], zero-padded past S."""
    n = -(-k.shape[1] // CHUNK)
    parts = [_chunks(t, n) for t in (q, k, v, g)]
    return parts + [_chunks(beta[..., None], n)[..., 0]]


def _unchunks(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, n, CHUNK, ...] -> [B, S, H, ...], the rows past S dropped."""
    b, h, n = x.shape[:3]
    x = x.transpose(2, 3).transpose(1, 3)
    return x.reshape(b, n * CHUNK, h, *x.shape[4:])[:, :s]


def decay_products(q: torch.Tensor, k: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A_qk (j <= i) and the unscaled A_kk (j < i), [..., C, C], of
    chunks q, k, g [..., C, K]. Each ratio's exponent is a sum of g over
    the shots between, all of one sign, never a difference of two
    prefix sums, which would cancel."""
    c, dk = k.shape[-2:]
    nb = c // SUB
    lead = k.shape[:-2]
    qb, kb, gb = (t.reshape(*lead, nb, SUB, dk) for t in (q, k, g))
    idx = torch.arange(SUB, device=k.device)
    # the diagonal sub-blocks, pairwise: g summed over (j, i], [j, i]
    span = (gb[..., None, :, :] * (idx[None, :] > idx[:, None])[..., None]
            ).cumsum(-2)
    ratio = torch.exp(span.transpose(-2, -3)) * (
        idx[:, None] >= idx[None, :])[..., None]
    kj = ratio * kb[..., None, :, :]
    qk_diag = (qb[..., :, None, :] * kj).sum(-1)
    kk_diag = (kb[..., :, None, :] * kj).sum(-1) * (
        idx[:, None] > idx[None, :])
    # a later sub-block's shots i against the shots j <= r before it,
    # r its first shot's predecessor: exp(g over (r, i]) exp(g over (j, r])
    local = gb.cumsum(-2)
    qk_rows, kk_rows = [qk_diag[..., 0, :, :]], [kk_diag[..., 0, :, :]]
    for i in range(1, nb):
        r = i * SUB
        tail = g[..., 1:r, :].flip(-2).cumsum(-2).flip(-2)
        right = k[..., :r, :] * torch.exp(F.pad(tail, (0, 0, 0, 1)))
        left = torch.exp(local[..., i, :, :])
        pad = (0, c - r - SUB)
        qk_rows.append(F.pad(torch.cat([
            (qb[..., i, :, :] * left) @ right.transpose(-1, -2),
            qk_diag[..., i, :, :]], -1), pad))
        kk_rows.append(F.pad(torch.cat([
            (kb[..., i, :, :] * left) @ right.transpose(-1, -2),
            kk_diag[..., i, :, :]], -1), pad))
    qk_rows[0] = F.pad(qk_rows[0], (0, c - SUB))
    kk_rows[0] = F.pad(kk_rows[0], (0, c - SUB))
    return torch.cat(qk_rows, -2), torch.cat(kk_rows, -2)


def wy_representation(a_kk: torch.Tensor, k_decayed: torch.Tensor,
                      v: torch.Tensor, beta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, U') of chunks: T (beta K exp(G)) and T (beta V), T = (I +
    beta A_kk)^-1 by forward substitution (``a_kk`` unscaled, strictly
    lower; ``k_decayed`` K exp(G); beta [..., C])."""
    dk = k_decayed.shape[-1]
    rhs = torch.cat([k_decayed, v], dim=-1) * beta[..., None]
    out = torch.linalg.solve_triangular(a_kk * beta[..., None], rhs,
                                        upper=False, unitriangular=True)
    return out[..., :dk], out[..., dk:]


def chunk_parts(q, k, v, g, beta):
    """What the pass over chunks takes and the output's intra-chunk
    part, of chunks [B, H, N, C, ...]: (Q exp(G), A_qk, W, U', K~,
    gamma)."""
    gc = g.cumsum(-2)
    a_qk, a_kk = decay_products(q, k, g)
    w, u0 = wy_representation(a_kk, k * torch.exp(gc), v, beta)
    # g summed over the shots after each, to the chunk's end
    rest = F.pad(g[..., 1:, :].flip(-2).cumsum(-2).flip(-2), (0, 0, 0, 1))
    return (q * torch.exp(gc), a_qk, w, u0, k * torch.exp(rest),
            torch.exp(gc[..., -1, :]))


def parts_bwd_plain(q, k, v, g, beta, d_qg, d_aqk, d_w, d_u0, d_kt,
                    d_gamma):
    """The gradient of :func:`chunk_parts`, of chunks [B, H, N, C, ...],
    from the gradients of its six outputs -> (dq, dk, dv, dg, dbeta): the
    backward kernel's arithmetic as torch products, recomputed from the
    inputs.

    The substitution: with Ab = A_kk diag(beta), y = R - Ab y (R = [K
    exp(G) | V]) and X = [W | U'] = beta y; its transpose gives dB = dX -
    (diag(beta) A_kk)^T dB, so dR = beta dB, dbeta_i = dB_i . y_i and
    dA_kk = -beta_i beta_j dB_i . y_j below the diagonal. The decays: the
    gradients of A_qk and A_kk reach q_i, k_i and k_j through the ratios
    exp(G_i - G_j), taken as the forward takes them (pairwise inside a
    sub-block, through the shot before the later sub-block between
    them); each pair j < i reaches G_i with the sign +, G_j with -, and
    one reverse scan turns dG into dg (K~'s exponent, g summed after each
    shot, one forward scan). A_qk's diagonal (ratio 1) reaches q and k
    alone: in dG its two terms would cancel, leaving only rounding."""
    c, dk = k.shape[-2:]
    nb = c // SUB
    lead = k.shape[:-2]
    gc = g.cumsum(-2)
    eg = torch.exp(gc)
    rest = F.pad(g[..., 1:, :].flip(-2).cumsum(-2).flip(-2), (0, 0, 0, 1))
    er = torch.exp(rest)
    a_kk = decay_products(q, k, g)[1]
    # the substitution and its transpose
    r = torch.cat([k * eg, v], -1)
    x = torch.cat(wy_representation(a_kk, k * eg, v, beta), -1)
    y = r - a_kk @ x
    d_b = torch.linalg.solve_triangular(
        (a_kk * beta[..., None]).transpose(-1, -2), torch.cat([d_w, d_u0], -1),
        upper=True, unitriangular=True)
    d_r = d_b * beta[..., None]
    d_beta = (d_b * y).sum(-1)
    d_akk = -(d_r @ x.transpose(-1, -2)).tril(-1)
    d_aqk = d_aqk.tril()
    # the decays inside each sub-block, pair by pair, as decay_products
    qb, kb, gb = (t.reshape(*lead, nb, SUB, dk) for t in (q, k, g))
    idx = torch.arange(SUB, device=k.device)
    span = (gb[..., None, :, :] * (idx[None, :] > idx[:, None])[..., None]
            ).cumsum(-2)
    # pairs j < i alone: a shot's own term (ratio 1) moves no decay
    ratio = torch.exp(span.transpose(-2, -3)) * (
        idx[:, None] > idx[None, :])[..., None]

    def diag_blocks(a):
        a = a.reshape(*lead, nb, SUB, nb, SUB).diagonal(dim1=-4, dim2=-2)
        return a.permute(*range(len(lead)), -1, -3, -2)[..., None]

    daq, dakk = diag_blocks(d_aqk), diag_blocks(d_akk)
    pq = (daq * ratio * kb[..., None, :, :]).sum(-2)
    kp = (dakk * ratio * kb[..., None, :, :]).sum(-2)
    km = ((daq * qb[..., :, None, :] + dakk * kb[..., :, None, :])
          * ratio).sum(-3)
    pq, kp, km = (t.reshape(*lead, c, dk) for t in (pq, kp, km))
    # a later sub-block's rows i against the shots j <= r before it:
    # exp(g over (r, i]) exp(g over (j, r])
    local = gb.cumsum(-2)
    for i in range(1, nb):
        r = i * SUB
        rows = slice(r, r + SUB)
        tail = g[..., 1:r, :].flip(-2).cumsum(-2).flip(-2)
        right = torch.exp(F.pad(tail, (0, 0, 0, 1)))
        left = torch.exp(local[..., i, :, :])
        kr = k[..., :r, :] * right
        daq_i, dakk_i = d_aqk[..., rows, :r], d_akk[..., rows, :r]
        pq[..., rows, :] += left * (daq_i @ kr)
        kp[..., rows, :] += left * (dakk_i @ kr)
        km[..., :r, :] += right * (
            daq_i.transpose(-1, -2) @ (qb[..., i, :, :] * left)
            + dakk_i.transpose(-1, -2) @ (kb[..., i, :, :] * left))
    d_kg = d_r[..., :dk]
    own = d_aqk.diagonal(dim1=-2, dim2=-1)[..., None]
    d_q = d_qg * eg + pq + own * k
    d_k = d_kg * eg + d_kt * er + kp + km + own * q
    d_gc = (d_qg * q + d_kg * k) * eg + q * pq + k * (kp - km)
    d_gc[..., -1, :] += d_gamma * eg[..., -1, :]
    d_rest = d_kt * k * er
    d_g = (d_gc.flip(-2).cumsum(-2).flip(-2)
           + F.pad(d_rest[..., :-1, :].cumsum(-2), (0, 0, 1, 0)))
    return d_q, d_k, d_r[..., dk:], d_g, d_beta


def pass_plain(a1t: torch.Tensor, a2: torch.Tensor, base: torch.Tensor,
               gamma: torch.Tensor, extra: Optional[torch.Tensor],
               sign: float, reverse: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic as torch products, over chunks [B, H, N,
    ...]: R starts at 0; for each chunk c, in order (``reverse``: last
    first), out_state[c] = R, X_c = base_c - sign a1t_c^T R, then R =
    gamma_c R + sign a2_c^T X_c (+ extra_c). Forward: a1t = W^T, a2 =
    K~, base = U', sign 1 -> (S_c, U_c). Backward: a1t = K~^T, a2 = W,
    base = dU from the outputs, extra = dS_c from the outputs, sign -1
    -> (dS_{c+1}, dU_c)."""
    n = a2.shape[2]
    r = base.new_zeros(*a2.shape[:2], a2.shape[-1], base.shape[-1])
    states, xs = [None] * n, [None] * n
    for c in (reversed(range(n)) if reverse else range(n)):
        states[c] = r
        xs[c] = base[:, :, c] - sign * (a1t[:, :, c].transpose(-1, -2) @ r)
        r = gamma[:, :, c, :, None] * r + sign * (
            a2[:, :, c].transpose(-1, -2) @ xs[c])
        if extra is not None:
            r = r + extra[:, :, c]
    return torch.stack(states, 2), torch.stack(xs, 2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernel("kda")
    ptr, int_ = ctypes.c_void_p, ctypes.c_int
    lib.avsum_kda_pass.restype = int_
    lib.avsum_kda_pass.argtypes = [int_, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                   int_, int_, int_, int_, ptr]
    lib.avsum_kda_intra_fwd.restype = int_
    lib.avsum_kda_intra_fwd.argtypes = [ptr] * 11 + [int_] * 4 + [ptr]
    lib.avsum_kda_intra_bwd.restype = int_
    lib.avsum_kda_intra_bwd.argtypes = [ptr] * 16 + [int_] * 4 + [ptr]
    lib.avsum_kda_layout.restype = None
    lib.avsum_kda_layout.argtypes = [ctypes.POINTER(ctypes.c_long)]
    out = (ctypes.c_long * 4)()
    lib.avsum_kda_layout(out)
    if list(out) != [CHUNK, KEY_DIM, V_SPLIT, SUB]:
        raise RuntimeError(f"KDA kernel layout {list(out)} is not the "
                           f"wrapper's {[CHUNK, KEY_DIM, V_SPLIT, SUB]}: "
                           "csrc/kda.cu and ops/kda.py disagree")
    return lib


def _launch(a1t, a2, base, gamma, extra, backward: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pass_plain` on the card (sign 1 forward, -1 backward): one
    launch over a grid of (V / V_SPLIT, H, B) CTAs, each a head's
    V_SPLIT columns of the state."""
    b, h, n, c, dk = a2.shape
    dv = base.shape[-1]
    if (c, dk) != (CHUNK, KEY_DIM) or dv % V_SPLIT:
        raise ValueError(f"the KDA kernel takes chunks of {CHUNK}, keys of "
                         f"{KEY_DIM} and values a multiple of {V_SPLIT}; got "
                         f"{c}, {dk}, {dv}")
    args = [t.float().contiguous() for t in (a1t, a2, base, gamma)]
    if extra is not None:
        extra = extra.float().contiguous()
    states = torch.empty(b, h, n, dk, dv, device=a2.device,
                         dtype=torch.float32)
    xs = torch.empty(b, h, n, c, dv, device=a2.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(a2.device).cuda_stream
    with torch.cuda.device(a2.device):
        err = _lib().avsum_kda_pass(
            int(backward), *(t.data_ptr() for t in args),
            None if extra is None else extra.data_ptr(), states.data_ptr(),
            xs.data_ptr(), b, h, n, dv, stream)
    if err:
        raise RuntimeError(f"KDA {'backward' if backward else 'forward'} "
                           f"kernel launch failed: CUDA error {err} "
                           f"([{b}, {h}] heads, {n} chunks, V {dv})")
    return states, xs


def kda_fwd(w, u0, kt, gamma) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward pass over chunks -> (S_c, U_c): the kernel for CUDA
    tensors, :func:`pass_plain` else."""
    if not w.is_cuda:
        return pass_plain(w.transpose(-1, -2), kt, u0, gamma, None, 1.0,
                          reverse=False)
    out = _launch(w.transpose(-1, -2), kt, u0, gamma, None, backward=False)
    kda_fwd.launches += 1
    return out


def kda_bwd(w, kt, gamma, d_states, d_u) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The backward's reverse pass over chunks -> (dS_{c+1}, dU_c): the
    kernel for CUDA tensors, :func:`pass_plain` else."""
    if not w.is_cuda:
        return pass_plain(kt.transpose(-1, -2), w, d_u, gamma, d_states,
                          -1.0, reverse=True)
    out = _launch(kt.transpose(-1, -2), w, d_u, gamma, d_states,
                  backward=True)
    kda_bwd.launches += 1
    return out


kda_fwd.launches = 0
kda_bwd.launches = 0


class StatePass(torch.autograd.Function):
    """(W, U', K~, gamma) of chunks [B, H, N, ...] -> (S_c [B, H, N, K,
    V], U_c [B, H, N, C, V]), the states entering each chunk and the
    corrected values. The backward's reverse pass over dS gives dU' and
    each dS_{c+1}, from which the gradients of W, K~ and gamma are
    batched products."""

    @staticmethod
    def forward(ctx, w, u0, kt, gamma):
        states, u = kda_fwd(w, u0, kt, gamma)
        ctx.save_for_backward(w, kt, gamma, states, u)
        return states, u

    @staticmethod
    def backward(ctx, d_states, d_u):
        w, kt, gamma, states, u = ctx.saved_tensors
        if d_states is None:
            d_states = torch.zeros_like(states)
        if d_u is None:
            d_u = torch.zeros_like(u)
        d_next, du = kda_bwd(w, kt, gamma, d_states, d_u)
        dw = -(du @ states.transpose(-1, -2))
        dkt = u @ d_next.transpose(-1, -2)
        dgamma = (states * d_next).sum(-1)
        return dw, du, dkt, dgamma


def _intra_args(q, k, v, g, beta):
    """The layer's tensors as the chunk-parallel kernels take them, float32
    and contiguous, after the shape check -> (tensors, (B, S, H, V))."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    if dk != KEY_DIM or dv % V_SPLIT or not 0 < dv <= KEY_DIM:
        raise ValueError(f"the KDA chunk kernels take chunks of {CHUNK}, keys "
                         f"of {KEY_DIM} and values a multiple of {V_SPLIT} "
                         f"up to {KEY_DIM}; got keys {dk}, values {dv}")
    return [_aligned(t) for t in (q, k, v, g, beta)], (b, s, h, dv)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """float32, contiguous, at a 16-byte boundary (the kernels' cp.async)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _intra_check(err: int, what: str, shape) -> None:
    if err:
        raise RuntimeError(f"KDA chunk {what} kernel launch failed: CUDA "
                           f"error {err} ([B, S, H, V] {list(shape)})")


def kda_intra_fwd(q, k, v, g, beta) -> Tuple[torch.Tensor, ...]:
    """(Q exp(G), A_qk, W, U', K~, gamma) of chunks [B, H, N, ...] from the
    layer's q, k, v, g [B, S, H, .] and beta [B, S, H]: the kernel for
    CUDA tensors, :func:`chunk_parts` else."""
    if not k.is_cuda:
        return chunk_parts(*chunk_inputs(q, k, v, g, beta))
    args, shape = _intra_args(q, k, v, g, beta)
    b, s, h, dv = shape
    n, dk = -(-s // CHUNK), KEY_DIM

    def new(*tail):
        return torch.empty(b, h, n, *tail, device=k.device,
                           dtype=torch.float32)

    outs = (new(CHUNK, dk), new(CHUNK, CHUNK), new(CHUNK, dk),
            new(CHUNK, dv), new(CHUNK, dk), new(dk))
    stream = torch.cuda.current_stream(k.device).cuda_stream
    with torch.cuda.device(k.device):
        err = _lib().avsum_kda_intra_fwd(
            *(t.data_ptr() for t in args + list(outs)), b, s, h, dv, stream)
    _intra_check(err, "forward", shape)
    kda_intra_fwd.launches += 1
    return outs


def kda_intra_bwd(q, k, v, g, beta, grads) -> Tuple[torch.Tensor, ...]:
    """The gradients of q, k, v, g [B, S, H, .] and beta [B, S, H] from
    those of :func:`kda_intra_fwd`'s six outputs: the kernel for CUDA
    tensors, :func:`parts_bwd_plain` else."""
    if not k.is_cuda:
        d = parts_bwd_plain(*chunk_inputs(q, k, v, g, beta), *grads)
        s = k.shape[1]
        return (*(_unchunks(t, s) for t in d[:4]),
                _unchunks(d[4][..., None], s)[..., 0])
    args, shape = _intra_args(q, k, v, g, beta)
    b, s, h, dv = shape
    grads = [_aligned(t) for t in grads]
    outs = [torch.empty_like(t) for t in args]
    stream = torch.cuda.current_stream(k.device).cuda_stream
    with torch.cuda.device(k.device):
        err = _lib().avsum_kda_intra_bwd(
            *(t.data_ptr() for t in args + grads + outs), b, s, h, dv,
            stream)
    _intra_check(err, "backward", shape)
    kda_intra_bwd.launches += 1
    return tuple(outs)


kda_intra_fwd.launches = 0
kda_intra_bwd.launches = 0


class ChunkParts(torch.autograd.Function):
    """q, k, v, g [B, S, H, .], beta [B, S, H] (float32) -> (Q exp(G),
    A_qk, W, U', K~, gamma) of chunks [B, H, N, ...]. Only the inputs are
    kept: the backward recomputes the decays, A_kk and the substitution
    from them."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta):
        ctx.save_for_backward(q, k, v, g, beta)
        return kda_intra_fwd(q, k, v, g, beta)

    @staticmethod
    def backward(ctx, *grads):
        return kda_intra_bwd(*ctx.saved_tensors, grads)


def chunk_kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """q, k [B, S, H, K], v [B, S, H, V], g [B, S, H, K] (log decay,
    <= 0), beta [B, S, H] -> o [B, S, H, V], float32. Shots past S pad
    the last chunk with zeros and change nothing before them. Under
    autograd only the inputs are kept for the chunk-parallel parts
    (:class:`ChunkParts`): their pairwise decays would take several GB a
    layer at an hour of shots."""
    b, s, h, _ = k.shape
    n = -(-s // CHUNK)
    qg, a_qk, w, u0, kt, gamma = ChunkParts.apply(
        q.float(), k.float(), v.float(), g.float(), beta.float())
    states, u = StatePass.apply(w, u0, kt, gamma)
    o = qg @ states + a_qk @ u
    o = o.transpose(2, 3).transpose(1, 3).reshape(b, n * CHUNK, h, -1)
    return o[:, :s]
