"""The audio-visual shot scorer with Kimi-Linear-48B-A3B's decoder as each
modality's temporal encoder, and its training step, written out in plain
PyTorch from the published description (Kimi Linear, arXiv:2510.26692;
the model's ``config.json``; flash-linear-attention's ``fla/layers/kda.py``
for what the config leaves out), float32, with no kernel and no chunking
trick:

    visual [B, S, Dv], audio [B, S, Da]
      -> per modality: Linear(hidden) -> ReLU -> dropout
      -> per modality the decoder: per layer i (1-indexed)
           h = x + ATT_i(RMSNorm(x)); x = h + FFN_i(RMSNorm(h))
         ATT_i Kimi Delta Attention where i is in ``kda_layers``, else
         latent attention without rotary positions (NoPE); FFN_i a
         SwiGLU of intermediate_size for i <= first_k_dense_replace,
         else the MoE; then RMSNorm, times the mask
      -> concatenation [B, S, 2 hidden] plus its multi-head self-attention
         of ``fusion_heads`` heads
      -> Linear(scorer_hidden) -> ReLU -> Linear(1) -> sigmoid, times the mask

Kimi Delta Attention, H heads of width d for keys and values:

    q, k, v = SiLU(causal depthwise conv_K(x W_{q,k,v}^T)), no bias
    q, k    = x / sqrt(sum x^2 + 1e-6) a head; q times d^-1/2
    g       = -exp(A_log[h]) softplus(f_b(f_a(x)) + dt_bias)
    beta    = sigmoid(x W_b^T)
    S_t     = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t     = S_t^T q_t
    y       = o_proj(RMSNorm_head(o) * sigmoid(g_b(g_a(x))))   (g_b with bias)

The recurrence runs token by token, as written, from S_0 = 0 over the
shots from left to right; at more than ``BLOCK`` shots in blocks of
``BLOCK`` under ``torch.utils.checkpoint``, so that autograd keeps one
state a block.

Latent attention, the MoE layers (sigmoid router over every expert, the
top k by score plus a correction bias, weights renormalized and scaled;
the held experts 0 .. ``moe_experts_held`` - 1; one shared SwiGLU), the
fusion attention, the loss, AdamW and dropout are
``benchmark/reference/decoder.py``'s, called as they are. Without rotary
positions its ``mla`` takes cos = 1 and sin = 0: the rotation is then the
de-interleaving permutation of the rope columns, the same for q and k, so
every score is q . k unrotated.

Departures from the source, each the scorer's: KDA runs causal, as its
recurrence is defined, but latent attention is bidirectional over the
real shots (padded keys masked), since the scorer judges each shot
against the whole video; padded shots come after the real ones; no
vocabulary; the correction bias is 0 and not updated; no balance loss.
The sizes the config leaves out are taken from fla's KDA layer: the
convolution has no bias, g_b has one, q is scaled by d^-1/2, the L2 norm
adds 1e-6, A = exp(A_log) starts uniform in [1, 16] and softplus(dt_bias)
log-uniform in [1e-3, 1e-1] (at least 1e-4).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import decoder, scorer
from benchmark.reference.scorer import AdamW, dropout, masked_mse, step_seeds

Leaves = Dict[str, torch.Tensor]

BLOCK = 64  # shots a checkpointed block of the recurrence
L2_EPS = 1e-6
A_RANGE = (1.0, 16.0)
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
# fan-in codes of the gates' leaves, drawn uniform after the normals
A_LOG, DT_BIAS = -2, -3


# ----------------------------------------------------------------------
# leaves and their seeded initial values
# ----------------------------------------------------------------------

def is_kda(model: dict, i: int) -> bool:
    """Whether the decoder's layer at 0-based index ``i`` is KDA."""
    return i + 1 in model["kda_layers"]


def kda_specs(model: dict, blk: str) -> List[Tuple]:
    hid = model["hidden_dim"]
    h, d = model["kda_num_heads"], model["kda_head_dim"]
    width, conv = h * d, model["short_conv_kernel_size"]
    return [(f"{blk}.q", (width, hid), hid), (f"{blk}.k", (width, hid), hid),
            (f"{blk}.v", (width, hid), hid),
            (f"{blk}.q_conv", (width, 1, conv), conv),
            (f"{blk}.k_conv", (width, 1, conv), conv),
            (f"{blk}.v_conv", (width, 1, conv), conv),
            (f"{blk}.f_a", (d, hid), hid), (f"{blk}.f_b", (width, d), d),
            (f"{blk}.A_log", (h,), A_LOG), (f"{blk}.dt_bias", (width,), DT_BIAS),
            (f"{blk}.b", (h, hid), hid), (f"{blk}.g_a", (d, hid), hid),
            (f"{blk}.g_b.w", (width, d), d), (f"{blk}.g_b.b", (width,), 0),
            (f"{blk}.o_norm.g", (d,), -1), (f"{blk}.o", (hid, width), width)]


def decoder_specs(model: dict, name: str) -> List[Tuple]:
    """[(leaf, shape, fan-in)] of one modality's decoder: the
    Moonlight decoder's leaves, with each KDA layer's attention leaves in
    place of its MLA's."""
    mla_names = ("q", "kv_a", "kv_norm.g", "kv_b", "o")
    out: List[Tuple] = []
    for spec in decoder.decoder_specs(model, name):
        leaf = spec[0]
        parts = leaf.split(".")
        if len(parts) > 2 and parts[1].isdigit() and is_kda(
                model, int(parts[1])):
            blk = ".".join(parts[:2])
            rest = ".".join(parts[2:])
            if rest == "ln0.g":
                out += [spec] + kda_specs(model, blk)
                continue
            if rest in mla_names:
                continue
        out.append(spec)
    return out


def leaf_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """[(name, shape, fan-in)] of every leaf, in a fixed order: a fan-in of
    0 marks a bias, -1 a norm's scale, ``A_LOG`` and ``DT_BIAS`` the
    gates'."""
    hid = model["hidden_dim"]
    specs: List[Tuple] = []
    for m, dim in (("visual", model["visual_dim"]), ("audio", model["audio_dim"])):
        specs += scorer._linear(f"{m}_fc", dim, hid)
    for m in ("visual", "audio"):
        specs += decoder_specs(model, f"{m}_enc")
    specs += scorer._attention("fusion", 2 * hid)
    specs += scorer._linear("head", 2 * hid, model["scorer_hidden"])
    specs += scorer._linear("out", model["scorer_hidden"], 1)
    return specs


def init_leaves(model: dict, seed: int, device) -> Leaves:
    """Every leaf from ``seed`` on ``device``: weights normal over the
    square root of their fan-in, drawn in one call; biases 0; norm scales
    1; then the gates from one uniform draw: A_log = log U(1, 16),
    dt_bias = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]."""
    specs = leaf_specs(model)
    total = sum(math.prod(shape) for _, shape, fan in specs if fan > 0)
    uniform = sum(math.prod(shape) for _, shape, fan in specs
                  if fan in (A_LOG, DT_BIAS))
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    rand = torch.rand(uniform, generator=gen, device=device)
    out: Leaves = {}
    at = u_at = 0
    for name, shape, fan in specs:
        n = math.prod(shape)
        if fan > 0:
            out[name] = (flat[at:at + n] / math.sqrt(fan)).view(shape)
            at += n
        elif fan in (A_LOG, DT_BIAS):
            u = rand[u_at:u_at + n].view(shape)
            u_at += n
            if fan == A_LOG:
                out[name] = torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u)
            else:
                dt = torch.exp(math.log(DT_MIN) + (math.log(DT_MAX)
                                                   - math.log(DT_MIN)) * u)
                dt = dt.clamp(min=DT_FLOOR)
                out[name] = dt + torch.log(-torch.expm1(-dt))
        elif fan < 0:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ----------------------------------------------------------------------
# the forward pass
# ----------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution, x [B, S, D], w [D, 1, K]:
    y_t = sum_i w[:, i] x_{t - K + 1 + i}, zeros before the first shot."""
    k = w.shape[-1]
    s = x.shape[1]
    padded = F.pad(x, (0, 0, k - 1, 0))
    return sum(padded[:, i:i + s] * w[:, 0, i] for i in range(k))


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def recurrence_block(state: torch.Tensor, q, k, v, g, beta
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The delta rule token by token: state [B, H, K, V]; q, k, g [B, T,
    H, K], v [B, T, H, V], beta [B, T, H] -> (the last state, o [B, T, H,
    V]). A token: S = Diag(alpha) S; S = S + beta k (v - S^T k)^T;
    o = S^T q."""
    tokens = zip(*(x.transpose(1, 2).unbind(2) for x in (
        torch.exp(g)[..., None], k[..., None, :], k * beta[..., None],
        v, q[..., None, :])))
    outs = []
    for alpha, kt, bk, vt, qt in tokens:
        state = alpha * state
        delta = vt - (kt @ state)[..., 0, :]
        state = torch.addcmul(state, bk[..., None], delta[..., None, :])
        outs.append((qt @ state)[..., 0, :])
    return state, torch.stack(outs, 1)


def kda_recurrence(q, k, v, g, beta) -> torch.Tensor:
    """o [B, S, H, V] of the recurrence from S_0 = 0, in blocks of
    ``BLOCK`` shots, each under ``checkpoint`` where autograd records."""
    b, s, h, dk = k.shape
    state = q.new_zeros(b, h, dk, v.shape[-1])
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, g, beta))
    outs = []
    for t0 in range(0, s, BLOCK):
        part = [t[:, t0:t0 + BLOCK] for t in (q, k, v, g, beta)]
        if grad and s > BLOCK:
            state, o = checkpoint(recurrence_block, state, *part,
                                  use_reentrant=False)
        else:
            state, o = recurrence_block(state, *part)
        outs.append(o)
    return torch.cat(outs, 1)


def kda_inputs(x: torch.Tensor, p: Leaves, name: str, model: dict
               ) -> Tuple[torch.Tensor, ...]:
    """The recurrence's q, k, v, g [B, S, H, d] and beta [B, S, H] of
    x [B, S, hidden]: the projections, convolutions, norms and gates."""
    b, s, _ = x.shape
    h, d = model["kda_num_heads"], model["kda_head_dim"]

    def branch(n: str) -> torch.Tensor:
        return F.silu(causal_conv(x @ p[f"{name}.{n}"].T,
                                  p[f"{name}.{n}_conv"])).view(b, s, h, d)

    q, k, v = l2_norm(branch("q")), l2_norm(branch("k")), branch("v")
    gate = (x @ p[f"{name}.f_a"].T) @ p[f"{name}.f_b"].T + p[f"{name}.dt_bias"]
    g = -torch.exp(p[f"{name}.A_log"])[:, None] * F.softplus(
        gate.view(b, s, h, d))
    beta = torch.sigmoid(x @ p[f"{name}.b"].T)
    return q * d ** -0.5, k, v, g, beta


def kda_output(o: torch.Tensor, x: torch.Tensor, p: Leaves, name: str,
               model: dict) -> torch.Tensor:
    """The layer's output of the recurrence's o [B, S, H, d]: the head-wise
    RMSNorm, the sigmoid gate of x and o_proj."""
    b, s, h, d = o.shape
    out_gate = torch.sigmoid((x @ p[f"{name}.g_a"].T) @ p[f"{name}.g_b.w"].T
                             + p[f"{name}.g_b.b"])
    o = decoder.rms_norm(o, p[f"{name}.o_norm.g"], model["rms_norm_eps"])
    o = o * out_gate.view(b, s, h, d)
    return o.reshape(b, s, h * d) @ p[f"{name}.o"].T


def kda(x: torch.Tensor, p: Leaves, name: str, model: dict,
        dense_only: bool = False) -> torch.Tensor:
    """Kimi Delta Attention over x [B, S, hidden]; ``dense_only`` leaves
    out the recurrence (for the FLOP counts, which add it from its
    shapes). Past ``BLOCK`` shots under autograd, the parts before and
    after the recurrence run under ``torch.utils.checkpoint`` (their
    [S, H d] intermediates, ~2 GB a layer at an hour of shots, are made
    again in the backward; the values are the same)."""
    remat = torch.is_grad_enabled() and x.shape[1] > BLOCK and not dense_only
    if remat:
        q, k, v, g, beta = checkpoint(kda_inputs, x, p, name, model,
                                      use_reentrant=False)
    else:
        q, k, v, g, beta = kda_inputs(x, p, name, model)
    if dense_only:
        o = v + 0 * (q.sum(-1, keepdim=True) + k.sum(-1, keepdim=True)
                     + g.sum(-1, keepdim=True) + beta[..., None])
    else:
        o = kda_recurrence(q, k, v, g, beta)
    if remat:
        return checkpoint(kda_output, o, x, p, name, model,
                          use_reentrant=False)
    return kda_output(o, x, p, name, model)


def nope_table(s: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) that rotate by nothing: decoder.mla without positions."""
    return (torch.ones(s, dim, device=device),
            torch.zeros(s, dim, device=device))


def decoder_forward(x: torch.Tensor, mask: torch.Tensor, p: Leaves,
                    name: str, model: dict,
                    biases: Optional[Dict[str, torch.Tensor]] = None,
                    routes: Optional[list] = None, dense_only: bool = False,
                    replay=None) -> torch.Tensor:
    """One modality's decoder; ``biases``, ``routes``, ``replay`` and
    ``dense_only`` as in ``decoder.decoder``."""
    eps = model["rms_norm_eps"]
    if model["mla_use_nope"]:
        rope = nope_table(x.shape[1], model["qk_rope_head_dim"], x.device)
    else:
        rope = decoder.rope_cos_sin(x.shape[1], model["qk_rope_head_dim"],
                                    model["rope_theta"], x.device)
    for i in range(model["temporal_layers"]):
        blk = f"{name}.{i}"
        y = decoder.rms_norm(x, p[f"{blk}.ln0.g"], eps)
        if is_kda(model, i):
            x = x + kda(y, p, blk, model, dense_only)
        else:
            x = x + decoder.mla(y, mask, p, blk, model, rope, dense_only)
        y = decoder.rms_norm(x, p[f"{blk}.ln1.g"], eps)
        if i < model["first_k_dense_replace"]:
            x = x + decoder.swiglu(y, p, f"{blk}.mlp")
        else:
            x = x + decoder.moe(y, mask, p, blk, model,
                                (biases or {}).get(blk), routes, dense_only,
                                replay)
    return decoder.rms_norm(x, p[f"{name}.norm.g"], eps) * mask[..., None]


def fusion_heads(model: dict) -> int:
    return model["fusion_heads"] or model["num_heads"]


def forward(p: Leaves, model: dict, visual: torch.Tensor, audio: torch.Tensor,
            mask: torch.Tensor, seeds=None,
            biases: Optional[Dict[str, torch.Tensor]] = None,
            routes: Optional[list] = None, dense_only: bool = False,
            replay: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """[B, S] scores, as ``decoder.forward``."""
    replay = None if replay is None else iter(replay)
    rate = model["dropout"]
    v = dropout(F.relu(scorer.linear(visual, p, "visual_fc")), rate, seeds)
    a = dropout(F.relu(scorer.linear(audio, p, "audio_fc")), rate, seeds)
    v = decoder_forward(v, mask, p, "visual_enc", model, biases, routes,
                        dense_only, replay)
    a = decoder_forward(a, mask, p, "audio_enc", model, biases, routes,
                        dense_only, replay)
    fused = torch.cat([v, a], dim=-1)
    fused = fused + decoder.fusion_attention(fused, mask, p,
                                             fusion_heads(model))
    x = F.relu(scorer.linear(fused, p, "head"))
    return torch.sigmoid(scorer.linear(x, p, "out"))[..., 0] * mask


def first_kda_input(p: Leaves, model: dict, visual: torch.Tensor,
                    seeds=None) -> torch.Tensor:
    """The input of the visual decoder's first layer's attention: the
    modality Linear, ReLU, dropout, the layer's RMSNorm."""
    x = dropout(F.relu(scorer.linear(visual, p, "visual_fc")),
                model["dropout"], seeds)
    return decoder.rms_norm(x, p["visual_enc.0.ln0.g"], model["rms_norm_eps"])


def train_steps(leaves: Leaves, model: dict, train: dict, total_steps: int,
                batches: List[Dict[str, torch.Tensor]], seed: int,
                replay: Optional[List[List[torch.Tensor]]] = None,
                ) -> Tuple[List[float], Leaves, List[List[torch.Tensor]]]:
    """``decoder.train_steps`` over this forward."""
    opt = AdamW(leaves, train, total_steps)
    losses: List[float] = []
    first: Optional[Leaves] = None
    routes: List[List[torch.Tensor]] = []
    for step, batch in enumerate(batches):
        params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        routes.append([])
        preds = forward(params, model, batch["visual"], batch["audio"],
                        batch["mask"], step_seeds(seed, step),
                        routes=routes[-1],
                        replay=None if replay is None else replay[step])
        loss = masked_mse(preds, batch["targets"], batch["mask"])
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        losses.append(loss.item())
        clipped = opt.step(grads)
        if first is None:  # kept on the host, out of the next steps' way
            first = {k: g.to("cpu", copy=True) for k, g in clipped.items()}
        del params, preds, loss, grads
    return losses, first, routes
