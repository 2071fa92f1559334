"""The audio-visual shot scorer with Moonlight-16B-A3B's decoder as each
modality's temporal encoder, and its training step, written out in plain
PyTorch from the published description (DeepSeek-V2, arXiv:2405.04434;
DeepSeek-V3, arXiv:2412.19437; the model's ``config.json`` and
``modeling_deepseek.py``), float32, with no kernel and no batching trick:

    visual [B, S, Dv], audio [B, S, Da]
      -> per modality: Linear(hidden) -> ReLU -> dropout
      -> per modality the decoder: per layer i
           h = x + MLA(RMSNorm(x)); x = h + FFN_i(RMSNorm(h))
         FFN_i a SwiGLU of intermediate_size below first_k_dense_replace,
         else the MoE; then RMSNorm, times the mask
      -> concatenation [B, S, 2 hidden] plus its multi-head self-attention
      -> Linear(scorer_hidden) -> ReLU -> Linear(1) -> sigmoid, times the mask

RMSNorm: x / sqrt(mean(x^2) + eps) * g. SwiGLU: down(silu(gate x) * up x),
no biases.

MLA (no q compression): q = x W_q^T as [nope | rope] columns a head;
[latent | k_rope] = x W_kv_a^T; [k_nope | v] a head = RMSNorm(latent)
W_kv_b^T; RoPE over the shot index (theta ``rope_theta``) on q's rope
columns and on the one rope key every head shares, the columns first
de-interleaved (the source's view(d / 2, 2).transpose(4, 3)), then
x cos + rotate_half(x) sin with cos, sin of [f | f]; logits scaled by
(nope + rope)^-1/2; o_proj over the heads' v.

MoE: sigmoid(x W_router^T) in float32 over every routed expert; the top
k by score + correction bias; weights the unbiased scores of those k over
their sum (+ 1e-20), times ``routed_scaling_factor``. The layer holds
experts 0 .. ``moe_experts_held`` - 1: for each of them the tokens that
chose it are gathered, its SwiGLU applied and its weighted output added
back; plus the shared experts, one SwiGLU of n_shared_experts *
moe_intermediate_size, on every token. Padded shots choose no expert.

Departures from the source, each the scorer's: attention is
bidirectional over the real shots (padded keys biased by -1e30), not
causal; there is no vocabulary (the input is shot features, the output
the scorer's); the correction bias is an input, 0 unless given (random
weights have no learned bias) and not updated; no auxiliary balance loss.
Attention is materialized, in blocks of ``QUERY_BLOCK`` queries under
``torch.utils.checkpoint`` past that many shots, so that S = 7168 at 16
heads fits. The fusion attention is the attention scorer's
(``scorer.py``: q, k, v and o with biases, D^-1/2). For a check, the
MoE layers can take another run's choice of experts (``replay``), each
weighed by the reference's own scores: the top k is discontinuous, so
two float32 runs that differ by rounding choose differently where two
experts' scores tie within it, and then differ by a whole expert's output
on that shot; replayed, the rest of the arithmetic is compared alone,
and the choices are compared apart.

The loss, the optimizer and dropout are ``scorer.py``'s: the masked mean
squared error, global-norm clipping and AdamW under the warm-up and
cosine schedule, dropout masks from each step's seeds (the two modality
Linears are the only sites: the decoder has none).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import scorer
from benchmark.reference.scorer import AdamW, dropout, masked_mse, step_seeds

Leaves = Dict[str, torch.Tensor]

NEG_INF = -1e30
QUERY_BLOCK = 1024


# ----------------------------------------------------------------------
# leaves and their seeded initial values
# ----------------------------------------------------------------------

def _swiglu(name: str, dim: int, width: int) -> List[Tuple]:
    return [(f"{name}.gate", (width, dim), dim), (f"{name}.up", (width, dim), dim),
            (f"{name}.down", (dim, width), width)]


def decoder_specs(model: dict, name: str) -> List[Tuple]:
    """[(leaf, shape, fan-in)] of one modality's decoder; a fan-in of -1
    marks an RMSNorm scale."""
    hid, heads = model["hidden_dim"], model["num_heads"]
    nope, rope = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    rank, vd = model["kv_lora_rank"], model["v_head_dim"]
    held, width = model["moe_experts_held"], model["moe_intermediate_size"]
    specs: List[Tuple] = []
    for i in range(model["temporal_layers"]):
        blk = f"{name}.{i}"
        specs += [(f"{blk}.ln0.g", (hid,), -1),
                  (f"{blk}.q", (heads * (nope + rope), hid), hid),
                  (f"{blk}.kv_a", (rank + rope, hid), hid),
                  (f"{blk}.kv_norm.g", (rank,), -1),
                  (f"{blk}.kv_b", (heads * (nope + vd), rank), rank),
                  (f"{blk}.o", (hid, heads * vd), heads * vd),
                  (f"{blk}.ln1.g", (hid,), -1)]
        if i < model["first_k_dense_replace"]:
            specs += _swiglu(f"{blk}.mlp", hid, model["intermediate_size"])
        else:
            specs += [(f"{blk}.router", (model["n_routed_experts"], hid), hid),
                      (f"{blk}.experts.gate", (held, width, hid), hid),
                      (f"{blk}.experts.up", (held, width, hid), hid),
                      (f"{blk}.experts.down", (held, hid, width), width)]
            specs += _swiglu(f"{blk}.shared", hid,
                             model["n_shared_experts"] * width)
    return specs + [(f"{name}.norm.g", (hid,), -1)]


def leaf_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """[(name, shape, fan-in)] of every leaf, in a fixed order; a fan-in
    of 0 marks a bias, -1 a norm's scale."""
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
    """Every leaf from ``seed`` on ``device``, by ``scorer.py``'s rule:
    weights normal over the square root of their fan-in, drawn in one
    call; biases 0; norm scales 1."""
    specs = leaf_specs(model)
    total = sum(math.prod(shape) for _, shape, fan in specs if fan > 0)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out: Leaves = {}
    at = 0
    for name, shape, fan in specs:
        if fan > 0:
            n = math.prod(shape)
            out[name] = (flat[at:at + n] / math.sqrt(fan)).view(shape)
            at += n
        elif fan < 0:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ----------------------------------------------------------------------
# the forward pass
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def swiglu(x: torch.Tensor, p: Leaves, name: str) -> torch.Tensor:
    return (F.silu(x @ p[f"{name}.gate"].T) * (x @ p[f"{name}.up"].T)
            ) @ p[f"{name}.down"].T


def rope_cos_sin(s: int, dim: int, theta: float, device):
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=device) / dim))
    t = torch.arange(s, dtype=torch.float32, device=device)
    emb = torch.cat([torch.outer(t, inv_freq)] * 2, dim=-1)
    return emb.cos(), emb.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """``apply_rotary_pos_emb`` of the source on [B, S, H, d]."""
    b, s, h, d = x.shape
    x = x.view(b, s, h, d // 2, 2).transpose(4, 3).reshape(b, s, h, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    rotated = torch.cat((-x2, x1), dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T scale + key bias) v, [B, S, H, D] each, materialized
    a block of queries at a time."""
    bias = torch.where(mask > 0, 0.0, NEG_INF)[:, None, None, :]

    def block(qb: torch.Tensor) -> torch.Tensor:
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, k) * scale + bias
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)

    s = q.shape[1]
    if s <= QUERY_BLOCK:
        return block(q)
    return torch.cat([checkpoint(block, q[:, i:i + QUERY_BLOCK],
                                 use_reentrant=False)
                      for i in range(0, s, QUERY_BLOCK)], dim=1)


def mla(x: torch.Tensor, mask: torch.Tensor, p: Leaves, name: str,
        model: dict, rope, dense_only: bool) -> torch.Tensor:
    b, s, _ = x.shape
    h = model["num_heads"]
    nope, rd = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    vd, rank = model["v_head_dim"], model["kv_lora_rank"]
    q = (x @ p[f"{name}.q"].T).view(b, s, h, nope + rd)
    q_nope, q_pe = q.split([nope, rd], dim=-1)
    latent, k_pe = (x @ p[f"{name}.kv_a"].T).split([rank, rd], dim=-1)
    kv = rms_norm(latent, p[f"{name}.kv_norm.g"], model["rms_norm_eps"])
    k_nope, v = (kv @ p[f"{name}.kv_b"].T).view(b, s, h, nope + vd).split(
        [nope, vd], dim=-1)
    cos, sin = rope
    q = torch.cat([q_nope, rotate(q_pe, cos, sin)], dim=-1)
    k_pe = rotate(k_pe.view(b, s, 1, rd), cos, sin).expand(b, s, h, rd)
    k = torch.cat([k_nope, k_pe], dim=-1)
    if dense_only:  # the counts add attention from its shapes
        ctx = v + 0 * (q.sum(-1, keepdim=True) + k.sum(-1, keepdim=True))
    else:
        ctx = attend(q, k, v, mask, (nope + rd) ** -0.5)
    return ctx.reshape(b, s, h * vd) @ p[f"{name}.o"].T


def route(x: torch.Tensor, p: Leaves, name: str, model: dict,
          bias: Optional[torch.Tensor], choice: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, hidden] -> (chosen experts [N, k], their weights [N, k]);
    ``choice`` given: those experts, weighed by these scores."""
    scores = torch.sigmoid(x.float() @ p[f"{name}.router"].float().T)
    if choice is None:
        biased = scores if bias is None else scores + bias
        choice = torch.topk(biased, model["num_experts_per_tok"],
                            dim=-1).indices
    weights = scores.gather(1, choice)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return choice, weights * model["routed_scaling_factor"]


def moe(x: torch.Tensor, mask: torch.Tensor, p: Leaves, name: str,
        model: dict, bias: Optional[torch.Tensor], routes: Optional[list],
        dense_only: bool, replay: Optional[Iterator] = None) -> torch.Tensor:
    b, s, d = x.shape
    t = x.reshape(b * s, d)
    choice, weights = route(t, p, name, model, bias)
    if routes is not None:
        routes.append(choice.detach())
    if replay is not None:
        choice, weights = route(t, p, name, model, bias,
                                next(replay).to(t.device))
    out = swiglu(t, p, f"{name}.shared")
    if dense_only:  # the counts add the routed experts from their pairs
        return (out + 0 * weights.sum(-1, keepdim=True)).view(b, s, d)
    real = mask.reshape(-1) > 0
    for e in range(model["moe_experts_held"]):
        token, slot = ((choice == e) & real[:, None]).nonzero(as_tuple=True)
        xe = t[token]
        ye = (F.silu(xe @ p[f"{name}.experts.gate"][e].T)
              * (xe @ p[f"{name}.experts.up"][e].T)) @ p[f"{name}.experts.down"][e].T
        out = out.index_add(0, token, ye * weights[token, slot, None])
    return out.view(b, s, d)


def decoder(x: torch.Tensor, mask: torch.Tensor, p: Leaves, name: str,
            model: dict, biases: Optional[Dict[str, torch.Tensor]] = None,
            routes: Optional[list] = None, dense_only: bool = False,
            replay: Optional[Iterator] = None) -> torch.Tensor:
    """One modality's decoder; ``biases`` {layer name: correction bias}
    (None: 0); each MoE layer's choices appended to ``routes``;
    ``replay`` yields the choices each MoE layer takes in place of its
    own (its weights still its own scores'); ``dense_only`` leaves out
    the MLA's attention core and the routed experts (for the FLOP
    counts, which add them from their shapes)."""
    eps = model["rms_norm_eps"]
    rope = rope_cos_sin(x.shape[1], model["qk_rope_head_dim"],
                        model["rope_theta"], x.device)
    for i in range(model["temporal_layers"]):
        blk = f"{name}.{i}"
        x = x + mla(rms_norm(x, p[f"{blk}.ln0.g"], eps), mask, p, blk, model,
                    rope, dense_only)
        y = rms_norm(x, p[f"{blk}.ln1.g"], eps)
        if i < model["first_k_dense_replace"]:
            x = x + swiglu(y, p, f"{blk}.mlp")
        else:
            x = x + moe(y, mask, p, blk, model, (biases or {}).get(blk),
                        routes, dense_only, replay)
    return rms_norm(x, p[f"{name}.norm.g"], eps) * mask[..., None]


def fusion_attention(x: torch.Tensor, mask: torch.Tensor, p: Leaves,
                     heads: int) -> torch.Tensor:
    b, s, e = x.shape
    d = e // heads
    q, k, v = (scorer.linear(x, p, f"fusion.{n}").view(b, s, heads, d)
               for n in "qkv")
    ctx = attend(q, k, v, mask, d ** -0.5).reshape(b, s, e)
    return scorer.linear(ctx, p, "fusion.o") * mask[..., None]


def forward(p: Leaves, model: dict, visual: torch.Tensor, audio: torch.Tensor,
            mask: torch.Tensor, seeds=None,
            biases: Optional[Dict[str, torch.Tensor]] = None,
            routes: Optional[list] = None, dense_only: bool = False,
            replay: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """[B, S] scores; ``seeds`` None: no dropout (evaluation); ``routes``
    gets each MoE layer's choices, the visual decoder's layers first;
    ``replay``, in that order, the choices the layers take instead."""
    replay = None if replay is None else iter(replay)
    rate = model["dropout"]
    v = dropout(F.relu(scorer.linear(visual, p, "visual_fc")), rate, seeds)
    a = dropout(F.relu(scorer.linear(audio, p, "audio_fc")), rate, seeds)
    v = decoder(v, mask, p, "visual_enc", model, biases, routes, dense_only,
                replay)
    a = decoder(a, mask, p, "audio_enc", model, biases, routes, dense_only,
                replay)
    fused = torch.cat([v, a], dim=-1)
    fused = fused + fusion_attention(fused, mask, p, model["num_heads"])
    x = F.relu(scorer.linear(fused, p, "head"))
    return torch.sigmoid(scorer.linear(x, p, "out"))[..., 0] * mask


def train_steps(leaves: Leaves, model: dict, train: dict, total_steps: int,
                batches: List[Dict[str, torch.Tensor]], seed: int,
                replay: Optional[List[List[torch.Tensor]]] = None,
                ) -> Tuple[List[float], Leaves, List[List[torch.Tensor]]]:
    """Train ``leaves`` in place over ``batches``, one step each ->
    (each step's loss, the first step's clipped gradient, each step's
    own choices of every MoE layer). ``replay``: each step's choices of
    another run, which the MoE layers take in place of their own."""
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
        if first is None:
            first = clipped
        del params, preds, loss, grads
    return losses, first, routes
