"""The audio-visual shot scorer and its training step, written out in plain
PyTorch from the published description, float32, with no kernel, no
cache and no batching trick:

    visual [B, S, Dv], audio [B, S, Da]
      -> per modality: Linear(hidden) -> ReLU -> dropout
      -> per modality a temporal encoder:
           "bilstm": a forward and a backward LSTM of hidden / 2 each,
             gates i, f, g, o, one bias, the state held across masked
             shots, an explicit loop of products over the shots;
           "attention": sinusoidal positions, then pre-norm blocks:
             LayerNorm -> multi-head self-attention -> dropout -> residual,
             LayerNorm -> Linear 4x -> GELU (erf) -> Linear -> dropout ->
             residual, times the mask
      -> concatenation [B, S, 2 hidden] plus its multi-head self-attention
      -> Linear(scorer_hidden) -> ReLU -> Linear(1) -> sigmoid, times the mask

Attention is materialized: logits scaled by D^-1/2, padded keys biased by
-1e30, softmax, product with V, every step in float32. q, k and v are
separate leaves (the published layers), so a key's bias, whose gradient
is nought under softmax, is a leaf of its own.

The loss is the masked mean squared error; the optimizer clips the
gradient by its global norm (scaling only at a norm of the limit or more)
and runs AdamW (b1 0.9, b2 0.999, eps 1e-8, bias correction, decoupled
weight decay on every leaf) under a linear warm-up from 0 and a cosine
decay to a tenth, the rate read at the update count before the update.

Dropout keeps a value with probability 1 - rate and scales it by
1 / (1 - rate). Its masks are inputs: each step's seeds come from a CPU
generator seeded by the step's (seed, step) pair, one integer a dropout
site in the order the sites run, and each site draws its mask with
``torch.rand`` from a generator on the tensor's device seeded by it.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Leaves = Dict[str, torch.Tensor]

LN_EPS = 1e-6
NEG_INF = -1e30
B1, B2, EPS = 0.9, 0.999, 1e-8


# ----------------------------------------------------------------------
# leaves and their seeded initial values
# ----------------------------------------------------------------------

def _linear(name: str, n_in: int, n_out: int) -> List[Tuple]:
    return [(f"{name}.w", (n_out, n_in), n_in), (f"{name}.b", (n_out,), 0)]


def _attention(name: str, dim: int) -> List[Tuple]:
    return [spec for p in "qkvo" for spec in _linear(f"{name}.{p}", dim, dim)]


def leaf_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """[(name, shape, fan-in)] of every leaf, in a fixed order; a fan-in
    of 0 marks a bias, -1 a LayerNorm scale."""
    hid = model["hidden_dim"]
    specs: List[Tuple] = []
    for m, dim in (("visual", model["visual_dim"]), ("audio", model["audio_dim"])):
        specs += _linear(f"{m}_fc", dim, hid)
    for m in ("visual", "audio"):
        if model["temporal_encoder"] == "bilstm":
            half = hid // 2
            for d in ("fwd", "bwd"):
                specs += [(f"{m}_enc.{d}.wi", (hid, 4 * half), hid),
                          (f"{m}_enc.{d}.wh", (half, 4 * half), half),
                          (f"{m}_enc.{d}.b", (4 * half,), 0)]
        elif model["temporal_encoder"] == "attention":
            for i in range(model["temporal_layers"]):
                blk = f"{m}_enc.{i}"
                specs += [(f"{blk}.ln0.g", (hid,), -1), (f"{blk}.ln0.b", (hid,), 0)]
                specs += _attention(blk, hid)
                specs += [(f"{blk}.ln1.g", (hid,), -1), (f"{blk}.ln1.b", (hid,), 0)]
                specs += _linear(f"{blk}.ff0", hid, 4 * hid)
                specs += _linear(f"{blk}.ff1", 4 * hid, hid)
        else:
            raise ValueError(f"no reference for encoder "
                             f"{model['temporal_encoder']!r}")
    specs += _attention("fusion", 2 * hid)
    specs += _linear("head", 2 * hid, model["scorer_hidden"])
    specs += _linear("out", model["scorer_hidden"], 1)
    return specs


def init_leaves(model: dict, seed: int, device) -> Leaves:
    """Every leaf from ``seed`` on ``device``: weights normal over the
    square root of their fan-in, drawn in one call; biases 0; LayerNorm
    scales 1."""
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
# dropout masks
# ----------------------------------------------------------------------

def step_seeds(seed: int, step: int) -> Iterator[int]:
    """The dropout seeds of one step, one a site, in the order the sites
    run."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(mixed[0]))
    while True:
        yield int(torch.randint(0, 2 ** 62, (), generator=gen))


def dropout(x: torch.Tensor, rate: float,
            seeds: Optional[Iterator[int]]) -> torch.Tensor:
    if seeds is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(next(seeds))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ----------------------------------------------------------------------
# the forward pass
# ----------------------------------------------------------------------

def linear(x: torch.Tensor, p: Leaves, name: str) -> torch.Tensor:
    return x @ p[f"{name}.w"].T + p[f"{name}.b"]


def layer_norm(x: torch.Tensor, p: Leaves, name: str) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{name}.g"] + p[f"{name}.b"]


def self_attention(x: torch.Tensor, mask: torch.Tensor, p: Leaves,
                   name: str, heads: int) -> torch.Tensor:
    b, s, e = x.shape
    d = e // heads
    q, k, v = (linear(x, p, f"{name}.{n}").view(b, s, heads, d) for n in "qkv")
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    logits = logits + torch.where(mask > 0, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, e)
    return linear(ctx, p, f"{name}.o") * mask[..., None]


def positions(s: int, dim: int, device) -> torch.Tensor:
    """[S, dim] sinusoidal table: [sin | cos] halves, an odd width padded
    with a zero column."""
    half = dim // 2
    log_base = torch.tensor(math.log(10000.0), dtype=torch.float32,
                            device=device)
    freqs = torch.exp(-log_base
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / half)
    angles = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs
    table = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return F.pad(table, (0, dim - table.shape[-1]))


def lstm(x: torch.Tensor, mask: torch.Tensor, p: Leaves, name: str,
         reverse: bool) -> torch.Tensor:
    b, s, _ = x.shape
    xw = x @ p[f"{name}.wi"] + p[f"{name}.b"]
    wh = p[f"{name}.wh"]
    h = x.new_zeros(b, wh.shape[0])
    c = torch.zeros_like(h)
    hs: List[Optional[torch.Tensor]] = [None] * s
    for t in (range(s - 1, -1, -1) if reverse else range(s)):
        i, f, g, o = (xw[:, t] + h @ wh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs[t] = h
    return torch.stack(hs, dim=1)


def encoder(x: torch.Tensor, mask: torch.Tensor, p: Leaves, name: str,
            model: dict, seeds) -> torch.Tensor:
    if model["temporal_encoder"] == "bilstm":
        out = torch.cat([lstm(x, mask, p, f"{name}.fwd", False),
                         lstm(x, mask, p, f"{name}.bwd", True)], dim=-1)
        return out * mask[..., None]
    rate = model["dropout"]
    x = x + positions(x.shape[1], x.shape[2], x.device)[None]
    for i in range(model["temporal_layers"]):
        blk = f"{name}.{i}"
        y = self_attention(layer_norm(x, p, f"{blk}.ln0"), mask, p, blk,
                           model["num_heads"])
        x = x + dropout(y, rate, seeds)
        y = linear(F.gelu(linear(layer_norm(x, p, f"{blk}.ln1"), p,
                                 f"{blk}.ff0")), p, f"{blk}.ff1")
        x = (x + dropout(y, rate, seeds)) * mask[..., None]
    return x


def forward(p: Leaves, model: dict, visual: torch.Tensor, audio: torch.Tensor,
            mask: torch.Tensor, seeds: Optional[Iterator[int]] = None
            ) -> torch.Tensor:
    """[B, S] scores; ``seeds`` None: no dropout (evaluation)."""
    rate = model["dropout"]
    v = dropout(F.relu(linear(visual, p, "visual_fc")), rate, seeds)
    a = dropout(F.relu(linear(audio, p, "audio_fc")), rate, seeds)
    v = encoder(v, mask, p, "visual_enc", model, seeds)
    a = encoder(a, mask, p, "audio_enc", model, seeds)
    fused = torch.cat([v, a], dim=-1)
    fused = fused + self_attention(fused, mask, p, "fusion", model["num_heads"])
    x = F.relu(linear(fused, p, "head"))
    return torch.sigmoid(linear(x, p, "out"))[..., 0] * mask


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2 * mask).sum() / mask.sum().clamp_min(1.0)


# ----------------------------------------------------------------------
# the optimizer
# ----------------------------------------------------------------------

def learning_rate(train: dict, total_steps: int, count: int) -> float:
    peak, warm = train["lr"], train["warmup_steps"]
    if count < warm:
        return peak * count / warm
    decay = max(total_steps, warm + 1) - warm
    c = min(count - warm, decay)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * c / decay)) + 0.1)


class AdamW:
    """Global-norm clipping, then AdamW, over a dict of leaves it updates
    in place."""

    def __init__(self, leaves: Leaves, train: dict, total_steps: int):
        self.leaves = leaves
        self.train = train
        self.total_steps = total_steps
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Leaves) -> Leaves:
        """One update; -> the clipped gradient the moments took."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        limit = self.train["grad_clip"]
        scale = 1.0 if norm < limit else limit / norm
        lr = learning_rate(self.train, self.total_steps, self.count)
        self.count += 1
        wd = self.train["weight_decay"]
        clipped = {}
        for k, p in self.leaves.items():
            g = (grads[k] * scale).to(p.dtype)
            clipped[k] = g
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).add_(g * g, alpha=1 - B2)
            m_hat = self.mu[k] / (1 - B1 ** self.count)
            v_hat = self.nu[k] / (1 - B2 ** self.count)
            p.sub_(lr * (m_hat / (v_hat.sqrt() + EPS) + wd * p))
        return clipped


def train_steps(leaves: Leaves, model: dict, train: dict, total_steps: int,
                batches: List[Dict[str, torch.Tensor]], seed: int,
                ) -> Tuple[List[float], Leaves]:
    """Train ``leaves`` in place over ``batches``, one step each ->
    (each step's loss, the first step's clipped gradient)."""
    opt = AdamW(leaves, train, total_steps)
    losses: List[float] = []
    first: Optional[Leaves] = None
    for step, batch in enumerate(batches):
        params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        preds = forward(params, model, batch["visual"], batch["audio"],
                        batch["mask"], step_seeds(seed, step))
        loss = masked_mse(preds, batch["targets"], batch["mask"])
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        losses.append(loss.item())
        clipped = opt.step(grads)
        if first is None:
            first = clipped
        del params, preds, loss, grads
    return losses, first

