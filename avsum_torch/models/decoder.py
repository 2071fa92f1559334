"""Moonlight-16B-A3B's decoder as a temporal encoder (``temporal_encoder:
mla_moe``): the DeepSeek-V3 layer (arXiv:2405.04434, arXiv:2412.19437) of
``modeling_deepseek.py``, over a modality's shot features in place of
token embeddings:

    x [B, S, hidden] -> per layer i:
        h = x + MLA(RMSNorm(x))
        x = h + FFN_i(RMSNorm(h))   # i < first_k_dense_replace: a SwiGLU
                                    # of intermediate_size; else the MoE
    -> RMSNorm -> times the mask

RMSNorm: x / sqrt(mean(x^2) + rms_norm_eps) * weight. No biases, no
dropout (the source's attention dropout is 0).

MLA without q compression (``q_lora_rank`` null): q = W_q x per head,
[qk_nope_head_dim | qk_rope_head_dim] columns; the latent
[kv_lora_rank | qk_rope_head_dim] = W_kv_a x, whose first part passes an
RMSNorm and W_kv_b to give each head's [k_nope | v]; the rope part is one
key shared by every head. RoPE (theta ``rope_theta``, no scaling) runs
over each shot's index on the rope columns as the source applies it:
the columns de-interleaved (evens, then odds), then x cos + rotate_half(x)
sin. Scores are scaled by (qk_nope + qk_rope)^-1/2. One departure from
the source: attention is bidirectional over the video's real shots,
padded keys masked, not causal, since the scorer judges each shot
against the whole video, as the port's attention encoder does. It runs
by :func:`avsum_torch.models.attention.attend`'s dispatch, with float32
probabilities on its materialized route; its kernels take q/k 192 and
v 128 unpadded.

The MoE layer: a float32 router of n_routed_experts outputs over the
float32 tokens, sigmoid scores; the top num_experts_per_tok experts by
score + ``e_score_correction_bias`` (a buffer, not trained; ``noaux_tc``
with one group), weighted by their unbiased scores normalized to sum 1
(``norm_topk_prob``) and scaled by ``routed_scaling_factor``; plus one
SwiGLU of n_shared_experts * moe_intermediate_size (the shared experts)
on every token. The layer holds ``moe_experts_held`` of the experts
(0 .. held - 1, the first rank's block of expert parallelism), routes
over all of them and adds its held experts' weighted outputs alone.
Dispatch is sparse: the token-expert pairs sorted by expert, one read of
the per-expert counts to the host, then for each held expert the
SwiGLU over its rows alone (``ops/linear.py`` products), combined by
``index_add``; no capacity, no dropped pairs. Padded shots are routed to
no expert.
Each dispatch adds to the counters ``HeldExperts.routed_held`` (pairs
computed here), ``.routed_total`` (pairs routed over every expert) and
``.host_syncs`` (its device-to-host reads), from the counts it reads
anyway. Spans: ``avsum.mla`` around each MLA forward, ``avsum.moe``
around each MoE forward.

Parameter names follow the source's where they map one to one
(``q_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``, ``kv_b_proj``,
``o_proj``, ``input_layernorm``, ``post_attention_layernorm``,
``mlp.gate``, ``mlp.shared_experts``, ``norm``); a SwiGLU's gate and up
projections are one ``gate_up`` matrix [2 width, dim] (gate rows first),
and the held experts' are stacked: ``experts.gate_up`` [held, 2 width,
dim], ``experts.down`` [held, dim, width].

There is no exchange over chips yet: on a mesh whose ``model`` or
``seq`` axis is above 1 the encoder raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.models.attention import attend
from avsum_torch.ops.linear import Linear, linear
from avsum_torch.parallel.mesh import AXIS_MODEL, AXIS_SEQ
from avsum_torch.train.config import ModelConfig
from avsum_torch.utils.profiling import annotate


def rope_table(s: int, dim: int, theta: float, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [S, dim] of positions 0 .. S - 1: the source's
    ``DeepseekV2RotaryEmbedding`` (float32 inverse frequencies
    theta^(-2i / dim), each angle twice, [f | f])."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim)
    angles = torch.outer(torch.arange(s, dtype=torch.float32, device=device),
                         inv)
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """[B, S, H, dim] rope columns, rotated: de-interleaved (the source's
    view(d / 2, 2).transpose), then x cos + rotate_half(x) sin."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[:, None, :] + half * sin[:, None, :]


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x), no biases; ``gate_up`` holds gate's rows
    then up's."""

    def __init__(self, dim: int, width: int):
        super().__init__()
        self.gate_up = Linear(dim, 2 * width, bias=False)
        self.down = Linear(width, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up(x).chunk(2, dim=-1)
        return self.down(F.silu(gate) * up)


class LatentAttention(nn.Module):
    """Multi-head latent attention without q compression, bidirectional
    over the real shots: [B, S, dim] -> [B, S, dim]."""

    def __init__(self, config: ModelConfig, use_kernel: bool):
        super().__init__()
        c = config
        self.heads = c.num_heads
        self.nope, self.rope, self.v_dim = (c.qk_nope_head_dim,
                                            c.qk_rope_head_dim, c.v_head_dim)
        self.rank = c.kv_lora_rank
        self.use_kernel = use_kernel
        dim = c.hidden_dim
        self.q_proj = Linear(dim, self.heads * (self.nope + self.rope),
                             bias=False)
        self.kv_a_proj_with_mqa = Linear(dim, self.rank + self.rope,
                                         bias=False)
        self.kv_a_layernorm = nn.RMSNorm(self.rank, eps=c.rms_norm_eps)
        self.kv_b_proj = Linear(self.rank,
                                self.heads * (self.nope + self.v_dim),
                                bias=False)
        self.o_proj = Linear(self.heads * self.v_dim, dim, bias=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        with annotate("avsum.mla"):
            b, s, _ = x.shape
            h = self.heads
            q_nope, q_pe = self.q_proj(x).view(b, s, h, -1).split(
                [self.nope, self.rope], dim=-1)
            latent, k_pe = self.kv_a_proj_with_mqa(x).split(
                [self.rank, self.rope], dim=-1)
            k_nope, v = self.kv_b_proj(self.kv_a_layernorm(latent)).view(
                b, s, h, -1).split([self.nope, self.v_dim], dim=-1)
            cos, sin = rope
            q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
            k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)
            k = torch.cat([k_nope, k_pe.expand(b, s, h, self.rope)], dim=-1)
            ctx = attend(q, k, v, mask, dtype=torch.float32,
                         kernel=self.use_kernel)
            return self.o_proj(ctx.to(x.dtype).reshape(b, s, h * self.v_dim))


class MoEGate(nn.Linear):
    """The router: float32 sigmoid scores of every expert, the top k by
    score + ``e_score_correction_bias``, their unbiased scores normalized
    and scaled. ``forward`` -> (experts [N, k] int64, weights [N, k]
    float32)."""

    def __init__(self, dim: int, n_experts: int, top_k: int, scale: float):
        super().__init__(dim, n_experts, bias=False)
        self.top_k, self.scale = top_k, scale
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(n_experts))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = torch.sigmoid(linear(x.float(), self.weight.float()))
        choice = torch.topk(scores + self.e_score_correction_bias,
                            self.top_k, dim=-1, sorted=False).indices
        weights = scores.gather(1, choice)
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        return choice, weights * self.scale


class HeldExperts(nn.Module):
    """This chip's routed experts 0 .. held - 1, stacked SwiGLUs:
    ``gate_up`` [held, 2 width, dim], ``down`` [held, dim, width]."""

    # stacked Linear weights [..., out, in]: ``fast_init_`` takes the last
    # axis as the fan-in
    stacked_linear = True
    # pairs computed here, pairs routed over every expert, device-to-host
    # reads: summed over every dispatch, never reset
    routed_held = routed_total = host_syncs = 0

    def __init__(self, held: int, n_experts: int, dim: int, width: int):
        super().__init__()
        self.n_experts = n_experts
        self.gate_up = nn.Parameter(torch.empty(held, 2 * width, dim))
        self.down = nn.Parameter(torch.empty(held, dim, width))

    def forward(self, x: torch.Tensor, choice: torch.Tensor,
                weights: torch.Tensor,
                keep: Optional[torch.Tensor]) -> torch.Tensor:
        """x [N, dim], the router's (choice, weights) [N, k], ``keep`` [N]
        (None: every token) -> [N, dim], the held experts' weighted sum."""
        k = choice.shape[1]
        held, n_experts = self.gate_up.shape[0], self.n_experts
        pairs = choice.reshape(-1)
        if keep is not None:  # padded shots go to no expert
            pairs = torch.where(keep.repeat_interleave(k) > 0, pairs,
                                n_experts)
        order = torch.argsort(pairs, stable=True)
        rows = torch.bincount(pairs, minlength=n_experts + 1).tolist()
        HeldExperts.host_syncs += 1
        HeldExperts.routed_total += sum(rows[:n_experts])
        HeldExperts.routed_held += sum(rows[:held])
        mine = order[:sum(rows[:held])]  # held experts sort first
        tokens = torch.div(mine, k, rounding_mode="floor")
        xs = x[tokens]
        outs, at = [], 0
        # every held expert runs, an empty one on no rows, so that each
        # holds a gradient; unbind's backward stacks the experts'
        # gradients once, where indexing would add a zero-filled copy of
        # the whole stack for each expert
        for e, (gate_up, down) in enumerate(zip(self.gate_up.unbind(0),
                                                self.down.unbind(0))):
            gate, up = linear(xs[at:at + rows[e]], gate_up).chunk(2, dim=-1)
            outs.append(linear(F.silu(gate) * up, down))
            at += rows[e]
        y = torch.cat(outs) * weights.reshape(-1)[mine, None]
        return x.new_zeros(x.shape).index_add(0, tokens, y)


class SparseMoE(nn.Module):
    """The routed experts this chip holds plus the shared experts."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        c = config
        if not 0 < c.moe_experts_held <= c.n_routed_experts:
            raise ValueError(f"model.moe_experts_held={c.moe_experts_held} "
                             f"must be in 1 .. n_routed_experts="
                             f"{c.n_routed_experts}")
        self.gate = MoEGate(c.hidden_dim, c.n_routed_experts,
                            c.num_experts_per_tok, c.routed_scaling_factor)
        self.experts = HeldExperts(c.moe_experts_held, c.n_routed_experts,
                                   c.hidden_dim, c.moe_intermediate_size)
        self.shared_experts = SwiGLU(
            c.hidden_dim, c.n_shared_experts * c.moe_intermediate_size)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        with annotate("avsum.moe"):
            b, s, d = x.shape
            flat = x.reshape(-1, d)
            choice, weights = self.gate(flat)
            keep = None if mask is None else mask.reshape(-1)
            routed = self.experts(flat, choice, weights.to(x.dtype), keep)
            return (routed + self.shared_experts(flat)).view(b, s, d)


class DecoderLayer(nn.Module):
    def __init__(self, config: ModelConfig, index: int, use_kernel: bool):
        super().__init__()
        c = config
        self.input_layernorm = nn.RMSNorm(c.hidden_dim, eps=c.rms_norm_eps)
        self.self_attn = LatentAttention(c, use_kernel)
        self.post_attention_layernorm = nn.RMSNorm(c.hidden_dim,
                                                   eps=c.rms_norm_eps)
        self.mlp = (SwiGLU(c.hidden_dim, c.intermediate_size)
                    if index < c.first_k_dense_replace else SparseMoE(c))

    def forward(self, x, mask, rope):
        x = x + self.self_attn(self.input_layernorm(x), mask, rope)
        y = self.post_attention_layernorm(x)
        return x + (self.mlp(y, mask) if isinstance(self.mlp, SparseMoE)
                    else self.mlp(y))


class DecoderEncoder(nn.Module):
    """``temporal_layers`` decoder layers and the final RMSNorm:
    [B, S, hidden] -> [B, S, hidden], times the mask."""

    def __init__(self, config: ModelConfig, use_kernel: bool, mesh=None):
        super().__init__()
        if mesh is not None and (mesh.size(AXIS_MODEL) > 1
                                 or mesh.size(AXIS_SEQ) > 1):
            raise ValueError(
                "temporal_encoder mla_moe runs on one device per replica: "
                "its experts' and shots' exchange over a mesh's model or "
                "seq axis is not written yet")
        self.theta = config.rope_theta
        self.rope_dim = config.qk_rope_head_dim
        self.layers = nn.ModuleList(
            DecoderLayer(config, i, use_kernel)
            for i in range(config.temporal_layers))
        self.norm = nn.RMSNorm(config.hidden_dim, eps=config.rms_norm_eps)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen`` is taken for the encoders' signature: the decoder has no
        dropout."""
        rope = rope_table(x.shape[1], self.rope_dim, self.theta, x.device)
        for layer in self.layers:
            x = layer(x, mask, rope)
        x = self.norm(x)
        return x if mask is None else x * mask.to(x.dtype)[..., None]
