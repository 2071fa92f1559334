"""Kimi Delta Attention (KDA), the linear-attention layer of Kimi Linear
(arXiv:2510.26692; ``fla/layers/kda.py`` of flash-linear-attention and
the model's ``modeling_kimi.py``), over a modality's shot features:
x [B, S, hidden] -> [B, S, hidden], with H heads of width d for keys
and values alike:

    q, k, v = SiLU(causal depthwise conv(W_{q,k,v} x))   (kernel
              ``short_conv_kernel_size``, no bias)
    q, k    = each head L2-normalised (x / sqrt(sum x^2 + 1e-6)); q
              scaled by d^-1/2
    g       = -exp(A_log[h]) softplus(f_b(f_a(x)) + dt_bias)   [H d]
    beta    = sigmoid(b_proj x)                              [H]
    S_t     = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1}
              + beta_t k_t v_t^T,   o_t = S_t^T q_t          (each head)
    y       = o_proj(RMSNorm_head(o) * sigmoid(g_b(g_a(x))))

f_a, g_a: hidden -> d; f_b: d -> H d without bias, g_b: d -> H d with
bias; A_log one value a head, dt_bias one a channel; the head-wise
RMSNorm has a weight of d and eps ``rms_norm_eps``. The recurrence runs
causal over the shots, as it is defined, by
:func:`avsum_torch.ops.kda.chunk_kda`'s chunks; padded shots come after
the real ones and so change none of them. Parameter names are the
source's (``q_conv1d``, ``f_a_proj``, ``dt_bias``, ``o_norm``, ...).
``fast_init_`` gives A_log and dt_bias their source's rule
(:meth:`KimiDeltaAttention.init_gates_`). Span: ``avsum.kda`` around the
forward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.ops import kda as kda_ops
from avsum_torch.ops.linear import Linear
from avsum_torch.train.config import ModelConfig
from avsum_torch.utils.profiling import annotate

L2_EPS = 1e-6
# the gates' init (fla's KDA layer): A in U(1, 16), softplus(dt_bias)
# log-uniform in [DT_MIN, DT_MAX], at least DT_FLOOR
A_RANGE = (1.0, 16.0)
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


def short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution: x [B, S, D], weight [D, 1, K] ->
    y_t = sum_i weight[:, i] x_{t - K + 1 + i} (zeros before the first
    shot), as shifted products in float32."""
    k = weight.shape[-1]
    s = x.shape[1]
    padded = F.pad(x, (0, 0, k - 1, 0))
    return sum(padded[:, i:i + s] * weight[:, 0, i] for i in range(k))


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


class ShortConv(nn.Conv1d):
    """SiLU(causal depthwise convolution) over [B, S, D], no bias; an
    ``nn.Conv1d``'s parameter ([D, 1, K]) and initialization."""

    def __init__(self, width: int, kernel: int):
        super().__init__(width, width, kernel, groups=width, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(short_conv(x, self.weight))


class KimiDeltaAttention(nn.Module):
    """[B, S, hidden] -> [B, S, hidden]; ``mask`` and ``rope`` are taken
    for the decoder layer's signature: the layer is causal and has no
    positions."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        c = config
        dim, h, d = c.hidden_dim, c.kda_num_heads, c.kda_head_dim
        width = h * d
        self.heads, self.head_dim = h, d
        self.q_proj = Linear(dim, width, bias=False)
        self.k_proj = Linear(dim, width, bias=False)
        self.v_proj = Linear(dim, width, bias=False)
        self.q_conv1d = ShortConv(width, c.short_conv_kernel_size)
        self.k_conv1d = ShortConv(width, c.short_conv_kernel_size)
        self.v_conv1d = ShortConv(width, c.short_conv_kernel_size)
        self.f_a_proj = Linear(dim, d, bias=False)
        self.f_b_proj = Linear(d, width, bias=False)
        self.A_log = nn.Parameter(torch.empty(h))
        self.dt_bias = nn.Parameter(torch.empty(width))
        self.b_proj = Linear(dim, h, bias=False)
        self.g_a_proj = Linear(dim, d, bias=False)
        self.g_b_proj = Linear(d, width, bias=True)
        self.o_norm = nn.RMSNorm(d, eps=c.rms_norm_eps)
        self.o_proj = Linear(width, dim, bias=False)

    @torch.no_grad()
    def init_gates_(self, gen: torch.Generator) -> None:
        """A_log = log A, A ~ U(1, 16) a head; dt_bias = softplus^-1(dt),
        dt log-uniform in [1e-3, 1e-1] (at least 1e-4) a channel."""
        lo, hi = A_RANGE
        a = lo + (hi - lo) * torch.rand(self.A_log.shape, generator=gen)
        self.A_log.copy_(a.log())
        dt = torch.exp(math.log(DT_MIN) + (math.log(DT_MAX) - math.log(DT_MIN))
                       * torch.rand(self.dt_bias.shape, generator=gen))
        dt = dt.clamp(min=DT_FLOOR)
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rope=None) -> torch.Tensor:
        with annotate("avsum.kda"):
            b, s, _ = x.shape
            h, d = self.heads, self.head_dim
            q = l2_norm(self.q_conv1d(self.q_proj(x)).view(b, s, h, d))
            k = l2_norm(self.k_conv1d(self.k_proj(x)).view(b, s, h, d))
            v = self.v_conv1d(self.v_proj(x)).view(b, s, h, d)
            g = -self.A_log.float().exp()[:, None] * F.softplus(
                (self.f_b_proj(self.f_a_proj(x)) + self.dt_bias).float(
                ).view(b, s, h, d))
            beta = torch.sigmoid(self.b_proj(x).float())
            o = kda_ops.chunk_kda(q * d ** -0.5, k, v, g, beta).to(x.dtype)
            gate = torch.sigmoid(self.g_b_proj(self.g_a_proj(x)))
            o = self.o_norm(o) * gate.view(b, s, h, d)
            return self.o_proj(o.reshape(b, s, h * d))
