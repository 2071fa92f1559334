"""BiLSTM temporal encoder (``avsum_tpu/models/temporal.py:31-104``).

The recurrence is a Python loop over time steps (the JAX package's
``lax.scan``). Gate order i, f, g, o; one bias; state frozen across
masked steps; the reverse direction walks from the last step.
Parameters keep the JAX layout: ``wi`` [F, 4H], ``wh`` [H, 4H], ``b`` [4H].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class LSTMCellScan(nn.Module):
    """One LSTM direction over [B, S, F] -> [B, S, H]."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32,
                 reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.reverse = reverse
        self.wi = nn.Parameter(torch.zeros(in_features, 4 * hidden, dtype=dtype))
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(4 * hidden, dtype=dtype))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        # input projections for all steps at once; only h @ wh stays inside
        xw = (torch.matmul(x, self.wi).float() + self.b).to(self.dtype)
        m = (torch.ones(b, s, 1, dtype=self.dtype, device=x.device)
             if mask is None else mask.to(self.dtype)[..., None])
        h = torch.zeros(b, self.hidden, dtype=self.dtype, device=x.device)
        c = torch.zeros_like(h)
        hs = [None] * s
        for t in (range(s - 1, -1, -1) if self.reverse else range(s)):
            gates = xw[:, t] + (h @ self.wh).to(self.dtype)
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            mt = m[:, t]
            h = mt * h_new + (1 - mt) * h
            c = mt * c_new + (1 - mt) * c
            hs[t] = h
        return torch.stack(hs, dim=1)


class BiLSTM(nn.Module):
    """Forward and backward halves concatenated: [B, S, F] -> [B, S, hidden]."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32):
        super().__init__()
        half = hidden // 2
        self.fwd = LSTMCellScan(in_features, half, dtype, reverse=False)
        self.bwd = LSTMCellScan(in_features, half, dtype, reverse=True)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = torch.cat([self.fwd(x, mask), self.bwd(x, mask)], dim=-1)
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return out
