"""AVScorer, the audio-visual shot scorer (``avsum_tpu/models/scorer.py``),
with "self" fusion and the BiLSTM or attention temporal encoder:

    visual [B,S,4096], audio [B,S,296]
      -> modality MLPs (Linear hidden + ReLU + dropout)
      -> temporal encoder per modality (BiLSTM, or attention blocks)
      -> concat [B,S,2*hidden] + self-attention over it (residual)
      -> Linear scorer_hidden -> ReLU -> Linear 1 (float32) -> sigmoid -> [B,S]

Module names follow the Flax tree (visual_fc.dense, visual_temporal.fwd or
visual_temporal.blocks.0, cross_attention.qkv, scorer_hidden, scorer_out).
``model.use_pallas`` reaches every self-attention through
:func:`avsum_torch.models.attention.kernel_enabled`. Dropout is active only
in ``train()`` mode and draws its masks from the generator passed to
``forward``. Cross fusion, the MoE and TCN encoders and pipeline stages
are not ported (``ROADMAP.md``) and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.attention import MultiHeadSelfAttention, kernel_enabled
from avsum_torch.models.temporal import (
    AttentionEncoder,
    BiLSTM,
    dropout,
    next_seed,
)
from avsum_torch.train.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_ported(config: ModelConfig) -> None:
    """Raise on the scorer variants the port does not have yet."""
    unported = []
    if config.temporal_encoder not in ("bilstm", "attention"):
        unported.append(f"temporal_encoder={config.temporal_encoder!r}")
    if config.fusion != "self":
        unported.append(f"fusion={config.fusion!r}")
    if config.pp_stages > 1:
        unported.append(f"pp_stages={config.pp_stages}")
    if unported:
        raise ValueError(
            f"not ported to avsum_torch yet: {', '.join(unported)} "
            "(see ROADMAP.md, queue A2 and A10-A11)")


class ModalityMLP(nn.Module):
    def __init__(self, in_features: int, hidden: int, rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rate = rate
        self.dense = nn.Linear(in_features, hidden)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        return dropout(F.relu(self.dense(x.to(self.dtype))), self.rate, seed)


class AVScorer(nn.Module):
    """Per-shot importance scores in [0, 1]; masked positions score 0."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        check_ported(config)
        self.config = config
        dtype = DTYPES[config.dtype]
        hid = config.hidden_dim
        use_kernel = kernel_enabled(config.use_pallas)
        self.visual_fc = ModalityMLP(config.visual_dim, hid, config.dropout,
                                     dtype)
        self.audio_fc = ModalityMLP(config.audio_dim, hid, config.dropout,
                                    dtype)
        if config.temporal_encoder == "bilstm":
            self.visual_temporal = BiLSTM(hid, hid, dtype)
            self.audio_temporal = BiLSTM(hid, hid, dtype)
        else:
            self.visual_temporal, self.audio_temporal = (
                AttentionEncoder(hid, config.temporal_layers,
                                 config.num_heads, config.dropout, dtype,
                                 use_kernel, config.remat).to(dtype)
                for _ in range(2))
        self.cross_attention = MultiHeadSelfAttention(
            2 * hid, config.num_heads, dtype, use_kernel)
        self.scorer_hidden = nn.Linear(2 * hid, config.scorer_hidden)
        self.scorer_out = nn.Linear(config.scorer_hidden, 1)
        for mod in (self.visual_fc, self.audio_fc, self.cross_attention,
                    self.scorer_hidden):
            mod.to(dtype)

    def forward(self, visual: torch.Tensor, audio: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: a CPU generator the dropout seeds are drawn from
        in ``train()`` mode (torch's default generator when None); unused
        in ``eval()`` mode."""
        if visual.dim() != 3 or audio.dim() != 3:
            raise ValueError("expect [B, S, D] inputs")
        gen = None
        if self.training and self.config.dropout > 0:
            gen = generator if generator is not None else torch.default_generator
        v = self.visual_fc(visual, next_seed(gen))
        a = self.audio_fc(audio, next_seed(gen))
        if self.config.temporal_encoder == "bilstm":
            v = self.visual_temporal(v, mask)
            a = self.audio_temporal(a, mask)
        else:
            v = self.visual_temporal(v, mask, gen)
            a = self.audio_temporal(a, mask, gen)
        fused = torch.cat([v, a], dim=-1)
        fused = fused + self.cross_attention(fused, mask)
        x = F.relu(self.scorer_hidden(fused.to(self.scorer_hidden.weight.dtype)))
        scores = torch.sigmoid(self.scorer_out(x.float()))[..., 0]
        if mask is not None:
            scores = scores * mask.to(scores.dtype)
        return scores


def make_model(config: ModelConfig = ModelConfig(), seed: int = 0,
               state_dict: Optional[dict] = None) -> AVScorer:
    """The scorer in eval mode, with weights from ``state_dict`` or seeded
    random ones."""
    model = AVScorer(config)
    if state_dict is None:
        fast_init_(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model.eval()
