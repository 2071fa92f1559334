"""AVScorer, the audio-visual shot scorer (``avsum_tpu/models/scorer.py``),
with the BiLSTM temporal encoder and "self" fusion:

    visual [B,S,4096], audio [B,S,296]
      -> modality MLPs (Linear hidden + ReLU; dropout is off at inference)
      -> BiLSTM per modality
      -> concat [B,S,2*hidden] + self-attention over it (residual)
      -> Linear scorer_hidden -> ReLU -> Linear 1 (float32) -> sigmoid -> [B,S]

Module names follow the Flax tree (visual_fc.dense, visual_temporal.fwd,
cross_attention.qkv, scorer_hidden, scorer_out). The attention encoder,
cross fusion, MoE and TCN variants are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.attention import MultiHeadSelfAttention
from avsum_torch.models.temporal import BiLSTM
from avsum_tpu.train.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ModalityMLP(nn.Module):
    def __init__(self, in_features: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(in_features, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.dense(x.to(self.dtype)))


class AVScorer(nn.Module):
    """Per-shot importance scores in [0, 1]; masked positions score 0."""

    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        if config.temporal_encoder != "bilstm" or config.fusion != "self":
            raise ValueError(
                "only temporal_encoder=bilstm with fusion=self is ported; got "
                f"{config.temporal_encoder!r} / {config.fusion!r}")
        self.config = config
        dtype = DTYPES[config.dtype]
        hid = config.hidden_dim
        self.visual_fc = ModalityMLP(config.visual_dim, hid, dtype)
        self.audio_fc = ModalityMLP(config.audio_dim, hid, dtype)
        self.visual_temporal = BiLSTM(hid, hid, dtype)
        self.audio_temporal = BiLSTM(hid, hid, dtype)
        self.cross_attention = MultiHeadSelfAttention(2 * hid,
                                                      config.num_heads, dtype)
        self.scorer_hidden = nn.Linear(2 * hid, config.scorer_hidden)
        self.scorer_out = nn.Linear(config.scorer_hidden, 1)
        for mod in (self.visual_fc, self.audio_fc, self.cross_attention,
                    self.scorer_hidden):
            mod.to(dtype)

    def forward(self, visual: torch.Tensor, audio: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if visual.dim() != 3 or audio.dim() != 3:
            raise ValueError("expect [B, S, D] inputs")
        v = self.visual_temporal(self.visual_fc(visual), mask)
        a = self.audio_temporal(self.audio_fc(audio), mask)
        fused = torch.cat([v, a], dim=-1)
        fused = fused + self.cross_attention(fused, mask)
        x = F.relu(self.scorer_hidden(fused.to(self.scorer_hidden.weight.dtype)))
        scores = torch.sigmoid(self.scorer_out(x.float()))[..., 0]
        if mask is not None:
            scores = scores * mask.to(scores.dtype)
        return scores


def make_model(config: ModelConfig = ModelConfig(), seed: int = 0,
               state_dict: Optional[dict] = None) -> AVScorer:
    """The scorer with weights from ``state_dict`` or seeded random ones."""
    model = AVScorer(config)
    if state_dict is None:
        fast_init_(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model.eval()
