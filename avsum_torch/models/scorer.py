"""AVScorer, the audio-visual shot scorer (``avsum_tpu/models/scorer.py``):

    visual [B,S,4096], audio [B,S,296]
      -> modality MLPs (Linear hidden + ReLU + dropout)
      -> temporal encoder per modality (``model.temporal_encoder``: BiLSTM,
         attention blocks, or with ``model.pp_stages`` > 1 the staged
         attention encoder, dilated convolutions "tcn", experts "moe")
      -> fusion: "self" concatenates and adds self-attention over the
         [B,S,2*hidden] concat (with ``model.chunk_size``, the only
         attention that takes it, as in JAX); "cross" adds to v its
         attention over a, then to a its attention over the updated v,
         and concatenates
      -> Linear scorer_hidden -> ReLU -> Linear 1 (float32) -> sigmoid -> [B,S]

Module names follow the Flax tree (visual_fc.dense, visual_temporal.fwd or
visual_temporal.blocks.0, cross_attention.qkv, v_attends_a.q, scorer_hidden,
scorer_out). ``model.use_pallas`` reaches every self-attention through
:func:`avsum_torch.models.attention.kernel_enabled`; the MoE blocks, the
stages and cross fusion materialize their attention as the JAX ones do.
Dropout is active only in ``train()`` mode and draws its masks from the
generator passed to ``forward``. Every variant runs on one device; the
mesh-parallel forms (GPipe stages, sharded experts, ring attention) are
not ported (``ROADMAP.md`` A6).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.attention import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
    kernel_enabled,
)
from avsum_torch.models.moe import MoEEncoder
from avsum_torch.models.temporal import (
    AttentionEncoder,
    BiLSTM,
    PipelinedAttentionEncoder,
    TemporalConvEncoder,
    dropout,
    next_seed,
)
from avsum_torch.train.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_temporal(config: ModelConfig, use_kernel: bool) -> nn.Module:
    """One modality's temporal encoder for ``config.temporal_encoder``."""
    dtype = DTYPES[config.dtype]
    hid, kind = config.hidden_dim, config.temporal_encoder
    if kind == "bilstm":
        return BiLSTM(hid, hid, dtype)
    if kind == "attention" and config.pp_stages > 1:
        return PipelinedAttentionEncoder(hid, config.temporal_layers,
                                         config.pp_stages, config.num_heads,
                                         dtype, config.remat)
    if kind == "attention":
        return AttentionEncoder(hid, config.temporal_layers, config.num_heads,
                                config.dropout, dtype, use_kernel,
                                config.remat).to(dtype)
    if kind == "moe":
        return MoEEncoder(hid, config.temporal_layers, config.num_heads,
                          config.moe_experts, config.moe_topk, config.dropout,
                          dtype)
    if kind == "tcn":
        return TemporalConvEncoder(hid, config.temporal_layers,
                                   dropout=config.dropout, dtype=dtype)
    raise ValueError(f"unknown temporal encoder {kind!r}")


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
        self.config = config
        dtype = DTYPES[config.dtype]
        hid = config.hidden_dim
        use_kernel = kernel_enabled(config.use_pallas)
        self.visual_fc = ModalityMLP(config.visual_dim, hid, config.dropout,
                                     dtype)
        self.audio_fc = ModalityMLP(config.audio_dim, hid, config.dropout,
                                    dtype)
        self.visual_temporal = make_temporal(config, use_kernel)
        self.audio_temporal = make_temporal(config, use_kernel)
        if config.fusion == "cross":
            self.v_attends_a, self.a_attends_v = (
                MultiHeadCrossAttention(hid, config.num_heads, dtype).to(dtype)
                for _ in range(2))
        else:
            self.cross_attention = MultiHeadSelfAttention(
                2 * hid, config.num_heads, dtype, use_kernel,
                config.chunk_size).to(dtype)
        self.scorer_hidden = nn.Linear(2 * hid, config.scorer_hidden)
        self.scorer_out = nn.Linear(config.scorer_hidden, 1)
        for mod in (self.visual_fc, self.audio_fc, self.scorer_hidden):
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
        if self.config.fusion == "cross":
            v = v + self.v_attends_a(v, a, mask)
            a = a + self.a_attends_v(a, v, mask)
            fused = torch.cat([v, a], dim=-1)
        else:
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
