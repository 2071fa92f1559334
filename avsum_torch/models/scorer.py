"""AVScorer, the audio-visual shot scorer (``avsum_tpu/models/scorer.py``):

    visual [B,S,4096], audio [B,S,296]
      -> modality MLPs (Linear hidden + ReLU + dropout)
      -> temporal encoder per modality (``model.temporal_encoder``: BiLSTM,
         attention blocks, or with ``model.pp_stages`` > 1 the staged
         attention encoder, dilated convolutions "tcn", experts "moe",
         Moonlight-16B-A3B's decoder "mla_moe": latent attention and
         sparse experts, ``models/decoder.py``)
      -> fusion: "self" concatenates and adds self-attention over the
         [B,S,2*hidden] concat (with ``model.chunk_size``, the only
         attention that takes it, as in JAX); "cross" adds to v its
         attention over a, then to a its attention over the updated v,
         and concatenates
      -> Linear scorer_hidden -> ReLU -> Linear 1 (float32) -> sigmoid -> [B,S]

Module names follow the Flax tree (visual_fc.dense, visual_temporal.fwd or
visual_temporal.blocks.0, cross_attention.qkv, v_attends_a.q, scorer_hidden,
scorer_out). ``model.use_pallas`` reaches every self-attention through
:func:`avsum_torch.models.attention.kernel_enabled`, and each attention
runs by :func:`avsum_torch.models.attention.attend`'s dispatch; the MoE
blocks, the stages and cross fusion take no kernel, as the JAX ones do.
Dropout is active only in ``train()`` mode and draws its masks from the
generator passed to ``forward``.

On a mesh (``AVScorer(config, mesh)``, the rank's block [B / data, S /
seq] of the batch; :func:`to_mesh` makes it from a one-device scorer)
the JAX scorer's mesh plumbing holds: with ``seq`` > 1 the attention
encoder's and the self fusion's attention run as ring attention; with
``model`` > 1 the MoE encoder's experts are split over the axis and the
staged encoder's stages run as a GPipe schedule (``pp_stages`` must
equal the axis). Cross fusion, the MoE blocks' attention, the BiLSTM and
the convolutions have no ring in JAX: with ``seq`` > 1 they gather the
shot axis and keep the rank's block.
With ``tensor_parallel`` (the layout :func:`avsum_torch.train.steps.
shard_state` gives a train state) every other matrix is split over
``model`` by JAX's ``state_shardings`` rule and its products run
column-parallel (:mod:`avsum_torch.parallel.tensor`); without it they
are whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.attention import (
    MultiHeadCrossAttention,
    MultiHeadSelfAttention,
    kernel_enabled,
)
from avsum_torch.models.decoder import DecoderEncoder
from avsum_torch.models.moe import EXPERT_PARAMS, MoEEncoder, MoEFFN
from avsum_torch.models.temporal import (
    AttentionEncoder,
    BiLSTM,
    PipelinedAttentionEncoder,
    TemporalConvEncoder,
    dropout,
    gather_shots,
    next_seed,
    seq_split,
)
from avsum_torch.ops.linear import Linear
from avsum_torch.parallel.comm import local_block
from avsum_torch.parallel.mesh import (
    AXIS_MODEL,
    AXIS_SEQ,
    Split,
    shard_tensors,
)
from avsum_torch.parallel.tensor import parallelize
from avsum_torch.train.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_temporal(config: ModelConfig, use_kernel: bool,
                  mesh=None) -> nn.Module:
    """One modality's temporal encoder for ``config.temporal_encoder``."""
    dtype = DTYPES[config.dtype]
    hid, kind = config.hidden_dim, config.temporal_encoder
    if kind == "bilstm":
        return BiLSTM(hid, hid, dtype, mesh)
    if kind == "attention" and config.pp_stages > 1:
        return PipelinedAttentionEncoder(hid, config.temporal_layers,
                                         config.pp_stages, config.num_heads,
                                         dtype, config.remat, mesh)
    if kind == "attention":
        return AttentionEncoder(hid, config.temporal_layers, config.num_heads,
                                config.dropout, dtype, use_kernel,
                                config.remat, mesh).to(dtype)
    if kind == "moe":
        return MoEEncoder(hid, config.temporal_layers, config.num_heads,
                          config.moe_experts, config.moe_topk, config.dropout,
                          dtype, mesh)
    if kind == "tcn":
        return TemporalConvEncoder(hid, config.temporal_layers,
                                   dropout=config.dropout, dtype=dtype,
                                   mesh=mesh)
    if kind == "mla_moe":
        return DecoderEncoder(config, use_kernel, mesh).to(dtype)
    raise ValueError(f"unknown temporal encoder {kind!r}")


class ModalityMLP(nn.Module):
    def __init__(self, in_features: int, hidden: int, rate: float = 0.0,
                 dtype=torch.float32, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.rate = rate
        self.mesh = mesh
        self.dense = Linear(in_features, hidden)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        return dropout(F.relu(self.dense(x.to(self.dtype))), self.rate, seed,
                       self.mesh)


class AVScorer(nn.Module):
    """Per-shot importance scores in [0, 1]; masked positions score 0.

    ``mesh``: a :class:`avsum_torch.parallel.mesh.Mesh` (None: one
    device); the scorer then takes and returns this rank's block."""

    def __init__(self, config: ModelConfig = ModelConfig(), mesh=None,
                 tensor_parallel: bool = False):
        super().__init__()
        self.config = config
        self.mesh = mesh
        dtype = DTYPES[config.dtype]
        hid = config.hidden_dim
        use_kernel = kernel_enabled(config.use_pallas)
        if tensor_parallel and config.temporal_encoder == "mla_moe":
            raise ValueError("temporal_encoder mla_moe has no tensor-parallel "
                             "layout yet")
        if (mesh is not None and config.pp_stages > 1
                and 1 < mesh.size(AXIS_MODEL) != config.pp_stages):
            raise ValueError(
                f"model.pp_stages={config.pp_stages} must equal the mesh's "
                f"model axis size {mesh.size(AXIS_MODEL)} (one stage per "
                "device)")
        self.visual_fc = ModalityMLP(config.visual_dim, hid, config.dropout,
                                     dtype, mesh)
        self.audio_fc = ModalityMLP(config.audio_dim, hid, config.dropout,
                                    dtype, mesh)
        self.visual_temporal = make_temporal(config, use_kernel, mesh)
        self.audio_temporal = make_temporal(config, use_kernel, mesh)
        if config.fusion == "cross":
            self.v_attends_a, self.a_attends_v = (
                MultiHeadCrossAttention(hid, config.num_heads, dtype).to(dtype)
                for _ in range(2))
        else:
            self.cross_attention = MultiHeadSelfAttention(
                2 * hid, config.num_heads, dtype, use_kernel,
                config.chunk_size,
                ring_mesh=mesh if seq_split(mesh) else None).to(dtype)
        self.scorer_hidden = Linear(2 * hid, config.scorer_hidden)
        self.scorer_out = Linear(config.scorer_hidden, 1)
        for mod in (self.visual_fc, self.audio_fc, self.scorer_hidden):
            mod.to(dtype)
        self.tp_splits: Dict[str, Split] = (
            parallelize(self, mesh) if tensor_parallel and mesh is not None
            else {})

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
        v = self.visual_temporal(v, mask, gen)
        a = self.audio_temporal(a, mask, gen)
        if self.config.fusion == "cross":
            v, full_mask = gather_shots(v, mask, self.mesh)
            a, _ = gather_shots(a, None, self.mesh)
            v = v + self.v_attends_a(v, a, full_mask)
            a = a + self.a_attends_v(a, v, full_mask)
            fused = local_block(torch.cat([v, a], dim=-1), self.mesh,
                                AXIS_SEQ)
        else:
            fused = torch.cat([v, a], dim=-1)
            fused = fused + self.cross_attention(fused, mask)
        x = F.relu(self.scorer_hidden(fused.to(self.scorer_hidden.weight.dtype)))
        scores = torch.sigmoid(self.scorer_out(x.float()))[..., 0]
        if mask is not None:
            scores = scores * mask.to(scores.dtype)
        return scores


    def split_names(self) -> Dict[str, Split]:
        """{name: Split} of the parameters split over ``model``: the
        experts under expert parallelism and, with ``tensor_parallel``,
        the matrices; every other one is whole on the ranks that hold
        it."""
        experts = {f"{path}.{name}": Split()
                   for path, mod in self.named_modules()
                   if isinstance(mod, MoEFFN) and mod.ep_mesh is not None
                   for name in EXPERT_PARAMS}
        return {**experts, **self.tp_splits}


def to_mesh(model: AVScorer, mesh, tensor_parallel: bool = False
            ) -> AVScorer:
    """``model`` (one-device layout) on ``mesh``: a scorer of the same
    config built for the mesh (with ``tensor_parallel``, its matrices
    split over ``model``), holding this rank's share of ``model``'s
    parameters, on the mesh's device, in ``model``'s mode."""
    if mesh.world == 1:
        return model.to(mesh.device)
    local = AVScorer(model.config, mesh, tensor_parallel)
    shapes = {k: tuple(v.shape) for k, v in local.state_dict().items()}
    local.load_state_dict(shard_tensors(model.state_dict(), shapes,
                                        local.split_names(), mesh))
    return local.to(mesh.device).train(model.training)


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
