"""Dataclass config system with YAML load + ``key.path=value`` CLI overrides.

Replaces the reference's never-loaded YAML (reference/configs/
data_config.yaml:1-16; SURVEY.md §5.6) and its hardcoded hyperparameters
(reference/scripts/train_av_model.py:64,68,70). The reference yaml's
keys (frame_size=299, visual sample_rate, audio sample_rate=16000) seed the
schema below.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "tvsum"  # tvsum | summe | synthetic
    video_dir: str = "data/videos"
    annotation_path: str = "data/ydata-tvsum50.mat"
    cache_dir: str = "data/processed"
    splits_path: str = "splits.json"
    n_folds: int = 5  # canonical 5-fold cross validation
    split_seed: int = 0  # reference splits were unseeded (create_splits.py:9)
    max_shots: int = 128  # padded shot-sequence bucket size
    batch_videos: int = 4  # videos per step (reference effective batch = 1)


@dataclass(frozen=True)
class AudioFeatConfig:
    sample_rate: int = 16000  # matches reference/VGGish (extractors.py:184)
    n_fft: int = 400
    # torchaudio's MelSpectrogram/MFCC default (hop = n_fft // 2), the
    # settings the reference ran with (extractors.py:236-246). Also the
    # n_fft == 2*hop shape the fused log-mel kernel K1 requires.
    hop_length: int = 200
    win_length: int = 400
    n_mels: int = 128  # reference MelSpectrogram n_mels=128 (extractors.py:241)
    n_mfcc: int = 40  # reference MFCC n_mfcc=40 (extractors.py:236)
    fmin: float = 0.0
    fmax: Optional[float] = None  # default sr/2
    log_base2: bool = True  # reference uses log2(mel + 1e-6) (extractors.py:243)
    eps: float = 1e-6
    vggish_dim: int = 128
    encoder: str = "vggish"  # vggish | large (upgraded encoder, config 4)
    # compute/ship dtype for the audio encoder (the spectral front-end
    # stays f32 — its golden contract is torchaudio-pinned). bfloat16
    # halves the ~290 MB VGGish weight upload a fresh process pays and
    # runs the convs on the tensor cores' bfloat16 path (cuDNN).
    dtype: str = "float32"  # float32 | bfloat16
    # path to ported VGGish params (audio/port_vggish.py::vggish_from_torch
    # saved via utils/serialization.py). "" = random init — stand-in for the
    # reference's torch.hub download (extractors.py:188)
    vggish_weights: str = ""
    # the fused STFT->mel->log CUDA kernel K1 (csrc/melspec.cu): None or
    # True = on for CUDA devices (the plain spectral ops on the CPU), False
    # = off; requires n_fft == 2*hop_length
    use_pallas: Optional[bool] = None
    # missing-audio policy: audio comes from a <stem>.wav sidecar or the
    # container itself (PCM mp4 tracks demux natively, avsum_torch/io/mp4.py).
    # False (default) = error when a soundtrack should exist but cannot be
    # decoded; True = substitute silence with a warning (reference-era
    # behavior was silent substitution)
    silence_fallback: bool = False
    # audio feature contract: 40 (MFCC) + 128 (log-mel) + 128 (VGGish) = 296.
    # Resolves the reference's 296-vs-384 inconsistency (SURVEY.md §8.1).
    feature_dim: int = 296


@dataclass(frozen=True)
class VisualFeatConfig:
    resnet_size: int = 224
    inception_size: int = 299
    # frame sampling: sample_fps > 0 samples at that rate (the declared
    # reference config, data_config.yaml: visual sample_rate: 2, and the
    # literature standard); sample_fps == 0 falls back to every
    # frame_stride-th frame (the reference code's behavior, extractors.py:399)
    sample_fps: float = 2.0
    frame_stride: int = 3  # reference: every 3rd frame (extractors.py:399)
    max_frames_per_shot: int = 96  # reference caps at 100; 96 = multiple of 8
    # host-side bilinear pre-resize (square, even) before frames cross the
    # host->device link; 0 disables. The backbones resize to 224/299 anyway,
    # so 304 ships ~2.5x fewer bytes from 640x360 sources at equal model
    # input quality. Only applied when the source is LARGER than this.
    ship_size: int = 304
    # adaptive near-duplicate sampling: a sampled frame is shipped/embedded
    # only when its mean abs luma difference vs the last shipped frame
    # reaches this threshold (0-255 scale; 0 disables). Skipped frames
    # reuse their run's embedding in per-shot pooling (exact frame counts,
    # approximate embeddings — the pooled mean uses one noise realization
    # per run instead of several). Standard adaptive-sampling lever for
    # static-camera content; fidelity pinned in tests/test_dedup.py.
    dedup_threshold: float = 0.0
    backbone: str = "dual"  # dual (resnet50+inceptionv3) | resnet50 | vit
    # path to a ported backbone variable tree (utils/serialization.py;
    # built by vision/port_torch.py::dual_backbone_variables). "" = random
    # init — the explicit stand-in for the reference's implicit pretrained
    # torchvision downloads (extractors.py:25-26)
    weights: str = ""
    feature_dim: int = 4096  # 2048 + 2048 concat contract (extractors.py:108)
    # backbone=vit only: s16 (from-scratch, mean pool) | b16 (torchvision
    # vit_b_16 layout — the one the offline weight port targets)
    vit_variant: str = "s16"
    dtype: str = "bfloat16"
    # frames a device dispatch of the backbones (the visual frontend's
    # batch bucket; the tail is zero-padded to it): 256 as in the JAX
    # package, so that both embed the same buckets.
    batch_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    visual_dim: int = 4096
    audio_dim: int = 296
    hidden_dim: int = 512
    num_heads: int = 4
    scorer_hidden: int = 64
    dropout: float = 0.3
    # attention | bilstm | tcn | moe | mla_moe (models/decoder.py)
    temporal_encoder: str = "attention"
    temporal_layers: int = 2
    # pipeline parallelism for the attention encoder (temporal_encoder:
    # "attention" only): >1 groups temporal_layers into this many GPipe
    # stages over the mesh's `model` axis, one stage's weights a rank, the
    # microbatches passed between ranks by the process group's sends and
    # receives (parallel/pipeline.py). 0/1 = off. The stage count must
    # equal mesh.model when the mesh's model axis is >1; without a model
    # axis the same stacked params run one after another (identical math,
    # mesh-portable checkpoints).
    pp_stages: int = 0
    # mixture-of-experts temporal encoder (temporal_encoder: "moe", the
    # expert-parallel upgraded-encoder path — experts shard over the mesh's
    # `model` axis when the trainer passes a mesh)
    moe_experts: int = 4
    moe_topk: int = 2
    # the DeepSeek-V3 decoder (temporal_encoder: "mla_moe"), keys named as
    # in the source's config.json; hidden_dim, num_heads and
    # temporal_layers give hidden_size, num_attention_heads and
    # num_hidden_layers. Latent attention: q without compression, k and v
    # from a kv_lora_rank latent, decoupled RoPE on qk_rope_head_dim
    # columns. Layers below first_k_dense_replace take a SwiGLU of
    # intermediate_size, the rest n_routed_experts SwiGLU experts of
    # moe_intermediate_size (sigmoid scores, the top num_experts_per_tok
    # by score + correction bias, weights normalized and scaled by
    # routed_scaling_factor) beside n_shared_experts shared ones.
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    # routed experts this chip holds (experts 0 .. held - 1, the first
    # rank's block under expert parallelism): the router scores all
    # n_routed_experts and the layer adds its held experts' share alone
    moe_experts_held: int = 64
    # Kimi Linear's hybrid (models/kda.py), keys named as in the source's
    # config.json: the 1-indexed layers in kda_layers
    # (linear_attn_config.kda_layers) take Kimi Delta Attention, of
    # kda_num_heads heads of kda_head_dim (linear_attn_config.num_heads,
    # .head_dim) behind a causal convolution of short_conv_kernel_size;
    # the others latent attention, with no rotary positions where
    # mla_use_nope. () builds latent attention in every layer.
    kda_layers: Tuple[int, ...] = ()
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    mla_use_nope: bool = False
    fusion: str = "self"  # self (MHSA over concat) | cross (co-attention)
    # heads of the self fusion's attention over [S, 2 hidden]; 0 = num_heads
    fusion_heads: int = 0
    chunk_size: int = 0  # 0 = full attention; >0 = blockwise/chunked
    # the flash-attention CUDA kernels (K2 forward, the fused backward, so
    # training never materializes [S, S] either): None or True = on for
    # CUDA tensors at sequences >= 512 (shorter ones and CPU tensors take
    # the materialized attention); False = off everywhere
    use_pallas: Optional[bool] = None
    # rematerialize attention blocks in the backward pass
    # (torch.utils.checkpoint): trades ~1 extra forward for not keeping
    # per-block activations, the memory lever for hour-scale (S~7200)
    # training
    remat: bool = False
    dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4  # reference AdamW lr (train_av_model.py:68)
    weight_decay: float = 1e-2
    epochs: int = 100  # reference (train_av_model.py:70)
    warmup_steps: int = 50
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    eval_every_epochs: int = 10
    save_every_epochs: int = 1  # checkpoint cadence (last epoch always saved)
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_path: Optional[str] = None  # JSONL scalar sink
    debug_nans: bool = False
    # float32 matmul precision for training, mapped onto torch's TF32
    # switches by train/steps.py::apply_matmul_precision (process-wide,
    # by the Trainer): "default" leaves torch's own settings (float32
    # products in full float32, through cuBLAS and the port's 3xTF32
    # CUDA kernels; cuDNN's convolutions in TF32); "float32"/"highest"
    # turns TF32 off for matmuls and cuDNN alike; "high"/"tensorfloat32"
    # turns it on (one TF32 pass, about three decimal digits; the port's
    # Linear kernel then leaves the products to cuBLAS); "bfloat16" lets
    # float32 matmuls run in bfloat16. Use "highest" for numerics-
    # sensitive A/B comparisons: PARITY_PROCEDURE.md §6 records a trained
    # model whose behavior changed with the precision alone.
    matmul_precision: str = "default"
    # Polyak/EMA weight averaging: > 0 maintains an exponential moving
    # average of the params on device (decay per step, e.g. 0.999) and
    # evaluates/scores with the averaged weights — a cheap stabilizer
    # for small-data training. 0 disables (no state, no overhead).
    ema_decay: float = 0.0


@dataclass(frozen=True)
class MeshShape:
    data: int = 1
    seq: int = 1
    model: int = 1
    auto_data: bool = True


@dataclass(frozen=True)
class SummaryConfig:
    budget_fraction: float = 0.15  # canonical 15%-duration knapsack budget
    min_shot_frames: int = 1


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    audio: AudioFeatConfig = field(default_factory=AudioFeatConfig)
    visual: VisualFeatConfig = field(default_factory=VisualFeatConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshShape = field(default_factory=MeshShape)
    summary: SummaryConfig = field(default_factory=SummaryConfig)


# ---------------------------------------------------------------------------
# Loading / overriding
# ---------------------------------------------------------------------------


def _from_dict(cls, d: Dict[str, Any]):
    if not is_dataclass(cls):
        return d
    kwargs = {}
    valid = {f.name: f for f in fields(cls)}
    for key, value in (d or {}).items():
        if key not in valid:
            raise KeyError(f"unknown config key {cls.__name__}.{key}")
        f = valid[key]
        if is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[key] = _from_dict(f.type, value)
        elif isinstance(value, dict):
            # nested dataclass declared via string annotation
            sub = _resolve_type(f)
            kwargs[key] = _from_dict(sub, value) if sub else value
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _resolve_type(f) -> Optional[type]:
    t = f.type
    if isinstance(t, type) and is_dataclass(t):
        return t
    if isinstance(t, str):
        t = globals().get(t)
        if isinstance(t, type) and is_dataclass(t):
            return t
    return None


def _set_path(cfg, dotted: str, raw: str):
    """Immutable update ``cfg`` at ``a.b.c`` with a YAML-parsed value."""
    parts = dotted.split(".")
    value = yaml.safe_load(raw)
    if isinstance(value, str):
        # YAML 1.1 parses bare "3e-4" as a string; coerce numeric-looking text
        try:
            value = int(value)
        except ValueError:
            try:
                value = float(value)
            except ValueError:
                pass

    def rec(node, idx):
        name = parts[idx]
        if not hasattr(node, name):
            raise KeyError(f"unknown config path: {dotted}")
        if idx == len(parts) - 1:
            return dataclasses.replace(node, **{name: value})
        child = getattr(node, name)
        return dataclasses.replace(node, **{name: rec(child, idx + 1)})

    return rec(cfg, 0)


def load_config(
    yaml_path: Optional[str] = None, overrides: Sequence[str] = ()
) -> Config:
    """Build a Config from an optional YAML file plus ``a.b=c`` overrides."""
    cfg = Config()
    if yaml_path:
        with open(yaml_path) as fh:
            raw = yaml.safe_load(fh) or {}
        cfg = _from_dict(Config, raw)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like key.path=value, got {item!r}")
        key, _, val = item.partition("=")
        cfg = _set_path(cfg, key.strip(), val.strip())
    return _normalize(cfg)


def _normalize(cfg: Config) -> Config:
    """Hold ``model.kda_layers`` as a tuple (YAML gives a list), and make
    dependent dims follow the backbone choice.

    A resnet50-only backbone natively emits 2048-d features; the 4096
    contract (extractors.py:108) is the *dual*-backbone concat. When the
    dims were left at their dual defaults, follow the backbone instead of
    padding/duplicating features to fake the contract."""
    if isinstance(cfg.model.kda_layers, list):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, kda_layers=tuple(cfg.model.kda_layers)))
    if cfg.visual.backbone == "resnet50":
        if cfg.visual.feature_dim == 4096:
            cfg = _set_path(cfg, "visual.feature_dim", "2048")
        if cfg.model.visual_dim == 4096:
            cfg = _set_path(cfg, "model.visual_dim", "2048")
    return cfg


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str) -> None:
    with open(path, "w") as fh:
        yaml.safe_dump(to_dict(cfg), fh, sort_keys=False)
