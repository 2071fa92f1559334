"""Frame preprocessing, the backbones and per-shot pooling
(``avsum_tpu/vision/backbone.py``).

Frames enter as [B, H, W, 3] RGB (the JAX package's layout), are
normalized (/255, ImageNet mean/std) in the compute dtype BEFORE the
bilinear resize, as the JAX package does, and the resize antialiases
when it downsamples, as ``jax.image.resize(..., "bilinear")`` does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.ops.color import yuv420_to_rgb
from avsum_torch.train.config import VisualFeatConfig
from avsum_torch.vision.inception import InceptionV3
from avsum_torch.vision.resnet import ResNet50

IMAGENET_MEAN = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32)
IMAGENET_STD = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normalize_frames(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] RGB in [0, 255] -> /255 in ``dtype``, then ImageNet
    mean/std in float32, cast back to ``dtype`` (JAX's promotion order)."""
    x = frames.to(dtype) / torch.tensor(255.0, dtype=dtype)
    x = (x.float() - IMAGENET_MEAN.to(x.device)) / IMAGENET_STD.to(x.device)
    return x.to(dtype)


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    """[n_in, n_out] bilinear weights of ``jax.image.resize``, in its
    float32 arithmetic: a triangle kernel, widened by n_in / n_out when
    shrinking (the antialias), normalized over each output sample."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - dist / max(inv_scale, f32(1)))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0)).astype(f32)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW bilinear resize to size x size, antialiased when shrinking, as
    two matmuls with ``jax.image.resize``'s weights (``F.interpolate``'s
    antialiased kernel has no bfloat16 version on the CPU)."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    wh = _resize_weights(h, size, x.device, x.dtype)
    ww = _resize_weights(w, size, x.device, x.dtype)
    return wh.T @ (x @ ww)


def preprocess_frames(frames: torch.Tensor, size: int,
                      dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] RGB -> normalized NCHW [B, 3, size, size]."""
    return resize(normalize_frames(frames, dtype).permute(0, 3, 1, 2), size)


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Flax/XLA "SAME" padding for a square kernel (extra row/col at the
    high end)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TinyBackbone(nn.Module):
    """Small conv stand-in for the dual backbone (CPU tests only)."""

    def __init__(self, out_dim: int = 4096, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(3, 32, 5, stride=4).to(dtype)
        self.conv1 = nn.Conv2d(32, 64, 3, stride=2).to(dtype)
        self.dense = nn.Linear(64, out_dim)  # float32 head, as in JAX

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = preprocess_frames(frames, 64, self.dtype)
        x = F.relu(self.conv0(_same_pad(x, 5, 4)))
        x = F.relu(self.conv1(_same_pad(x, 3, 2)))
        return self.dense(x.mean(dim=(2, 3)).float())


class DualBackbone(nn.Module):
    """ResNet50 ‖ InceptionV3 -> [B, 4096]: one normalization at the shipped
    resolution, then a resize to 224 and to 299 in ``dtype``."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet50()
        self.inception = InceptionV3()
        self.to(dtype)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = normalize_frames(frames, self.dtype).permute(0, 3, 1, 2)
        r = self.resnet(resize(x, 224))
        i = self.inception(resize(x, 299))
        return torch.cat([r, i], dim=-1)


class VisualFrontend:
    """Frame embedding on the device + masked per-shot mean pooling."""

    def __init__(self, config: VisualFeatConfig, model: nn.Module,
                 device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = config.batch_size

    @torch.inference_mode()
    def frame_features_yuv(self, y: np.ndarray, u: np.ndarray,
                           v: np.ndarray) -> torch.Tensor:
        """YUV420 planes [F, H, W] / [F, H/2, W/2] uint8 -> [F, D] float32
        features on the device, in batches of ``batch_size`` frames."""
        feats = []
        for i in range(0, y.shape[0], self.batch_size):
            planes = [torch.from_numpy(np.ascontiguousarray(p[i:i + self.batch_size]))
                      .to(self.device) for p in (y, u, v)]
            frames = torch.stack(yuv420_to_rgb(*planes), dim=-1)
            feats.append(self.model(frames).float())
        if not feats:
            return torch.zeros(0, self.config.feature_dim, device=self.device)
        return torch.cat(feats)

    @torch.inference_mode()
    def frame_features(self, frames: np.ndarray) -> torch.Tensor:
        """[F, H, W, 3] RGB frames -> [F, D] float32 features on the
        device, in batches of ``batch_size`` frames (uint8 goes up as it
        is and is converted on the device)."""
        feats = [self.model(torch.from_numpy(np.ascontiguousarray(
            frames[i:i + self.batch_size])).to(self.device)).float()
            for i in range(0, frames.shape[0], self.batch_size)]
        if not feats:
            return torch.zeros(0, self.config.feature_dim, device=self.device)
        return torch.cat(feats)

    def shot_features(self, frames: Optional[np.ndarray],
                      frame_shot_ids: np.ndarray, n_shots: int,
                      yuv=None) -> torch.Tensor:
        """Frames tagged with their shot id -> [n_shots, D] mean-pooled on
        the device; a shot with no frame gets zeros. ``yuv=(y, u, v)``
        planes (with ``frames`` None) take the YUV420 path."""
        feats = (self.frame_features_yuv(*yuv) if yuv is not None
                 else self.frame_features(frames))
        ids = np.asarray(frame_shot_ids, np.int64)
        return self.pool(feats, ids, np.ones(len(ids), bool), n_shots)[0]

    @torch.inference_mode()
    def pool(self, feats: torch.Tensor, shot_ids: np.ndarray,
             keep: np.ndarray, n_shots: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked segment mean of ``pool_on_device`` (run_ids=None): frame f
        adds to shot ``shot_ids[f]`` when ``keep[f]``. -> (pooled [n_shots,
        D] float32, counts [n_shots] float32), on the device."""
        ids = torch.from_numpy(np.asarray(shot_ids, np.int64)).to(self.device)
        w = torch.from_numpy(np.asarray(keep, np.float32)).to(self.device)
        d = feats.shape[1]
        sums = torch.zeros(n_shots, d, device=self.device).index_add_(
            0, ids, feats.float() * w[:, None])
        counts = torch.zeros(n_shots, device=self.device).index_add_(0, ids, w)
        return sums / counts.clamp(min=1.0)[:, None], counts


def sample_shot_frames(
    shot_boundaries: np.ndarray,
    frame_stride: int = 3,
    max_frames_per_shot: int = 96,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every ``frame_stride``-th frame from each shot's start, capped per
    shot -> (frame indices, shot ids); a numpy copy of the JAX module's."""
    frame_idx, shot_ids = [], []
    for s, (start, end) in enumerate(np.asarray(shot_boundaries, np.int64)):
        idx = np.arange(start, end)[::frame_stride][:max_frames_per_shot]
        frame_idx.append(idx)
        shot_ids.append(np.full(len(idx), s, np.int64))
    if not frame_idx:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(frame_idx), np.concatenate(shot_ids)


def make_backbone(config: VisualFeatConfig, seed: int = 0,
                  state_dict: Optional[dict] = None) -> nn.Module:
    """The backbone for ``config.backbone`` (dual | tiny) with weights from
    ``state_dict`` or, without one, seeded random ones."""
    dtype = DTYPES[config.dtype]
    if config.weights:
        raise ValueError(
            "visual.weights holds a JAX param file; convert it with "
            "avsum_torch.convert and pass the state_dict instead")
    if config.backbone == "dual":
        model = DualBackbone(dtype)
    elif config.backbone == "tiny":
        model = TinyBackbone(config.feature_dim, dtype)
    else:
        raise ValueError(f"visual backbone {config.backbone!r} is not ported")
    if state_dict is None:
        fast_init_(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model
