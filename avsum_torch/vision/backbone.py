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
from avsum_torch.utils.profiling import annotate
from avsum_torch.utils.transfer import HostCopy, PinnedRing, to_device
from avsum_torch.vision.inception import InceptionV3
from avsum_torch.vision.resnet import ResNet50

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet mean and std as float32 tensors on ``device``, uploaded
    once per device (an upload on every batch would wait for the
    device's queue)."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_frames(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] RGB in [0, 255] -> /255 in ``dtype``, then ImageNet
    mean/std in float32, cast back to ``dtype`` (JAX's promotion order)."""
    x = frames.to(dtype) / torch.tensor(255.0, dtype=dtype)
    mean, std = _imagenet_stats(x.device)
    x = (x.float() - mean) / std
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


class ResNetBackbone(nn.Module):
    """ResNet50 alone (``visual.backbone: resnet50``) -> [B, 2048]: frames
    normalized and resized to 224 in ``dtype``."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet50()
        self.to(dtype)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.resnet(preprocess_frames(frames, 224, self.dtype))


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
    """Frame embedding on the device + masked per-shot mean pooling.

    The dispatch methods upload each batch through a ring of pinned
    buffers (the span ``avsum.frame_upload``) and enqueue its embedding
    without waiting for the device, so the host can read the next batch
    (or run other host work) meanwhile; :meth:`pool_on_device` pools the
    pending features on the device."""

    MIN_BUCKET = 32

    def __init__(self, config: VisualFeatConfig, model: nn.Module,
                 device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = config.batch_size
        self._ring = PinnedRing(self.device)

    def tail_bucket(self, n: int) -> int:
        """Batch bucket for a block of ``n`` frames: ``batch_size`` for a
        full block, else the smallest power-of-two fraction of it (>=
        ``MIN_BUCKET``) that holds ``n``, so a short tail block embeds
        (and uploads) little padding."""
        b = self.batch_size
        while b // 2 >= max(n, self.MIN_BUCKET):
            b //= 2
        return b

    def _embed_packed(self, buf: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """One flat uint8 device buffer ``[B*h*w | B*(h/2)*(w/2) | same]``
        -> [B, D] float32 features (B from the buffer's length); the
        colour conversion's and both networks' launches are the span
        ``avsum.embed_enqueue``."""
        ny, nc = h * w, (h // 2) * (w // 2)
        b = buf.numel() // (ny + 2 * nc)
        y = buf[:b * ny].view(b, h, w)
        u = buf[b * ny:b * (ny + nc)].view(b, h // 2, w // 2)
        v = buf[b * (ny + nc):b * (ny + 2 * nc)].view(b, h // 2, w // 2)
        with annotate("avsum.embed_enqueue"):
            rgb = torch.stack(yuv420_to_rgb(y, u, v), dim=-1)
            return self.model(rgb).float()

    @torch.inference_mode()
    def dispatch_yuv(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        """Enqueue the embedding of YUV420 planes [F, H, W] / [F, H/2, W/2]
        uint8 in batches of ``batch_size`` (the tail zero-padded to its
        bucket) -> (pending [bucket, D] device tensors, F). Each batch goes
        up as one packed buffer."""
        f, h, w = y.shape
        ny, nc = h * w, (h // 2) * (w // 2)
        pending = []
        for i in range(0, f, self.batch_size):
            planes = [p[i:i + self.batch_size] for p in (y, u, v)]
            n = planes[0].shape[0]
            bb = self.tail_bucket(n)

            def fill(buf, planes=planes, n=n, bb=bb):
                for start, size, plane in ((0, ny, planes[0]),
                                           (bb * ny, nc, planes[1]),
                                           (bb * (ny + nc), nc, planes[2])):
                    buf[start:start + n * size] = plane.reshape(-1)
                    buf[start + n * size:start + bb * size] = 0

            with annotate("avsum.frame_upload"):
                dev = self._ring.upload(bb * (ny + 2 * nc), fill)
            pending.append(self._embed_packed(dev, h, w))
        return pending, f

    @torch.inference_mode()
    def dispatch_packed(self, buf: np.ndarray, h: int, w: int) -> torch.Tensor:
        """Enqueue the embedding of ONE packed plane buffer, the layout
        ``io.native``'s ``read_yuv420_packed`` writes (length ``bucket *
        (h*w + 2*(h/2)*(w/2))`` for a valid bucket) -> [bucket, D]."""
        per = h * w + 2 * (h // 2) * (w // 2)
        b, rem = divmod(buf.shape[0], per) if buf.ndim == 1 else (0, 1)
        if rem or b <= 0 or (b != self.batch_size and b != self.tail_bucket(b)):
            raise ValueError(
                f"packed buffer shape {buf.shape} is not a bucket multiple "
                f"of the {h}x{w} plane layout (full batch = "
                f"({self.batch_size * per},))")

        def fill(host):
            host[:] = buf

        with annotate("avsum.frame_upload"):
            dev = self._ring.upload(buf.shape[0], fill)
        return self._embed_packed(dev, h, w)

    def collect(self, pending, n_frames: int) -> np.ndarray:
        """Pending features -> [n_frames, D] float32 on the host."""
        if not pending:
            return np.zeros((0, self.config.feature_dim), np.float32)
        return torch.cat(pending)[:n_frames].cpu().numpy()

    def frame_features_yuv(self, y: np.ndarray, u: np.ndarray,
                           v: np.ndarray) -> torch.Tensor:
        """YUV420 planes [F, H, W] / [F, H/2, W/2] uint8 -> [F, D] float32
        features on the device."""
        pending, f = self.dispatch_yuv(y, u, v)
        if not pending:
            return torch.zeros(0, self.config.feature_dim, device=self.device)
        return torch.cat(pending)[:f]

    @torch.inference_mode()
    def frame_features(self, frames: np.ndarray) -> torch.Tensor:
        """[F, H, W, 3] RGB frames -> [F, D] float32 features on the
        device, in batches of ``batch_size`` frames (uint8 goes up as it
        is and is converted on the device)."""
        feats = [self.model(to_device(frames[i:i + self.batch_size],
                                      self.device)).float()
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
        """Masked segment mean: frame f adds to shot ``shot_ids[f]`` when
        ``keep[f]`` -> (pooled [n_shots, D] float32, counts [n_shots]
        float32), on the device."""
        ids = to_device(np.asarray(shot_ids, np.int64), self.device)
        w = to_device(np.asarray(keep, np.float32), self.device)
        sums = torch.zeros(n_shots, feats.shape[1], device=self.device)
        sums.index_add_(0, ids, feats.float() * w[:, None])
        counts = torch.zeros(n_shots, device=self.device).index_add_(0, ids, w)
        return sums / counts.clamp(min=1.0)[:, None], counts

    @torch.inference_mode()
    def pool_on_device(self, pending, n_frames: int, shot_ids: np.ndarray,
                       keep: np.ndarray, n_shots: int,
                       run_ids: Optional[np.ndarray] = None,
                       return_device: bool = False):
        """Segment-pool dispatched frame features on the device.

        ``shot_ids`` / ``keep``: each sampled frame's shot and cap mask.
        ``run_ids``: each sampled frame's index into the embedded frames
        (frame f pools embedding ``run_ids[f]``; with frame dedup only a
        run's first frame is embedded); None is the identity. The shot
        axis is bucketed to a multiple of 64 (at least 64) plus one
        overflow bin, which takes the padded frames.

        -> (pooled [n_shots, D], counts [n_shots]) float32 numpy arrays;
        with ``return_device`` the pooled features stay on the device as
        the whole [bucket + 1, D] tensor (rows >= n_shots are padding, the
        last is the overflow bin) and the counts come as a
        :class:`HostCopy` already on its way to the host."""
        if not pending:
            return (np.zeros((n_shots, self.config.feature_dim), np.float32),
                    np.zeros(n_shots, np.float32))
        feats = torch.cat(pending)
        n_bucket = max(64, -(-n_shots // 64) * 64)
        if run_ids is None:
            f_pad = feats.shape[0]
        else:
            # the sampled-frame axis, padded to a multiple of batch_size
            f_pad = max(self.batch_size,
                        -(-n_frames // self.batch_size) * self.batch_size)
            runs = np.zeros(f_pad, np.int64)
            runs[:n_frames] = run_ids
            feats = feats[to_device(runs, self.device)]
        ids = np.full(f_pad, n_bucket, np.int64)  # padding -> overflow bin
        ids[:n_frames] = shot_ids
        keep_p = np.zeros(f_pad, np.float32)
        keep_p[:n_frames] = keep
        pooled, counts = self.pool(feats, ids, keep_p, n_bucket + 1)
        if return_device:
            return pooled, HostCopy(counts)
        return (pooled[:n_shots].cpu().numpy(),
                counts[:n_shots].cpu().numpy())


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
    """The backbone for ``config.backbone`` (dual | resnet50 | vit | tiny)
    in eval mode, with weights from ``state_dict``, else from the JAX
    package's file ``config.weights`` (Flax msgpack or ``.npz``, the
    backbone's variables), else seeded random ones.
    The ViT is ``config.vit_variant`` at ``config.resnet_size``."""
    dtype = DTYPES[config.dtype]
    if state_dict is None and config.weights:
        from avsum_torch.convert import backbone_file

        state_dict = backbone_file(config.weights)
    if config.backbone == "dual":
        model = DualBackbone(dtype)
    elif config.backbone == "resnet50":
        if config.feature_dim != 2048:
            raise ValueError(
                "backbone 'resnet50' emits 2048-d features; set "
                "visual.feature_dim=2048 and model.visual_dim=2048 (load_config "
                "does so when they are left at their defaults)")
        model = ResNetBackbone(dtype)
    elif config.backbone == "vit":
        from avsum_torch.vision.vit import VIT_VARIANTS, ViTBackbone

        if config.vit_variant not in VIT_VARIANTS:
            raise ValueError(f"unknown vit_variant {config.vit_variant!r}; "
                             f"options: {sorted(VIT_VARIANTS)}")
        embed, depth, heads, cls = VIT_VARIANTS[config.vit_variant]
        model = ViTBackbone(config.feature_dim, embed, depth, heads,
                            config.resnet_size, cls_token=cls, dtype=dtype)
    elif config.backbone == "tiny":
        model = TinyBackbone(config.feature_dim, dtype)
    else:
        raise ValueError(f"unknown visual backbone {config.backbone!r}")
    if state_dict is None:
        fast_init_(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model.eval()
