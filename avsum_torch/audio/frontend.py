"""Per-shot audio features, the 296-d contract (``avsum_tpu/audio/frontend.py``):
40 MFCC + 128 log2-mel + 128 from the patch encoder (VGGish, or the large
encoder with ``audio.encoder: large``), each mean-pooled over a shot's rows.

The whole waveform's streams are computed once on the device; the
log-mel goes through kernel K1 (:func:`avsum_torch.ops.melspec.fused_log_mel`)
when ``audio.use_pallas`` leaves it on and n_fft == 2 * hop_length, as the
JAX package dispatches to its Pallas kernel; otherwise through the plain
spectral ops.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from avsum_torch.audio.vggish import (
    VGGISH_FRAMES,
    VGGISH_HOP,
    vggish_log_mel_patches,
)
from avsum_torch.models.attention import kernel_enabled
from avsum_torch.ops.melspec import fused_log_mel
from avsum_torch.ops.spectral import amplitude_to_db, dct_matrix, mel_spectrogram
from avsum_torch.train.config import AudioFeatConfig
from avsum_torch.utils.transfer import to_device

VGGISH_BATCH = 256  # patches per VGGish call (bounds activation memory)


def segment_means(features: torch.Tensor, start: np.ndarray,
                  end: np.ndarray) -> torch.Tensor:
    """Row-range means of [T, D] via a float32 cumsum -> [S, D]; empty or
    out-of-range segments clamp to one row (``_segment_means``)."""
    t = features.shape[0]
    cs = torch.cat([features.new_zeros(1, features.shape[1]),
                    torch.cumsum(features.float(), dim=0)])
    s = np.clip(start.astype(np.int32), 0, t - 1)
    e = np.clip(end.astype(np.int32), s + 1, t)
    se = to_device(np.stack([s, e]).astype(np.int64), features.device)
    s_t, e_t = se[0], se[1]
    total = cs[e_t] - cs[s_t]
    return total / (e_t - s_t).float()[:, None]


class AudioFrontend:
    """Whole-waveform spectral + VGGish streams, then per-shot pooling."""

    def __init__(self, config: AudioFeatConfig, vggish: torch.nn.Module,
                 device: torch.device, use_pallas: Optional[bool] = None):
        """``vggish``: the patch encoder, VGGish or the large encoder
        (:func:`avsum_torch.audio.vggish.make_audio_encoder`)."""
        flag = use_pallas if use_pallas is not None else config.use_pallas
        self.use_kernel = kernel_enabled(flag)
        if self.use_kernel and config.n_fft != 2 * config.hop_length:
            if flag is True:  # explicitly requested, loudly refused
                warnings.warn(
                    "audio.use_pallas=True but the fused log-mel kernel "
                    f"requires n_fft == 2*hop_length (got {config.n_fft}/"
                    f"{config.hop_length}); using the plain spectral path",
                    stacklevel=2)
            self.use_kernel = False
        self.config = config
        self.device = torch.device(device)
        self.vggish = vggish.to(self.device).eval()

    @torch.inference_mode()
    def dispatch_full(self, waveform) -> Tuple[torch.Tensor, ...]:
        """[T] int16 or float waveform -> (mfcc [N, 40], log-mel [N, n_mels],
        vggish [P, 128]) on the device, enqueued without waiting for it.
        The waveform is zero-padded to a power-of-two length first, as the
        JAX package buckets it; int16 samples go up as they are and are
        scaled by 1/32768 on the device."""
        cfg = self.config
        wave = np.asarray(waveform).reshape(-1)
        if wave.dtype != np.int16:
            wave = wave.astype(np.float32)
        t = max(len(wave), cfg.sample_rate)
        wave = np.pad(wave, (0, (1 << (t - 1).bit_length()) - len(wave)))
        x = to_device(wave, self.device)
        x = x.float() * (1.0 / 32768.0) if x.dtype == torch.int16 else x
        if self.use_kernel:
            mel, lm = fused_log_mel(
                x, sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                hop_length=cfg.hop_length, n_mels=cfg.n_mels, eps=cfg.eps)
            if not cfg.log_base2:  # the kernel emits log2
                lm = lm * math.log(2.0)
        else:
            mel = mel_spectrogram(
                x, cfg.sample_rate, n_fft=cfg.n_fft,
                hop_length=cfg.hop_length, win_length=cfg.win_length,
                n_mels=cfg.n_mels)
            lm = torch.log(mel + cfg.eps)
            if cfg.log_base2:
                lm = lm / math.log(2.0)
        mf = amplitude_to_db(mel, 80.0) @ dct_matrix(cfg.n_mfcc, cfg.n_mels,
                                                     mel.device)
        patches = vggish_log_mel_patches(x)
        vg = torch.cat([self.vggish(patches[i:i + VGGISH_BATCH])
                        for i in range(0, len(patches), VGGISH_BATCH)])
        return mf, lm, vg

    @torch.inference_mode()
    def pool(self, full, boundaries_samples: np.ndarray, mask=None,
             s_bucket: Optional[int] = None,
             return_device: bool = False) -> torch.Tensor:
        """Pool full-waveform streams over [S, 2] sample bounds -> [S, 296]
        on the device, rows times ``mask`` ([S], default ones).

        ``s_bucket`` pads the shot axis to that many rows (zero rows past
        S): the device-resident scoring passes the scorer's padded S so
        both modalities share it; ``return_device`` returns all
        ``s_bucket`` rows instead of the first S.

        Bounds become row indices in float32 as XLA computes them for the
        JAX package: a division by a constant is a multiplication by its
        float32 reciprocal, so a bound that lands exactly on a row edge
        (153600 / 15360) can round up to the next row there, and here."""
        mf, lm, vg = full
        bounds = np.asarray(boundaries_samples, np.float32).reshape(-1, 2)
        s = len(bounds)
        s_bucket = s if s_bucket is None else s_bucket
        if s_bucket < s:
            raise ValueError(f"s_bucket {s_bucket} < {s} shots")
        bounds_p = np.zeros((s_bucket, 2), np.float32)
        bounds_p[:s] = bounds
        mask_p = np.zeros(s_bucket, np.float32)
        mask_p[:s] = 1.0 if mask is None else np.asarray(mask, np.float32).reshape(-1)
        mf_s = bounds_p * np.float32(1.0 / self.config.hop_length)
        vg_s = bounds_p * np.float32(1.0 / (VGGISH_HOP * VGGISH_FRAMES))
        mf_end = np.ceil(mf_s[:, 1])
        out = torch.cat([
            segment_means(mf, mf_s[:, 0], mf_end),
            segment_means(lm, mf_s[:, 0], mf_end),
            segment_means(vg, vg_s[:, 0], np.ceil(vg_s[:, 1])),
        ], dim=-1) * to_device(mask_p, mf.device)[:, None]
        return out if return_device else out[:s]

    def shot_features(self, waveform, boundaries_samples) -> torch.Tensor:
        """[T] waveform + [S, 2] (start, end) sample bounds -> [S, 296]."""
        return self.pool(self.dispatch_full(waveform), boundaries_samples)
