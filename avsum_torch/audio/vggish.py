"""VGGish, the large audio encoder and their log-mel patch front-end
(``avsum_tpu/audio/vggish.py``).

Module names follow the Flax modules (conv1_1 ... conv4_2, fc1_1, fc1_2,
fc2; the large encoder's conv{i}_{j}, ln{i}_{j}, fc1, fc2). VGGish's conv
stack runs NCHW; before the flatten the activation is permuted to NHWC
[B, 6, 4, 512], the order of the Flax flatten and of torchvggish's own
forward, so ``fc1_1`` takes the Flax kernel with a plain transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from avsum_torch.ops.spectral import mel_spectrogram

VGGISH_SR = 16000
VGGISH_N_FFT = 400
VGGISH_HOP = 160
VGGISH_N_MELS = 64
VGGISH_FMIN = 125.0
VGGISH_FMAX = 7500.0
VGGISH_FRAMES = 96
VGGISH_EMBED = 128
_STAGES = ((64, 1), (128, 1), (256, 2), (512, 2))
_LARGE_STAGES = ((96, 2), (192, 2), (384, 3), (768, 3))
LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def vggish_log_mel_patches(waveform: torch.Tensor) -> torch.Tensor:
    """[T] 16 kHz mono -> [n_patches, 96, 64] log(mel + 0.01) examples;
    a short input gives one zero-padded patch. n_fft 400 / hop 160 is not
    the n_fft == 2*hop shape of the fused kernel, so this takes the plain
    spectral path."""
    mel = mel_spectrogram(
        waveform, sample_rate=VGGISH_SR, n_fft=VGGISH_N_FFT,
        hop_length=VGGISH_HOP, n_mels=VGGISH_N_MELS, f_min=VGGISH_FMIN,
        f_max=VGGISH_FMAX,
    )
    logmel = torch.log(mel + 0.01)
    t = logmel.shape[0]
    n_patches = max(t // VGGISH_FRAMES, 1)
    needed = n_patches * VGGISH_FRAMES
    if t < needed:
        logmel = F.pad(logmel, (0, 0, 0, needed - t))
    return logmel[:needed].reshape(n_patches, VGGISH_FRAMES, VGGISH_N_MELS)


class VGGish(nn.Module):
    """AudioSet VGGish: [B, 96, 64] log-mel patches -> [B, 128] float32."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, (features, reps) in enumerate(_STAGES):
            for j in range(reps):
                setattr(self, f"conv{i + 1}_{j + 1}",
                        nn.Conv2d(cin, features, 3, padding=1))
                cin = features
        self.fc1_1 = nn.Linear(6 * 4 * 512, 4096)
        self.fc1_2 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, VGGISH_EMBED)
        self.to(dtype)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = patches.to(self.dtype)[:, None]
        for i, (_, reps) in enumerate(_STAGES):
            for j in range(reps):
                x = F.relu(getattr(self, f"conv{i + 1}_{j + 1}")(x))
            x = F.max_pool2d(x, 2, stride=2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC flatten, as in Flax
        x = F.relu(self.fc1_1(x))
        x = F.relu(self.fc1_2(x))
        return F.relu(self.fc2(x)).float()


class LargeAudioEncoder(nn.Module):
    """The upgraded audio encoder (``audio.encoder: large``): [B, 96, 64]
    log-mel patches -> [B, embed_dim] float32, VGGish's contract.

    Four stages of 3x3 "SAME" convolutions (96 x 2, 192 x 2, 384 x 3,
    768 x 3), each followed by a LayerNorm over the channels only
    (epsilon 1e-6) and the tanh GELU, a 2x2 max-pool after each stage;
    then the spatial mean, ``fc1`` 1024 with the tanh GELU, and ``fc2``.
    The activations are kept channels-last, so the channel LayerNorm
    reads them in place."""

    def __init__(self, embed_dim: int = VGGISH_EMBED, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, (features, reps) in enumerate(_LARGE_STAGES):
            for j in range(reps):
                setattr(self, f"conv{i + 1}_{j + 1}",
                        nn.Conv2d(cin, features, 3, padding=1))
                setattr(self, f"ln{i + 1}_{j + 1}",
                        nn.LayerNorm(features, eps=LAYER_NORM_EPS))
                cin = features
        self.fc1 = nn.Linear(cin, 1024)
        self.fc2 = nn.Linear(1024, embed_dim)
        self.to(dtype)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = patches.to(self.dtype)[:, None].contiguous(
            memory_format=torch.channels_last)
        for i, (_, reps) in enumerate(_LARGE_STAGES):
            for j in range(reps):
                x = getattr(self, f"conv{i + 1}_{j + 1}")(x)
                y = getattr(self, f"ln{i + 1}_{j + 1}")(x.permute(0, 2, 3, 1))
                x = F.gelu(y, approximate="tanh").permute(0, 3, 1, 2)
            x = F.max_pool2d(x, 2, stride=2)
        x = F.gelu(self.fc1(x.mean(dim=(2, 3))), approximate="tanh")
        return self.fc2(x).float()


def make_audio_encoder(encoder: str, embed_dim: int = VGGISH_EMBED,
                       dtype=torch.float32) -> nn.Module:
    """The patch encoder for ``audio.encoder``: VGGish or the large one."""
    if encoder == "vggish":
        return VGGish(dtype)
    if encoder == "large":
        return LargeAudioEncoder(embed_dim, dtype)
    raise ValueError(f"unknown audio encoder {encoder!r}")
