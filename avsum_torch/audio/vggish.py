"""VGGish and its log-mel patch front-end (``avsum_tpu/audio/vggish.py``).

Module names follow the Flax module (conv1_1 ... conv4_2, fc1_1, fc1_2,
fc2). The conv stack runs NCHW; before the flatten the activation is
permuted to NHWC [B, 6, 4, 512], the order of the Flax flatten and of
torchvggish's own forward, so ``fc1_1`` takes the Flax kernel with a
plain transpose.
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
