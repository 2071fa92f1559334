"""The audio features of a summarize, written out plainly from
torchaudio's and VGGish's published definitions:

- the waveform (16 kHz PCM16 / 32768) zero-padded to a power of two of
  at least a second;
- the mel power spectrogram: ``torch.stft`` with a periodic Hann window,
  centred by reflection, power 2, an HTK mel filterbank without norm;
- 40 MFCC: 10 log10 of the mel power (floor 1e-10), clamped to 80 dB
  below the whole spectrogram's peak, times the orthonormal DCT-II;
- 128 log2-mel: log2(mel + eps) at n_fft 400, hop 200;
- VGGish (Hershey et al., 2017) over 0.96 s patches of log(mel + 0.01)
  at n_fft 400, hop 160, 64 mels from 125 to 7500 Hz: four stages of 3x3
  convolutions and ReLU with 2x2 max-pools, a channels-last flatten, and
  4096, 4096 and 128 dense layers with ReLU;
- each stream mean-pooled over a shot's rows, the rows found from its
  sample bounds in float32 (start truncated, end rounded up, at least
  one row).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VGGISH_HOP, VGGISH_FRAMES, VGGISH_MELS = 160, 96, 64
_STAGES = ((64, 1), (128, 1), (256, 2), (512, 2))


class VGGish(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 1
        for i, (features, reps) in enumerate(_STAGES):
            for j in range(reps):
                setattr(self, f"conv{i + 1}_{j + 1}",
                        nn.Conv2d(cin, features, 3, padding=1))
                cin = features
        self.fc1_1 = nn.Linear(6 * 4 * 512, 4096)
        self.fc1_2 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, 128)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = patches.to(self.fc2.weight.dtype)[:, None]
        for i, (_, reps) in enumerate(_STAGES):
            for j in range(reps):
                x = F.relu(getattr(self, f"conv{i + 1}_{j + 1}")(x))
            x = F.max_pool2d(x, 2, stride=2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(self.fc1_1(x))
        x = F.relu(self.fc1_2(x))
        return F.relu(self.fc2(x)).float()


def mel_fbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
              sample_rate: int, device) -> torch.Tensor:
    """[n_freqs, n_mels] HTK triangles, no norm."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    pts = 700.0 * (10.0 ** (np.linspace(hz_to_mel(f_min), hz_to_mel(f_max),
                                        n_mels + 2) / 2595.0) - 1.0)
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1],
                                    slopes[:, 2:] / diff[1:]))
    return torch.as_tensor(fb, dtype=torch.float32, device=device)


def _dft_power(x: torch.Tensor, n_fft: int, hop: int,
               window: torch.Tensor) -> torch.Tensor:
    """[freqs, frames] power as two products of the windowed frames with
    the DFT's cosines and sines (the control's form: the products take
    the matmul precision)."""
    pad = n_fft // 2
    frames = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = frames.unfold(0, n_fft, hop) * window
    angle = (-2.0 * np.pi * np.arange(n_fft)[:, None]
             * np.arange(n_fft // 2 + 1)[None, :] / n_fft)
    cos = torch.as_tensor(np.cos(angle), dtype=torch.float32, device=x.device)
    sin = torch.as_tensor(np.sin(angle), dtype=torch.float32, device=x.device)
    return ((frames @ cos) ** 2 + (frames @ sin) ** 2).T


def mel_power(x: torch.Tensor, n_fft: int, hop: int, n_mels: int,
              f_min: float, f_max: float, sample_rate: int,
              dft: bool = False) -> torch.Tensor:
    """[T] -> [frames, n_mels]; ``dft``: the power by :func:`_dft_power`
    in place of ``torch.stft``."""
    window = torch.hann_window(n_fft, periodic=True, device=x.device)
    if dft:
        power = _dft_power(x, n_fft, hop, window)
    else:
        spec = torch.stft(x, n_fft, hop, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec.abs() ** 2  # [freqs, frames]
    fb = mel_fbank(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate,
                   x.device)
    return power.T @ fb


def dct(n_mfcc: int, n_mels: int, device) -> torch.Tensor:
    n = np.arange(n_mels, dtype=np.float64)[:, None]
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    m = np.cos(np.pi / n_mels * (n + 0.5) * k) * np.sqrt(2.0 / n_mels)
    m[:, 0] /= np.sqrt(2.0)
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def streams(wave: np.ndarray, audio: dict, vggish: VGGish, device,
            dft: bool = False):
    """int16 [T] -> (mfcc [N, 40], log-mel [N, n_mels], vggish [P, 128])."""
    sr = audio["sample_rate"]
    t = max(len(wave), sr)
    n = 1 << (t - 1).bit_length()
    x = torch.zeros(n, device=device)
    x[:len(wave)] = torch.as_tensor(wave.astype(np.float32) / 32768.0,
                                    device=device)
    mel = mel_power(x, audio["n_fft"], audio["hop_length"], audio["n_mels"],
                    0.0, sr / 2.0, sr, dft)
    logmel = torch.log2(mel + 1e-6)
    db = 10.0 * torch.log10(mel.clamp(min=1e-10))
    db = torch.maximum(db, db.max() - 80.0)
    mfcc = db @ dct(audio["n_mfcc"], audio["n_mels"], device)
    vmel = torch.log(mel_power(x, 400, VGGISH_HOP, VGGISH_MELS, 125.0, 7500.0,
                               sr, dft) + 0.01)
    p = max(vmel.shape[0] // VGGISH_FRAMES, 1)
    vmel = F.pad(vmel, (0, 0, 0, max(0, p * VGGISH_FRAMES - vmel.shape[0])))
    patches = vmel[:p * VGGISH_FRAMES].reshape(p, VGGISH_FRAMES, VGGISH_MELS)
    with torch.no_grad():
        emb = torch.cat([vggish(patches[i:i + 256])
                         for i in range(0, p, 256)])
    return mfcc, logmel, emb


def _means(rows: torch.Tensor, start: np.ndarray, end: np.ndarray
           ) -> torch.Tensor:
    t = rows.shape[0]
    s = np.clip(start.astype(np.int32), 0, t - 1)
    e = np.clip(end.astype(np.int32), s + 1, t)
    out = torch.stack([rows[a:b].double().mean(0) for a, b in zip(s, e)])
    return out.float()


def shot_features(wave: np.ndarray, bounds_samples: np.ndarray, audio: dict,
                  vggish: VGGish, device, dft: bool = False) -> torch.Tensor:
    """[S, 296]: MFCC, log-mel and VGGish means over each shot."""
    return pool(streams(wave, audio, vggish, device, dft), bounds_samples,
                audio)


def pool(full, bounds_samples: np.ndarray, audio: dict) -> torch.Tensor:
    """:func:`streams`' rows -> [S, 296], their means over each shot."""
    mfcc, logmel, emb = full
    b = np.asarray(bounds_samples, np.float32).reshape(-1, 2)
    hop = b * np.float32(1.0 / audio["hop_length"])
    vg = b * np.float32(1.0 / (VGGISH_HOP * VGGISH_FRAMES))
    end = np.ceil(hop[:, 1])
    return torch.cat([_means(mfcc, hop[:, 0], end),
                      _means(logmel, hop[:, 0], end),
                      _means(emb, vg[:, 0], np.ceil(vg[:, 1]))], dim=-1)
