"""A whole summarize, written out plainly: shots (``media``), per-shot
visual and audio features (``vision``, ``audio``), the scorer's scores
over the shot axis padded to a multiple of 32 (``scorer``, no dropout),
and the knapsack: a shot's value is its score times its length in
frames, the capacity ``budget_fraction`` of the frames, the exact 0/1
optimum by a float64 dynamic programme over capacities that takes a
shot only where it strictly gains, read back from the last shot; where
no shot fits, the best-scoring shot cut to the budget.

``precision``: "float32" (the reference), or "control": the bfloat16
parts of the configuration (the backbones, VGGish) in float8 e4m3 (each
layer's weights and inputs rounded to it, products summed in float32)
and the float32 parts in TF32: the spectrograms as products with the
DFT's cosines and sines, the mel, MFCC and DCT products, the scorer.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import numpy as np
import torch
from torch import nn

from benchmark.reference import audio as ref_audio
from benchmark.reference import media, scorer, vision

SCORER_PAD = 32


def _fp8_hook(module, args):
    x = args[0]
    return (x.to(torch.float8_e4m3fn).to(x.dtype),) + tuple(args[1:])


@contextlib.contextmanager
def fp8(model: nn.Module) -> Iterator[None]:
    """Each convolution's and dense layer's weights and inputs rounded to
    float8 e4m3 while open; the weights restored after."""
    layers = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    saved = [m.weight.detach().clone() for m in layers]
    hooks = [m.register_forward_pre_hook(_fp8_hook) for m in layers]
    with torch.no_grad():
        for m in layers:
            m.weight.copy_(m.weight.to(torch.float8_e4m3fn).to(m.weight.dtype))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for m, w in zip(layers, saved):
                m.weight.copy_(w)


@contextlib.contextmanager
def tf32(on: bool) -> Iterator[None]:
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def knapsack(scores: np.ndarray, bounds: np.ndarray, n_frames: int,
             budget: float) -> np.ndarray:
    """-> the selected segments [K, 2]."""
    lengths = np.maximum(bounds[:, 1] - bounds[:, 0], 0)
    values = (np.asarray(scores, np.float32)
              * lengths.astype(np.float32)).astype(np.float64)
    cap = int(budget * n_frames)
    best = np.zeros(cap + 1)
    take = np.zeros((len(values), cap + 1), bool)
    for i, (v, w) in enumerate(zip(values, lengths)):
        if w <= 0 or w > cap:
            continue
        cand = np.full(cap + 1, -np.inf)
        cand[w:] = best[:-w] + v
        take[i] = cand > best
        best = np.where(take[i], cand, best)
    chosen = np.zeros(len(values), bool)
    c = cap
    for i in range(len(values) - 1, -1, -1):
        if take[i, c]:
            chosen[i] = True
            c -= int(lengths[i])
    if not chosen.any() and len(bounds):
        i = int(np.argmax(scores))
        start = int(bounds[i, 0])
        return np.array([[start, min(int(bounds[i, 1]),
                                     start + max(int(budget * n_frames), 1))]],
                        np.int64)
    return bounds[chosen]


def score(leaves: scorer.Leaves, model: dict, visual: torch.Tensor,
          audio: torch.Tensor) -> torch.Tensor:
    """Per-shot rows [S, Dv] and [S, Da] -> scores [S], the shot axis
    padded to a multiple of 32 and masked, as a summarize scores it."""
    s, device = visual.shape[0], visual.device
    sp = max(SCORER_PAD, -(-s // SCORER_PAD) * SCORER_PAD)
    pad = torch.zeros(sp, device=device)
    pad[:s] = 1.0
    vis_p = torch.zeros(1, sp, visual.shape[1], device=device)
    aud_p = torch.zeros(1, sp, audio.shape[1], device=device)
    vis_p[0, :s], aud_p[0, :s] = visual, audio
    return scorer.forward(leaves, model, vis_p, aud_p, pad[None])[0, :s]


def features(stem: str, weights: Dict[str, dict], config: dict, device,
             precision: str = "float32") -> Dict[str, np.ndarray]:
    """The clip ``<stem>.y4m`` + ``<stem>.wav`` -> boundaries [S, 2],
    visual [S, 4096], audio [S, 296], the log-mel of every frame of the
    soundtrack [N, n_mels] and scores [S]."""
    prog = config["program"]
    vis, aud, model = prog["visual"], prog["audio"], prog["model"]
    y, u, v, fps = media.read_y4m(stem + ".y4m")
    bounds = media.boundaries(media.content_scores(y, u, v, device))
    backbone = vision.DualBackbone().to(device).eval()
    backbone.load_state_dict(weights["visual"])
    vggish = ref_audio.VGGish().to(device).eval()
    vggish.load_state_dict(weights["vggish"])
    low = precision == "control"
    with torch.no_grad(), tf32(low):
        with fp8(backbone) if low else contextlib.nullcontext():
            visual = vision.shot_features(
                backbone, y, u, v, bounds,
                max(1, round(fps / vis["sample_fps"])), vis["ship_size"],
                vis["max_frames_per_shot"], device)
        samples = bounds.astype(np.float64) / fps * aud["sample_rate"]
        with fp8(vggish) if low else contextlib.nullcontext():
            full = ref_audio.streams(media.read_wav(stem + ".wav"), aud,
                                     vggish, device, dft=low)
        audio = ref_audio.pool(full, samples, aud)
        scores = score(weights["scorer"], model, visual, audio)
    return {"boundaries": bounds, "visual": visual.cpu().numpy(),
            "audio": audio.cpu().numpy(), "logmel": full[1].cpu().numpy(),
            "scores": scores.cpu().numpy(),
            "fps": fps, "n_frames": y.shape[0]}
