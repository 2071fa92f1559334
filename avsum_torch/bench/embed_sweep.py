"""The embed program's device efficiency by batch and backbone, the
counterpart of the JAX package's ``scripts/sweep_embed_mfu.py``:
``python -m avsum_torch.bench embed-sweep [--plan "base:64,128;..."]
[--ship 304] [--iters 6] [--out F.json]``.

Each (variant, batch) cell of ``--plan`` times the pipeline's packed
embed (:meth:`avsum_torch.vision.backbone.VisualFrontend._embed_packed`:
YUV420 planes -> RGB -> backbone, in bfloat16) on a device-resident uint8
buffer of ``batch`` frames at ``--ship`` x ``--ship`` (numpy's
``default_rng(0)``, the JAX script's bytes): one call for the set-up
(``compile_s``: there is no compile, it is the first call's cuDNN and
allocator set-up), then ``--iters`` calls, each timed by CUDA events
with one element of the output read back. FLOPs a frame come from
``FlopCounterMode`` over the backbone (its convolutions and products,
the two matmuls of each resize among them; the colour conversion is not
counted), MFU against the H100's dense bf16 rate (989 TFLOP/s).

Variants, with the weights drawn from ``--seed``:

- ``base``: :class:`~avsum_torch.vision.backbone.DualBackbone` (ResNet50
  at 224 and InceptionV3 at 299);
- ``resize_bf16``: the JAX script's ``DualBF16Resize`` written out (/255
  in bfloat16, ImageNet statistics in float32, then both resizes in
  bfloat16). Both packages' dual backbones already normalize and resize
  in the compute dtype, so this is the program of ``base``; the name is
  kept so that both sweeps have the same rows;
- ``resnet_only`` / ``inception_only``: one backbone alone (/255 and the
  statistics in float32, then the resize to 224 or 299 in bfloat16), to
  split the dual program's time.

A cell that runs out of device memory becomes an ``error`` row; any other
exception fails the command. One JSON line a cell, then the best by MFU;
``--out`` gets them all. On the CPU the device metrics are null.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
from torch import nn

from avsum_torch.bench import (
    H100_BF16_FLOPS,
    card,
    emit,
    log,
    on_card,
    require_device,
    tf32_off,
)

DEFAULT_PLAN = ("base:64,128,256,512;resize_bf16:128,256;resnet_only:128;"
                "inception_only:128")
VARIANTS = ("base", "resize_bf16", "resnet_only", "inception_only")
DTYPE = torch.bfloat16


class DualBF16Resize(nn.Module):
    """The JAX script's ``resize_bf16`` dual backbone: /255 in ``dtype``,
    the ImageNet statistics in float32, cast to ``dtype``, both resizes
    in ``dtype``."""

    def __init__(self, dtype=DTYPE):
        from avsum_torch.vision.inception import InceptionV3
        from avsum_torch.vision.resnet import ResNet50

        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet50()
        self.inception = InceptionV3()
        self.to(dtype)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        from avsum_torch.vision.backbone import _imagenet_stats, resize

        x = frames.to(self.dtype) / torch.tensor(255.0, dtype=self.dtype)
        mean, std = _imagenet_stats(x.device)
        x = ((x.float() - mean) / std).to(self.dtype).permute(0, 3, 1, 2)
        return torch.cat([self.resnet(resize(x, 224)),
                          self.inception(resize(x, 299))], dim=-1)


class OneBackbone(nn.Module):
    """One of the dual program's backbones alone: /255 and the statistics
    in float32, cast to ``dtype``, resized to its size in ``dtype``."""

    def __init__(self, which: str, dtype=DTYPE):
        from avsum_torch.vision.inception import InceptionV3
        from avsum_torch.vision.resnet import ResNet50

        super().__init__()
        self.dtype = dtype
        if which == "resnet_only":
            self.size, self.net = 224, ResNet50()
        else:
            self.size, self.net = 299, InceptionV3()
        self.to(dtype)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        from avsum_torch.vision.backbone import normalize_frames, resize

        x = normalize_frames(frames, torch.float32).to(self.dtype)
        return self.net(resize(x.permute(0, 3, 1, 2), self.size))


def build_model(variant: str, seed: int = 0) -> nn.Module:
    """The variant's backbone in bfloat16, eval mode, weights from
    ``seed``."""
    from avsum_torch.init import fast_init_
    from avsum_torch.vision.backbone import DualBackbone

    if variant == "base":
        model = DualBackbone(DTYPE)
    elif variant == "resize_bf16":
        model = DualBF16Resize()
    elif variant in ("resnet_only", "inception_only"):
        model = OneBackbone(variant)
    else:
        raise SystemExit(f"unknown variant {variant!r}; options: "
                         f"{', '.join(VARIANTS)}")
    return fast_init_(model, seed).eval()


def parse_plan(plan: str):
    """``"v:b,b;v:b"`` -> [(variant, [batch, ...]), ...]."""
    return [(v, [int(x) for x in bs.split(",")])
            for v, bs in (item.split(":") for item in plan.split(";"))]


def packed_buffer(batch: int, ship: int) -> np.ndarray:
    """The JAX script's input: ``batch`` frames' YUV420 planes, uint8
    from ``default_rng(0)``."""
    n = batch * (ship * ship + 2 * (ship // 2) * (ship // 2))
    return np.random.default_rng(0).integers(0, 256, size=n, dtype=np.uint8)


def measure(variant: str, batch: int, ship: int, iters: int, device: str,
            seed: int = 0) -> dict:
    """One cell's row (printed)."""
    from avsum_torch.bench.e2e import embed_flops_per_frame
    from avsum_torch.train.config import load_config
    from avsum_torch.vision.backbone import VisualFrontend

    model = build_model(variant, seed)
    flops = embed_flops_per_frame(model, ship) * batch
    cfg = load_config(overrides=[f"visual.batch_size={batch}",
                                 "visual.dtype=bfloat16"])
    frontend = VisualFrontend(cfg.visual, model, device)
    buf = torch.from_numpy(packed_buffer(batch, ship)).to(device)
    card_on = on_card(device)
    times = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        out = frontend._embed_packed(buf, ship, ship)
        float(out[0, 0])
        compile_s = time.perf_counter() - t0
        for _ in range(iters):
            if card_on:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            out = frontend._embed_packed(buf, ship, ship)
            if card_on:
                end.record()
            float(out[0, 0])  # the readback: the call has finished
            if card_on:
                times.append(start.elapsed_time(end) / 1e3)
    best = min(times) if times else None
    row = {
        "variant": variant,
        "batch": batch,
        "ms_per_frame": None if best is None else 1e3 * best / batch,
        "batch_s": best,
        "gflops_per_frame": flops / batch / 1e9,
        "mfu_pct": (None if best is None
                    else 100 * flops / best / H100_BF16_FLOPS),
        "compile_s": compile_s if card_on else None,
        "times_s": times if card_on else None,
        "card": card(device),
    }
    emit(row)
    return row


def add_arguments(ap) -> None:
    ap.add_argument("--plan", default=DEFAULT_PLAN,
                    help="semicolon-separated variant:batch,batch,... pairs")
    ap.add_argument("--ship", type=int, default=304)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default=None)


def run(args) -> int:
    require_device(args.device)
    tf32_off(args.device)
    if args.config or args.weights or args.overrides:
        raise SystemExit("embed-sweep: the variants are the script's own")
    plan = parse_plan(args.plan)
    for variant, _ in plan:
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}; options: "
                             f"{', '.join(VARIANTS)}")
    rows = []
    for variant, batches in plan:
        for b in batches:
            try:
                rows.append(measure(variant, b, args.ship, args.iters,
                                    args.device, args.seed))
            except torch.cuda.OutOfMemoryError as e:
                row = {"variant": variant, "batch": b,
                       "error": f"{type(e).__name__}: {str(e)[:200]}"}
                rows.append(row)
                emit(row)
            if on_card(args.device):
                torch.cuda.empty_cache()
    timed = [r for r in rows if r.get("mfu_pct") is not None]
    best = max(timed, key=lambda r: r["mfu_pct"]) if timed else None
    if best is not None:
        emit({"best": best})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"plan": args.plan, "ship": args.ship,
                       "iters": args.iters, "device": args.device,
                       "card": card(args.device), "rows": rows,
                       "best": best}, fh, indent=1)
        log(f"wrote {args.out}")
    return 0
