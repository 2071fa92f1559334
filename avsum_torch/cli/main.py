"""``python -m avsum_torch.cli summarize VIDEO``: the port's CLI
(``avsum_tpu/cli/main.py:241-289``, summarize only; same JSON keys).

Weights: ``--weights FILE.pt`` holds a dict of state_dicts under
"scorer", "visual" and "vggish" (made by :mod:`avsum_torch.convert`);
a part it lacks, and every part with ``--random-init``, is drawn from
``--seed``. Without ``--weights`` or ``--random-init`` there is no scorer
and every shot scores 1, as in the JAX CLI without ``--checkpoint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import torch

from avsum_tpu.train.config import Config, load_config


def build_pipeline(cfg: Config, device: str, seed: int = 0,
                   weights: Optional[dict] = None, with_scorer: bool = True):
    """-> (AVPipeline, scorer or None) with weights from ``weights`` (a
    dict of state_dicts) or drawn from ``seed``."""
    from avsum_torch.audio.frontend import AudioFrontend
    from avsum_torch.audio.vggish import VGGish
    from avsum_torch.init import fast_init_
    from avsum_torch.models.scorer import make_model
    from avsum_torch.pipeline import AVPipeline
    from avsum_torch.vision.backbone import DTYPES, VisualFrontend, make_backbone

    weights = weights or {}
    backbone = make_backbone(cfg.visual, seed, weights.get("visual"))
    if cfg.audio.vggish_weights:
        raise ValueError(
            "audio.vggish_weights holds a JAX param file; convert it with "
            "avsum_torch.convert and pass it under --weights")
    vggish = VGGish(DTYPES[cfg.audio.dtype])
    if "vggish" in weights:
        vggish.load_state_dict(weights["vggish"])
    else:
        fast_init_(vggish, seed + 1)
    pipeline = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, device),
                          AudioFrontend(cfg.audio, vggish, device))
    model = None
    if with_scorer:
        model = make_model(cfg.model, seed + 2, weights.get("scorer"))
        model = model.to(device)
    return pipeline, model


def summary_json(result: dict) -> dict:
    return {
        "video_id": result["video_id"],
        "n_frames": int(result["n_frames"]),
        "fps": float(result["fps"]),
        "segments": [[int(a), int(b)] for a, b in result["segments"]],
        "shot_scores": [float(s) for s in result["scores"]],
    }


def cmd_summarize(args) -> int:
    from avsum_torch.build import ensure_native_io

    cfg = load_config(args.config, args.overrides)
    ensure_native_io()
    if args.device.startswith("cuda"):
        # float32 products stay float32 (the port's parity setting)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    weights = None
    if args.weights:
        weights = torch.load(args.weights, map_location="cpu",
                             weights_only=True)
    pipeline, model = build_pipeline(
        cfg, args.device, args.seed, weights,
        with_scorer=args.random_init or (weights or {}).get("scorer") is not None)
    out = summary_json(pipeline.summarize(args.video, model))
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(out, fh, indent=1)
    else:
        print(json.dumps(out))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="avsum_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize", help="summarize one video")
    p.add_argument("video")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    w = p.add_mutually_exclusive_group()
    w.add_argument("--weights", default=None,
                   help="torch file of state_dicts (avsum_torch.convert)")
    w.add_argument("--random-init", action="store_true",
                   help="draw every weight, the scorer's too, from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--output", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        if os.path.isdir(args.video):
            ap.error("summarize takes one video file")
        return cmd_summarize(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
