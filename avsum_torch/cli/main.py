"""The port's CLI (``avsum_tpu/cli/main.py``): ``summarize`` (same JSON
keys) and ``train``.

``python -m avsum_torch.cli summarize VIDEO``. Weights: ``--weights
FILE.pt`` holds a dict of state_dicts under "scorer", "visual" and
"vggish" (made by :mod:`avsum_torch.convert`); a part it lacks, and every
part with ``--random-init``, is drawn from ``--seed``. ``--checkpoint
DIR`` takes the scorer's parameters from the port's latest training
checkpoint there. Without any of them there is no scorer and every shot
scores 1, as in the JAX CLI without ``--checkpoint``.

``python -m avsum_torch.cli train --config C.yaml``: the scorer trained on
the feature cache (``data.cache_dir``) with the dataset's annotations,
``total_steps`` = steps per epoch x epochs; ``--splits``/``--fold`` pick
the train videos and evaluate on the test ones, ``--resume`` continues
from the latest checkpoint at the epoch after it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

import torch

from avsum_torch.train.config import Config, load_config

log = logging.getLogger("avsum_torch.cli")


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
                          AudioFrontend(cfg.audio, vggish, device,
                                        use_pallas=cfg.audio.use_pallas))
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
    weights = {}
    if args.weights:
        weights = torch.load(args.weights, map_location="cpu",
                             weights_only=True)
    if args.checkpoint:
        from avsum_torch.train.checkpoint import CheckpointManager

        payload, _ = CheckpointManager(args.checkpoint).load()
        if payload is None:
            print(f"no checkpoint in {args.checkpoint}", file=sys.stderr)
            return 1
        weights = {**weights, "scorer": payload["model"]}
    pipeline, model = build_pipeline(
        cfg, args.device, args.seed, weights,
        with_scorer=args.random_init or "scorer" in weights)
    out = summary_json(pipeline.summarize(args.video, model))
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(out, fh, indent=1)
    else:
        print(json.dumps(out))
    return 0


def _load_examples(cfg: Config, video_ids=None):
    from avsum_torch.data.datasets import (
        load_cached_examples,
        load_summe_examples,
        load_tvsum_examples,
    )
    from avsum_torch.data.cache import FeatureCache

    cache = FeatureCache(cfg.data.cache_dir)
    if cfg.data.dataset == "tvsum":
        return load_tvsum_examples(cache, cfg.data.annotation_path, video_ids)
    if cfg.data.dataset == "summe":
        return load_summe_examples(cache, cfg.data.annotation_path, video_ids)
    return load_cached_examples(cache, video_ids=video_ids)


def cmd_train(args) -> int:
    from avsum_torch.models.scorer import make_model
    from avsum_torch.train.trainer import Trainer
    from avsum_torch.data.batching import batch_iterator
    from avsum_torch.data.splits import load_splits

    cfg = load_config(args.config, args.overrides)
    split = None
    if args.splits:
        splits = load_splits(args.splits)
        split = splits[args.fold] if isinstance(splits, list) else splits
    examples = _load_examples(cfg, split["train"] if split else None)
    if not examples:
        print("no training examples found (cache empty or ids mismatch)",
              file=sys.stderr)
        return 1
    log.info("training on %d videos", len(examples))
    steps_per_epoch = max(1, len(examples) // cfg.data.batch_videos)
    trainer = Trainer(make_model(cfg.model, seed=cfg.train.seed), cfg,
                      total_steps=steps_per_epoch * cfg.train.epochs,
                      device=args.device)

    def batches(epoch: int):
        # the epoch folds into the shuffle seed: a fresh order per epoch
        return batch_iterator(examples, cfg.data.batch_videos,
                              cfg.data.max_shots, seed=cfg.train.seed + epoch)

    eval_fn = None
    if split:
        test_examples = _load_examples(cfg, split["test"])
        if test_examples:
            def eval_fn():
                return trainer.evaluate_videos(batch_iterator(
                    test_examples, cfg.data.batch_videos, cfg.data.max_shots,
                    shuffle=False))
    trainer.init_state()
    start_epoch = 0
    if args.resume and trainer.maybe_restore() is not None:
        start_epoch = int(trainer.last_meta.get("epoch", -1)) + 1
    trainer.fit(batches, eval_fn=eval_fn, start_epoch=start_epoch)
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="avsum_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize", help="summarize one video")
    p.add_argument("video")
    _add_common(p)
    w = p.add_mutually_exclusive_group()
    w.add_argument("--weights", default=None,
                   help="torch file of state_dicts (avsum_torch.convert)")
    w.add_argument("--random-init", action="store_true",
                   help="draw every weight, the scorer's too, from --seed")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="the scorer from this training checkpoint dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None, help="write the JSON here")
    p = sub.add_parser("train", help="train the scorer")
    _add_common(p)
    p.add_argument("--splits", default=None, help="splits JSON")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    if args.cmd == "summarize":
        if os.path.isdir(args.video):
            ap.error("summarize takes one video file")
        return cmd_summarize(args)
    return cmd_train(args)


if __name__ == "__main__":
    sys.exit(main())
