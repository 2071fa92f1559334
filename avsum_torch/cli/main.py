"""The port's CLI (``avsum_tpu/cli/main.py``): ``preprocess``, ``splits``,
``train``, ``evaluate``, ``summarize``, ``serve`` and ``export``, with the
JAX CLI's JSON keys. Every command runs on ``--device`` (default
``cuda``).

``python -m avsum_torch.cli summarize VIDEO``. Weights: ``--weights
FILE.pt`` holds a dict of state_dicts under "scorer", "visual" and
"vggish" (made by ``python -m avsum_torch.convert --params/--visual/
--vggish``); an encoder it lacks comes from the JAX package's file that
``visual.weights`` or ``audio.vggish_weights`` names (Flax msgpack or
``.npz``), as in the JAX CLI; any other part is drawn from ``--seed``
(the scorer only with ``--random-init``). ``--checkpoint DIR`` takes
the scorer's parameters from the port's latest training checkpoint
there. Without any of them
there is no scorer and every shot scores 1, as in the JAX CLI without
``--checkpoint``. ``summarize DIR`` writes one ``<video_id>.json`` per
``.y4m`` / ``.mp4`` into ``--output`` (default ``summaries``);
``--render STEM`` also writes the summary's media to ``STEM.y4m`` +
``STEM.wav``, or to one mp4 when STEM ends in ``.mp4``.

``python -m avsum_torch.cli preprocess --input-dir DIR --cache-dir C``:
every video of DIR into the feature cache, with the backbone and VGGish
weights from ``--weights`` / ``--seed`` as in ``summarize``.
``splits --cache-dir C --output S.json [--kfold]`` writes seeded folds of
the cached ids.

``python -m avsum_torch.cli train --config C.yaml``: the scorer trained on
the feature cache (``data.cache_dir``) with the dataset's annotations,
``total_steps`` = steps per epoch x epochs; ``--splits``/``--fold`` pick
the train videos and evaluate on the test ones, ``--resume`` continues
from the latest checkpoint at the epoch after it.

``train`` and ``evaluate`` run at the config's mesh (``config.mesh``)
with one process per rank: ``torchrun --nproc-per-node N -m
avsum_torch.cli train --config C.yaml`` (``--backend gloo`` where the
ranks share one card; NCCL is the default on the card, gloo on the CPU).
Only the primary rank logs, prints and writes checkpoints.

``python -m avsum_torch.cli evaluate --splits S.json --fold K
[--canonical]``: the scorer from the latest checkpoint in
``train.checkpoint_dir`` (random weights, with a warning, when there is
none) on the fold's test videos (every cached video without
``--splits``); prints one JSON line of f1, spearman and kendall, plus
canonical_f1 and n_videos with ``--canonical`` (the per-annotator
knapsack F1 of :mod:`avsum_torch.summary.protocol`).

``python -m avsum_torch.cli serve [--port P]``: the HTTP service of
:mod:`avsum_torch.serve.server` (POST /v1/summarize, /v1/summarize/upload,
GET /healthz, /readyz, /v1/stats), with the scorer from ``--weights``,
``--checkpoint``, ``--random-init`` or an exported ``--artifact``; it
drains its queue and exits on SIGTERM. ``python -m avsum_torch.cli export
--output F (--checkpoint DIR | --weights W.pt | --random-init)`` writes the
scorer as a ``torch.export`` artifact on ``--device``
(:mod:`avsum_torch.serve.export`).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import time
from typing import List, Optional

import torch

from avsum_torch.train.config import Config, load_config

log = logging.getLogger("avsum_torch.cli")


def build_pipeline(cfg: Config, device: str, seed: int = 0,
                   weights: Optional[dict] = None, with_scorer: bool = True):
    """-> (AVPipeline, scorer or None) with weights from ``weights`` (a
    dict of state_dicts), else, for the encoders, from the JAX package's
    files ``visual.weights`` and ``audio.vggish_weights``, else drawn from
    ``seed``."""
    from avsum_torch.audio.frontend import AudioFrontend
    from avsum_torch.audio.vggish import make_audio_encoder
    from avsum_torch.convert import vggish_file
    from avsum_torch.init import fast_init_
    from avsum_torch.pipeline import AVPipeline
    from avsum_torch.vision.backbone import DTYPES, VisualFrontend, make_backbone

    weights = weights or {}
    backbone = make_backbone(cfg.visual, seed, weights.get("visual"))
    vggish = make_audio_encoder(cfg.audio.encoder, cfg.audio.vggish_dim,
                                DTYPES[cfg.audio.dtype])
    if "vggish" in weights:
        vggish.load_state_dict(weights["vggish"])
    elif cfg.audio.vggish_weights:
        vggish.load_state_dict(vggish_file(cfg.audio.vggish_weights))
    else:
        fast_init_(vggish, seed + 1)
    pipeline = AVPipeline(cfg, VisualFrontend(cfg.visual, backbone, device),
                          AudioFrontend(cfg.audio, vggish, device,
                                        use_pallas=cfg.audio.use_pallas))
    model = None
    if with_scorer:
        model = make_scorer(cfg, seed, weights.get("scorer")).to(device)
    return pipeline, model


def make_scorer(cfg: Config, seed: int = 0, state: Optional[dict] = None):
    """The scorer with the ``state`` dict's weights or, without one, those
    ``--seed`` draws in every command (summarize, serve, export)."""
    from avsum_torch.models.scorer import make_model

    return make_model(cfg.model, seed + 2, state)


def summary_json(result: dict) -> dict:
    return {
        "video_id": result["video_id"],
        "n_frames": int(result["n_frames"]),
        "fps": float(result["fps"]),
        "segments": [[int(a), int(b)] for a, b in result["segments"]],
        "shot_scores": [float(s) for s in result["scores"]],
    }


def _device_setup(args) -> dict:
    """TF32 off on the card (float32 products stay float32, the port's
    parity setting) -> the ``--weights`` dict."""
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if not args.weights:
        return {}
    return torch.load(args.weights, map_location="cpu", weights_only=True)


def _media_setup(args) -> dict:
    """The native decoder built, then :func:`_device_setup`."""
    from avsum_torch.build import ensure_native_io

    ensure_native_io()
    return _device_setup(args)


def _checkpoint_scorer(path: str) -> Optional[dict]:
    """The scorer's state_dict from the latest training checkpoint in
    ``path``, or None when there is none."""
    from avsum_torch.train.checkpoint import CheckpointManager

    payload, _ = CheckpointManager(path).load()
    return None if payload is None else payload["model"]


def cmd_preprocess(args) -> int:
    from avsum_torch.data.cache import FeatureCache

    cfg = load_config(args.config, args.overrides)
    weights = _media_setup(args)
    pipeline, _ = build_pipeline(cfg, args.device, args.seed, weights,
                                 with_scorer=False)
    cache = FeatureCache(args.cache_dir or cfg.data.cache_dir)
    done = pipeline.preprocess_dataset(args.input_dir or cfg.data.video_dir,
                                       cache)
    log.info("preprocessed %d videos", len(done))
    return 0


def cmd_splits(args) -> int:
    from avsum_torch.data.cache import FeatureCache
    from avsum_torch.data.splits import (
        create_kfold_splits,
        create_split,
        save_splits,
    )

    cfg = load_config(args.config, args.overrides)
    cache = FeatureCache(args.cache_dir or cfg.data.cache_dir)
    ids = cache.video_ids()
    if not ids:
        log.error("no cached videos in %s", cache.cache_dir)
        return 1
    if args.kfold:
        splits = create_kfold_splits(ids, cfg.data.n_folds, cfg.data.split_seed)
    else:
        splits = create_split(ids, seed=cfg.data.split_seed)
    out = args.output or cfg.data.splits_path
    save_splits(splits, out)
    log.info("wrote %s (%d videos)", out, len(ids))
    return 0


def cmd_summarize(args) -> int:
    cfg = load_config(args.config, args.overrides)
    weights = _media_setup(args)
    if args.checkpoint:
        scorer = _checkpoint_scorer(args.checkpoint)
        if scorer is None:
            print(f"no checkpoint in {args.checkpoint}", file=sys.stderr)
            return 1
        weights = {**weights, "scorer": scorer}
    pipeline, model = build_pipeline(
        cfg, args.device, args.seed, weights,
        with_scorer=args.random_init or "scorer" in weights)

    if os.path.isdir(args.video):
        out_dir = args.output or "summaries"
        os.makedirs(out_dir, exist_ok=True)
        n_ok = 0
        for name in sorted(os.listdir(args.video)):
            if not name.lower().endswith((".y4m", ".mp4")):
                continue
            try:
                out = summary_json(pipeline.summarize(
                    os.path.join(args.video, name), model))
                with open(os.path.join(out_dir, out["video_id"] + ".json"),
                          "w") as fh:
                    json.dump(out, fh, indent=1)
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — per-item isolation
                log.error("failed %s: %s", name, e)
        log.info("summarized %d videos -> %s", n_ok, out_dir)
        return 0 if n_ok else 1

    out = summary_json(pipeline.summarize(args.video, model))
    if args.render:
        from avsum_torch.summary.render import render_summary

        stem, ext = os.path.splitext(args.render)
        if ext.lower() == ".mp4":
            render_summary(args.video, out["segments"], stem, container="mp4")
        else:
            render_summary(args.video, out["segments"], args.render)
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


def _on_ranks(cmd):
    """``cmd`` in ``torchrun``'s process group (none for one process),
    which it leaves at its end; the ranks but the primary log warnings
    only."""

    @functools.wraps(cmd)
    def run(args) -> int:
        from avsum_torch.parallel import multihost
        from avsum_torch.parallel.mesh import default_backend

        if not multihost.initialize(
                backend=args.backend or default_backend(args.device)):
            return cmd(args)
        if not multihost.is_primary():
            logging.getLogger().setLevel(logging.WARNING)
        try:
            return cmd(args)
        finally:
            multihost.shutdown()

    return run


@_on_ranks
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
                      device=args.device, backend=args.backend)

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


@_on_ranks
def cmd_evaluate(args) -> int:
    from avsum_torch.data.batching import batch_iterator
    from avsum_torch.data.splits import load_splits
    from avsum_torch.models.scorer import make_model
    from avsum_torch.train.trainer import Trainer

    cfg = load_config(args.config, args.overrides)
    video_ids = None
    if args.splits:
        splits = load_splits(args.splits)
        split = splits[args.fold] if isinstance(splits, list) else splits
        video_ids = split["test"]
    examples = _load_examples(cfg, video_ids)
    if not examples:
        log.error("no eval examples found")
        return 1
    trainer = Trainer(make_model(cfg.model, seed=cfg.train.seed), cfg,
                      device=args.device, backend=args.backend)
    trainer.init_state()
    if trainer.maybe_restore() is None:
        log.warning("no checkpoint found in %s; evaluating random init",
                    cfg.train.checkpoint_dir)
    metrics = trainer.evaluate_videos(batch_iterator(
        examples, cfg.data.batch_videos, cfg.data.max_shots, shuffle=False))
    if args.canonical:
        metrics.update(_canonical_eval(cfg, trainer, examples,
                                       trainer.device))
    if trainer.mesh.is_primary:
        print(json.dumps(metrics))
    return 0


def _canonical_eval(cfg: Config, trainer, examples, device: str) -> dict:
    """Canonical per-annotator knapsack F1 (summary/protocol.py) over the
    examples that have annotations; every shot of a video is scored, and
    a knapsack of 5e7 DP cells or more runs on ``device``."""
    from avsum_torch.summary.protocol import evaluate_canonical

    if cfg.data.dataset == "tvsum":
        from avsum_torch.data.tvsum import load_tvsum, tvsum_index

        anno = tvsum_index(load_tvsum(cfg.data.annotation_path))
        user_key = "user_frame_scores"

        def users(video_id):
            return anno[video_id].user_scores
    elif cfg.data.dataset == "summe":
        from avsum_torch.data.summe import load_summe_dir

        anno = {v.video_id: v for v in load_summe_dir(cfg.data.annotation_path)}
        user_key = "user_masks"

        def users(video_id):
            return anno[video_id].user_score
    else:
        return {}
    videos = [{"pred_shot_scores": trainer.score_video(ex, cfg.data.max_shots),
               "boundaries": ex.shot_boundaries, "n_frames": ex.n_frames,
               user_key: users(ex.video_id)}
              for ex in examples if ex.video_id in anno]
    return evaluate_canonical(videos, cfg.data.dataset,
                              cfg.summary.budget_fraction, device)


def cmd_serve(args) -> int:
    from avsum_torch.serve import ServeConfig, SummarizeServer
    from avsum_torch.serve.export import load_scorer

    cfg = load_config(args.config, args.overrides)
    weights = _media_setup(args)
    if args.checkpoint:
        scorer = _checkpoint_scorer(args.checkpoint)
        if scorer is None:
            log.error("no checkpoint in %s", args.checkpoint)
            return 1
        weights = {**weights, "scorer": scorer}
    pipeline, model = build_pipeline(
        cfg, args.device, args.seed, weights,
        with_scorer=(args.random_init or "scorer" in weights)
        and not args.artifact)
    if args.artifact:  # the exported program, its weights inside
        model = load_scorer(args.artifact, args.device)
    server = SummarizeServer(pipeline, ServeConfig(
        host=args.host, port=args.port, warmup=not args.no_warmup,
        access_log=args.access_log or "", media_root=args.media_root or "",
        max_queue=args.max_queue, request_timeout_s=args.request_timeout,
        max_upload_mb=args.max_upload_mb), model=model)
    server.start(block=True)
    return 0


def cmd_export(args) -> int:
    from avsum_torch.serve.export import export_scorer

    cfg = load_config(args.config, args.overrides)
    weights = _device_setup(args)
    if args.checkpoint:
        state = _checkpoint_scorer(args.checkpoint)
        if state is None:
            log.error("no checkpoint in %s", args.checkpoint)
            return 1
    elif "scorer" in weights:
        state = weights["scorer"]
    elif args.random_init:
        state = None
        log.warning("exporting RANDOM-INIT weights (--random-init)")
    else:
        log.error("pass --checkpoint DIR, --weights FILE.pt with a scorer, "
                  "or --random-init")
        return 1
    t0 = time.perf_counter()
    blob = export_scorer(make_scorer(cfg, args.seed, state),
                         cfg.model.visual_dim, cfg.model.audio_dim,
                         device=args.device)
    with open(args.output, "wb") as fh:
        fh.write(blob)
    log.info("wrote %s (%d bytes, exported in %.2f s)", args.output,
             len(blob), time.perf_counter() - t0)
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")


def _add_backend(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend under torchrun (default "
                        "nccl on cuda, gloo on cpu; gloo where ranks share "
                        "one card)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="avsum_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("preprocess", help="extract features into the cache")
    _add_common(p)
    p.add_argument("--input-dir", default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--weights", default=None,
                   help="torch file of state_dicts (avsum_torch.convert)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("splits", help="create seeded train/test splits")
    _add_common(p)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--kfold", action="store_true", help="canonical k-fold")
    p.set_defaults(fn=cmd_splits)

    p = sub.add_parser("train", help="train the scorer")
    _add_common(p)
    _add_backend(p)
    p.add_argument("--splits", default=None, help="splits JSON")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate the latest checkpoint")
    _add_common(p)
    _add_backend(p)
    p.add_argument("--splits", default=None, help="splits JSON")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--canonical", action="store_true",
                   help="also the canonical per-annotator knapsack F1")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("summarize",
                       help="summarize a video (or a directory of videos)")
    p.add_argument("video", help="video file or directory (batch mode)")
    _add_common(p)
    w = p.add_mutually_exclusive_group()
    w.add_argument("--weights", default=None,
                   help="torch file of state_dicts (avsum_torch.convert)")
    w.add_argument("--random-init", action="store_true",
                   help="draw every weight, the scorer's too, from --seed")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="the scorer from this training checkpoint dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None,
                   help="write the JSON here (a directory for a directory)")
    p.add_argument("--render", default=None, metavar="OUT_STEM",
                   help="also write the summary media to OUT_STEM.y4m/.wav, "
                        "or to one mp4 when OUT_STEM ends in .mp4")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("serve", help="run the HTTP summarization service")
    _add_common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    w = p.add_mutually_exclusive_group()
    w.add_argument("--weights", default=None,
                   help="torch file of state_dicts (avsum_torch.convert)")
    w.add_argument("--random-init", action="store_true",
                   help="draw every weight, the scorer's too, from --seed")
    p.add_argument("--seed", type=int, default=0)
    s = p.add_mutually_exclusive_group()
    s.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="the scorer from this training checkpoint dir")
    s.add_argument("--artifact", default=None, metavar="FILE",
                   help="score with an exported scorer (export) instead of "
                        "the model code")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the synthetic warmup clip before readiness")
    p.add_argument("--access-log", default=None, metavar="PATH",
                   help="JSONL access log (one line per summarize request)")
    p.add_argument("--media-root", default=None, metavar="DIR",
                   help="only serve media under this directory (403 "
                        "outside it); use it for a non-loopback --host")
    p.add_argument("--max-queue", type=int, default=64,
                   help="queued requests beyond this get 429 (0: no bound)")
    p.add_argument("--request-timeout", type=float, default=0.0,
                   metavar="SECONDS",
                   help="per-request wall-clock budget (504 past it; 0: none)")
    p.add_argument("--max-upload-mb", type=int, default=512,
                   help="largest body for POST /v1/summarize/upload (413 "
                        "beyond; 0 disables uploads)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export", help="export the scorer as a torch.export "
                                      "artifact (weights inside, symbolic "
                                      "batch and shot axes)")
    _add_common(p)
    w = p.add_mutually_exclusive_group()
    w.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="the scorer from this training checkpoint dir")
    w.add_argument("--weights", default=None,
                   help="torch file of state_dicts with a scorer")
    w.add_argument("--random-init", action="store_true",
                   help="the scorer summarize --random-init draws from "
                        "--seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
