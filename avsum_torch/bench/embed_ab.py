"""A/B of the embed batch size end to end, the counterpart of the JAX
package's ``scripts/ab_embed_batch.py``: ``python -m avsum_torch.bench
embed-ab [--batches 256,512] [--rounds 4] [--out F.json]``.

One pipeline per batch size, each the e2e bench's (``BENCH_SETS``: the
dual backbone and VGGish in bfloat16, then ``--config`` / ``--set``) with
``visual.batch_size`` the candidate, the same weights (``--seed`` or
``--weights``), on the e2e bench's clip (``--scenes``, ``--media-dir``;
written once). Each pipeline is warmed by one summarize, and every batch
must give the same summary segments as the first (a batch size changes
the dispatch, never the summary). Then ``--rounds`` rounds of whole
summarizes, interleaved (A, B, A, B, ...) in this one process so that
drift in the host or the card falls on both alike, each under
``collect_stages``.

Prints one JSON line: per batch the best and median wall seconds, every
run's, and the stage seconds of its best run; the largest |difference|
of a shot score between batches; K1's launches over the timed runs; the
card. ``--out`` writes the same line to a file.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from avsum_torch.bench import (
    card,
    emit,
    launches,
    log,
    require_device,
    reset_launches,
)


def add_arguments(ap) -> None:
    from avsum_torch.bench.e2e import BENCH_DIR, SCENES

    ap.add_argument("--batches", default="256,512")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--scenes", type=int, default=SCENES,
                    help="scenes of the clip (25: bench.py's clip)")
    ap.add_argument("--media-dir", default=BENCH_DIR,
                    help="where the clip is written once and reused")


def run(args) -> int:
    import torch

    from avsum_torch.bench.e2e import BENCH_SETS, ensure_media, media_stem
    from avsum_torch.cli.main import _media_setup, build_pipeline
    from avsum_torch.train.config import load_config
    from avsum_torch.utils.profiling import collect_stages

    require_device(args.device)
    batches = [int(b) for b in args.batches.split(",")]
    stem = media_stem(args.media_dir, args.scenes)
    ensure_media(stem, args.scenes)
    video = stem + ".y4m"
    weights = _media_setup(args)

    results = {b: [] for b in batches}
    stages_best, segments, scores, pipelines = {}, {}, {}, {}
    for b in batches:
        cfg = load_config(args.config, BENCH_SETS + list(args.overrides)
                          + [f"visual.batch_size={b}"])
        pipelines[b] = build_pipeline(cfg, args.device, args.seed, weights)
        # warm every program (cuDNN's set-up excluded from the timing)
        t0 = time.perf_counter()
        r = pipelines[b][0].summarize(video, pipelines[b][1])
        log(json.dumps({"warm_batch": b,
                        "warmup_s": round(time.perf_counter() - t0, 1)}))
        segments[b] = np.asarray(r["segments"])
        scores[b] = np.asarray(r["scores"], np.float64)

    base = batches[0]
    gap = max((float(np.max(np.abs(scores[b] - scores[base])))
               for b in batches[1:]), default=0.0)
    for b in batches[1:]:
        if not np.array_equal(segments[b], segments[base]):
            raise AssertionError(
                f"segments differ for batch {b} (max |d score| against "
                f"batch {base}: {gap:.3e})")

    reset_launches()
    for rnd in range(args.rounds):
        for b in batches:
            pipe, model = pipelines[b]
            with collect_stages() as st:
                t0 = time.perf_counter()
                pipe.summarize(video, model)  # ends in the host's scores
                dt = time.perf_counter() - t0
            results[b].append(dt)
            if (b not in stages_best
                    or dt < min(results[b][:-1], default=1e9)):
                stages_best[b] = {k.split(".")[-1]: round(v, 3)
                                  for k, v in st.items()}
            log(json.dumps({"round": rnd, "batch": b,
                            "wall_s": round(dt, 3)}))

    out = {
        "backend": torch.device(args.device).type,
        "device": args.device,
        "card": card(args.device),
        "rounds": args.rounds,
        "identical_segments": True,
        "max_abs_score_diff": gap,
        "per_batch": {
            str(b): {
                "best_s": round(min(ts), 3),
                "median_s": round(float(np.median(ts)), 3),
                "runs_s": [round(t, 3) for t in ts],
                "best_stages_s": stages_best[b],
            }
            for b, ts in results.items()
        },
        "kernels": launches("melspec"),
    }
    emit(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(out) + "\n")
    return 0
