"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (the kernels built into the
checkout's ``build/``, the weights and inputs made from the seed, every
shape the window uses warmed up) is timed as ``setup_s``; then the
window runs for ``--seconds``; then the check compares what the window's
program produced with the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number compared beside its limit, which also end
standard error. Without a card, or with fewer than the cell asks for,
the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every kernel cache at a fixed path inside the checkout, so that
    only a checkout's first run builds; no library may load JAX."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from benchmark import counts, harness

    cell = harness.find_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"cell {args.workload} needs {chips} CUDA device(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    harness.log(f"card: {_card_line()}; peaks {counts.PEAKS}")
    harness.log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, compared = harness.execute(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda", STARTED)
    for name, value, limit in compared:
        harness.log(f"compared {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
