"""Which side of a decoder cell's ``grad1_gap`` is off: the first step's
gradient of the leaves that read worst, in the port, in the float32
reference the check runs and in the same reference in float64, on one
seed, on the card:

    python3 -m benchmark.grad_witness --workload <cell> --seed <n> [--leaves a,b]

The port takes its three checked steps (the cell's ``setup``); the
float32 reference then takes the first step's gradient of every leaf,
whose clipping scale and median leaf norm the check's numbers use, and
the float64 reference the gradient of the leaves named (by default the
one worst in the port against the float32 reference) alone, so that
autograd keeps only what lies between them and the loss. The float64
gradients are clipped at the float32 reference's scale (the global norm
agrees to float32 rounding). Each reference replays the port's choice
of experts, as the check does; the router's scores stay float32 in both
(``reference/decoder.py`` casts them).

One JSON line a leaf on standard output: the three clipped norms and
the gaps between them, each as the check's ``grad1_gap`` takes it
(|a - b| over the larger of b and the median leaf). The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict, List

import torch

from benchmark import harness
from benchmark.drivers import train
from benchmark.reference.scorer import masked_mse, step_seeds


def first_grads(run, st, leaves: Dict[str, torch.Tensor], wanted: List[str],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The gradient of the first step's loss with respect to ``wanted``
    alone, the reference in ``dtype``, on the pool's first batch."""
    reference = run.cell.driver.reference
    model_cfg = run.cell.config["program"]["model"]
    batch = {k: torch.as_tensor(v, device=run.device)
             for k, v in st["pool"][0].items()}
    params = {k: v.detach().to(dtype).requires_grad_(k in wanted)
              for k, v in leaves.items()}
    preds = reference.forward(
        params, model_cfg, batch["visual"].to(dtype),
        batch["audio"].to(dtype), batch["mask"].to(dtype),
        step_seeds(run.seed % 2 ** 63, 0), routes=[],
        replay=st["routes"][0])
    loss = masked_mse(preds, batch["targets"].to(dtype),
                      batch["mask"].to(dtype))
    grads = torch.autograd.grad(loss, [params[k] for k in wanted])
    return dict(zip(wanted, grads))


def gap(a: float, b: float, median: float) -> float:
    return abs(a - b) / max(b, median)


def witness(cell, seed: int, device: str, wanted: List[str]
            ) -> List[Dict[str, object]]:
    """The module's readings of ``cell`` on ``seed``, a dict a leaf of
    ``wanted`` (empty: the port's worst against the float32 reference)."""
    run = harness.Run(cell, seed, device)
    model_cfg = cell.config["program"]["model"]
    clip = cell.config["program"]["train"]["grad_clip"]
    t0 = time.perf_counter()
    st = cell.driver.setup(run)
    train.free_program(st)
    leaves = cell.driver.reference.init_leaves(model_cfg, seed, run.device)
    names = sorted(leaves)
    g32 = first_grads(run, st, leaves, names, torch.float32)
    norms = {k: float(g.double().norm()) for k, g in g32.items()}
    del g32
    total = sum(n * n for n in norms.values()) ** 0.5
    scale = 1.0 if total < clip else clip / total
    ref32 = {k: n * scale for k, n in norms.items()}
    median = statistics.median(ref32.values())
    port = st["grad1"]
    wanted = wanted or [max(names, key=lambda k: gap(port[k], ref32[k],
                                                      median))]
    g64 = first_grads(run, st, leaves, wanted, torch.float64)
    peak = (f", peak allocated {torch.cuda.max_memory_allocated()} bytes"
            if run.on_card else "")
    harness.log(f"witness: {time.perf_counter() - t0:.1f} s, global norm "
                f"{total:.9e}, clip scale {scale:.9e}{peak}")
    out = []
    for k in wanted:
        ref64 = float(g64[k].norm()) * scale
        out.append({"leaf": k, "port": port[k], "reference32": ref32[k],
                    "reference64": ref64, "median": median,
                    "port_vs_reference32": gap(port[k], ref32[k], median),
                    "port_vs_reference64": gap(port[k], ref64, median),
                    "reference32_vs_reference64": gap(ref32[k], ref64,
                                                      median)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--leaves", default="",
                    help="comma-separated reference leaves; default: the "
                         "port's worst against the float32 reference")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    for line in witness(cell, args.seed, "cuda",
                        [k for k in args.leaves.split(",") if k]):
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
