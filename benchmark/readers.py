"""What the per-layer readers under ``benchmark/metrics/`` share: each
reads one metric of a traced run and gives None where its run holds
nothing to read."""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple

from benchmark import counts
from benchmark.harness import log


def idle_pct(run) -> Optional[float]:
    """100 - the share of the traced window that the union of the device's
    operations covers."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def flash_roofline_pct(run, kernel: str,
                       count: Callable[..., Tuple[float, float]]
                       ) -> Optional[float]:
    """Sum of the launches' bounds over the sum of their device time, for
    the kernel whose name holds ``kernel``; each window step launches it
    once for each of ``counts.attention_calls``."""
    launches = run.trace.kernels(kernel)
    batches = run.cell.traffic.get("batches")
    if not launches or batches is None:
        return None
    model = run.cell.config["program"]["model"]
    calls = counts.attention_calls(model, batches["videos"], batches["bucket"])
    steps = run.window_result.counts["steps"]
    if len(launches) != len(calls) * steps:
        log(f"{kernel}: {len(launches)} launches, not {len(calls)} in each "
            f"of {steps} steps: no roofline")
        return None
    bound = steps * sum(counts.bound_s(*count(*c), counts.PEAKS["tf32_flops"])
                        for c in calls)
    busy = sum(op.end - op.start for op in launches) / 1e9
    return 100.0 * bound / busy


def kernels_launched_in(run, span: str) -> List:
    """The device kernels whose launches the host made inside ``span``
    (the trace's correlation ids join a launch to its kernel)."""
    if run.trace is None:
        return []
    spans = sorted((op.start, op.end) for op in run.trace.host if op.name == span)
    if not spans:
        return []
    starts = [s for s, _ in spans]
    inside = set()
    for op in run.trace.host:
        if not op.correlation:
            continue
        i = bisect.bisect_right(starts, op.start) - 1
        if i >= 0 and op.start < spans[i][1]:
            inside.add(op.correlation)
    return [k for k in run.trace.kernels() if k.correlation in inside]
