"""The program's spans in a run: the device operations launched inside a
span, joined through the trace, and a span's host seconds a video.

A span (``avsum_torch.utils.profiling.annotate``) is a host operation of
the trace, stamped on the profiler's clock. A device operation belongs to
a span when the runtime call that launched it (a kernel launch, a copy, a
set: the CUDA runtime or driver call that carries its correlation id)
started inside one of that span's intervals, on whichever thread made the
call: the autograd engine launches the backward from a thread of its own
while the caller's span stays open. Kernels, copies and sets all count.
The profiler numbers its own operations (``aten::*``, the spans) from 1
as well, in an id space of their own, so only runtime and driver calls
(``cuda*``, ``cu*``) are joined.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

from benchmark.trace import DeviceOp, Trace

RUNTIME = "cu"  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernelEx, ...


def intervals(trace: Trace, names: Iterable[str]) -> List[Tuple[int, int]]:
    """The union of the host spans named in ``names``, as sorted disjoint
    [start, end) intervals in ns."""
    wanted = set(names)
    out: List[Tuple[int, int]] = []
    for s, e in sorted((op.start, op.end) for op in trace.host
                       if op.name in wanted):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def launched_in(trace: Optional[Trace],
                names: Iterable[str]) -> List[DeviceOp]:
    """The device operations of every kind whose launch started inside a
    span named in ``names``."""
    if trace is None:
        return []
    spans = intervals(trace, names)
    if not spans:
        return []
    starts = [s for s, _ in spans]
    inside = set()
    for op in trace.host:
        if not op.correlation or not op.name.startswith(RUNTIME):
            continue
        i = bisect.bisect_right(starts, op.start) - 1
        if i >= 0 and op.start < spans[i][1]:
            inside.add(op.correlation)
    return [op for op in trace.device if op.correlation in inside]


def device_ms_per(run, names: Iterable[str], count: str) -> Optional[float]:
    """Device milliseconds of the operations launched inside the spans
    ``names``, over the window's ``counts[count]`` (steps or videos);
    None where the trace holds no such operation or nothing was counted."""
    n = run.window_result.counts.get(count, 0)
    ops = launched_in(run.trace, names)
    if not n or not ops:
        return None
    return sum(op.end - op.start for op in ops) / 1e6 / n


def span_s_per_video(run, name: str) -> Optional[float]:
    """Host seconds of the span ``name`` (``collect_stages``) over the
    window's completed videos; None where the span never opened."""
    videos = run.window_result.counts.get("videos", 0)
    spent = run.window_result.spans.get(name)
    if not videos or spent is None:
        return None
    return spent / videos
