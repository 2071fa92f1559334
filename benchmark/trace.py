"""The device trace of a run's window, reduced to what the per-layer
readers and the result's breakdown read.

``torch.profiler`` records the host thread's operations and every device
operation (kernels, copies, sets) while the window runs. The window's
bounds are the ``bench.window`` span the drivers open around it, widened
to its device operations. The device is busy where the union of the
device operations' intervals covers the window; operations on
overlapping streams count once.
"""

from __future__ import annotations

import contextlib
import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"


@dataclass
class DeviceOp:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    kind: str  # "kernel", "memcpy", "memset" or another activity
    correlation: int


@dataclass
class HostOp:
    name: str
    start: int
    end: int
    correlation: int


@dataclass
class Trace:
    window: Tuple[int, int]
    device: List[DeviceOp]
    host: List[HostOp]
    busy_ns: int = 0
    gaps: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def kernels(self, contains: str = "") -> List[DeviceOp]:
        return [op for op in self.device
                if op.kind == "kernel" and contains in op.name]


def _kind(event) -> str:
    name = event.name()
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy"
    if "Memset" in name or "memset" in name:
        return "memset"
    return "kernel"


def _annotation(event) -> bool:
    """A host span mirrored on the device's timeline (``record_function``
    under CUDA): no device operation."""
    flag = getattr(event, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    return "annotation" in str(getattr(event, "activity_type", lambda: "")())


def union(intervals: List[Tuple[int, int]], lo: int, hi: int
          ) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns within [lo, hi], the uncovered gaps) of ``intervals``."""
    covered, gaps, at = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
            at = s
        if e > at:
            covered += e - at
            at = e
    if at < hi:
        gaps.append((at, hi))
    return covered, gaps


def from_profiler(prof) -> Trace:
    """The window's trace out of a finished ``torch.profiler.profile``."""
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if _annotation(ev):
                continue
            device.append(DeviceOp(ev.name(), start, end, _kind(ev),
                                   ev.correlation_id()))
        else:
            host.append(HostOp(ev.name(), start, end, ev.correlation_id()))
            if ev.name() == WINDOW_SPAN:
                window = (start, end)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    # the device is idle when the window opens and when the profile stops,
    # so every device operation is the window's; the host's and the
    # device's clocks differ by some microseconds in the trace, so the
    # window reaches to its first and last device operation
    if device:
        window = (min(window[0], min(op.start for op in device)),
                  max(window[1], max(op.end for op in device)))
    host = [op for op in host if op.end > window[0] and op.start < window[1]]
    busy, gaps = union([(op.start, op.end) for op in device], *window)
    return Trace(window, device, host, busy, gaps)


@contextlib.contextmanager
def profiled() -> Iterator[Dict[str, Optional[Trace]]]:
    """Profile the enclosed region; the yielded dict's ``trace`` is set
    once it closes."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, Optional[Trace]] = {"trace": None}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    out["trace"] = from_profiler(prof)


def top_device_ops(trace: Trace, n: int = 10) -> List[List]:
    """[[name, seconds]] of the device operations that took most time."""
    total: Dict[str, int] = {}
    for op in trace.device:
        total[op.name] = total.get(op.name, 0) + op.end - op.start
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_by_host(trace: Trace, n: int = 10) -> List[List]:
    """[[name, seconds]] of the longest idle time by what the host was
    doing: each gap in the device's activity is named by the innermost
    host operation open at its midpoint (``idle`` where none is)."""
    events = sorted(trace.host, key=lambda op: op.start)
    mids = sorted(((s + e) // 2, e - s) for s, e in trace.gaps)
    total: Dict[str, int] = {}
    by_start: List[Tuple[int, int]] = []  # (-start, index) of opened events
    i = 0
    for mid, length in mids:
        while i < len(events) and events[i].start <= mid:
            heapq.heappush(by_start, (-events[i].start, i))
            i += 1
        while by_start and events[by_start[0][1]].end <= mid:
            heapq.heappop(by_start)
        name = events[by_start[0][1]].name if by_start else "idle"
        total[name] = total.get(name, 0) + length
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in ranked]
