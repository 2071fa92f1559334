"""Tracing (``avsum_tpu/utils/profiling.py``) on ``torch.profiler``.

- ``annotate(name)`` wraps a region in a ``torch.profiler.record_function``
  span, so the pipeline's stages and the train step's phases show in a
  trace, and adds the region's host seconds to every active
  ``collect_stages`` collector. A span is a host-side marker: it enqueues
  nothing on the device and waits for nothing. Opened on the thread that
  launches the region's work, it is stamped on the profiler's clock, so a
  trace joins it to the device operations launched inside it.
- ``trace_to(log_dir)`` writes a Chrome trace of the enclosed region into
  ``log_dir``, with the CPU's activity and, where a card is present, the
  CUDA kernels'; every thread's spans are in it (the pipeline's detect
  thread's too).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch

# active stage collectors (collect_stages); annotate() feeds every one, so
# a caller gets the seconds of each stage without threading a timer
# through the pipeline
_collectors: list = []


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if _collectors:
            dt = time.perf_counter() - start
            for c in list(_collectors):
                c[name] = c.get(name, 0.0) + dt


@contextlib.contextmanager
def collect_stages() -> Iterator[Dict[str, float]]:
    """Accumulate {annotate name: host seconds} over the enclosed region.

    The pipeline overlaps stages across threads (host detection under the
    device dispatch), so the spans can sum past the wall clock."""
    acc: Dict[str, float] = {}
    _collectors.append(acc)
    try:
        yield acc
    finally:
        # by identity: two collectors may hold equal dicts
        _collectors[:] = [c for c in _collectors if c is not acc]


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (CPU activity, CUDA too where a card is
    present, every thread) and write its Chrome trace to
    ``log_dir/avsum.<pid>.<ns>.trace.json``; yields the profiler, whose
    ``key_averages()`` the caller may read after the region."""
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"avsum.{os.getpid()}.{time.time_ns()}.trace.json"))
