"""Tracing and timing (``avsum_tpu/utils/profiling.py``) on
``torch.profiler``.

- ``annotate(name)`` wraps a region in a ``torch.profiler.record_function``
  span, so the pipeline's stages show in a trace under the JAX package's
  names, and adds the region's host seconds to every active
  ``collect_stages`` collector. A span is a host-side marker: it enqueues
  nothing on the device and waits for nothing.
- ``Timer`` accumulates host-clock seconds; ``time(name, result)`` and
  ``measure`` wait for ``result``'s CUDA devices (a synchronize of each)
  before stopping, and never wait for tensors on the CPU, which are
  computed eagerly.
- ``trace_to(log_dir)`` writes a Chrome trace of the enclosed region into
  ``log_dir``, with the CPU's activity and, where a card is present, the
  CUDA kernels'; every thread's spans are in it (the pipeline's detect
  thread's too).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional, Set

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
        _collectors.remove(acc)


def _cuda_devices(tree: Any) -> Set[torch.device]:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree))
    return set()


def block_until_ready(result: Any) -> Any:
    """Wait for the CUDA devices ``result``'s tensors live on (nested
    lists, tuples and dicts); -> ``result``."""
    for device in _cuda_devices(result):
        torch.cuda.synchronize(device)
    return result


class Timer:
    """Accumulating host-clock timer; waits for its result's devices."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def time(self, name: str, result: Any = None) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            block_until_ready(result)
            self._add(name, time.perf_counter() - start)

    def measure(self, name: str, fn: Callable, *args, **kwargs):
        start = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        dt = time.perf_counter() - start
        self._add(name, dt)
        return out, dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_s": v / self.counts[k]}
                for k, v in self.totals.items()}


def timed(name: Optional[str] = None):
    """Decorator: ``annotate`` a function's calls (coarse host spans)."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


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
