"""The join of program spans to device operations (``benchmark/spans.py``)
and the readers that use it, on synthetic traces: operations of every
kind launched inside a span count, from any thread; launches outside it
do not; a reader gives None where its span never opened, as a program
without the span gives."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark.tests.conftest import HERE
from benchmark.trace import DeviceOp, HostOp, Trace

SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
# the metrics that read the program's spans, and the span each reads
SPAN_READERS = {
    "place_batch_ms.train": "avsum.place_batch",
    "forward_ms.train": "avsum.forward",
    "backward_ms.train": "avsum.backward",
    "optimizer_ms.train": "avsum.optimizer",
    "frame_read_s.summarize": "avsum.frame_read",
    "embed_enqueue_s.summarize": "avsum.embed_enqueue",
    "detect_wait_s.summarize": "avsum.detect_join",
    "device_wait_s.summarize": "avsum.device_wait",
    "scorer_launch_s.summarize": "avsum.scorer_launch",
    "audio_ms_per_video.summarize": "avsum.audio_embed",
}


def _trace() -> Trace:
    """Two steps, each a ``avsum.backward`` span on the caller's thread
    over [100, 200) and [300, 400), and ``avsum.place_batch`` over [0,
    50): inside the spans a kernel launch on the caller's thread, a copy
    and a set launched by another thread; outside them a kernel at 250."""
    host = [HostOp("avsum.place_batch", 0, 50, 0),
            HostOp("cudaMemcpyAsync", 10, 40, 1),
            HostOp("avsum.backward", 100, 200, 0),
            HostOp("cudaLaunchKernel", 110, 115, 2),   # the caller's
            HostOp("cudaMemcpyAsync", 150, 160, 3),    # another thread's
            HostOp("cudaLaunchKernel", 250, 255, 4),   # between the spans
            HostOp("avsum.backward", 300, 400, 0),
            HostOp("cudaMemsetAsync", 399, 401, 5),    # starts inside
            # the profiler's own numbering: 4 is not the kernel at 250
            HostOp("aten::mm", 305, 310, 4)]
    device = [DeviceOp("Memcpy HtoD (Pageable -> Device)", 20, 2_000_020,
                       "memcpy", 1),
              DeviceOp("flash_bwd_kernel<2>", 120, 3_000_120, "kernel", 2),
              DeviceOp("Memcpy DtoD", 170, 1_000_170, "memcpy", 3),
              DeviceOp("other_kernel", 260, 7_000_260, "kernel", 4),
              DeviceOp("Memset", 402, 500_402, "memset", 5)]
    return Trace((0, 8_000_000), device, host)


def _run(trace=None, counts=None, window_spans=None):
    return SimpleNamespace(
        trace=trace,
        window_result=harness.Window(attempted=2, failed=0, metrics={},
                                     counts=counts or {},
                                     spans=window_spans or {}))


def test_the_join_takes_every_kind_launched_inside_from_any_thread():
    got = spans.launched_in(_trace(), ["avsum.backward"])
    assert sorted(op.name for op in got) == [
        "Memcpy DtoD", "Memset", "flash_bwd_kernel<2>"]
    assert {op.kind for op in got} == {"kernel", "memcpy", "memset"}
    both = spans.launched_in(_trace(), ["avsum.backward", "avsum.place_batch"])
    assert len(both) == 4


def test_the_join_leaves_out_launches_outside_the_span():
    trace = _trace()
    inside = {op.name for op in spans.launched_in(trace, ["avsum.backward"])}
    assert "other_kernel" not in inside  # launched at 250; aten's id 4
    assert "Memcpy HtoD (Pageable -> Device)" not in inside
    assert spans.launched_in(trace, ["avsum.forward"]) == []
    assert spans.launched_in(None, ["avsum.backward"]) == []
    # nested or overlapping spans of one name count each launch once
    trace.host.append(HostOp("avsum.backward", 105, 180, 0))
    assert len(spans.launched_in(trace, ["avsum.backward"])) == 3
    assert spans.intervals(trace, ["avsum.backward"]) == [(100, 200),
                                                          (300, 400)]


def test_device_ms_are_summed_over_the_window_count():
    run = _run(_trace(), {"steps": 2})
    assert spans.device_ms_per(run, ["avsum.backward"], "steps") == (
        pytest.approx((3_000_000 + 1_000_000 + 500_000) / 1e6 / 2))
    assert spans.device_ms_per(run, ["avsum.place_batch"], "steps") == (
        pytest.approx(1.0))
    assert spans.device_ms_per(_run(_trace(), {"steps": 0}),
                               ["avsum.backward"], "steps") is None


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_each_span_reader_reads_its_span_and_none_without_it(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    assert len(entry["workloads"]) == 1
    reader = harness.load_module(HERE / "metrics" / f"{metric}.py")
    span = SPAN_READERS[metric]
    counts = {"steps": 4, "videos": 4}
    # a program without the span: a trace and a window, nothing to read
    empty = Trace((0, 10), [DeviceOp("k", 0, 5, "kernel", 1)],
                  [HostOp("cudaLaunchKernel", 0, 1, 1),
                   HostOp("avsum.audio_pool", 0, 5, 0)])
    assert reader.read(_run(empty, counts, {"avsum.visual_dispatch": 1.0})
                       ) is None
    host = [HostOp(span, 0, 100, 0), HostOp("cudaLaunchKernel", 10, 12, 7)]
    device = [DeviceOp("k", 20, 8_000_020, "kernel", 7)]
    got = reader.read(_run(Trace((0, 9_000_000), device, host), counts,
                           {span: 2.0}))
    want = 0.5 if entry["source"] == "program_span" else 2.0
    assert got == pytest.approx(want)
