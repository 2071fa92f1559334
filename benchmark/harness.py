"""One run of one cell: the cell's files found by name, the driver's
set-up, window and check, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The harness finds, by those names alone:

- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the mix, whose ``driver`` names
  ``benchmark/drivers/<driver>.py`` and whose parameters the driver hands
  to the generator it names under ``benchmark/generators/``;
- ``benchmark/limits/<cell>.json``: the limit of each number the check
  compares;
- ``benchmark/metrics/<metric>.py``: the reader of each per-layer metric.

A driver module has ``setup(run) -> state``, ``window(run, state,
seconds) -> Window`` and ``check(run, state) -> [(name, value, limit)]``;
the check frees the program's state before its reference runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from benchmark import trace as tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "avsum_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path) -> ModuleType:
    """A module from its file (names may hold dots)."""
    name = "benchmark._found." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    driver: ModuleType
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec_path: Optional[Path] = None,
              root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = load_json(spec_path or root.parent / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r}; cells: {sorted(entries)}")
    entry = entries[name]
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(
        name=name, entry=entry,
        config=load_json(root / "configs" / f"{entry['config']}.json"),
        traffic=traffic,
        driver=load_module(root / "drivers" / f"{traffic['driver']}.py"),
        limits=load_json(root / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, root=root)


@dataclasses.dataclass
class Window:
    """What a window did: ``attempted`` and ``failed`` units of work, its
    end-to-end metrics (by name) and counts the readers take."""
    attempted: int
    failed: int
    metrics: Dict[str, float]
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)


class Run:
    """One run of a cell: its seed and device, and what its window and
    trace give the readers."""

    def __init__(self, cell: Cell, seed: int, device: str):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.window_result: Optional[Window] = None
        self.trace: Optional[tracing.Trace] = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self) -> Iterator[Dict[str, float]]:
        """The measured window: the device idle at its start, the
        ``bench.window`` span over it, and its host-clock seconds, up to
        the device's last operation, in the yielded dict's ``seconds``."""
        self.sync()
        clock: Dict[str, float] = {}
        t0 = time.perf_counter()
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            yield clock
            self.sync()
        clock["seconds"] = time.perf_counter() - t0


def device_info(run: Run) -> dict:
    info = {"platform": "gpu" if run.on_card else run.device.type,
            "kind": (torch.cuda.get_device_name(run.device) if run.on_card
                     else "cpu"),
            "count": run.cell.entry["chips"],
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(run.device)
                                  if run.on_card else 0)}
    return info


def read_per_layer(run: Run) -> Dict[str, dict]:
    out = {}
    for metric in run.cell.per_layer:
        reader = load_module(run.cell.root / "metrics" / f"{metric['name']}.py")
        value = reader.read(run)
        if value is None:
            log(f"per-layer {metric['name']}: nothing to read")
            continue
        out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", started: Optional[float] = None
            ) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """One run -> (the result line's object, the numbers compared)."""
    started = time.perf_counter() if started is None else started
    run = Run(cell, seed, device)
    if run.on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    state = cell.driver.setup(run)
    run.sync()
    setup_s = time.perf_counter() - started
    log(f"set-up {setup_s:.3f} s")
    if trace:
        seconds = min(seconds, cell.traffic.get("trace_seconds", seconds))
        with tracing.profiled() as got:
            run.window_result = cell.driver.window(run, state, seconds)
        run.trace = got["trace"]
    else:
        run.window_result = cell.driver.window(run, state, seconds)
    win = run.window_result
    device_line = device_info(run)
    if trace:
        metrics = read_per_layer(run)
        device_line.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
    else:
        wanted = {m["name"]: m for m in cell.end_to_end}
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for name, value in win.metrics.items():
            if name in wanted:
                metrics[name] = {"value": value, "unit": wanted[name]["unit"]}
        missing = set(wanted) - set(metrics)
        if missing:
            raise RuntimeError(f"the window gave no {sorted(missing)}")
    compared = cell.driver.check(run, state)
    del state
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark measures "
                         "the PyTorch port alone")
    correct = (win.attempted > 0 and win.failed == 0
               and all(value <= limit for _, value, limit in compared))
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": device_line}
    if trace:
        result["breakdown"] = {
            "device_ops": tracing.top_device_ops(run.trace),
            "idle_gaps": tracing.idle_by_host(run.trace)}
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in compared}
    return result, compared
