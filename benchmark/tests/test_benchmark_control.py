"""On the card: each cell's control, the reference in the precision below
the configuration's in the port's place, reads over a limit, and the
port as it runs reads within every limit. Run there with

    python -m pytest -p no:cacheprovider benchmark/tests/test_benchmark_control.py
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import HERE

CELLS = [w["name"] for w in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


def _card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["sound", "control"])
def test_the_control_fails_and_the_port_passes(cell, mode):
    _card()
    found = harness.find_cell(cell)
    run = harness.Run(found, 2 ** 31 + 41, "cuda")
    got = found.driver.readings(run, mode)
    over = [k for k, v in got.items() if not v <= found.limits[k]]
    if mode == "sound":
        assert not over, got
    else:
        assert over, got
