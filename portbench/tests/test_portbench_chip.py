"""On the card (`-m chip`): each cell at its own size, a short window, the
program within its limits and the control outside them."""

from __future__ import annotations

import pytest

from portbench import control, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(cuda, name):
    cell = spec.cell(name, BENCH)
    wrong = spec.entry_module(cell["workload"]["entry"]).CONTROL
    out = control.control(name, 2**31 + 777, 2.0, None, cuda, BENCH)
    limits = cell["workload"]["check"]["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out[wrong].items()), out
