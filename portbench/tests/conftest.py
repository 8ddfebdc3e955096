"""Fixtures of the benchmark's tests, and the marker of those that need a
CUDA card (`chip`): they skip without one, decided inside the `cuda`
fixture, never while a module is imported.

    python3 -m pytest portbench/tests -q            # here: the CPU tests
    python3 -m pytest portbench/tests -q -m chip    # on a machine with a card
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import spec
from portbench.reference import walks as refwalks

# the cells' graphs and walks cut to a size a CPU test holds (the widths too:
# these are tests, not cells)
TINY = {"graph": {"num_vertices": 240, "num_edges": 2400},
        "walk": {"walks_per_node": 3, "walk_length": 8},
        "model": {"dim": 16, "row_block": 4}}
TINY_PAD_LIMIT = 64   # walkers x widest row above which the CDF is chunked
TINY_ROWS_PER_CALL = 64


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m chip on the chip")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench, base): BENCHMARK.json's cells over copies of their files in
    tmp_path, every configuration cut to TINY, the walk cells comparing
    TINY_ROWS_PER_CALL rows a call, and the exact-CDF walks in their
    chunked form (the one the reference replays) at that size."""
    from stellar_rw_tpu_torch.ops import sampling

    monkeypatch.setattr(sampling, "CDF_PAD_LIMIT", TINY_PAD_LIMIT)
    monkeypatch.setattr(refwalks, "CDF_PAD_LIMIT", TINY_PAD_LIMIT)
    bench = spec.benchmark()
    for d in ("metrics", "entries"):
        shutil.copytree(spec.HERE / d, tmp_path / d)
    (tmp_path / "workloads").mkdir()
    for w in bench["workloads"]:
        wl = json.loads((spec.HERE / "workloads" / f"{w['name']}.json")
                        .read_text())
        if "rows_per_call" in wl["check"]:
            # a tiny corpus's few rows a call can all agree by chance
            wl["check"]["rows_per_call"] = TINY_ROWS_PER_CALL
        (tmp_path / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(wl))
    (tmp_path / "configs").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        for group, sizes in TINY.items():
            cfg[group].update({k: v for k, v in sizes.items()
                               if k in cfg[group] or group != "model"})
        (tmp_path / "configs" / f"{c['name']}.json").write_text(
            json.dumps(cfg))
    return bench, Path(tmp_path)
