"""Finding a cell's files by name.

BENCHMARK.json (at the root of the checkout) names each cell with its
configuration and traffic; the cell's own files are found by those names:

  configs/<config>.json       the configuration as it is run
  workloads/<cell>.json       the cell's traffic parameters and its `why`
  entries/<entry>.py          the code the window drives, named by the
                              workload's `entry` (see graphcell.py)
  metrics/<metric>.py         a per-layer metric's reader: read(run)

A new configuration, cell, entry or per-layer metric is a new file here and
a new entry in BENCHMARK.json; nothing else changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None, base: Path = HERE) -> dict:
    """The cell `name`: its BENCHMARK.json entry, its workload file and its
    configuration file, checked against one another."""
    bench = benchmark() if bench is None else bench
    entry = _by_name(bench["workloads"], name, "workload")
    wl = load_json("workloads", name, base)
    cfg = load_json("configs", entry["config"], base)
    for key in ("config", "traffic"):
        if wl.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} "
                             f"{wl.get(key)!r}, BENCHMARK.json {entry[key]!r}")
    if cfg.get("name") != entry["config"]:
        raise ValueError(f"configs/{entry['config']}.json names "
                         f"{cfg.get('name')!r}")
    return {"name": name, "entry": entry, "workload": wl, "config": cfg}


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric of BENCHMARK.json is reported in the cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def _module(kind: str, name: str, base: Path):
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: Path = HERE):
    """The `read` function of metrics/<name>.py."""
    return _module("metrics", name, base).read


def entry_module(name: str, base: Path = HERE):
    """The module entries/<name>.py: its make(cell, seed, device) and its
    CONTROL."""
    return _module("entries", name, base)
