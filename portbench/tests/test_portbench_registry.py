"""BENCHMARK.json and the files it names: each configuration, cell and
per-layer metric is found by name and parses, a new one is picked up with
no edit to a file that is there, and the file keeps to the contract's
shape."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = spec.cell(cell, BENCH)
    assert c["config"]["name"] == c["entry"]["config"]
    module = spec.entry_module(c["workload"]["entry"])
    assert callable(module.make) and module.CONTROL
    assert c["workload"]["why"]
    limits = c["workload"]["check"]["limits"]
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_every_configuration_file_is_its_own(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    cfg = json.loads((spec.ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"]
    assert cfg["source"] and cfg["assumed"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    """Copies of the files with one cell, its entry and one metric added as
    new files: each is found by name, and the files that were there are
    unchanged."""
    for d in ("configs", "workloads", "metrics", "entries"):
        shutil.copytree(spec.HERE / d, tmp_path / d)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}
    wl = json.loads((tmp_path / "workloads" /
                     "blogcatalog.walk_cdf.json").read_text())
    wl["traffic"] = "walk_uniform"
    wl["entry"] = "walk_twice"
    wl["walk"] = {"p": 1.0, "q": 1.0}
    (tmp_path / "entries" / "walk_twice.py").write_text(
        "CONTROL = 'bf16'\n\n\ndef make(cell, seed, device):\n"
        "    return (cell['workload']['walk'], seed, device)\n")
    (tmp_path / "workloads" / "blogcatalog.walk_uniform.json").write_text(
        json.dumps(wl))
    (tmp_path / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "blogcatalog.walk_uniform",
                               "config": "blogcatalog",
                               "traffic": "walk_uniform", "chips": 1,
                               "why": "uniform walks"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "Device", "moves": "walk_steps_per_s",
                               "workloads": ["blogcatalog.walk_uniform"]})
    c = spec.cell("blogcatalog.walk_uniform", bench, tmp_path)
    assert c["workload"]["walk"] == {"p": 1.0, "q": 1.0}
    module = spec.entry_module(c["workload"]["entry"], tmp_path)
    assert module.make(c, 7, "cpu") == ({"p": 1.0, "q": 1.0}, 7, "cpu")
    read = spec.metric_reader("calls_per_s", tmp_path)
    assert read(type("Run", (), {"calls": 6, "window_s": 2.0})) == 3.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in tmp_path.rglob("*") if p.is_file()}
    assert {k: after[k] for k in before} == before


def test_a_cell_whose_files_disagree_is_refused(tmp_path):
    for d in ("configs", "workloads"):
        shutil.copytree(spec.HERE / d, tmp_path / d)
    p = tmp_path / "workloads" / "blogcatalog.walk_cdf.json"
    wl = json.loads(p.read_text())
    wl["traffic"] = "other"
    p.write_text(json.dumps(wl))
    with pytest.raises(ValueError, match="traffic"):
        spec.cell("blogcatalog.walk_cdf", BENCH, tmp_path)
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", BENCH, tmp_path)


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    assert {c["name"] for c in b["configs"]} == {
        w["config"] for w in b["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(
        b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert spec.applies(e2e[m["moves"]], w)
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if spec.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(spec.applies(m, w["name"]) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024
