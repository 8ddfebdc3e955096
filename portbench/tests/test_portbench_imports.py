"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared by their
top-level part (before the first dot) whole, so the port, whose name
begins with the JAX package's, passes."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

import pytest

from portbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "stellar_rw_tpu"}
MODULES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)
REFERENCE = [p for p in MODULES if p.parent.name == "reference"]


def _top_level_imports(path) -> set:
    """Top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(spec.HERE)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_the_reference_imports_nothing_of_the_program(path):
    assert _top_level_imports(path) <= {"__future__", "math", "typing",
                                        "numpy", "torch"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            # relative imports stay inside reference/
            assert node.level == 1, ast.dump(node)


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    return set(out.stdout.split())


def test_the_run_loads_neither_jax_nor_the_jax_package():
    """Every module of the benchmark and every module of the port that its
    entries call, imported in a fresh process."""
    loaded = _loaded_after(
        "from portbench import run, harness, control, graphcell, trace, spec\n"
        "b = spec.benchmark()\n"
        "for m in b['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "for w in b['workloads']:\n"
        "    spec.entry_module(spec.cell(w['name'], b)['workload']['entry'])\n"
        "from stellar_rw_tpu_torch.walk import engine\n"
        "from stellar_rw_tpu_torch.models import word2vec\n"
        "from stellar_rw_tpu_torch.graph import csr\n"
        "from stellar_rw_tpu_torch.ops import sampling\n")
    assert "stellar_rw_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "from portbench.reference import graph, prng, trainer, walks\n")
    assert not loaded & (FORBIDDEN | {"stellar_rw_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("stellar_rw_tpu_torch.fake", "jaxtyping", "flax_like",
                 "stellar_rw_tpu.fake", "jaxlib.fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert "stellar_rw_tpu.fake" in found and "jaxlib.fake" in found
    assert not {"stellar_rw_tpu_torch.fake", "jaxtyping",
                "flax_like"} & set(found)
