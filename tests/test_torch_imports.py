"""The port stands alone: it must run where neither jax nor the JAX package
is installed.

An AST scan, not a subprocess: this image imports jax at interpreter start,
so an import that needs jax would succeed here and fail on the GPU machine.
No file of stellar_rw_tpu_torch/ and no chip_*.py script imports jax, bench or
any module of stellar_rw_tpu; the port keeps its own copy of every host
module it needs."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "stellar_rw_tpu_torch")

FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "bench", "stellar_rw_tpu"}


def _module_file(mod: str) -> str | None:
    base = os.path.join(ROOT, *mod.split("."))
    if os.path.isdir(base):
        return os.path.join(base, "__init__.py")
    return base + ".py" if os.path.exists(base + ".py") else None


def _module_of(path: str) -> str:
    rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _imports(path: str) -> set[str]:
    """Absolute module names imported by a file (relative ones resolved);
    `from pkg import name` counts pkg.name where that is a module."""
    me = _module_of(path)
    pkg = me if path.endswith("__init__.py") else me.rpartition(".")[0]
    out = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.add(mod)
            for a in node.names:
                if _module_file(f"{mod}.{a.name}"):
                    out.add(f"{mod}.{a.name}")
    return out


def _port_files():
    files = glob.glob(os.path.join(ROOT, "chip_*.py"))
    assert os.path.join(ROOT, "chip_smoke.py") in files
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_jax(path):
    """No jax, no bench and nothing of the JAX package."""
    bad = {m for m in _imports(path) if m.split(".")[0] in FORBIDDEN_TOP}
    assert not bad, f"{path} imports {bad}"


def test_port_imports_resolve_inside_the_port():
    """Every first-party module a port file imports is a file of the port
    (a relative import that climbs out of the package would not be)."""
    seen = set()
    for path in _port_files():
        for m in _imports(path):
            if m.split(".")[0] == "stellar_rw_tpu_torch":
                seen.add(m)
                assert _module_file(m) is not None, f"{path} imports {m}"
    for m in ("graph.csr", "graph.io", "graph.partition", "native",
              "utils.config", "utils.stats", "utils.logging", "ops.alias",
              "ops.shard_walk", "models.eval", "parallel.multihost"):
        assert f"stellar_rw_tpu_torch.{m}" in seen, m


def test_scanner_sees_jax_imports():
    """The scan itself finds what it guards against."""
    found = _imports(os.path.join(ROOT, "stellar_rw_tpu", "ops",
                                  "sampling.py"))
    assert "jax" in found and "jax.numpy" in found
    assert "stellar_rw_tpu.ops.alias" in _imports(
        os.path.join(ROOT, "stellar_rw_tpu", "models", "word2vec.py"))
    # and a port-side import of the JAX package would be caught
    assert "stellar_rw_tpu" in FORBIDDEN_TOP
    assert "stellar_rw_tpu_torch.ops.alias" in _imports(
        os.path.join(PORT, "models", "word2vec.py"))
