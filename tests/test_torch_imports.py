"""The port must run where jax is not installed.

An AST scan, not a subprocess: this image imports jax at interpreter start,
so an import that needs jax would succeed here and fail on the GPU machine.
Every file of stellar_rw_tpu_torch/ and chip_smoke.py, and every module of
the JAX package they reach (followed transitively, package __init__ files
included), must import no jax, and the JAX-package modules reached must be
the host-only ones the port is allowed to share."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "stellar_rw_tpu_torch")

# host-only, jax-free modules of the JAX package the port shares
SHARED = {
    "stellar_rw_tpu", "stellar_rw_tpu.graph", "stellar_rw_tpu.graph.io",
    "stellar_rw_tpu.graph.csr", "stellar_rw_tpu.ops",
    "stellar_rw_tpu.ops.alias", "stellar_rw_tpu.utils",
    "stellar_rw_tpu.utils.config", "stellar_rw_tpu.utils.stats",
    "stellar_rw_tpu.utils.logging", "stellar_rw_tpu.native",
    "stellar_rw_tpu.models", "stellar_rw_tpu.models.eval",
}
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "bench"}


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


def _with_parents(mod: str) -> set[str]:
    parts = mod.split(".")
    return {".".join(parts[:i]) for i in range(1, len(parts) + 1)}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_jax(path):
    bad = {m for m in _imports(path) if m.split(".")[0] in FORBIDDEN_TOP}
    assert not bad, f"{path} imports {bad}"


def test_shared_modules_are_jax_free_transitively():
    seen, todo = set(), []
    for path in _port_files():
        for m in _imports(path):
            if m.split(".")[0] == "stellar_rw_tpu":
                todo.extend(_with_parents(m))
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        assert m in SHARED, f"the port reaches {m}, not a shared module"
        f = _module_file(m)
        assert f is not None, m
        for sub in _imports(f):
            top = sub.split(".")[0]
            assert top not in FORBIDDEN_TOP, f"{m} imports {sub}"
            if top == "stellar_rw_tpu":
                todo.extend(_with_parents(sub))
    assert "stellar_rw_tpu.graph.csr" in seen


def test_scanner_sees_jax_imports():
    """The scan itself finds what it guards against."""
    found = _imports(os.path.join(ROOT, "stellar_rw_tpu", "ops",
                                  "sampling.py"))
    assert "jax" in found and "jax.numpy" in found
    assert "stellar_rw_tpu.ops.alias" in _imports(
        os.path.join(ROOT, "stellar_rw_tpu", "models", "word2vec.py"))
