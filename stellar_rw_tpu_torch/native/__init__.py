"""ctypes bindings for the native C++ graph builder (the port's own copy).

The shared library is built from graph_builder.cpp of this directory on first
use, by the host compiler, into build/native/ of the checkout (keyed by a hash
of the source and flags), and exposes `build_graph(path, ...)` returning a
fully-populated CSRGraph (alias + hash tables included). Without a compiler
every caller falls back to the NumPy builders, whose output is bit-identical:
catch NativeUnavailable, or ask `available()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graph_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
# no -march=native: the library may be copied to another host with the
# checkout; no FMA contraction: the alias rows must equal the NumPy builder's
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build_so() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libstellar_native-{tag.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"could not build native graph builder: {detail}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build_so())
        except OSError as e:
            raise NativeUnavailable(f"could not load native graph builder: "
                                    f"{e}") from e
        lib.srw_build.restype = ctypes.c_void_p
        lib.srw_build.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        for fn in (lib.srw_num_vertices, lib.srw_num_edges, lib.srw_hash_size):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.srw_copy.restype = None
        lib.srw_free.argtypes = [ctypes.c_void_p]
        lib.srw_build_alias.restype = None
        lib.srw_build_alias.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_void_p]
        lib.srw_build_hash.restype = ctypes.c_void_p
        lib.srw_build_hash.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64]
        lib.srw_hash_total.restype = ctypes.c_int64
        lib.srw_hash_total.argtypes = [ctypes.c_void_p]
        lib.srw_hash_copy.restype = None
        lib.srw_hash_free.argtypes = [ctypes.c_void_p]
        lib.srw_gather_rows.restype = None
        lib.srw_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int64]
        lib.srw_parse_walks.restype = ctypes.c_int64
        lib.srw_parse_walks.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def parse_walks(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Parse a walks-file byte buffer (uint8[n]) -> (values i64[NT], tokens per
    non-empty line i64[NL]). Single C++ pass at memory bandwidth; semantics
    identical to graph/io._parse_uint_lines (the NumPy fallback)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    nl = ctypes.c_int64(0)
    nt = lib.srw_parse_walks(c(data), ctypes.c_int64(len(data)), None, None,
                             ctypes.byref(nl))
    if nt < 0:
        # same contract as the NumPy fallback: oversized tokens are an error,
        # never a silent int64 wrap
        raise ValueError("token exceeds 19 digits (int64 overflow)")
    values = np.zeros(nt, dtype=np.int64)
    counts = np.zeros(nl.value, dtype=np.int64)
    if nt:
        lib.srw_parse_walks(c(data), ctypes.c_int64(len(data)), c(values),
                            c(counts), None)
    return values, counts


def build_alias_rows(offsets: np.ndarray,
                     weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row Vose alias tables for a CSR (offsets i64[V+1], weights f32[E]) ->
    (keep_prob f32[E], in-row alias pos i32[E]). Bit-identical to the Python
    worklist in graph/csr.build_alias_tables, ~100x faster at LiveJournal scale."""
    lib = _load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    E = len(weights)
    prob = np.ones(E, dtype=np.float32)
    pos = np.zeros(E, dtype=np.int32)
    if E:
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.srw_build_alias(c(offsets), c(weights),
                            ctypes.c_int64(len(offsets) - 1), c(prob), c(pos))
    return prob, pos


def build_hash_rows(offsets: np.ndarray, cols: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row open-addressing membership tables for a CSR -> (hash_offsets
    i64[V+1], hash_mask i32[V], hash_table i32[H]). Bit-identical layouts to
    graph/csr.build_hash_tables (same round-based placement), ~100x faster at
    LiveJournal scale."""
    lib = _load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    V = len(offsets) - 1
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    h = lib.srw_build_hash(c(offsets), c(cols), ctypes.c_int64(V))
    try:
        H = lib.srw_hash_total(ctypes.c_void_p(h))
        hoff = np.empty(V + 1, np.int64)
        hmask = np.empty(max(V, 1), np.int32)
        htab = np.empty(max(H, 1), np.int32)
        lib.srw_hash_copy(ctypes.c_void_p(h), c(hoff), c(hmask), c(htab))
    finally:
        lib.srw_hash_free(ctypes.c_void_p(h))
    return hoff, hmask[:V], htab[:H]


def gather_rows(starts: np.ndarray, lens: np.ndarray, src: np.ndarray,
                out: np.ndarray) -> None:
    """out[:lens.sum()] = concatenation of src[starts[i]:starts[i]+lens[i]]
    via range memcpys. src/out must be contiguous with the same dtype."""
    lib = _load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    assert src.flags.c_contiguous and out.flags.c_contiguous
    assert src.dtype == out.dtype
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.srw_gather_rows(c(starts), c(lens), ctypes.c_int64(len(starts)),
                        c(src), c(out), ctypes.c_int64(src.dtype.itemsize))


def build_graph(path: str, weighted: bool = True, directed: bool = False,
                partitioned: bool = False, num_partitions: int = 1, seed: int = 0):
    """Parse an edge list natively -> (CSRGraph with alias+hash tables, home i32[V])."""
    from ..graph.csr import CSRGraph

    lib = _load()
    h = lib.srw_build(path.encode(), int(weighted), int(directed),
                      int(partitioned), int(num_partitions), seed)
    if not h:
        raise FileNotFoundError(path)
    try:
        V = lib.srw_num_vertices(h)
        E = lib.srw_num_edges(h)
        H = lib.srw_hash_size(h)
        ids = np.empty(V, np.int64)
        offsets = np.empty(V + 1, np.int64)
        cols = np.empty(E, np.int32)
        weights = np.empty(E, np.float32)
        aprob = np.empty(E, np.float32)
        apos = np.empty(E, np.int32)
        hoff = np.empty(V + 1, np.int64)
        hmask = np.empty(V, np.int32)
        htab = np.empty(max(H, 1), np.int32)
        home = np.empty(V, np.int32)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.srw_copy(ctypes.c_void_p(h), c(ids), c(offsets), c(cols), c(weights),
                     c(aprob), c(apos), c(hoff), c(hmask), c(htab), c(home))
    finally:
        lib.srw_free(ctypes.c_void_p(h))
    g = CSRGraph(offsets=offsets, cols=cols, weights=weights, ids=ids,
                 alias_prob=aprob, alias_pos=apos,
                 hash_offsets=hoff, hash_mask=hmask, hash_table=htab[:H])
    return g, home
