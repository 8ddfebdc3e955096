"""Packed walk tables on the device, and the host builders that make them.

The host builders are the JAX package's (stellar_rw_tpu/ops/sampling.py:
96-249, 321, 554-569), re-homed here because that module imports jax at
module level. They are NumPy only; tests/test_torch_walk.py holds every
table they build equal, array for array, to the originals.

The port keeps only the packed layout the production sampler reads: one
16-byte row per gather (`alias_packed`, `hash_buckets`, `vmeta`). A graph
whose layout does not fit i32 (pack_tables_host returns None) is refused
with PackingUnavailable: the JAX package's unpacked fallback is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..graph.csr import HASH_MULT  # Knuth multiplicative hash

BUCKET_SLOTS = 4  # membership bucket width: one aligned 16-byte row gather

DRAW_QUANTUM = 8192


class PackingUnavailable(ValueError):
    """The graph's packed tables would exceed i32 (or the graph is empty)."""


class DeviceGraph(NamedTuple):
    """Packed walk tables resident on one device.

    offsets: i64[V+1] CSR row offsets (kept for degree and invariant checks);
    alias_packed: i32[E,4] (prob bits, col-if-keep, col-if-alias, alias pos);
    hash_buckets: i32[NB,4] bucketized neighbor sets, -1 = empty slot;
    vmeta: i32[V,4] (row start, degree, bucket base, nb-1).
    """

    offsets: torch.Tensor
    alias_packed: torch.Tensor
    hash_buckets: torch.Tensor
    vmeta: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.vmeta.shape[0]

    @property
    def num_edges(self) -> int:
        return self.alias_packed.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vmeta.device


def bucket_tables_host(offsets, cols):
    """Bucketized per-vertex membership tables, vectorized on host.

    Each vertex's UNIQUE neighbors are placed in nb power-of-two buckets of
    BUCKET_SLOTS slots; a key's only possible home is bucket
    hash(key) & (nb - 1), so the device membership test is one aligned
    16-byte row read + 4 compares. Buckets that overflow BUCKET_SLOTS double
    that row's nb and rebuild (rare: average load is <= 2 keys/bucket).

    Returns (hash_meta i32[V,2] = (bucket row base, nb-1), buckets
    i32[NB, BUCKET_SLOTS], -1 = empty) or None when the layout exceeds i32.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int32)
    V = len(offsets) - 1
    E = len(cols)
    deg = offsets[1:] - offsets[:-1]
    if E:
        first = np.ones(E, dtype=bool)
        first[1:] = cols[1:] != cols[:-1]
        first[np.clip(offsets[:-1], 0, E - 1)] = True
        row_of = np.repeat(np.arange(V, dtype=np.int64), deg)
        keys = cols[first].astype(np.int64)
        krow = row_of[first]
        udeg = np.zeros(V, dtype=np.int64)
        np.add.at(udeg, krow, 1)
    else:
        keys = np.zeros(0, dtype=np.int64)
        krow = np.zeros(0, dtype=np.int64)
        udeg = np.zeros(V, dtype=np.int64)
    # nb = pow2ceil(need / 2): average load <= 2 of BUCKET_SLOTS slots
    need = np.maximum(udeg, 1)
    nb = (2 ** np.ceil(np.log2(np.maximum(need, 2) / 2.0))).astype(np.int64)
    h0 = ((keys.astype(np.uint64) * np.uint64(HASH_MULT))
          & np.uint64(0xFFFFFFFF)).astype(np.int64)
    idx = np.arange(len(keys), dtype=np.int64)
    while True:
        boff = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(nb, out=boff[1:])
        NB = int(boff[-1])
        if NB >= 2**31 // BUCKET_SLOTS:
            return None
        gb = boff[:-1][krow] + (h0 & (nb[krow] - 1))
        order = np.argsort(gb, kind="stable")
        gbs = gb[order]
        if len(gbs):
            newgrp = np.ones(len(gbs), dtype=bool)
            newgrp[1:] = gbs[1:] != gbs[:-1]
            rank = idx - np.maximum.accumulate(np.where(newgrp, idx, 0))
        else:
            rank = idx
        over = rank >= BUCKET_SLOTS
        if not over.any():
            buckets = np.full((NB, BUCKET_SLOTS), -1, dtype=np.int32)
            buckets[gbs, rank] = keys[order].astype(np.int32)
            hash_meta = np.stack([boff[:-1], nb - 1], 1).astype(np.int32)
            return hash_meta, buckets
        nb[np.unique(krow[order[over]])] *= 2  # grow + rebuild (rare)


def pack_tables_host(offsets, cols, alias_prob, alias_pos):
    """Packed fast-path tables on host, vectorized: (row_meta, alias_packed,
    hash_meta, hash_buckets), or None for an empty graph or a layout too
    large for i32. The alias rows carry BOTH possible candidate vertex ids,
    so a trial's candidate comes out of one 16-byte row read."""
    V = len(offsets) - 1
    E = len(alias_pos) if alias_pos is not None else 0
    if V == 0 or E == 0:
        return None
    if int(offsets[-1]) >= 2**31:
        return None
    deg = offsets[1:] - offsets[:-1]
    row_meta = np.stack([offsets[:-1], deg], 1).astype(np.int32)
    prob_bits = np.ascontiguousarray(alias_prob, dtype=np.float32).view(np.int32)
    row_of = np.repeat(np.arange(V, dtype=np.int64), deg)
    col_alias = np.asarray(cols, dtype=np.int32)[
        offsets[:-1][row_of] + alias_pos.astype(np.int64)]
    alias_packed = np.stack(
        [prob_bits, np.asarray(cols, dtype=np.int32), col_alias,
         alias_pos.astype(np.int32)], 1)
    bt = bucket_tables_host(offsets, cols)
    if bt is None:
        return None
    hash_meta, hash_buckets = bt
    return row_meta, alias_packed, hash_meta, hash_buckets


def vmeta_host(row_meta: np.ndarray, hash_meta: np.ndarray) -> np.ndarray:
    """Fuse row_meta and hash_meta into one [V,4] row."""
    return np.concatenate([row_meta, hash_meta], axis=-1)


def device_put_graph(graph, device) -> DeviceGraph:
    """Upload a host CSRGraph (graph/csr.py) as packed
    tables. Raises PackingUnavailable where the JAX package would fall back
    to its unpacked tables."""
    graph.build_alias_tables()
    pk = pack_tables_host(graph.offsets, graph.cols, graph.alias_prob,
                          graph.alias_pos)
    if pk is None:
        raise PackingUnavailable(
            f"graph with V={graph.num_vertices}, E={graph.num_edges} has no "
            "packed i32 layout (empty, or beyond 2**31 entries); the "
            "unpacked tables are not ported")
    row_meta, alias_packed, hash_meta, hash_buckets = pk
    put = lambda x, dt: torch.as_tensor(
        np.ascontiguousarray(x), dtype=dt).to(device)
    return DeviceGraph(
        offsets=put(graph.offsets, torch.int64),
        alias_packed=put(alias_packed, torch.int32),
        hash_buckets=put(hash_buckets, torch.int32),
        vmeta=put(vmeta_host(row_meta, hash_meta), torch.int32),
    )


def search_iters(max_degree: int) -> int:
    return max(1, math.ceil(math.log2(max_degree + 1))) + 1


def plan_sampler(sampler: str, p: float, q: float) -> tuple[str, int]:
    """Resolve the production sampler + rejection round budget for a (p, q).

    Worst-case acceptance is min_f/max_f = 1/ratio for f in {1/p, 1, 1/q};
    the budget k_candidates * max_rounds ~ 8*ratio keeps the truncation
    probability below e^-8. Beyond ratio 32 the JAX package switches to the
    exact inverse-CDF sampler ("cdf")."""
    if sampler != "rejection":
        return sampler, 16
    fs = (1.0 / p, 1.0, 1.0 / q)
    ratio = max(fs) / min(fs)
    if ratio > 32.0:
        return "cdf", 16
    return "rejection", max(16, int(2.0 * ratio) + 1)


def draw_width(n: int) -> int:
    """Stream width for rejection-sampler uniforms: the strictly-greater
    multiple of DRAW_QUANTUM of the unpadded start count n. Every trial's
    dense uniforms are drawn at shape (3, draw_width(n))."""
    return (n // DRAW_QUANTUM + 1) * DRAW_QUANTUM
