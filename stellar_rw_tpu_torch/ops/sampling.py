"""Packed walk tables on the device, and the host builders that make them.

The host builders are the JAX package's (stellar_rw_tpu/ops/sampling.py:
96-249, 321, 554-569), re-homed here because that module imports jax at
module level. They are NumPy only; tests/test_torch_walk.py holds every
table they build equal, array for array, to the originals.

The port keeps only the packed layout the production sampler reads: one
16-byte row per gather (`alias_packed`, `hash_buckets`, `vmeta`). A graph
whose layout does not fit i32 (pack_tables_host returns None) is refused
with PackingUnavailable: the JAX package's unpacked fallback is not ported.

The exact inverse-CDF samplers (the JAX package's ops/sampling.py:251-518)
are here as plain torch on any device: the kernel of ops/cdf_walk.py
computes them bit for bit. They read `cdf_rows` (col, weight bits), uploaded
only for the CDF path, and the bucket tables for membership. Their sums run
in one fixed order, the kernel's (one warp a walker):

  * padded form: total and the prefix of b / total left to right, entry by
    entry. That is XLA's order on the CPU for rows of up to 17 entries
    (tests/test_torch_cdf.py), so there the form equals the JAX package's
    bit for bit on any weights;
  * chunked form: the total as 32 lane sums (lane l adds entries l, l+32,
    ... in turn) joined by a butterfly, and the prefix as an inclusive scan
    of each 32-entry piece (Kogge-Stone) added to the running sum of the
    pieces before it. The chunk width sets only the memory of a pass.

Any order gives the JAX package's result where every partial sum is exact
(unit or dyadic weights, p and q powers of two); elsewhere the forms agree
with it in distribution.
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
    vmeta: i32[V,4] (row start, degree, bucket base, nb-1);
    cdf_rows: i32[E,2] (col, weight as f32 bits), for the CDF samplers only.
    """

    offsets: torch.Tensor
    alias_packed: torch.Tensor
    hash_buckets: torch.Tensor
    vmeta: torch.Tensor
    cdf_rows: torch.Tensor | None = None   # i32[E,2] (col, f32 weight bits)

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


def cdf_rows_host(graph) -> np.ndarray:
    """i32[E,2]: each arc's column and its f32 weight's bits, one 8-byte
    read a row entry for the CDF samplers."""
    w = np.ascontiguousarray(graph.weights, dtype=np.float32).view(np.int32)
    return np.stack([np.asarray(graph.cols, dtype=np.int32), w], 1)


def with_cdf_rows(g: DeviceGraph, graph) -> DeviceGraph:
    """g with the CDF samplers' row table uploaded (a no-op if it has one)."""
    if g.cdf_rows is not None:
        return g
    return g._replace(cdf_rows=torch.as_tensor(cdf_rows_host(graph)).to(
        g.device))


def device_put_graph(graph, device, cdf: bool = False) -> DeviceGraph:
    """Upload a host CSRGraph (graph/csr.py) as packed
    tables; cdf=True adds the CDF samplers' `cdf_rows`. Raises
    PackingUnavailable where the JAX package would fall back to its
    unpacked tables."""
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
        cdf_rows=put(cdf_rows_host(graph), torch.int32) if cdf else None,
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


CDF_PAD_LIMIT = 1 << 27   # elements the padded exact-CDF path may materialize
CDF_CHUNK = 256           # row-slice width of the streaming exact-CDF path
LANES = 32                # the kernel's warp: the chunked form's sum order


def plan_cdf_chunk(batch_walkers: int, max_degree: int) -> int:
    """0 = padded exact CDF; else the chunk width of the streaming form.
    Callers take the decision from plan_cdf_chunk_corpus, never from a
    batch: the two forms agree only in distribution."""
    if batch_walkers * max(max_degree, 1) <= CDF_PAD_LIMIT:
        return 0
    return CDF_CHUNK


def plan_cdf_chunk_corpus(num_walks: int, n_starts: int,
                          max_degree: int) -> int:
    """The padded-or-chunked decision from the whole corpus's walker count,
    so every batching of one corpus takes the same form."""
    return plan_cdf_chunk(num_walks * n_starts, max_degree)


def _row_span(g: DeviceGraph, rows: torch.Tensor):
    vm = g.vmeta[rows.long()]
    return vm[:, 0].long(), vm[:, 1].long()


def _entries(g: DeviceGraph, idx: torch.Tensor):
    """(cols, f32 weights) of the row entries at flat positions idx
    (clamped into the table, as the JAX package's gathers are; a shard's
    table holds its own rows' arcs, fewer than its packed tables' rows)."""
    e = g.cdf_rows[idx.clamp(0, max(g.cdf_rows.shape[0] - 1, 0))]
    return e[..., 0], e[..., 1].view(torch.float32)


def gather_padded_row(g: DeviceGraph, rows: torch.Tensor, max_degree: int):
    """Rows padded to max_degree: (dsts i32[W,MD], w f32[W,MD], valid
    bool[W,MD]). MD stops at the longest row of the batch: the columns
    beyond it are invalid in every row and change no draw."""
    s, deg = _row_span(g, rows)
    if rows.numel():
        max_degree = min(max_degree, int(deg.max()))
    pos = torch.arange(max_degree, device=rows.device)
    dsts, w = _entries(g, s[:, None] + pos[None, :])
    return dsts, w, pos[None, :] < deg[:, None]


def _fdtype(dtype) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}.get(
        dtype, dtype)


def bias_quotients(p: float, q: float, dtype) -> tuple[float, float]:
    """1/p and 1/q in the accumulation type, as the JAX package rounds
    them: f32 quotients of f32 operands, or f64 quotients."""
    if _fdtype(dtype) == torch.float64:
        return 1.0 / p, 1.0 / q
    return (float(np.float32(1.0) / np.float32(p)),
            float(np.float32(1.0) / np.float32(q)))


def _bias(g: DeviceGraph, dst, prev_row, prev_id, p: float, q: float,
          dtype):
    """node2vec bias: dst == prev -> 1/p, dst in N(prev) -> 1, else 1/q,
    with the quotients in `dtype` (f32: 1.0f / f32(p))."""
    dtype = _fdtype(dtype)
    inv_p, inv_q = bias_quotients(p, q, dtype)
    meta = g.vmeta[prev_row.long()]
    h = (dst.to(torch.int64) * int(HASH_MULT)) & 0xFFFFFFFF
    win = g.hash_buckets[(meta[..., 2] + (h & meta[..., 3])).long()]
    member = (win == dst[..., None]).any(dim=-1)
    full = lambda v: torch.full(dst.shape, v, dtype=dtype,
                                device=dst.device)
    return torch.where(dst == prev_id, full(inv_p),
                       torch.where(member, full(1.0), full(inv_q)))


def _cdf_pick(b: torch.Tensor, valid: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
    """First index whose running normalized sum reaches u; 0 (the row head)
    if none. Total and prefix run left to right, entry by entry."""
    b = torch.where(valid, b, torch.zeros((), dtype=b.dtype,
                                          device=b.device))
    total = torch.zeros(b.shape[0], dtype=b.dtype, device=b.device)
    for j in range(b.shape[1]):
        total = total + b[:, j]
    x = b / torch.where(total > 0, total, torch.ones_like(total))[:, None]
    c = torch.zeros_like(total)
    ge = torch.zeros_like(valid)
    for j in range(b.shape[1]):
        c = c + x[:, j]
        ge[:, j] = c >= u
    return torch.argmax((ge & valid).to(torch.int8), dim=1)


def cdf_sample_first_order(g: DeviceGraph, cur: torch.Tensor, u: torch.Tensor,
                           max_degree: int, dtype="float32") -> torch.Tensor:
    """Weight-proportional draw by the padded inverse CDF; garbage where
    deg(cur) == 0 (the caller masks)."""
    dsts, w, valid = gather_padded_row(g, cur, max_degree)
    j = _cdf_pick(w.to(_fdtype(dtype)), valid, u)
    return torch.gather(dsts, 1, j[:, None])[:, 0]


def cdf_sample_second_order(g: DeviceGraph, cur_row, prev_row, prev_id,
                            u: torch.Tensor, p: float, q: float,
                            max_degree: int, dtype="float32") -> torch.Tensor:
    """Exact biased draw by the padded inverse CDF."""
    dsts, w, valid = gather_padded_row(g, cur_row, max_degree)
    f = _bias(g, dsts, prev_row[:, None], prev_id[:, None], p, q, dtype)
    j = _cdf_pick(w.to(_fdtype(dtype)) * f, valid, u)
    return torch.gather(dsts, 1, j[:, None])[:, 0]


def _chunk_scan(g: DeviceGraph, rows: torch.Tensor, chunk: int, body_fn,
                init):
    """Run body_fn(carry, dsts i32[W,n,32], w f32[W,n,32], valid) over each
    row in slices of whole 32-entry pieces, while any row has unread
    entries. A slice is at least `chunk` wide, and as wide as an eighth of
    CDF_PAD_LIMIT elements allows: the width changes no result."""
    s, deg = _row_span(g, rows)
    W = rows.shape[0]
    max_deg = int(deg.max()) if W else 0
    width = max(chunk, min(max_deg, CDF_PAD_LIMIT // 8 // max(W, 1)))
    width = -(-width // LANES) * LANES
    pos = torch.arange(width, device=rows.device)
    carry = init
    for base in range(0, max_deg, width):
        idx = base + pos[None, :]
        dsts, w = _entries(g, s[:, None] + idx)
        shape = (W, width // LANES, LANES)
        carry = body_fn(carry, dsts.reshape(shape), w.reshape(shape),
                        (idx < deg[:, None]).reshape(shape))
    return carry


def _lane_total(acc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Add the pieces b [W, n, 32] into the lane sums acc [W, 32] in turn."""
    for k in range(b.shape[1]):
        acc = acc + b[:, k]
    return acc


def _butterfly(acc: torch.Tensor) -> torch.Tensor:
    """The warp's xor butterfly over the lane sums [W, 32] -> [W]."""
    lane = torch.arange(LANES, device=acc.device)
    off = LANES // 2
    while off:
        acc = acc + acc[:, lane ^ off]
        off //= 2
    return acc[:, 0]


def _piece_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive Kogge-Stone scan along the last axis (32 lanes)."""
    d = 1
    while d < LANES:
        nxt = v.clone()
        nxt[..., d:] = v[..., d:] + v[..., :-d]
        v, d = nxt, 2 * d
    return v


def _chunked_pick(g: DeviceGraph, rows, u, chunk: int, weigh, dtype):
    """The chunked form: first entry whose running (unnormalized) sum
    reaches u * total; the row head if none. weigh(dsts, w) -> b."""
    dtype = _fdtype(dtype)
    W = rows.shape[0]
    dev = rows.device
    zero = torch.zeros((), dtype=dtype, device=dev)

    def acc_total(acc, dsts, w, valid):
        return _lane_total(acc, torch.where(valid, weigh(dsts, w), zero))

    acc = _chunk_scan(g, rows, chunk, acc_total,
                      torch.zeros((W, LANES), dtype=dtype, device=dev))
    thresh = u.to(dtype) * _butterfly(acc)

    def find(carry, dsts, w, valid):
        cum, found = carry
        scan = _piece_scan(torch.where(valid, weigh(dsts, w), zero))
        cums = []
        for k in range(scan.shape[1]):
            cums.append(cum)
            cum = cum + scan[:, k, -1]
        c = torch.stack(cums, 1)[:, :, None] + scan
        hit = ((c >= thresh[:, None, None]) & valid).reshape(W, -1)
        first = torch.argmax(hit.to(torch.int8), dim=1)
        pick = torch.gather(dsts.reshape(W, -1), 1, first[:, None])[:, 0]
        found = torch.where((found < 0) & hit.any(dim=1), pick, found)
        return cum, found

    _, found = _chunk_scan(g, rows, chunk, find,
                           (torch.zeros(W, dtype=dtype, device=dev),
                            torch.full((W,), -1, dtype=torch.int32,
                                       device=dev)))
    s, _ = _row_span(g, rows)
    head, _ = _entries(g, s)
    return torch.where(found >= 0, found, head)


def cdf_sample_second_order_chunked(g: DeviceGraph, cur_row, prev_row,
                                    prev_id, u, p: float, q: float,
                                    chunk: int, dtype="float32"):
    """Exact biased inverse-CDF draw streamed through the rows: pass 1 the
    total biased weight, pass 2 the first entry whose running sum reaches
    u * total (the JAX package's unnormalized test)."""
    dt = _fdtype(dtype)
    pr, pi = prev_row[:, None, None], prev_id[:, None, None]
    return _chunked_pick(
        g, cur_row, u, chunk,
        lambda dsts, w: w.to(dt) * _bias(g, dsts, pr, pi, p, q, dt), dt)


def cdf_sample_first_order_chunked(g: DeviceGraph, rows, u, chunk: int,
                                   dtype="float32"):
    """Weight-proportional chunked inverse-CDF draw."""
    dt = _fdtype(dtype)
    return _chunked_pick(g, rows, u, chunk, lambda dsts, w: w.to(dt), dt)


def draw_width(n: int) -> int:
    """Stream width for rejection-sampler uniforms: the strictly-greater
    multiple of DRAW_QUANTUM of the unpadded start count n. Every trial's
    dense uniforms are drawn at shape (3, draw_width(n))."""
    return (n // DRAW_QUANTUM + 1) * DRAW_QUANTUM
