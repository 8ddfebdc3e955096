"""Sparse neighborhood-aggregate primitives: SpMM, SDDMM, the row softmax,
gathers and scatters over a CSR graph (port of stellar_rw_tpu/ops/spmm.py).

The GNN-feed ops that let walk corpora and embeddings feed GNN-style layers.
Every op is differentiable. On the card each is a torch.autograd.Function
whose forward and backward launch csrc/spmm.cu's three kernels:
  * segment_sum: Y[s] = scale_s * sum over the arcs e of segment s of
    w_e * X[idx_e] (scale 1 / max(deg, 1) for the mean), on the CSR order
    (segments = source rows) or the transposed order (arcs stably sorted by
    destination): spmm, spmm_mean and scatter_add_rows forward, and every
    backward pass (gather_rows' too);
  * sddmm_rows: s_e = <x[row_e], y[col_e]>, a row's x held while its arcs'
    y rows stream, the dots of a run of 32 arcs finished together;
  * row_softmax: an item's max, exps, sum and quotients from its arcs read
    once, or its backward dS = a * (dA - sum_row a * dA); a split row's
    items combine their partials in a second pass.
A segment longer than `chunk` arcs is split into items of `chunk` arcs, a
warp an item (segment_items); the segment sum's partial sums are summed in
item order by a tree of two levels (groups of FAN items, then the groups),
each level by whichever warp finishes last, and the softmax's by every
item of the row in one fixed order, so a result is the same in every run.
The segment sum and the SDDMM gather rows by 16-byte loads; each kernel's
grid is the blocks the card holds at once (segment_grid). The segment
sums are taken in double, the SDDMM's dots in float within a lane and in
double across lanes. gather_rows' forward is index_select, a copy with no
arithmetic, as the JAX package's x[idx]. On the CPU each op runs its plain
version (index_select, index_add_, scatter_reduce), whose gradients
torch's autograd takes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import resolve_device
from ._build import Kernel, ptr, require_cuda, sm_count, stream

SPMM_SEGMENT_SUM = Kernel(
    "spmm.cu", "srw_segment_sum_launch",
    [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
# the SDDMM and row-softmax kernels of the same source (and library)
SPMM_SDDMM = Kernel(
    "spmm.cu", "srw_sddmm_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_void_p])
SPMM_ROW_SOFTMAX = Kernel(
    "spmm.cu", "srw_row_softmax_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p])

THREADS = 256           # kThreads in the source: 8 warps, a warp an item
# arcs of an item: longer segments are split. At bench.py::measure_spmm's
# graph (D 128), on an H100, items of 128 arcs took the segment sum 0.0511
# ms; of 256, 0.0570; of 64, 0.0583 (chip_smoke.py phase 20)
CHUNK = 128
# the segment sum: blocks an SM (kSegBlocks, its __launch_bounds__), the
# arcs whose indices and weights a warp stages at once (kRun), and the
# partials of a split segment's group (kFan: a group's partials are summed
# first, then the groups' sums)
SEGMENT_BLOCKS_PER_SM = 3
RUN = 32
FAN = 16
# the SDDMM's and the softmax's blocks an SM (kDotBlocks, kSoftBlocks); the
# SDDMM's items (at measure_spmm's graph, D 128, on an H100, items of 32 /
# 64 / 128 arcs took 0.0430-0.0432 / 0.0435-0.0443 / 0.0449-0.0452 ms:
# chip_spmm_parts.py) and the longest item the softmax holds in registers
# (32 * kPer arcs; items of 64 took it 0.0139 ms, of 128 0.0097)
SDDMM_BLOCKS_PER_SM = 3
SOFTMAX_BLOCKS_PER_SM = 6
SDDMM_CHUNK = 64
SOFTMAX_CHUNK = 128


def segment_items(offsets: np.ndarray, chunk: int = CHUNK
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernels' work items over segments [offsets[s], offsets[s+1]):
    (segment, first arc, partial) of each run of at most `chunk` arcs, in
    segment order; an empty segment has one of no arcs (the segment sum
    writes its zero row, so its output needs no zero fill). A segment of
    more than
    `chunk` arcs (a hub row) is split into several items, numbered in
    order by `partial` (their rows of the partial sums; -1 for an item
    that is its whole segment), whose partials the kernel sums in that
    order (groups of FAN, then the groups)."""
    if chunk < 1:
        raise ValueError(f"segment_items: chunk {chunk}")
    offsets = np.asarray(offsets, dtype=np.int64)
    deg = np.diff(offsets)
    n = np.maximum(-(-deg // chunk), 1)                   # items a segment
    seg = np.repeat(np.arange(len(deg), dtype=np.int64), n)
    first = np.repeat(np.cumsum(n) - n, n)
    start = offsets[:-1][seg] + (np.arange(len(seg)) - first) * chunk
    split = n[seg] > 1
    part = np.where(split, np.cumsum(split) - 1, -1)
    return (seg.astype(np.int32), start.astype(np.int32),
            part.astype(np.int32))


@dataclass(frozen=True)
class Order:
    """One order of the arcs for segment sums: its segments' offsets
    [S + 1], the work items (segment_items; `item_start` has one more
    entry, the arcs' count, so an item ends where the next begins),
    `chunk`, the number of partial rows and, for each in turn, its split
    item's (first arc, end, its segment's first partial row, its
    segment's items) (`part_desc`, the softmax's second pass). It holds
    no state a launch writes: each launch takes its own partial rows and
    arrival counters, so launches on one Order may run on several streams
    at once."""

    offsets: torch.Tensor
    item_seg: torch.Tensor
    item_start: torch.Tensor
    item_part: torch.Tensor
    part_desc: torch.Tensor
    parts: int
    chunk: int

    @classmethod
    def build(cls, offsets: np.ndarray, device, chunk: int = CHUNK):
        seg, start, part = segment_items(offsets, chunk)
        offsets = np.asarray(offsets, dtype=np.int64)
        bounds = np.append(start, offsets[-1])
        split = np.flatnonzero(part >= 0)
        s = seg[split]
        desc = np.stack([
            bounds[split], bounds[split + 1],
            part[split] - (start[split] - offsets[s]) // chunk,
            -(-(offsets[s + 1] - offsets[s]) // chunk)], axis=1)
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32)
                                        ).to(device)
        return cls(put(offsets), put(seg), put(bounds), put(part),
                   put(desc.reshape(-1, 4)), len(split), chunk)


@dataclass(frozen=True)
class EdgeStructure:
    """Edge-axis view of a CSR graph for segment ops.

    row, col, weight: each stored arc's source, destination and weight in
    CSR order (the JAX package's fields); for the kernels also the CSR
    order's segments (`csr`; `dots` and `soft`, the same in the SDDMM's
    items of at most SDDMM_CHUNK arcs and the softmax's of at most
    SOFTMAX_CHUNK: `csr` itself where its chunk is no longer), the
    transposed order (`t_order`: the arcs stably sorted by col, `t_row` =
    row[t_order], `trans`: its segments by destination) and 1 / max(
    out-degree, 1) a vertex (`inv_deg`), built once on the host."""

    row: torch.Tensor        # i32[E]
    col: torch.Tensor        # i32[E]
    weight: torch.Tensor     # f32[E]
    num_vertices: int
    csr: Order
    t_order: torch.Tensor    # i32[E]
    t_row: torch.Tensor      # i32[E]
    trans: Order
    inv_deg: torch.Tensor    # f32[V]
    dots: Order
    soft: Order

    @classmethod
    def from_csr(cls, graph, device="cuda", chunk: int = CHUNK
                 ) -> "EdgeStructure":
        device = resolve_device("EdgeStructure.from_csr", device)
        V = graph.num_vertices
        offsets = np.asarray(graph.offsets, dtype=np.int64)
        deg = np.diff(offsets)
        row = np.repeat(np.arange(V, dtype=np.int32), deg)
        col = np.asarray(graph.cols, dtype=np.int32)
        t_order = np.argsort(col, kind="stable").astype(np.int32)
        t_offsets = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(np.bincount(col, minlength=V), out=t_offsets[1:])
        put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt)
                                            ).to(device)
        csr = Order.build(offsets, device, chunk)
        at_most = lambda n: csr if chunk <= n else Order.build(offsets,
                                                                device, n)
        return cls(row=put(row, np.int32), col=put(col, np.int32),
                   weight=put(graph.weights, np.float32), num_vertices=V,
                   csr=csr, t_order=put(t_order, np.int32),
                   t_row=put(row[t_order], np.int32),
                   trans=Order.build(t_offsets, device, chunk),
                   inv_deg=put(1.0 / np.maximum(deg, 1), np.float32),
                   dots=at_most(SDDMM_CHUNK), soft=at_most(SOFTMAX_CHUNK))


# ------------------------------------------------------------- plain versions


def spmm_ref(es: EdgeStructure, x, weighted: bool = True):
    msgs = x.index_select(0, es.col)
    if weighted:
        msgs = msgs * es.weight.to(x.dtype)[:, None]
    return x.new_zeros((es.num_vertices, x.shape[1])).index_add(0, es.row,
                                                                msgs)


def spmm_mean_ref(es: EdgeStructure, x):
    s = spmm_ref(es, x, weighted=False)
    deg = x.new_zeros(es.num_vertices).index_add(
        0, es.row, x.new_ones(es.row.shape[0]))
    return s / deg.clamp_min(1.0)[:, None]


def sddmm_ref(es: EdgeStructure, x, y):
    return (x.index_select(0, es.row) * y.index_select(0, es.col)).sum(-1)


def sddmm_softmax_ref(es: EdgeStructure, scores):
    """The row max is taken off before exp and detached: a softmax does
    not depend on it, so the gradient is the softmax's own."""
    smax = torch.full((es.num_vertices,), -torch.inf, dtype=scores.dtype,
                      device=scores.device).scatter_reduce(
        0, es.row.long(), scores.detach(), "amax")
    ex = torch.exp(scores - smax[es.row])
    ssum = scores.new_zeros(es.num_vertices).index_add(0, es.row, ex)
    return ex / ssum.clamp_min(1e-30)[es.row]


def _idx(es: EdgeStructure, which: str):
    if which not in ("row", "col"):
        raise ValueError(f"which must be 'row' or 'col', got {which!r}")
    return es.col if which == "col" else es.row


def gather_rows_ref(es: EdgeStructure, x, which: str = "col"):
    return x.index_select(0, _idx(es, which))


def scatter_add_rows_ref(es: EdgeStructure, msgs, which: str = "row"):
    return msgs.new_zeros((es.num_vertices, msgs.shape[1])).index_add(
        0, _idx(es, which), msgs)


# -------------------------------------------------------------------- kernels


def segment_sum(order: Order, x: torch.Tensor, idx=None, w=None, widx=None,
                mean: bool = False, kernel: Kernel = SPMM_SEGMENT_SUM
                ) -> torch.Tensor:
    """Y [S, D] with Y[s] = scale_s * sum over the arcs e of segment s of
    w[widx[e]] * x[idx[e]] (idx, w, widx each the identity / 1 when None;
    scale_s = 1 / max(deg_s, 1) for the mean, else 1): one launch of
    csrc/spmm.cu's segment_sum (`kernel`: or a variant of its source built
    with the same entry point)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"segment_sum: x must be float32 [N, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    opt = [t for t in (idx, w, widx) if t is not None]
    require_cuda("segment_sum", x, order.offsets, *opt)
    if (idx is not None and idx.dtype != torch.int32) or (
            widx is not None and widx.dtype != torch.int32) or (
            w is not None and w.dtype != torch.float32):
        raise ValueError("segment_sum: idx/widx int32, w float32")
    S = order.offsets.shape[0] - 1
    D = x.shape[1]
    out = torch.empty((S, D), dtype=torch.float32, device=x.device)
    n = order.item_seg.shape[0]
    if n and D:
        opt_ptr = lambda t: None if t is None else ptr(t)
        # a split segment's partial rows and its arrival counters (a
        # group's at its first partial row, the segment's at its second):
        # this launch's own, from the caching allocator
        partials = arrive = None
        if order.parts:
            partials = torch.empty((order.parts, D), dtype=torch.float64,
                                   device=x.device)
            arrive = torch.zeros(order.parts, dtype=torch.int32,
                                 device=x.device)
        kernel.launch(
            ptr(out), ptr(x), D, ptr(order.offsets), n, ptr(order.item_seg),
            ptr(order.item_start), ptr(order.item_part), order.chunk,
            opt_ptr(idx), opt_ptr(w), opt_ptr(widx), int(mean),
            opt_ptr(partials), opt_ptr(arrive),
            segment_grid(n, sm_count(x.device)), stream(x.device))
    return out


def sddmm_rows(es: EdgeStructure, x: torch.Tensor, y: torch.Tensor,
               kernel: Kernel = SPMM_SDDMM) -> torch.Tensor:
    """s_e = <x[row_e], y[col_e]> over `es.dots`' items: one launch of
    csrc/spmm.cu's sddmm_rows (`kernel`: or a variant of its source built
    with the same entry point)."""
    _check_rows("sddmm", es, x, y)
    out = torch.empty(es.col.shape[0], dtype=torch.float32, device=x.device)
    n = es.dots.item_seg.shape[0]
    if n:
        kernel.launch(ptr(out), ptr(x), ptr(y), x.shape[1], n,
                      ptr(es.dots.item_seg), ptr(es.dots.item_start),
                      ptr(es.col), segment_grid(n, sm_count(x.device),
                                                SDDMM_BLOCKS_PER_SM),
                      stream(x.device))
    return out


def row_softmax(es: EdgeStructure, a: torch.Tensor,
                da: torch.Tensor | None = None,
                kernel: Kernel = SPMM_ROW_SOFTMAX) -> torch.Tensor:
    """The row softmax of scores `a` [E] by source row (da None), or its
    backward a * (da - sum_row a * da) for the softmax `a`: csrc/spmm.cu's
    row_softmax over `es.soft`'s items, a second pass over the split rows'
    items where a row is split (`kernel`: or a variant of its source built
    with the same entry point)."""
    for t in (a,) if da is None else (a, da):
        if t.shape != es.col.shape or t.dtype != torch.float32:
            raise ValueError(f"row_softmax: expected float32 [E], got "
                             f"{t.dtype} {tuple(t.shape)}")
    order = es.soft
    require_cuda("row_softmax", a, order.offsets,
                 *(() if da is None else (da,)))
    out = torch.empty_like(a)
    n = order.item_seg.shape[0]
    if n and a.numel():
        # a split row's items' (max, sum of exps) or dots: this call's own
        partials = (torch.empty(2 * order.parts, dtype=torch.float32,
                                device=a.device) if order.parts else None)
        kernel.launch(
            ptr(out), ptr(a), None if da is None else ptr(da), n,
            ptr(order.item_start), ptr(order.item_part), order.chunk,
            ptr(order.part_desc) if order.parts else None, order.parts,
            None if partials is None else ptr(partials), int(da is not None),
            segment_grid(n, sm_count(a.device), SOFTMAX_BLOCKS_PER_SM),
            stream(a.device))
    return out


def segment_grid(items: int, sms: int,
                 per_sm: int = SEGMENT_BLOCKS_PER_SM) -> int:
    """A kernel's persistent grid (the segment sum's by default): a warp an
    item while the items fill fewer blocks than the card holds at once,
    else every resident block (`per_sm` an SM, the kernel's
    __launch_bounds__), whose warps stride over the items, so no partial
    second wave is left."""
    return max(1, min(per_sm * sms, -(-items // (THREADS // 32))))


def _check_rows(name, es, *xs):
    for x in xs:
        if x.dim() != 2 or x.shape[0] != es.num_vertices or (
                x.dtype != torch.float32):
            raise ValueError(f"{name}: expected float32 [V={es.num_vertices}"
                             f", D], got {x.dtype} {tuple(x.shape)}")
    require_cuda(name, *xs, es.col)


# -------------------------------------------------- autograd on the card


class _SpMM(torch.autograd.Function):
    """Y = A X (weighted or not) or its row mean; dX = A^T dY over the
    transposed order (per arc: the weight, or 1 / deg of its source)."""

    @staticmethod
    def forward(ctx, x, es, weighted, mean):
        ctx.es, ctx.weighted, ctx.mean = es, weighted, mean
        return segment_sum(es.csr, x.contiguous(), idx=es.col,
                           w=es.weight if weighted else None, mean=mean)

    @staticmethod
    def backward(ctx, dy):
        es = ctx.es
        if ctx.weighted:
            w, widx = es.weight, es.t_order
        elif ctx.mean:
            w, widx = es.inv_deg, es.t_row
        else:
            w = widx = None
        return (segment_sum(es.trans, dy.contiguous(), idx=es.t_row, w=w,
                            widx=widx), None, None, None)


class _SDDMM(torch.autograd.Function):
    """s_e = <x_row, y_col>; dx = sum by row of g_e y_col (CSR order), dy =
    sum by col of g_e x_row (transposed order)."""

    @staticmethod
    def forward(ctx, x, y, es):
        x, y = x.contiguous(), y.contiguous()
        ctx.es = es
        ctx.save_for_backward(x, y)
        return sddmm_rows(es, x, y)

    @staticmethod
    def backward(ctx, g):
        es = ctx.es
        x, y = ctx.saved_tensors
        g = g.contiguous()
        dx = segment_sum(es.csr, y, idx=es.col, w=g)
        dy = segment_sum(es.trans, x, idx=es.t_row, w=g, widx=es.t_order)
        return dx, dy, None


class _RowSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, es):
        ctx.es = es
        a = row_softmax(es, scores.contiguous())
        ctx.save_for_backward(a)
        return a

    @staticmethod
    def backward(ctx, da):
        (a,) = ctx.saved_tensors
        return row_softmax(ctx.es, a, da.contiguous()), None


class _GatherRows(torch.autograd.Function):
    """x[idx] by index_select; its backward is the segment sum of the arcs'
    gradients by endpoint."""

    @staticmethod
    def forward(ctx, x, es, which):
        ctx.es, ctx.which = es, which
        return x.index_select(0, _idx(es, which))

    @staticmethod
    def backward(ctx, dg):
        es = ctx.es
        dg = dg.contiguous()
        if ctx.which == "row":
            return segment_sum(es.csr, dg), None, None
        return segment_sum(es.trans, dg, idx=es.t_order), None, None


class _ScatterAddRows(torch.autograd.Function):
    """Per-arc messages summed onto their endpoints by segment sum; its
    backward gathers each arc's endpoint gradient."""

    @staticmethod
    def forward(ctx, msgs, es, which):
        ctx.es, ctx.which = es, which
        msgs = msgs.contiguous()
        if which == "row":
            return segment_sum(es.csr, msgs)
        return segment_sum(es.trans, msgs, idx=es.t_order)

    @staticmethod
    def backward(ctx, dy):
        return dy.index_select(0, _idx(ctx.es, ctx.which)), None, None


# ---------------------------------------------------------- the public ops


def spmm(es: EdgeStructure, x, weighted: bool = True):
    """Y = A @ X: for each vertex u, the sum over its arcs (u, v) of
    w_uv * x_v. x: [V, D] -> [V, D]."""
    if x.device.type == "cpu":
        return spmm_ref(es, x, weighted)
    return _SpMM.apply(x, es, weighted, False)


def spmm_mean(es: EdgeStructure, x):
    """Degree-normalized aggregate (mean over out-neighbors; zero rows for
    isolates)."""
    if x.device.type == "cpu":
        return spmm_mean_ref(es, x)
    return _SpMM.apply(x, es, False, True)


def sddmm(es: EdgeStructure, x, y):
    """Sampled dense-dense matmul: per stored arc (u, v), s_e = <x_u, y_v>.
    x, y: [V, D] -> [E]."""
    if x.device.type == "cpu":
        return sddmm_ref(es, x, y)
    return _SDDMM.apply(x, y, es)


def sddmm_softmax(es: EdgeStructure, scores):
    """Row-wise (per source vertex) softmax over arc scores: the GAT-style
    attention normalization."""
    if scores.device.type == "cpu":
        return sddmm_softmax_ref(es, scores)
    return _RowSoftmax.apply(scores, es)


def gather_rows(es: EdgeStructure, x, which: str = "col"):
    """Features of each arc's endpoint ([E, D])."""
    _idx(es, which)
    if x.device.type == "cpu":
        return gather_rows_ref(es, x, which)
    return _GatherRows.apply(x, es, which)


def scatter_add_rows(es: EdgeStructure, msgs, which: str = "row"):
    """Per-arc messages [E, D] summed onto their source (which="row") or
    destination ("col") vertices ([V, D])."""
    _idx(es, which)
    if msgs.device.type == "cpu":
        return scatter_add_rows_ref(es, msgs, which)
    return _ScatterAddRows.apply(msgs, es, which)
