"""The shared-negative SGNS step in the shifted-window form: kernels and
plain version.

`sgns_conv_step(w_in, w_out, block, cwin, negs, lr, neg_weight, window)`
applies one block's step in place: the skip-gram pairs of block i32 [B, T]
(-1 padded) under the dynamic windows cwin i32 [B, T], the kB negatives
`negs` shared by the whole block, each row moved by lr times the mean of its
gradients, all computed from the tables as they were before the step (the
JAX package's stellar_rw_tpu/models/word2vec.py::_sgns_apply_shared_conv,
non-band and single replica, which it matches to rounding).

CUDA tensors make three calls a step: csrc/sgns_conv.cu's accumulate kernel
(the positive half for all 2w offsets at once, the counts, ein and the
negatives' rows; a block of threads a tile of a walk with its halo of rows,
a warp a position: launch_plan), sgns_shared_grads (the negative half,
csrc/sgns_shared.cu, with the accumulated acc_in as its vo and g_pos = 1,
so its d_vi is acc_in + d_neg) and csrc/sgns_conv.cu's scatter kernel (a
warp 128 columns of a unit of a token group: its rows' sum; a group split
over several units summed in unit order by the last of them; each group's
sum over its count added into the tables once; the negatives' rows). The
token groups come from group_blocks, once a run for the whole corpus (the
trainer) or once a call.
CPU tensors run sgns_conv_step_ref: _valid_from_cwin and
_sgns_apply_shared_conv, the trainer's own plain step. The kernels sum in
another order (sum-then-divide, atomics between a row's group and its
negatives), so they agree with the plain version to rounding.

With `buffer` given (a reduction buffer, ops/dp_apply.py) the step runs in
accumulate mode, one slot of the data-parallel trainer's merged update:
the accumulate kernel and sgns_shared_grads run unchanged, and in place of
the scatter-update csrc/sgns_conv.cu's scatter in accumulate mode adds each
position's d_in and acc_out rows and counts into the buffer (no token
groups: nothing is divided by a count here; a thread four columns of a
position and table, one 16-byte vector reduction; a position whose count
in a table is 0 adds nothing there), and each negative's weighted d_wn and
cnt_n, the negatives' counts merged with the context rows' as in the JAX
package's psum'd step (stellar_rw_tpu/models/word2vec.py:475-484). The
tables are not written. Its plain version is sgns_conv_accumulate_ref.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel, ptr, require_cuda, stream
from .dp_apply import buffer_ptrs, buffer_views
from . import sgns
from .sgns import sgns_shared_grads_ref
from .sgns_exact import APPLY_BLOCKS, TABLE_BUDGET, _offsets, _sms, \
    _valid_from_cwin, check_buffer

SGNS_CONV_ACCUMULATE = Kernel(
    "sgns_conv.cu", "srw_sgns_conv_accumulate_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_void_p])
# the scatter-update kernel of the same source (and the same library)
SGNS_CONV_SCATTER = Kernel(
    "sgns_conv.cu", "srw_sgns_conv_scatter_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# the scatter in accumulate mode, a kernel of its own: into the merged
# update's buffer (acc_in, acc_out, cnt_in, cnt_out), with no token groups
SGNS_CONV_SCATTER_ACCUMULATE = Kernel(
    "sgns_conv.cu", "srw_sgns_conv_scatter_accumulate_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 5)

THREADS = 256           # kThreads in the source
# kAccThreads in the source: the accumulate kernel's threads a block at a
# slice of at most CHUNK columns, twice as many at a wider one
ACC_THREADS = 128
CHUNK = 128
H100_SMS = 132          # launch_plan's default; the wrapper asks the device
TILES = (32, 16, 8)     # positions a block of the accumulate kernel, widest first
# dynamic shared memory a block of the accumulate kernel may take: two an
# SM, as sgns_exact.cu's step (the halo tables are the bulk)
SMEM_BUDGET = TABLE_BUDGET
# positions of a token group a warp of the scatter kernel sums; longer
# groups are split into units of HUB, summed in unit order and added once
HUB = 16
_PAD = torch.iinfo(torch.int32).max   # padding's sort key: last
_CONT = 1 << 31                       # a unit that continues its group
_GROUP_POSITIONS = 1 << 18             # positions group_blocks sorts at once


class LaunchPlan(NamedTuple):
    """How csrc/sgns_conv.cu's accumulate kernel cuts one block [B, T]."""

    tile: int          # positions a thread block
    tiles: int         # tiles a walk: the grid is (tiles, B)
    blocks: int        # tiles * B
    halo_rows: int     # rows of ein and of eout in shared memory: tile + 2w
    cols: int          # columns of a row slice held at once (a multiple of 32)
    slices: int        # slices a row takes
    smem_bytes: int    # dynamic shared memory a block
    threads: int       # threads a block: ACC_THREADS, twice that above CHUNK


def smem_bytes(tile: int, window: int, cols: int) -> int:
    """The accumulate kernel's shared memory: the halo's ein and eout
    slices (rows of cols floats), the two sides' dots (then g), and the
    halo's tokens and windows."""
    H = tile + 2 * window
    return 4 * (2 * H * cols + 2 * tile * 2 * window + 2 * H)


def launch_plan(B: int, T: int, D: int, window: int,
                sm_count: int = H100_SMS, tiles=TILES) -> LaunchPlan:
    """The accumulate kernel's plan for a block [B, T] at dim D and window w
    on a card of `sm_count` SMs (mirrors the dispatch of the .cu): the
    widest tile of `tiles` whose grid of B * ceil(T / tile) blocks gives
    every SM two (the narrowest when none does; never wider than T; at
    walk_10k's blocks tiles of 8 beat 16 and 32, PERF.md), the fewest row
    slices of a multiple of 32 columns that keep the block within
    SMEM_BUDGET, cut evenly, and ACC_THREADS threads a block at one chunk
    of CHUNK columns a slice, twice as many at more."""
    if B < 1 or T < 1 or D < 1 or window < 1 or sm_count < 1 \
            or B > 65535:
        raise ValueError(f"sgns_conv launch_plan: B={B} T={T} D={D} "
                         f"window={window} sm_count={sm_count}")
    tile = next((t for t in tiles if B * -(-T // t) >= 2 * sm_count),
                tiles[-1])
    tile = min(tile, T)
    fit = (SMEM_BUDGET - smem_bytes(tile, window, 0)) // (
        smem_bytes(tile, window, 32) - smem_bytes(tile, window, 0)) * 32
    if fit < 32:
        raise ValueError(f"sgns_conv launch_plan: window {window} leaves no "
                         f"room for a row slice in {SMEM_BUDGET} bytes")
    slices = -(-D // fit)
    cols = -(-D // slices)                  # the row cut evenly
    cols = -(-cols // 32) * 32
    n = -(-T // tile)
    return LaunchPlan(tile, n, n * B, tile + 2 * window, cols,
                      -(-D // cols), smem_bytes(tile, window, cols),
                      2 * ACC_THREADS if cols > CHUNK else ACC_THREADS)


class Groups(NamedTuple):
    """Each block's positions grouped by token (group_blocks): two int32 a
    corpus position."""

    order: torch.Tensor  # [n, B*T] positions sorted by token, stably; padding last
    units: torch.Tensor  # [n, B*T] units' first sorted index (| 1 << 31 where
    #                      a unit continues its group); unused: the valid count


def group_blocks(blocks: torch.Tensor, hub: int = HUB,
                 chunk: int | None = None) -> Groups:
    """The scatter kernel's view of blocks i32 [n, B, T] (-1 padded): each
    block's positions stably sorted by token (padding last), and the token
    groups cut into units of at most `hub` positions. Made once a run (the
    corpus blocks do not change between epochs), on the blocks' device,
    `chunk` blocks a sort; by default as many as hold _GROUP_POSITIONS
    positions, so the sort's temporaries (about 40 bytes a position) do
    not grow with the corpus. Issues no host synchronization."""
    n = blocks.shape[0]
    flat = blocks.reshape(n, -1)
    N = flat.shape[1]
    if chunk is None:
        chunk = max(1, _GROUP_POSITIONS // max(N, 1))
    order = torch.empty((n, N), dtype=torch.int32, device=blocks.device)
    units = torch.empty_like(order)
    j = torch.arange(N, dtype=torch.int32, device=blocks.device)
    # a unit's entry is its first position, less 2**31 where it continues
    # its group (int32: cols - _CONT wraps to cols + INT32_MIN)
    cont = j + torch.iinfo(torch.int32).min
    for c0 in range(0, n, chunk):
        x = flat[c0:c0 + chunk]
        m = x.shape[0]
        key, idx = torch.sort(torch.where(x < 0, _PAD, x), dim=1,
                              stable=True)
        order[c0:c0 + m] = idx
        del idx
        valid = key != _PAD
        # each position's offset in its token group, from the group's
        # first position in the sorted keys
        rel = j - torch.searchsorted(key, key, out_int32=True)
        del key
        first = valid & (rel % hub == 0)           # a unit starts here
        # unit u's entry in column u; the other positions write column N,
        # which is dropped; entries past the last unit keep the valid count
        uid = torch.where(first, torch.cumsum(first, 1) - 1, N)
        u = torch.empty((m, N + 1), dtype=torch.int32, device=x.device)
        u[:, :N] = valid.sum(1, keepdim=True, dtype=torch.int32)
        u.scatter_(1, uid, torch.where(rel > 0, cont, j))
        units[c0:c0 + m] = u[:, :N]
    return Groups(order, units)


def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """y[:, t] = x[:, t + d] along axis 1, zero beyond the bounds."""
    if d == 0:
        return x
    y = torch.zeros_like(x)
    if d > 0:
        y[:, :-d] = x[:, d:]
    else:
        y[:, -d:] = x[:, :d]
    return y


def _conv_grads(w_in, w_out, block, valid, negs, neg_weight: float,
                window: int):
    """The conv step's gradients from the tables as they are, in their
    dtype: (tok, negs, acc_in, acc_out [N, D] by position, cnt_in,
    cnt_out [V], d_wn [kB, D], the valid pairs times neg_weight, cnt_n)."""
    B, T = block.shape
    N = B * T
    D = w_in.shape[1]
    dt = w_in.dtype
    offs = _offsets(window)
    tok = block.reshape(-1).clamp_min(0).long()
    negs = negs.long()
    vf = valid.to(dt)                                   # [B, T, 2w]
    ein = w_in[tok].reshape(B, T, D)
    eout = w_out[tok].reshape(B, T, D)
    wn = w_out[negs]                                    # [kB, D]
    logits = torch.stack([(ein * _shift(eout, d)).sum(-1) for d in offs], -1)
    g_pos = (torch.sigmoid(logits) - 1.0) * vf          # [B, T, 2w]
    vcnt = vf.sum(-1)                                   # [B, T]
    # negative half: sgns_shared_grads with vi = ein, g_pos = 0 and
    # mask = neg_weight * vcnt (every valid pair of a center shares
    # sigmoid(ein . wn)); d_vo is g_pos * ein = 0 and unused
    e2 = ein.reshape(N, D)
    d_neg, _, d_wn = sgns_shared_grads_ref(
        e2, e2, wn, torch.zeros(N, dtype=dt, device=e2.device),
        (neg_weight * vcnt).reshape(N))
    acc_in = sum(g_pos[..., i, None] * _shift(eout, d)
                 for i, d in enumerate(offs)) + d_neg.reshape(B, T, D)
    acc_out = sum(_shift(g_pos[..., i, None] * ein, -d)
                  for i, d in enumerate(offs))
    cnt_out_pos = sum(_shift(vf[..., i], -d) for i, d in enumerate(offs))
    cnt_in = torch.zeros(w_in.shape[0], dtype=dt, device=e2.device
                         ).index_add_(0, tok, vcnt.reshape(N))
    cnt_out = torch.zeros(w_out.shape[0], dtype=dt, device=e2.device
                          ).index_add_(0, tok, cnt_out_pos.reshape(N))
    vsum = vf.sum() * neg_weight
    cnt_n = vsum.clamp_min(1.0)
    return (tok, negs, acc_in.reshape(N, D), acc_out.reshape(N, D), cnt_in,
            cnt_out, d_wn, vsum, cnt_n)


def _sgns_apply_shared_conv(w_in, w_out, block, valid, negs, lr: float,
                            neg_weight: float, window: int):
    """Shared-negative SGNS step in the dense shifted-window form (single
    replica, band=False), in place, in the tables' dtype. block i32 [B, T],
    valid bool [B, T, 2w], negs [kB]."""
    tok, negs, acc_in, acc_out, cnt_in, cnt_out, d_wn, _, cnt_n = \
        _conv_grads(w_in, w_out, block, valid, negs, neg_weight, window)
    w_in.index_add_(0, tok, -lr * acc_in
                    / cnt_in.clamp_min(1.0)[tok][:, None])
    w_out.index_add_(0, tok, -lr * acc_out
                     / cnt_out.clamp_min(1.0)[tok][:, None])
    w_out.index_add_(0, negs, -lr * d_wn / cnt_n)
    return w_in, w_out


def _sgns_accumulate_shared_conv(w_in, w_out, block, valid, negs,
                                 neg_weight: float, window: int, buffer):
    """The data-parallel form of the conv step before its psum: each
    position's sums and counts added into the reduction buffer (in its
    dtype), the negatives' rows into acc_out weighted by valid pairs *
    neg_weight / cnt_n and their count cnt_n into cnt_out, beside the
    context rows'. The tables are untouched."""
    a_in, a_out, b_in, b_out = buffer_views(buffer, *w_in.shape)
    tok, negs, acc_in, acc_out, cnt_in, cnt_out, d_wn, vsum, cnt_n = \
        _conv_grads(w_in, w_out, block, valid, negs, neg_weight, window)
    dt = buffer.dtype
    a_in.index_add_(0, tok, acc_in.to(dt))
    a_out.index_add_(0, tok, acc_out.to(dt))
    a_out.index_add_(0, negs, (d_wn * (vsum / cnt_n)).to(dt))
    b_in += cnt_in.to(dt)
    b_out += cnt_out.to(dt)
    b_out.index_add_(0, negs, cnt_n.to(dt).expand(negs.shape[0]))
    return buffer


def sgns_conv_step_ref(w_in, w_out, block, cwin, negs, lr: float,
                       neg_weight: float, window: int):
    """Plain torch version: the block's pair mask and
    _sgns_apply_shared_conv, in place."""
    valid, _ = _valid_from_cwin(block, cwin, window)
    return _sgns_apply_shared_conv(w_in, w_out, block, valid, negs, lr,
                                   neg_weight, window)


def sgns_conv_accumulate_ref(w_in, w_out, block, cwin, negs,
                             neg_weight: float, window: int, buffer):
    """Plain torch version of the accumulate mode: the block's pair mask
    and _sgns_accumulate_shared_conv."""
    valid, _ = _valid_from_cwin(block, cwin, window)
    return _sgns_accumulate_shared_conv(w_in, w_out, block, valid, negs,
                                        neg_weight, window, buffer)


class ConvWorkspace:
    """The conv step's scratch for tables w_in, w_out and blocks [B, T]
    with kB negatives: the accumulate kernel's outputs (ein, acc_in,
    acc_out [B*T, D], the negative half's mask and ones, the two counts,
    each block's valid pairs, wn [kB, D]), sgns_shared_grads' outputs (d_in
    = its d_vi [B*T, D], d_wn [kB, D]; its d_vo, which the step never
    reads, is not written), partials' and g's scratch and plan, so
    that its call allocates nothing and asks the device nothing, and the
    scatter kernel's unit sums and counters of split groups. One serves
    every step of an epoch. `tiles` are the accumulate kernel's candidate
    tiles (launch_plan)."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor, B: int,
                 T: int, window: int, kB: int, tiles=TILES):
        dev, D = w_in.device, w_in.shape[1]
        N = B * T
        self.key = (tuple(w_in.shape), tuple(w_out.shape), B, T, window, kB)
        self.plan = launch_plan(B, T, D, window, _sms(dev), tiles)
        f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        self.ein, self.acc_in, self.acc_out = f(N, D), f(N, D), f(N, D)
        self.mask = f(N)
        self.ones = torch.ones(N, dtype=torch.float32, device=dev)
        self.cnt = torch.empty((2, N), dtype=torch.int32, device=dev)
        self.valid = torch.empty(self.plan.blocks, dtype=torch.int32,
                                 device=dev)
        self.wn = f(kB, D)
        self.shared_plan = sgns.launch_plan(N, D, kB, _sms(dev))
        self.d_in, self.d_wn = f(N, D), f(kB, D)
        self.part = f(self.shared_plan.part_floats)
        self.g = (f(self.shared_plan.g_floats) if self.shared_plan.g_floats
                  else None)
        # a unit's sum a (table, unit) in 128-column chunks, its count; a
        # counter a (table, group's first unit, chunk), left at zero by each
        # step
        chunks = -(-D // 128)
        self.unit_sums = f(2, N, chunks * 128)
        self.unit_counts = torch.empty((2, N), dtype=torch.int32,
                                       device=dev)
        self.arrive = torch.zeros((2, N, chunks), dtype=torch.int32,
                                  device=dev)
        self._outs = (ctypes.c_void_p * 7)(*(
            t.data_ptr() for t in (self.ein, self.acc_in, self.acc_out,
                                   self.mask, self.cnt, self.valid,
                                   self.wn)))

    def serves(self, w_in, w_out, B: int, T: int, window: int,
               kB: int) -> bool:
        return self.key == (tuple(w_in.shape), tuple(w_out.shape), B, T,
                            window, kB)


def sgns_conv_step(w_in, w_out, block, cwin, negs, lr: float,
                   neg_weight: float, window: int,
                   ws: ConvWorkspace | None = None,
                   groups: tuple[torch.Tensor, torch.Tensor] | None = None,
                   buffer=None):
    """One conv step in place (see the module). CUDA tensors launch the
    kernels with the scratch `ws` (a new ConvWorkspace if none is given)
    and the block's grouping `groups` = (order, units), rows of
    group_blocks (made here if none is given); CPU tensors run
    sgns_conv_step_ref. Any D. With `buffer` (the reduction buffer of
    ops/dp_apply.py) the step runs in accumulate mode: the tables stay, lr
    and `groups` are not read."""
    if w_in.device.type == "cpu":
        if buffer is not None:
            return sgns_conv_accumulate_ref(w_in, w_out, block, cwin, negs,
                                            neg_weight, window, buffer)
        return sgns_conv_step_ref(w_in, w_out, block, cwin, negs, lr,
                                  neg_weight, window)
    B, T = block.shape
    kB = negs.shape[0]
    if (w_out.shape[1] != w_in.shape[1] or cwin.shape != (B, T)
            or negs.dim() != 1 or kB < 1):
        raise ValueError(f"sgns_conv_step: shapes w_in {tuple(w_in.shape)} "
                         f"w_out {tuple(w_out.shape)} block {(B, T)} cwin "
                         f"{tuple(cwin.shape)} negs {tuple(negs.shape)}")
    if w_in.dtype != torch.float32 or w_out.dtype != torch.float32:
        raise ValueError("sgns_conv_step: tables must be float32")
    for name, t in (("block", block), ("cwin", cwin), ("negs", negs)):
        if t.dtype != torch.int32:
            raise ValueError(f"sgns_conv_step: {name} must be int32, got "
                             f"{t.dtype}")
    if buffer is None:
        if groups is None:
            g = group_blocks(block[None])
            groups = (g.order[0], g.units[0])
        order, units = groups
        if order.shape != (B * T,) or units.shape != (B * T,):
            raise ValueError(f"sgns_conv_step: groups of "
                             f"{tuple(order.shape)} and "
                             f"{tuple(units.shape)} for a block {(B, T)}")
        require_cuda("sgns_conv_step", w_in, w_out, block, cwin, negs,
                     order, units)
    else:
        require_cuda("sgns_conv_step", w_in, w_out, block, cwin, negs)
        check_buffer("sgns_conv_step", w_in, w_out, buffer)
    if ws is None:
        ws = ConvWorkspace(w_in, w_out, B, T, window, kB)
    elif not ws.serves(w_in, w_out, B, T, window, kB):
        raise ValueError(f"sgns_conv_step: workspace for {ws.key}")
    launch_accumulate(ws, w_in, w_out, block, cwin, negs, window, neg_weight)
    launch_negative_half(ws)
    if buffer is None:
        launch_scatter(ws, w_in, w_out, block, order, units, negs,
                       neg_weight, lr)
    else:
        launch_scatter_accumulate(ws, block, negs, neg_weight, buffer)
    return w_in, w_out


def launch_accumulate(ws: ConvWorkspace, w_in, w_out, block, cwin, negs,
                      window: int, neg_weight: float) -> None:
    """The accumulate kernel on checked tensors, into ws."""
    B, T = block.shape
    p = ws.plan
    SGNS_CONV_ACCUMULATE.launch(
        ptr(w_in), ptr(w_out), ptr(block), ptr(cwin), ptr(negs),
        negs.shape[0], ws._outs, B, T, w_in.shape[1], window, p.tile,
        p.tiles, p.cols, p.smem_bytes, float(neg_weight),
        stream(w_in.device))


def launch_negative_half(ws: ConvWorkspace) -> None:
    """sgns_shared_grads on ws's accumulations, into ws: d_in = acc_in +
    d_neg and d_wn."""
    sgns.launch_shared(ws.shared_plan, ws.ein, ws.acc_in, ws.wn, ws.ones,
                       ws.mask, ws.d_in, None, ws.d_wn, ws.part, ws.g)


def launch_scatter(ws: ConvWorkspace, w_in, w_out, block, order, units,
                   negs, neg_weight: float, lr: float) -> None:
    """The scatter-update kernel: each token group's d_in (acc_in + d_neg)
    and acc_out summed over its count and added into w_in and w_out, the
    negatives' rows of w_out updated."""
    N, D = ws.d_in.shape
    kB = negs.shape[0]
    items = 2 * N * -(-D // 128) + kB   # a warp 128 columns of a unit, table
    blocks = max(1, min(APPLY_BLOCKS, -(-items // (THREADS // 32))))
    SGNS_CONV_SCATTER.launch(
        ptr(block), ptr(order), ptr(units), ptr(ws.d_in), ptr(ws.acc_out),
        ptr(ws.cnt), ptr(ws.d_wn), ptr(negs), kB, ptr(ws.valid),
        ws.valid.numel(), float(neg_weight), float(lr), ptr(w_in),
        ptr(w_out), ptr(ws.unit_sums), ptr(ws.unit_counts), ptr(ws.arrive),
        N, D, blocks, stream(w_out.device))


def launch_scatter_accumulate(ws: ConvWorkspace, block, negs,
                              neg_weight: float, buffer) -> None:
    """The scatter in accumulate mode on a checked `buffer`: each
    position's d_in (acc_in + d_neg) and acc_out rows and counts into the
    buffer's acc_in, acc_out, cnt_in and cnt_out rows of its token, the
    negatives' weighted d_wn and cnt_n into acc_out and cnt_out; a thread
    four columns of a (position, table)."""
    N, D = ws.d_in.shape
    kB = negs.shape[0]
    g = -(-D // 4)                      # a thread four columns
    items = kB * g + N * 2 * g
    blocks = max(1, min(APPLY_BLOCKS, -(-items // THREADS)))
    V = ws.key[0][0]                    # the tables' rows
    SGNS_CONV_SCATTER_ACCUMULATE.launch(
        ptr(block), ptr(ws.d_in), ptr(ws.acc_out), ptr(ws.cnt),
        ptr(ws.d_wn), ptr(negs), kB, ptr(ws.valid), ws.valid.numel(),
        float(neg_weight), N, D, blocks, *buffer_ptrs(buffer, V, D),
        stream(block.device))
