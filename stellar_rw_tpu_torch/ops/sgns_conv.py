"""The shared-negative SGNS step in the shifted-window form: kernels and
plain version.

`sgns_conv_step(w_in, w_out, block, cwin, negs, lr, neg_weight, window)`
applies one block's step in place: the skip-gram pairs of block i32 [B, T]
(-1 padded) under the dynamic windows cwin i32 [B, T], the kB negatives
`negs` shared by the whole block, each row moved by lr times the mean of its
gradients, all computed from the tables as they were before the step (the
JAX package's stellar_rw_tpu/models/word2vec.py::_sgns_apply_shared_conv,
non-band and single replica, which it matches to rounding).

CUDA tensors launch, per step: csrc/sgns_conv.cu's accumulate kernel (the
positive half for all 2w offsets at once, the counts, ein and the negatives'
rows), sgns_shared_grads (the negative half, csrc/sgns_shared.cu, with the
accumulated acc_in as its vo and g_pos = 1, so its d_vi is acc_in + d_neg),
csrc/sgns_conv.cu's scatter kernel (every position's rows into compact delta
slots; the negatives' rows updated) and csrc/sgns_exact.cu's apply kernel
(the touched rows updated, the slots emptied). CPU tensors run
sgns_conv_step_ref: _valid_from_cwin and _sgns_apply_shared_conv, the
trainer's own plain step. The kernels sum in another order (atomics,
sum-then-divide), so they agree with the plain version to rounding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel, ptr, require_cuda, stream
from .sgns import sgns_shared_grads, sgns_shared_grads_ref
from .sgns_exact import (APPLY_BLOCKS, TABLE_BUDGET, Workspace, _offsets,
                         _sms, _valid_from_cwin, launch_apply)

SGNS_CONV_ACCUMULATE = Kernel(
    "sgns_conv.cu", "srw_sgns_conv_accumulate_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_void_p])
# the scatter kernel of the same source (and the same library)
SGNS_CONV_SCATTER = Kernel(
    "sgns_conv.cu", "srw_sgns_conv_scatter_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 3 + [ctypes.c_void_p])

THREADS = 256           # kThreads in the source
H100_SMS = 132          # launch_plan's default; the wrapper asks the device
TILES = (32, 16, 8)     # positions a block of the accumulate kernel, widest first
# dynamic shared memory a block of the accumulate kernel may take: two an
# SM, as sgns_exact.cu's kernel (a) (the halo tables are the bulk)
SMEM_BUDGET = TABLE_BUDGET


class LaunchPlan(NamedTuple):
    """How csrc/sgns_conv.cu's accumulate kernel cuts one block [B, T]."""

    tile: int          # positions a thread block
    tiles: int         # tiles a walk: the grid is (tiles, B)
    blocks: int        # tiles * B
    halo_rows: int     # rows of ein and of eout in shared memory: tile + 2w
    cols: int          # columns of a row slice held at once (a multiple of 32)
    slices: int        # slices a row takes
    smem_bytes: int    # dynamic shared memory a block


def smem_bytes(tile: int, window: int, cols: int) -> int:
    """The accumulate kernel's shared memory: the halo's ein and eout
    slices (rows of cols + 1 floats), the two sides' dots (g), the halo's
    tokens and windows and the tile's two pair counts."""
    H = tile + 2 * window
    return 4 * (2 * H * (cols + 1) + 2 * tile * 2 * window + 2 * H
                + 2 * tile)


def launch_plan(B: int, T: int, D: int, window: int,
                sm_count: int = H100_SMS, tiles=TILES) -> LaunchPlan:
    """The accumulate kernel's plan for a block [B, T] at dim D and window w
    on a card of `sm_count` SMs (mirrors the dispatch of the .cu): the
    widest tile of `tiles` whose grid of B * ceil(T / tile) blocks gives
    every SM two (the narrowest when none does; never wider than T; at
    walk_10k's blocks tiles of 8 beat 16 and 32, PERF.md), and the widest
    row slice, a multiple of 32 columns, that keeps the block within
    SMEM_BUDGET."""
    if B < 1 or T < 1 or D < 1 or window < 1 or sm_count < 1:
        raise ValueError(f"sgns_conv launch_plan: B={B} T={T} D={D} "
                         f"window={window} sm_count={sm_count}")
    tile = next((t for t in tiles if B * -(-T // t) >= 2 * sm_count),
                tiles[-1])
    tile = min(tile, T)
    fit = (SMEM_BUDGET - smem_bytes(tile, window, 0)) // (
        smem_bytes(tile, window, 32) - smem_bytes(tile, window, 0)) * 32
    cols = min(-(-D // 32) * 32, fit)
    if cols < 32:
        raise ValueError(f"sgns_conv launch_plan: window {window} leaves no "
                         f"room for a row slice in {SMEM_BUDGET} bytes")
    n = -(-T // tile)
    return LaunchPlan(tile, n, n * B, tile + 2 * window, cols,
                      -(-D // cols), smem_bytes(tile, window, cols))


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


def _sgns_apply_shared_conv(w_in, w_out, block, valid, negs, lr: float,
                            neg_weight: float, window: int):
    """Shared-negative SGNS step in the dense shifted-window form (single
    replica, band=False), in place, in the tables' dtype. block i32 [B, T],
    valid bool [B, T, 2w], negs [kB]."""
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
    cnt_n = (vf.sum() * neg_weight).clamp_min(1.0)
    w_in.index_add_(0, tok, -lr * acc_in.reshape(N, D)
                    / cnt_in.clamp_min(1.0)[tok][:, None])
    w_out.index_add_(0, tok, -lr * acc_out.reshape(N, D)
                     / cnt_out.clamp_min(1.0)[tok][:, None])
    w_out.index_add_(0, negs, -lr * d_wn / cnt_n)
    return w_in, w_out


def sgns_conv_step_ref(w_in, w_out, block, cwin, negs, lr: float,
                       neg_weight: float, window: int):
    """Plain torch version: the block's pair mask and
    _sgns_apply_shared_conv, in place."""
    valid, _ = _valid_from_cwin(block, cwin, window)
    return _sgns_apply_shared_conv(w_in, w_out, block, valid, negs, lr,
                                   neg_weight, window)


class ConvWorkspace:
    """The conv step's scratch for tables w_in, w_out and blocks [B, T]
    with kB negatives: the accumulate kernel's outputs (ein, acc_in,
    acc_out [B*T, D], the negative half's mask and ones, the two counts,
    each block's valid pairs, wn [kB, D]) and the delta slots (a Workspace
    whose w_out rows are bounded by the positions: a position touches its
    own token's rows alone). One serves every step of an epoch. `tiles`
    are the accumulate kernel's candidate tiles (launch_plan)."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor, B: int,
                 T: int, window: int, kB: int, tiles=TILES):
        dev, D = w_in.device, w_in.shape[1]
        N = B * T
        self.key = (tuple(w_in.shape), tuple(w_out.shape), B, T, window, kB)
        self.plan = launch_plan(B, T, D, window, _sms(dev), tiles)
        self.slots = Workspace(w_in, w_out, N, targets=1)
        f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        self.ein, self.acc_in, self.acc_out = f(N, D), f(N, D), f(N, D)
        self.mask = f(N)
        self.ones = torch.ones(N, dtype=torch.float32, device=dev)
        self.cnt = torch.empty((2, N), dtype=torch.int32, device=dev)
        self.valid = torch.empty(self.plan.blocks, dtype=torch.int32,
                                 device=dev)
        self.wn = f(kB, D)
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
                   ws: ConvWorkspace | None = None):
    """One conv step in place (see the module). CUDA tensors launch the
    kernels with the scratch `ws` (a new ConvWorkspace if none is given);
    CPU tensors run sgns_conv_step_ref. Any D."""
    if w_in.device.type == "cpu":
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
    require_cuda("sgns_conv_step", w_in, w_out, block, cwin, negs)
    if ws is None:
        ws = ConvWorkspace(w_in, w_out, B, T, window, kB)
    elif not ws.serves(w_in, w_out, B, T, window, kB):
        raise ValueError(f"sgns_conv_step: workspace for {ws.key}")
    launch_accumulate(ws, w_in, w_out, block, cwin, negs, window, neg_weight)
    d_in, _, d_wn = sgns_shared_grads(ws.ein, ws.acc_in, ws.wn, ws.ones,
                                      ws.mask)
    launch_scatter(ws, w_out, block, d_in, d_wn, negs, neg_weight, lr)
    launch_apply(ws.slots, w_in, w_out, lr)
    return w_in, w_out


def launch_accumulate(ws: ConvWorkspace, w_in, w_out, block, cwin, negs,
                      window: int, neg_weight: float) -> None:
    """The accumulate kernel on checked tensors, into ws."""
    B, T = block.shape
    p = ws.plan
    SGNS_CONV_ACCUMULATE.launch(
        ptr(w_in), ptr(w_out), ptr(block), ptr(cwin), ptr(negs),
        negs.shape[0], ws._outs, ptr(ws.slots.counts), B, T, w_in.shape[1],
        window, p.tile, p.tiles, p.cols, p.smem_bytes, float(neg_weight),
        stream(w_in.device))


def launch_scatter(ws: ConvWorkspace, w_out, block, d_in, d_wn, negs,
                   neg_weight: float, lr: float) -> None:
    """The scatter kernel: each position's acc_in + d_neg (d_in) and acc_out
    into ws's delta slots, the negatives' rows of w_out updated."""
    N, D = d_in.shape
    kB = negs.shape[0]
    blocks = max(1, min(APPLY_BLOCKS, -(-(N + kB) // (THREADS // 32))))
    SGNS_CONV_SCATTER.launch(
        ptr(block), ptr(d_in), ptr(ws.acc_out), ptr(ws.cnt), ptr(d_wn),
        ptr(negs), kB, ptr(ws.valid), ws.valid.numel(), float(neg_weight),
        float(lr), ptr(w_out), ws.slots._ptrs, N, D, blocks,
        stream(w_out.device))
