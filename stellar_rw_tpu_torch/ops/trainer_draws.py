"""The skip-gram trainer's per-block draws: kernel wrapper and plain version.

`trainer_draws(key, c0, n, B, T, window, neg_shape, neg_keep, neg_alias)`
makes the random draws of blocks c0 .. c0 + n - 1 of an epoch whose key is
`key`: for block i, kb = fold_in(key, i), its dynamic windows
cwin = randint(kb, (B, T), 1, window + 1) and its negatives
_draw_negatives(fold_in(kb, 2), neg_shape, keep, alias), the streams of the
JAX package's epoch scan (stellar_rw_tpu/models/word2vec.py:116, 146-151)
bit for bit. Returns (cwin i32 [n, B, T], negs i32 [n, *neg_shape]).
A negative shape of no elements (the hierarchical-softmax trainer's (0,))
draws the windows alone and takes no alias table (neg_keep and neg_alias
may be None).

CUDA tensors launch csrc/trainer_draws.cu, one launch for the n blocks
under launch_plan, with the window's reciprocal from span_magic; CPU
tensors run trainer_draws_ref, the same streams in int64 torch threefry
(ops/prng.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import prng
from ._build import Kernel, ptr, require_cuda, stream

TRAINER_DRAWS_KERNEL = Kernel(
    "trainer_draws.cu", "srw_trainer_draws_launch",
    [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_uint]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_void_p] * 3)

THREADS = 256        # kThreads in the source
PER_THREAD = 8       # most elements a thread draws (kPerThread)


def span_magic(span: int) -> tuple[int, int, int]:
    """(magic, sh1, sh2) with which csrc/trainer_draws.cu's mod_span takes
    v mod span for every uint32 v (Granlund and Montgomery's division by an
    invariant integer): t = umulhi(magic, v), q = (t + ((v - t) >> sh1)) >>
    sh2, v - q * span. span in [1, 2^32)."""
    if not 1 <= span < 1 << 32:
        raise ValueError(f"span_magic: span {span}")
    lg = (span - 1).bit_length()                  # ceil(log2(span))
    magic = ((1 << 32) * ((1 << lg) - span)) // span + 1
    return magic, min(lg, 1), max(lg - 1, 0)


class DrawPlan(NamedTuple):
    """How csrc/trainer_draws.cu cuts a chunk of n blocks of BT + M
    elements."""

    runs: int      # thread blocks a block's elements take, one run each
    per: int       # strides of THREADS elements a run (<= PER_THREAD)


def launch_plan(n: int, BT: int, M: int) -> DrawPlan:
    """Runs of the same number of strides (the fewest runs of at most
    PER_THREAD strides of THREADS elements that cover BT + M), one thread
    block a run: n * runs thread blocks in one grid dimension."""
    total = BT + M
    if n < 0 or BT < 0 or M < 0:
        raise ValueError(f"trainer_draws launch_plan: n={n} BT={BT} M={M}")
    runs = max(1, -(-total // (THREADS * PER_THREAD)))
    per = max(1, -(-total // (runs * THREADS)))
    runs = max(1, -(-total // (per * THREADS)))
    if n * runs >= 1 << 31:
        raise ValueError(f"trainer_draws: {n * runs} thread blocks in one "
                         "launch")
    return DrawPlan(runs, per)


def _draw_negatives(key: torch.Tensor, shape, neg_keep: torch.Tensor,
                    neg_alias: torch.Tensor) -> torch.Tensor:
    """Unigram^power negatives by alias table; key may carry batch dims."""
    n = neg_keep.shape[0]
    u1 = prng.uniform(key, shape)
    u2 = prng.uniform(prng.fold_in(key, 1), shape)
    j = torch.clamp_max((u1 * n).to(torch.int32), n - 1).long()
    return torch.where(u2 < neg_keep[j], j, neg_alias[j].long())


def trainer_draws_ref(key, c0: int, n: int, B: int, T: int, window: int,
                      neg_shape, neg_keep, neg_alias):
    """Plain version: the blocks' keys, randint and _draw_negatives in int64
    torch threefry."""
    ids = torch.arange(c0, c0 + n, device=key.device)
    kb = prng.fold_in(key, ids)                               # [n, 2]
    cwin = prng.randint(kb, (B, T), 1, window + 1)            # [n, B, T]
    if math.prod(neg_shape) == 0:
        return cwin, torch.empty((n,) + tuple(neg_shape), dtype=torch.int32,
                                 device=key.device)
    negs = _draw_negatives(prng.fold_in(kb, 2), tuple(neg_shape), neg_keep,
                           neg_alias)
    return cwin, negs.to(torch.int32)


def trainer_draws(key, c0: int, n: int, B: int, T: int, window: int,
                  neg_shape, neg_keep, neg_alias, out=None):
    """Draws of blocks c0 .. c0 + n - 1 (see the module). key: int64 [2]
    (uint32 words); neg_keep f32 [V]; neg_alias int [V] (int32 on the
    card); both unused, and may be None, when neg_shape has no element.
    out: (cwin, negs), int32 tensors of those shapes on key's device, each
    contiguous (a slot's part of the trainer's [S, n, ...] draws), written
    in place of new ones and returned."""
    if key.device.type == "cpu":
        got = trainer_draws_ref(key, c0, n, B, T, window, neg_shape,
                                neg_keep, neg_alias)
        if out is None:
            return got
        for into, drawn in zip(out, got):
            into.copy_(drawn)
        return tuple(out)
    TRAINER_DRAWS_KERNEL.fn()
    neg_shape = tuple(neg_shape)
    M = math.prod(neg_shape)
    if M == 0:    # no negatives: the kernel reads no table
        neg_keep = torch.empty(0, dtype=torch.float32, device=key.device)
        neg_alias = torch.empty(0, dtype=torch.int32, device=key.device)
    V = neg_keep.shape[0]
    if (key.shape != (2,) or key.dtype != torch.int64 or window < 1 or n < 0
            or (M and V < 1) or neg_alias.shape != (V,)):
        raise ValueError(f"trainer_draws: key {tuple(key.shape)} "
                         f"{key.dtype}, window {window}, n {n}, keep "
                         f"{tuple(neg_keep.shape)}, alias "
                         f"{tuple(neg_alias.shape)}")
    if neg_keep.dtype != torch.float32 or neg_alias.dtype != torch.int32:
        raise ValueError("trainer_draws: keep must be float32 and alias "
                         "int32")
    require_cuda("trainer_draws", key, neg_keep, neg_alias)
    if out is None:
        cwin = torch.empty((n, B, T), dtype=torch.int32, device=key.device)
        negs = torch.empty((n,) + neg_shape, dtype=torch.int32,
                           device=key.device)
    else:
        cwin, negs = out
        if (cwin.shape != (n, B, T) or negs.shape != (n,) + neg_shape
                or cwin.dtype != torch.int32 or negs.dtype != torch.int32):
            raise ValueError(f"trainer_draws: out of {tuple(cwin.shape)} "
                             f"{cwin.dtype}, {tuple(negs.shape)} "
                             f"{negs.dtype} for {n} blocks")
        require_cuda("trainer_draws", key, cwin, negs)
    plan = launch_plan(n, B * T, M)
    TRAINER_DRAWS_KERNEL.launch(ptr(key), c0, n, B * T, M, window,
                                *span_magic(window), plan.runs, plan.per,
                                ptr(neg_keep), ptr(neg_alias), V,
                                ptr(cwin), ptr(negs), stream(key.device))
    return cwin, negs

