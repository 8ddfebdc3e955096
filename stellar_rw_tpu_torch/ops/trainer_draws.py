"""The skip-gram trainer's per-block draws: kernel wrapper and plain version.

`trainer_draws(key, c0, n, B, T, window, neg_shape, neg_keep, neg_alias)`
makes the random draws of blocks c0 .. c0 + n - 1 of an epoch whose key is
`key`: for block i, kb = fold_in(key, i), its dynamic windows
cwin = randint(kb, (B, T), 1, window + 1) and its negatives
_draw_negatives(fold_in(kb, 2), neg_shape, keep, alias), the streams of the
JAX package's epoch scan (stellar_rw_tpu/models/word2vec.py:116, 146-151)
bit for bit. Returns (cwin i32 [n, B, T], negs i32 [n, *neg_shape]).

CUDA tensors launch csrc/trainer_draws.cu, one launch for the n blocks;
CPU tensors run trainer_draws_ref, the same streams in int64 torch
threefry (ops/prng.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import prng
from ._build import Kernel, ptr, require_cuda, stream

TRAINER_DRAWS_KERNEL = Kernel(
    "trainer_draws.cu", "srw_trainer_draws_launch",
    [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] + [ctypes.c_void_p] * 3)

THREADS = 256        # kThreads in the source
PER_THREAD = 8       # elements a thread draws (kPerThread)


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
    negs = _draw_negatives(prng.fold_in(kb, 2), tuple(neg_shape), neg_keep,
                           neg_alias)
    return cwin, negs.to(torch.int32)


def trainer_draws(key, c0: int, n: int, B: int, T: int, window: int,
                  neg_shape, neg_keep, neg_alias):
    """Draws of blocks c0 .. c0 + n - 1 (see the module). key: int64 [2]
    (uint32 words); neg_keep f32 [V]; neg_alias int [V] (int32 on the
    card)."""
    if key.device.type == "cpu":
        return trainer_draws_ref(key, c0, n, B, T, window, neg_shape,
                                 neg_keep, neg_alias)
    TRAINER_DRAWS_KERNEL.fn()
    neg_shape = tuple(neg_shape)
    V = neg_keep.shape[0]
    if (key.shape != (2,) or key.dtype != torch.int64 or window < 1 or n < 0
            or V < 1 or neg_alias.shape != (V,)):
        raise ValueError(f"trainer_draws: key {tuple(key.shape)} "
                         f"{key.dtype}, window {window}, n {n}, keep "
                         f"{tuple(neg_keep.shape)}, alias "
                         f"{tuple(neg_alias.shape)}")
    if neg_keep.dtype != torch.float32 or neg_alias.dtype != torch.int32:
        raise ValueError("trainer_draws: keep must be float32 and alias "
                         "int32")
    require_cuda("trainer_draws", key, neg_keep, neg_alias)
    M = math.prod(neg_shape)
    cwin = torch.empty((n, B, T), dtype=torch.int32, device=key.device)
    negs = torch.empty((n,) + neg_shape, dtype=torch.int32,
                       device=key.device)
    TRAINER_DRAWS_KERNEL.launch(ptr(key), c0, n, B * T, M, window,
                                ptr(neg_keep), ptr(neg_alias), V, ptr(cwin),
                                ptr(negs), stream(key.device))
    return cwin, negs
