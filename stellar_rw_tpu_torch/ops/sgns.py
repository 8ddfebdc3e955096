"""Shared-negative SGNS gradients: kernel wrapper and plain version.

Port of the Pallas kernel stellar_rw_tpu/ops/pallas/sgns.py::
sgns_shared_grads, with the same arguments and returns. CUDA tensors launch
csrc/sgns_shared.cu; CPU tensors run sgns_shared_grads_ref. The trainer's
conv step (models/word2vec.py) routes its negative half through it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._build import Kernel, ptr, require_cuda, stream

SGNS_KERNEL = Kernel(
    "sgns_shared.cu", "srw_sgns_shared_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

TILE_ROWS = 32       # rows of P per block tile (TM in csrc/sgns_shared.cu)
H100_SMS = 132       # launch_plan's default; the wrapper asks the device
SMEM_LIMIT = 232_448  # dynamic shared memory one block can have on sm_90
# (padded D, negatives a chunk) of the tile kernel's instantiations: DP * KC
# is the d_wn partial a block keeps in registers, at most 64 floats a
# thread; the tiles hold each value's two TF32 parts (8 bytes an element)
WIDTHS = ((64, 128), (128, 128), (256, 64))
# D above SPLIT_D runs the split form (any D): sgns_logits, a block a tile
# of LOGIT_ROWS rows and LOGIT_KC negatives, writes g; then sgns_grads,
# GRAD_BLOCKS_PER_SM blocks an SM, a block a column slice of SPLIT_SW and a
# row group of tiles of GRAD_ROWS rows, GRAD_KB negatives a pass, writes
# d_vi, d_vo and the group's d_wn partial. These mirror the constexprs of
# csrc/sgns_shared.cu (SPLIT_D, LTM, LKC, GTM, GSW, GKB, GMINB), which sizes
# its rings and shared memory itself.
SPLIT_D = 256
LOGIT_ROWS, LOGIT_KC = 32, 32
GRAD_ROWS, SPLIT_SW, GRAD_KB, GRAD_BLOCKS_PER_SM = 32, 64, 128, 2


class LaunchPlan(NamedTuple):
    """How the tile kernel of csrc/sgns_shared.cu cuts one call (D up to
    SPLIT_D)."""

    dp: int            # D padded to the instantiation's width
    kc: int            # negatives held in shared memory at a time
    chunks: int        # passes over the tiles, one a chunk of kc negatives
    tiles: int         # tiles of TILE_ROWS rows
    blocks: int        # persistent blocks, a d_wn partial each
    smem_bytes: int    # dynamic shared memory a block
    wn_placement: str  # "whole" (one chunk) or "chunks"
    part_floats: int   # floats of the partials' scratch
    g_floats: int = 0  # the tile kernel keeps g in shared memory

    @property
    def partials(self) -> int:
        """d_wn partials that reduce_partials sums (the C entry's nblk)."""
        return self.blocks


class SplitPlan(NamedTuple):
    """How the split form of csrc/sgns_shared.cu cuts one call (D above
    SPLIT_D): sgns_grads' grid is slices x groups."""

    tiles: int         # tiles of GRAD_ROWS rows
    slices: int        # column slices of SPLIT_SW
    groups: int        # row groups of equal tiles, a d_wn partial each
    part_floats: int   # floats of the partials' scratch
    g_floats: int      # floats of g's scratch: LOGIT_ROWS-row tiles of kB
    #                    rounded up to LOGIT_KC

    @property
    def partials(self) -> int:
        """d_wn partials that reduce_partials sums (the C entry's nblk)."""
        return self.groups


def launch_plan(P: int, D: int, kB: int,
                sms: int = H100_SMS) -> LaunchPlan | SplitPlan:
    """The kernel's tiling for vi [P, D] and wn [kB, D] on a card of `sms`
    SMs (mirrors the dispatch in csrc/sgns_shared.cu)."""
    if D < 1 or kB < 1 or P < 0:
        raise ValueError(f"sgns_shared_grads: need D >= 1, kB >= 1, P >= 0; "
                         f"got P={P} D={D} kB={kB}")
    if D > SPLIT_D:
        # the gradient kernel in one wave: GRAD_BLOCKS_PER_SM blocks an SM
        # at most, every row group of equal tiles
        tiles = -(-P // GRAD_ROWS)
        slices = -(-D // SPLIT_SW)
        groups = min(tiles, max(1, sms * GRAD_BLOCKS_PER_SM // slices))
        if groups:
            groups = -(-tiles // -(-tiles // groups))
        ldg = -(-kB // LOGIT_KC) * LOGIT_KC
        rows = -(-P // LOGIT_ROWS) * LOGIT_ROWS
        return SplitPlan(tiles, slices, groups, max(groups, 1) * kB * D,
                         rows * ldg)
    tiles = -(-P // TILE_ROWS)
    dp, kc = next(w for w in WIDTHS if D <= w[0])
    blocks = min(tiles, sms)
    chunks = -(-kB // kc)
    smem = 8 * ((TILE_ROWS + kc) * (dp + 4) + TILE_ROWS * (kc + 4))
    return LaunchPlan(dp, kc, chunks, tiles, blocks, smem,
                      "whole" if chunks == 1 else "chunks",
                      max(blocks, 1) * kB * D)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the CPU: f32 rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (13 bits dropped)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
            ).view(np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """f32 cut to TF32's 10 mantissa bits (13 bits cleared): the split
    form's split_fast, and the tensor cores' read of an f32 operand."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_tf32(a: np.ndarray, b: np.ndarray, passes: int = 3,
                split=tf32_round) -> np.ndarray:
    """a @ b as the kernel's tensor-core product computes it, emulated in
    NumPy: operands split into TF32 hi and lo parts by `split` (tf32_round
    where the tile kernel splits by cvt.rna, tf32_trunc where the split
    form cuts bits), f32 accumulation. passes=3 is the kernel's
    error-compensated product (lo*hi + hi*lo + hi*hi), passes=1 a single
    TF32 product (hi*hi)."""
    a_hi, b_hi = split(a), split(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = split(a - a_hi), split(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def sgns_shared_grads_tf32(vi, vo, wn, g_pos, neg_mask, passes: int = 3):
    """NumPy emulation of the kernel's arithmetic (f32 arrays): the plain
    version with each product through matmul_tf32."""
    neg = matmul_tf32(vi, wn.T, passes)
    g_neg = ((1 / (1 + np.exp(-neg))) * neg_mask[:, None]).astype(np.float32)
    d_vi = g_pos[:, None] * vo + matmul_tf32(g_neg, wn, passes)
    d_vo = g_pos[:, None] * vi
    d_wn = matmul_tf32(g_neg.T, vi, passes)
    return d_vi, d_vo, d_wn


def sgns_shared_grads_ref(vi, vo, wn, g_pos, neg_mask):
    """Plain version: f32 matmuls (TF32 off where it runs on the card)."""
    neg = vi @ wn.T
    g_neg = torch.sigmoid(neg) * neg_mask[:, None]
    d_vi = g_pos[:, None] * vo + g_neg @ wn
    d_vo = g_pos[:, None] * vi
    d_wn = g_neg.T @ vi
    return d_vi, d_vo, d_wn


def sgns_shared_grads(vi: torch.Tensor, vo: torch.Tensor, wn: torch.Tensor,
                      g_pos: torch.Tensor, neg_mask: torch.Tensor):
    """Fused gradients for the shared-negative SGNS step.

    vi, vo: f32 [P, D] center / context rows; wn: f32 [kB, D] shared
    negatives; g_pos: f32 [P] positive-pair gradient; neg_mask: f32 [P]
    per-row negative weight. Returns (d_vi [P, D], d_vo [P, D],
    d_wn [kB, D])."""
    if vi.device.type == "cpu":
        return sgns_shared_grads_ref(vi, vo, wn, g_pos, neg_mask)
    SGNS_KERNEL.fn()
    P, D = vi.shape
    kB = wn.shape[0]
    if vo.shape != (P, D) or wn.shape != (kB, D) or g_pos.shape != (P,) \
            or neg_mask.shape != (P,):
        raise ValueError("sgns_shared_grads: shapes vi/vo [P,D], wn [kB,D], "
                         "g_pos/neg_mask [P] expected")
    for t in (vi, vo, wn, g_pos, neg_mask):
        if t.dtype != torch.float32:
            raise ValueError(f"sgns_shared_grads: float32 expected, got "
                             f"{t.dtype}")
    require_cuda("sgns_shared_grads", vi, vo, wn, g_pos, neg_mask)
    plan = launch_plan(P, D, kB, torch.cuda.get_device_properties(
        vi.device).multi_processor_count)
    d_vi = torch.empty_like(vi)
    d_vo = torch.empty_like(vo)
    d_wn = torch.empty_like(wn)
    f = lambda n: torch.empty(n, dtype=torch.float32, device=vi.device)
    launch_shared(plan, vi, vo, wn, g_pos, neg_mask, d_vi, d_vo, d_wn,
                  f(plan.part_floats), f(plan.g_floats) if plan.g_floats
                  else None)
    return d_vi, d_vo, d_wn


def launch_shared(plan: LaunchPlan | SplitPlan, vi, vo, wn, g_pos, neg_mask,
                  d_vi, d_vo, d_wn, part, g) -> None:
    """The kernel on checked tensors under `plan` (launch_plan of these
    shapes), into the given outputs and scratch (part_floats floats of
    partials; g_floats of g, None where the plan has none, which the C
    entry refuses above SPLIT_D): a caller that keeps them, as the conv
    step's workspace does, allocates nothing and asks the device nothing a
    call. d_vo None: d_vo is not written."""
    P, D = vi.shape
    SGNS_KERNEL.launch(ptr(vi), ptr(vo), ptr(wn), ptr(g_pos), ptr(neg_mask),
                       ptr(d_vi), None if d_vo is None else ptr(d_vo),
                       ptr(d_wn), ptr(part), None if g is None else ptr(g),
                       P, D, wn.shape[0], plan.partials,
                       stream(vi.device))
