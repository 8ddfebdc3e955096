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
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

TILE_ROWS = 32       # rows of P per block tile (TM in csrc/sgns_shared.cu)
H100_SMS = 132       # launch_plan's default; the wrapper asks the device
SMEM_LIMIT = 232_448  # dynamic shared memory one block can have on sm_90
# (padded D, negatives a chunk, tiles pre-split) of the kernel's
# instantiations: DP * KC is the d_wn partial a block keeps in registers, at
# most 64 floats a thread; pre-split tiles hold each value's two TF32 parts
# (8 bytes an element), which the widest D has no room for
WIDTHS = ((64, 128, True), (128, 128, True), (256, 64, True),
          (512, 32, False))
# D above the widest width: (slice width, negatives a chunk, pre-split) of
# sgns_shared_sliced, which runs the tiles over column slices: any D
SLICED = (256, 64, False)


class LaunchPlan(NamedTuple):
    """How csrc/sgns_shared.cu cuts one call."""

    dp: int            # D padded to the instantiation's width
    kc: int            # negatives held in shared memory at a time
    presplit: bool     # tiles hold (hi, lo) TF32 pairs, split at load time
    chunks: int        # passes over the tiles, one a chunk of kc negatives
    tiles: int         # tiles of TILE_ROWS rows
    blocks: int        # persistent blocks = d_wn partials
    smem_bytes: int    # dynamic shared memory a block
    wn_placement: str  # "whole" (one chunk) or "chunks"
    part_floats: int   # floats of the partials' scratch
    slices: int = 1    # column slices of dp a row takes (D above 512)


def launch_plan(P: int, D: int, kB: int, sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's tiling for vi [P, D] and wn [kB, D] on a card of `sms`
    SMs (mirrors the dispatch in csrc/sgns_shared.cu)."""
    if D < 1 or kB < 1 or P < 0:
        raise ValueError(f"sgns_shared_grads: need D >= 1, kB >= 1, P >= 0; "
                         f"got P={P} D={D} kB={kB}")
    dp, kc, pre = next((w for w in WIDTHS if D <= w[0]), SLICED)
    tiles = -(-P // TILE_ROWS)
    blocks = min(tiles, sms)
    chunks = -(-kB // kc)
    smem = (8 if pre else 4) * ((TILE_ROWS + kc) * (dp + 4)
                                + TILE_ROWS * (kc + 4))
    return LaunchPlan(dp, kc, pre, chunks, tiles, blocks, smem,
                      "whole" if chunks == 1 else "chunks",
                      max(blocks, 1) * kB * D, -(-D // dp))


def tf32_round(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on the CPU: f32 rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (13 bits dropped)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
            ).view(np.float32)


def matmul_tf32(a: np.ndarray, b: np.ndarray, passes: int = 3) -> np.ndarray:
    """a @ b as the kernel's tensor-core product computes it, emulated in
    NumPy: operands split into TF32 hi and lo parts, f32 accumulation.
    passes=3 is the kernel's error-compensated product (lo*hi + hi*lo +
    hi*hi), passes=1 a single TF32 product (hi*hi)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
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
    part = torch.empty(plan.part_floats, dtype=torch.float32,
                       device=vi.device)
    SGNS_KERNEL.launch(ptr(vi), ptr(vo), ptr(wn), ptr(g_pos), ptr(neg_mask),
                       ptr(d_vi), ptr(d_vo), ptr(d_wn), ptr(part), P, D, kB,
                       plan.blocks, stream(vi.device))
    return d_vi, d_vo, d_wn
