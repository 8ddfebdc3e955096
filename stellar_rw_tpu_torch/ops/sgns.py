"""Shared-negative SGNS gradients: kernel wrapper and plain version.

Port of the Pallas kernel stellar_rw_tpu/ops/pallas/sgns.py::
sgns_shared_grads, with the same arguments and returns. CUDA tensors launch
csrc/sgns_shared.cu; CPU tensors run sgns_shared_grads_ref. The trainer's
conv step (models/word2vec.py) routes its negative half through it.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, ptr, require_cuda, stream

SGNS_KERNEL = Kernel(
    "sgns_shared.cu", "srw_sgns_shared_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

ROWS = 16            # rows of P per block tile (csrc/sgns_shared.cu)
MAX_BLOCKS = 264     # two blocks per SM of an H100; caps the d_wn partials
MAX_DIM = 512        # shared-memory budget of one block tile


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
    if D > MAX_DIM:
        raise ValueError(f"sgns_shared_grads: D={D} exceeds {MAX_DIM}")
    for t in (vi, vo, wn, g_pos, neg_mask):
        if t.dtype != torch.float32:
            raise ValueError(f"sgns_shared_grads: float32 expected, got "
                             f"{t.dtype}")
    require_cuda("sgns_shared_grads", vi, vo, wn, g_pos, neg_mask)
    nblk = min(-(-P // ROWS), MAX_BLOCKS)
    d_vi = torch.empty_like(vi)
    d_vo = torch.empty_like(vo)
    d_wn = torch.empty_like(wn)
    part = torch.empty((max(nblk, 1), kB, D), dtype=torch.float32,
                       device=vi.device)
    SGNS_KERNEL.launch(ptr(vi), ptr(vo), ptr(wn), ptr(g_pos), ptr(neg_mask),
                       ptr(d_vi), ptr(d_vo), ptr(d_wn), ptr(part), P, D, kB,
                       nblk, stream(vi.device))
    return d_vi, d_vo, d_wn
