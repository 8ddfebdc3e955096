"""The exact-negative SGNS step: kernels and plain version.

`sgns_exact_step(w_in, w_out, block, cwin, negs, lr, window)` applies one
block's step in place: the skip-gram pairs of block i32 [B, T] (-1 padded)
under the dynamic windows cwin i32 [B, T], each with the context and its k
negatives negs [B*T*2w, k] as targets; every row moves by lr times the mean
of its gradients, all computed from the tables as they were before the step
(the JAX package's stellar_rw_tpu/models/word2vec.py::_sgns_apply over
_pairs_for_block, which it matches to rounding).

CUDA tensors launch the two kernels of csrc/sgns_exact.cu (gradients into a
delta table with a list of the touched rows, then the update of those rows
alone); CPU tensors run the plain version: _valid_from_cwin,
_pairs_from_valid and _sgns_apply, the trainer's own step. The kernels sum
in another order (atomics), so they agree with the plain version to
rounding: rtol 1e-5 on the tables after a step.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, ptr, require_cuda, stream

SGNS_EXACT_GRADS = Kernel(
    "sgns_exact.cu", "srw_sgns_exact_grads_launch",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# the update kernel of the same source (and the same library)
SGNS_EXACT_APPLY = Kernel(
    "sgns_exact.cu", "srw_sgns_exact_apply_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_void_p])

MAX_DIM = 512           # widest instantiation: 16 floats a lane
APPLY_BLOCKS = 1056     # 8 blocks of 8 warps an SM of the H100's 132


def _offsets(window: int) -> list[int]:
    return list(range(-window, 0)) + list(range(1, window + 1))


def _valid_from_cwin(block: torch.Tensor, cwin: torch.Tensor, window: int):
    """[B, T, 2w] pair mask and clamped context positions [T, 2w] for the
    dynamic windows cwin [B, T]."""
    T = block.shape[1]
    dev = block.device
    offs = torch.tensor(_offsets(window), dtype=torch.int64, device=dev)
    ctx_pos = torch.arange(T, device=dev)[:, None] + offs[None, :]
    in_bounds = (ctx_pos >= 0) & (ctx_pos < T)
    ctx_pos_c = ctx_pos.clamp(0, T - 1)
    contexts = block[:, ctx_pos_c]
    valid = (in_bounds[None] & (offs.abs()[None, None, :] <= cwin[..., None])
             & (block[..., None] >= 0) & (contexts >= 0))
    return valid, ctx_pos_c


def _pairs_from_valid(block, valid, ctx_pos_c):
    centers = block[:, :, None].expand(valid.shape)
    contexts = block[:, ctx_pos_c]
    return centers.reshape(-1), contexts.reshape(-1), valid.reshape(-1)


def _sgns_apply(w_in, w_out, centers, contexts, valid, negs, lr: float):
    """One exact-negative SGNS step with manual gradients and scatter-mean
    updates (single replica), in place. P pairs, k negatives per pair."""
    P = centers.shape[0]
    k = negs.shape[1]
    c = torch.where(valid, centers, 0).long()
    targets = torch.cat([torch.where(valid, contexts, 0).long()[:, None],
                         negs.long()], dim=1)                   # [P, 1+k]
    vi = w_in[c]                                                # [P, D]
    vo = w_out[targets]                                         # [P, 1+k, D]
    logits = torch.einsum("pd,pkd->pk", vi, vo)
    labels = torch.zeros((P, 1 + k), dtype=torch.float32, device=vi.device)
    labels[:, 0] = 1.0
    g = (torch.sigmoid(logits) - labels) * valid[:, None]
    d_vi = torch.einsum("pk,pkd->pd", g, vo)
    d_vo = (g[:, :, None] * vi[:, None, :]).reshape(-1, vi.shape[-1])
    tflat = targets.reshape(-1)
    vmask = valid[:, None].expand(P, 1 + k).reshape(-1).to(torch.float32)
    cnt_in = torch.zeros(w_in.shape[0], device=vi.device).index_add_(
        0, c, valid.to(torch.float32))
    cnt_out = torch.zeros(w_out.shape[0], device=vi.device).index_add_(
        0, tflat, vmask)
    w_in.index_add_(0, c, -lr * d_vi / cnt_in.clamp_min(1.0)[c][:, None])
    w_out.index_add_(0, tflat,
                     -lr * d_vo / cnt_out.clamp_min(1.0)[tflat][:, None])
    return w_in, w_out


class Workspace:
    """The kernels' scratch for tables of V_in and V_out rows of D floats:
    delta tables, counts, flags and touched-row lists. The update kernel
    leaves every delta, count and flag at zero, so one workspace serves
    every step on those tables; the trainer makes one an epoch."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor):
        dev = w_in.device
        z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=dev)
        v_in, v_out, dim = w_in.shape[0], w_out.shape[0], w_in.shape[1]
        self.shape = (v_in, v_out, dim)
        self.d_in = z(v_in, dim, dt=torch.float32)
        self.d_out = z(v_out, dim, dt=torch.float32)
        self.cnt_in, self.cnt_out = z(v_in), z(v_out)
        self.flag_in, self.flag_out = z(v_in), z(v_out)
        self.list_in, self.list_out = z(v_in), z(v_out)
        self.counts = z(2)


def sgns_exact_step_ref(w_in, w_out, block, cwin, negs, lr: float,
                        window: int):
    """Plain torch version: the trainer's pair enumeration and
    _sgns_apply, in place."""
    valid, ctx_pos_c = _valid_from_cwin(block, cwin, window)
    centers, contexts, vflat = _pairs_from_valid(block, valid, ctx_pos_c)
    return _sgns_apply(w_in, w_out, centers, contexts, vflat, negs, lr)


def sgns_exact_step(w_in, w_out, block, cwin, negs, lr: float, window: int,
                    ws: Workspace | None = None):
    """One exact-negative step in place (see the module). CUDA tensors
    launch csrc/sgns_exact.cu, with the scratch `ws` (a new Workspace if
    none is given); CPU tensors run sgns_exact_step_ref."""
    if w_in.device.type == "cpu":
        return sgns_exact_step_ref(w_in, w_out, block, cwin, negs, lr, window)
    SGNS_EXACT_GRADS.fn()
    SGNS_EXACT_APPLY.fn()
    B, T = block.shape
    D = w_in.shape[1]
    if (w_out.shape[1] != D or cwin.shape != (B, T)
            or negs.shape[0] != B * T * 2 * window):
        raise ValueError(f"sgns_exact_step: shapes w_in {tuple(w_in.shape)} "
                         f"w_out {tuple(w_out.shape)} block {(B, T)} cwin "
                         f"{tuple(cwin.shape)} negs {tuple(negs.shape)} "
                         f"window {window}")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"sgns_exact_step: dim {D} beyond the kernel's "
                         f"1..{MAX_DIM}")
    if w_in.dtype != torch.float32 or w_out.dtype != torch.float32:
        raise ValueError("sgns_exact_step: tables must be float32")
    negs = negs.to(torch.int32)
    for name, t in (("block", block), ("cwin", cwin)):
        if t.dtype != torch.int32:
            raise ValueError(f"sgns_exact_step: {name} must be int32, "
                             f"got {t.dtype}")
    require_cuda("sgns_exact_step", w_in, w_out, block, cwin, negs)
    if ws is None:
        ws = Workspace(w_in, w_out)
    elif ws.shape != (w_in.shape[0], w_out.shape[0], D):
        raise ValueError(f"sgns_exact_step: workspace for {ws.shape}")
    launch_grads(ws, w_in, w_out, block, cwin, negs, window)
    launch_apply(ws, w_in, w_out, lr)
    return w_in, w_out


def launch_grads(ws: Workspace, w_in, w_out, block, cwin, negs,
                 window: int) -> None:
    """Kernel (a) on checked tensors: gradients into ws."""
    B, T = block.shape
    SGNS_EXACT_GRADS.launch(
        ptr(w_in), ptr(w_out), ptr(block), ptr(cwin), ptr(negs),
        ptr(ws.d_in), ptr(ws.d_out), ptr(ws.cnt_in), ptr(ws.cnt_out),
        ptr(ws.flag_in), ptr(ws.flag_out), ptr(ws.list_in),
        ptr(ws.list_out), ptr(ws.counts), B * T, T, window, negs.shape[1],
        w_in.shape[1], stream(w_in.device))


def launch_apply(ws: Workspace, w_in, w_out, lr: float) -> None:
    """Kernel (b): the touched rows of both tables updated, ws zeroed."""
    SGNS_EXACT_APPLY.launch(
        ptr(w_in), ptr(w_out), ptr(ws.d_in), ptr(ws.d_out), ptr(ws.cnt_in),
        ptr(ws.cnt_out), ptr(ws.flag_in), ptr(ws.flag_out), ptr(ws.list_in),
        ptr(ws.list_out), ptr(ws.counts), w_in.shape[1], APPLY_BLOCKS,
        float(lr), stream(w_in.device))
