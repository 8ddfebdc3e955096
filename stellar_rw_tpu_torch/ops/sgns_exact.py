"""The exact-negative SGNS step: kernels and plain version.

`sgns_exact_step(w_in, w_out, block, cwin, negs, lr, window)` applies one
block's step in place: the skip-gram pairs of block i32 [B, T] (-1 padded)
under the dynamic windows cwin i32 [B, T], each with the context and its k
negatives negs [B*T*2w, k] as targets; every row moves by lr times the mean
of its gradients, all computed from the tables as they were before the step
(the JAX package's stellar_rw_tpu/models/word2vec.py::_sgns_apply over
_pairs_for_block, which it matches to rounding).

CUDA tensors launch the two kernels of csrc/sgns_exact.cu under launch_plan
(gradients into compact delta slots with a list of the touched rows, the
hub rows' summed a block at a time in a small shared-memory table first;
then the update of those rows alone); CPU tensors run the plain version:
_valid_from_cwin, _pairs_from_valid and _sgns_apply, the trainer's own
step. The kernels sum in another order (atomics), so they agree with the
plain version to rounding: rtol 1e-5 on the tables after a step.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel, ptr, require_cuda, stream

SGNS_EXACT_GRADS = Kernel(
    "sgns_exact.cu", "srw_sgns_exact_grads_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2)
# the update kernel of the same source (and the same library)
SGNS_EXACT_APPLY = Kernel(
    "sgns_exact.cu", "srw_sgns_exact_apply_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_void_p])

APPLY_BLOCKS = 1056     # 8 blocks of 8 warps an SM of the H100's 132
H100_SMS = 132          # launch_plan's default; the wrapper asks the device
THREADS = 512           # kernel (a)'s block (kMaxThreads in the source)
BLOCKS_PER_SM = 2       # ... two an SM (kMinBlocks: 64 registers a thread)
# shared memory one of those blocks can have: half an SM's 233,472 bytes on
# sm_90, less the 1,024 reserved a block
TABLE_BUDGET = 233_472 // BLOCKS_PER_SM - 1_024
TABLE_ROWS = 16         # a block's table: room for its hub rows


class LaunchPlan(NamedTuple):
    """How csrc/sgns_exact.cu's kernel (a) cuts one block of positions."""

    nv: int            # floats a lane holds of a row slice (32 * nv columns)
    slices: int        # slices a row takes: 1 keeps the rows in registers
    blocks: int        # persistent blocks
    threads: int       # threads a block
    positions: int     # consecutive center positions a block
    slots: int         # rows of the block's shared-memory table
    smem_bytes: int    # dynamic shared memory a block: the table


def slot_bytes(D: int) -> int:
    """Shared memory a table row takes: its key, its count and D floats
    padded to a multiple of 32."""
    return 8 + 4 * (-(-D // 32) * 32)


def launch_plan(D: int, B: int, T: int, window: int, k: int,
                sm_count: int = H100_SMS) -> LaunchPlan:
    """Kernel (a)'s plan for a block [B, T] at dim D, window w and k
    negatives on a card of `sm_count` SMs (the .cu dispatch picks nv from D
    alike): BLOCKS_PER_SM persistent blocks an SM, each over `positions`
    consecutive centers, with a table of TABLE_ROWS rows where TABLE_BUDGET
    holds them, never more than twice the rows its positions can touch. The
    table is for the hub rows, which come first and most often: rows that
    find no slot go straight to device memory, and a larger table costs
    more in probes and flushes than it saves (PERF.md, section 6)."""
    if D < 1 or B < 0 or T < 0 or window < 1 or k < 0 or sm_count < 1:
        raise ValueError(f"sgns_exact launch_plan: D={D} B={B} T={T} "
                         f"window={window} k={k} sm_count={sm_count}")
    nv = 1 if D <= 32 else 2 if D <= 64 else 4
    BT = B * T
    blocks = max(1, min(sm_count * BLOCKS_PER_SM, BT))
    positions = max(1, -(-BT // blocks))
    blocks = max(1, -(-BT // positions))
    touched = positions * (2 * window * (1 + k) + 1)
    slots = min(TABLE_BUDGET // slot_bytes(D), 2 * touched, TABLE_ROWS)
    return LaunchPlan(nv, -(-D // (32 * nv)), blocks, THREADS, positions,
                      slots, slots * slot_bytes(D))


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
    """The kernels' scratch for tables of V_in and V_out rows of D floats
    and blocks of `positions` center positions, window w, k negatives:
    compact delta slots with their counts and rows, and a row-to-slot map
    (-1 when free). A block touches at most min(V_in, positions) rows of
    w_in and min(V_out, positions * 2w * (1 + k)) of w_out, so the delta
    slots are bounded by the block, not by the vocabulary; the map is one
    int a row. The update kernel leaves every slot and map entry empty
    again, so one workspace serves every step; the trainer makes one an
    epoch. `targets` overrides the w_out rows a position can touch (the
    conv step, ops/sgns_conv.py, touches its own token's row alone: 1)."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor,
                 positions: int, window: int = 1, k: int = 0,
                 targets: int | None = None):
        dev = w_in.device
        v_in, v_out, dim = w_in.shape[0], w_out.shape[0], w_in.shape[1]
        self.shape = (v_in, v_out, dim)
        if targets is None:
            targets = 2 * window * (1 + k)
        self.rows = (min(v_in, positions), min(v_out, positions * targets))
        z = lambda n, w=None, dt=torch.int32: torch.zeros(
            (n,) if w is None else (n, w), dtype=dt, device=dev)
        self.d = [z(r, dim, torch.float32) for r in self.rows]
        self.cnt = [z(r) for r in self.rows]
        self.list = [z(r) for r in self.rows]
        self.map = [torch.full((v,), -1, dtype=torch.int32, device=dev)
                    for v in (v_in, v_out)]
        self.counts = z(2)
        self._ptrs = (ctypes.c_void_p * 9)(*(
            t.data_ptr() for t in (*self.d, *self.cnt, *self.map,
                                   *self.list, self.counts)))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            *self.d, *self.cnt, *self.list, *self.map, self.counts))

    def serves(self, w_in, w_out, positions: int, window: int,
               k: int) -> bool:
        """Whether a step on these tables and this block fits the
        workspace."""
        need = (min(w_in.shape[0], positions),
                min(w_out.shape[0], positions * 2 * window * (1 + k)))
        return (self.shape == (w_in.shape[0], w_out.shape[0],
                               w_in.shape[1])
                and all(n <= r for n, r in zip(need, self.rows)))


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
    none is given); CPU tensors run sgns_exact_step_ref. Any D."""
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
    if w_in.dtype != torch.float32 or w_out.dtype != torch.float32:
        raise ValueError("sgns_exact_step: tables must be float32")
    negs = negs.to(torch.int32)
    for name, t in (("block", block), ("cwin", cwin)):
        if t.dtype != torch.int32:
            raise ValueError(f"sgns_exact_step: {name} must be int32, "
                             f"got {t.dtype}")
    require_cuda("sgns_exact_step", w_in, w_out, block, cwin, negs)
    k = negs.shape[1]
    if ws is None:
        ws = Workspace(w_in, w_out, B * T, window, k)
    elif not ws.serves(w_in, w_out, B * T, window, k):
        raise ValueError(f"sgns_exact_step: workspace for {ws.shape} with "
                         f"{ws.rows} delta rows")
    launch_grads(ws, w_in, w_out, block, cwin, negs, window)
    launch_apply(ws, w_in, w_out, lr)
    return w_in, w_out


def launch_grads(ws: Workspace, w_in, w_out, block, cwin, negs, window: int,
                 plan: LaunchPlan | None = None, stats=None) -> None:
    """Kernel (a) on checked tensors: gradients into ws, under `plan`
    (launch_plan for this card if none is given). stats, an int32 [3]
    tensor, gets added the row adds into the blocks' tables, the row adds
    into device memory and the table slots flushed."""
    B, T = block.shape
    k = negs.shape[1]
    if plan is None:
        plan = launch_plan(w_in.shape[1], B, T, window, k, _sms(w_in.device))
    SGNS_EXACT_GRADS.launch(
        ptr(w_in), ptr(w_out), ptr(block), ptr(cwin), ptr(negs), ws._ptrs,
        B * T, T, window, k, w_in.shape[1], plan.blocks, plan.threads,
        plan.positions, plan.slots,
        None if stats is None else ptr(stats), stream(w_in.device))


def launch_apply(ws: Workspace, w_in, w_out, lr: float) -> None:
    """Kernel (b): the touched rows of both tables updated, ws emptied."""
    SGNS_EXACT_APPLY.launch(ptr(w_in), ptr(w_out), ws._ptrs, w_in.shape[1],
                            APPLY_BLOCKS, float(lr), stream(w_in.device))


_SMS: dict = {}


def _sms(device) -> int:
    """The SM count of a CUDA device, asked once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]
