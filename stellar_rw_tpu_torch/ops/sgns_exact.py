"""The exact-negative SGNS step: kernels and plain version.

`sgns_exact_step(w_in, w_out, block, cwin, negs, lr, window)` applies one
block's step in place: the skip-gram pairs of block i32 [B, T] (-1 padded)
under the dynamic windows cwin i32 [B, T], each with the context and its k
negatives negs [B*T*2w, k] as targets; every row moves by lr times the mean
of its gradients, all computed from the tables as they were before the step
(the JAX package's stellar_rw_tpu/models/word2vec.py::_sgns_apply over
_pairs_for_block, which it matches to rounding).

CUDA tensors launch csrc/sgns_exact.cu's one kernel a step under
launch_plan, a cooperative launch (gradients into compact delta slots with
a list of the touched rows, the hub rows' summed a block at a time in a
small shared-memory table first; a grid barrier; then the update of those
rows alone, which empties the slots again); CPU tensors run the plain
version:
_valid_from_cwin, _pairs_from_valid and _sgns_apply, the trainer's own
step. The kernels sum in another order (atomics), so they agree with the
plain version to rounding: rtol 1e-5 on the tables after a step.

Slots. block, cwin and negs may carry a leading slot dimension ([S, B, T],
[S, B, T], [S, B*T*2w, k]; each slot's part contiguous, any stride between
slots, as slots[:, i] of the trainer's [S, n_blocks, B, T]): the S slots of
the data-parallel trainer's merged update. Without a buffer that is the
merged update itself (the JAX package's psum'd step,
stellar_rw_tpu/models/word2vec.py:190-201, on one card): one launch of the
same kernel over all the slots' pairs, counted as a merged launch, whose
plain twin is sgns_exact_merged_ref (each slot's _sgns_accumulate,
then dp_apply_ref). With `buffer` given (a reduction buffer,
ops/dp_apply.py) the step runs in accumulate mode, for slots whose update
is summed across ranks first: their gradient sums and counts are added into
the buffer and the tables are not written (_sgns_apply with axis_name,
before its psum). On the card that is the same kernel through its
accumulate entry point, one launch for all the slots; its plain version is
sgns_exact_accumulate_ref, slot by slot.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel, ptr, require_cuda, stream
from .dp_apply import buffer_numel, buffer_ptrs, buffer_views, dp_apply_ref
from ._build import sm_count as _sms

# w_in, w_out, block, cwin, negs, scratch; S, BT; the slot strides; T,
# window, k, D, blocks, threads, positions, slots; lr; stats
_STEP_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
              + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 8
              + [ctypes.c_float] + [ctypes.c_void_p])
SGNS_EXACT_STEP = Kernel("sgns_exact.cu", "srw_sgns_exact_step_launch",
                         _STEP_ARGS + [ctypes.c_void_p])
# the data-parallel merged update of S slots on one card: the same entry
# point, counted on its own
SGNS_EXACT_MERGED = Kernel("sgns_exact.cu", SGNS_EXACT_STEP.symbol,
                           SGNS_EXACT_STEP.argtypes)
# the step in accumulate mode: the merged update's buffer as four more
# arguments (acc_in, acc_out, cnt_in, cnt_out)
SGNS_EXACT_ACCUMULATE = Kernel(
    "sgns_exact.cu", "srw_sgns_exact_accumulate_launch",
    _STEP_ARGS + [ctypes.c_void_p] * 5)

APPLY_BLOCKS = 1056     # the conv scatter's grid cap: 8 blocks of 8 warps
                        # an SM of the H100's 132
H100_SMS = 132          # launch_plan's default; the wrapper asks the device
THREADS = 512           # the step's block (kMaxThreads in the source)
# ... two an SM (kMinBlocks: 64 registers a thread); a cooperative launch
# needs every block resident, so a plan never asks for more
BLOCKS_PER_SM = 2
# shared memory one of those blocks can have: half an SM's 233,472 bytes on
# sm_90, less the 1,024 reserved a block
TABLE_BUDGET = 233_472 // BLOCKS_PER_SM - 1_024
TABLE_ROWS = 16         # a block's table: room for its hub rows


class LaunchPlan(NamedTuple):
    """How csrc/sgns_exact.cu's step cuts one block of positions."""

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
    """The step's plan for a block [B, T] (the merged update of S slots of
    B rows: S * B rows) at dim D, window w and k negatives on a card of
    `sm_count` SMs (the .cu dispatch picks nv from D alike): at most
    BLOCKS_PER_SM persistent blocks an SM (all resident, as the cooperative
    launch needs), each over `positions` consecutive centers, with a table
    of TABLE_ROWS rows where TABLE_BUDGET holds them, never more than twice
    the rows its positions can touch. The table is for the hub rows, which
    come first and most often: rows that find no slot go straight to
    device memory, and a larger table costs more in probes and flushes than
    it saves (PERF.md, section 6)."""
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


def _sgns_grads(w_in, w_out, centers, contexts, valid, negs):
    """The step's gradients from the tables as they are: (c, d_vi, tflat,
    d_vo, cnt_in, cnt_out), the center rows and their gradients [P, D],
    the target rows and theirs [P*(1+k), D], and each table's counts."""
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
    return c, d_vi, tflat, d_vo, cnt_in, cnt_out


def _sgns_apply(w_in, w_out, centers, contexts, valid, negs, lr: float):
    """One exact-negative SGNS step with manual gradients and scatter-mean
    updates (single replica), in place. P pairs, k negatives per pair."""
    c, d_vi, tflat, d_vo, cnt_in, cnt_out = _sgns_grads(
        w_in, w_out, centers, contexts, valid, negs)
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
    int a row, and `counts` the slots taken in each table. The kernel
    leaves every slot, map entry and count empty again, so one workspace
    serves every step; the trainer makes one an epoch. `rows`, when
    given, are the delta rows of each table, and `counts` the length of
    the counts (another step's bounds and counts: the hierarchical-softmax
    step's, ops/hsoftmax.py::HSWorkspace)."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor,
                 positions: int, window: int = 1, k: int = 0,
                 rows: tuple[int, int] | None = None, counts: int = 2):
        dev = w_in.device
        v_in, v_out, dim = w_in.shape[0], w_out.shape[0], w_in.shape[1]
        self.shape = (v_in, v_out, dim)
        self.rows = rows or (min(v_in, positions),
                             min(v_out, positions * 2 * window * (1 + k)))
        z = lambda n, w=None, dt=torch.int32: torch.zeros(
            (n,) if w is None else (n, w), dtype=dt, device=dev)
        self.d = [z(r, dim, torch.float32) for r in self.rows]
        self.cnt = [z(r) for r in self.rows]
        self.list = [z(r) for r in self.rows]
        self.map = [torch.full((v,), -1, dtype=torch.int32, device=dev)
                    for v in (v_in, v_out)]
        self.counts = z(counts)
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


def _sgns_accumulate(w_in, w_out, centers, contexts, valid, negs, buffer):
    """The data-parallel form of _sgns_apply before its psum: the step's
    gradient sums and counts added into the reduction buffer (in its
    dtype), the tables untouched."""
    acc_in, acc_out, b_in, b_out = buffer_views(buffer, *w_in.shape)
    c, d_vi, tflat, d_vo, cnt_in, cnt_out = _sgns_grads(
        w_in, w_out, centers, contexts, valid, negs)
    acc_in.index_add_(0, c, d_vi.to(buffer.dtype))
    acc_out.index_add_(0, tflat, d_vo.to(buffer.dtype))
    b_in += cnt_in.to(buffer.dtype)
    b_out += cnt_out.to(buffer.dtype)
    return buffer


def sgns_exact_accumulate_ref(w_in, w_out, block, cwin, negs, window: int,
                              buffer):
    """Plain torch version of the accumulate mode: the trainer's pair
    enumeration and _sgns_accumulate, slot by slot where block has a slot
    dimension."""
    if block.dim() == 3:
        for s in range(block.shape[0]):
            sgns_exact_accumulate_ref(w_in, w_out, block[s], cwin[s],
                                      negs[s], window, buffer)
        return buffer
    valid, ctx_pos_c = _valid_from_cwin(block, cwin, window)
    centers, contexts, vflat = _pairs_from_valid(block, valid, ctx_pos_c)
    return _sgns_accumulate(w_in, w_out, centers, contexts, vflat, negs,
                            buffer)


def sgns_exact_merged_ref(w_in, w_out, blocks, cwins, negs, lr: float,
                          window: int, buffer=None):
    """Plain twin of the merged update of S slots (blocks [S, B, T]), in
    place: each slot's _sgns_accumulate into one reduction buffer in the
    tables' dtype, then dp_apply_ref, as the data-parallel trainer merges
    its slots. `buffer`, when given, is that buffer, zero: dp_apply_ref
    leaves it zero again, so one serves every merged update."""
    if buffer is None:
        buffer = torch.zeros(buffer_numel(*w_in.shape), dtype=w_in.dtype,
                             device=w_in.device)
    sgns_exact_accumulate_ref(w_in, w_out, blocks, cwins, negs, window,
                              buffer)
    return dp_apply_ref(w_in, w_out, buffer, lr)


def _slot_layout(name: str, block, cwin, negs, window: int):
    """(S, B, T, k, slot strides) of one block ([B, T], [B, T],
    [B*T*2w, k]) or of S slots' ([S, B, T], [S, B, T], [S, B*T*2w, k]),
    each slot's part contiguous; raises on anything else."""
    if block.dim() == 2:
        block, cwin, negs = block[None], cwin[None], negs[None]
    if block.dim() != 3 or cwin.dim() != 3 or negs.dim() != 3:
        raise ValueError(f"{name}: block {tuple(block.shape)}, cwin "
                         f"{tuple(cwin.shape)}, negs {tuple(negs.shape)}")
    S, B, T = block.shape
    k = negs.shape[2]
    if (cwin.shape != (S, B, T) or negs.shape[:2] != (S, B * T * 2 * window)
            or block.stride()[1:] != (T, 1) or cwin.stride()[1:] != (T, 1)
            or negs.stride()[1:] != (k, 1)):
        raise ValueError(f"{name}: slots of block {tuple(block.shape)} "
                         f"cwin {tuple(cwin.shape)} negs "
                         f"{tuple(negs.shape)} window {window}, or a slot "
                         f"not contiguous")
    strides = tuple(t.stride(0) if S > 1 else 0 for t in (block, cwin, negs))
    return S, B, T, k, strides


def sgns_exact_step(w_in, w_out, block, cwin, negs, lr: float, window: int,
                    ws: Workspace | torch.Tensor | None = None, buffer=None):
    """One exact-negative step in place (see the module): of one block, or
    the merged update of S slots when block, cwin and negs carry a slot
    dimension. CUDA tensors launch csrc/sgns_exact.cu once, with the
    scratch `ws` (a new Workspace for S * B * T positions if none is
    given); CPU tensors run sgns_exact_step_ref (one block) or
    sgns_exact_merged_ref (slots; `ws` is then its zero reduction buffer,
    a new one if none is given). Any D. With `buffer` (the reduction
    buffer of ops/dp_apply.py) the step runs in accumulate mode: the
    tables stay, lr is not read."""
    if w_in.device.type == "cpu":
        if buffer is not None:
            return sgns_exact_accumulate_ref(w_in, w_out, block, cwin, negs,
                                             window, buffer)
        if block.dim() == 3:
            return sgns_exact_merged_ref(w_in, w_out, block, cwin, negs, lr,
                                         window, ws)
        return sgns_exact_step_ref(w_in, w_out, block, cwin, negs, lr, window)
    (SGNS_EXACT_STEP if block.dim() == 2 and buffer is None
     else SGNS_EXACT_MERGED if buffer is None else SGNS_EXACT_ACCUMULATE).fn()
    negs = negs.to(torch.int32)
    S, B, T, k, _ = _slot_layout("sgns_exact_step", block, cwin, negs,
                                 window)
    D = w_in.shape[1]
    if w_out.shape[1] != D:
        raise ValueError(f"sgns_exact_step: tables {tuple(w_in.shape)} and "
                         f"{tuple(w_out.shape)}")
    if w_in.dtype != torch.float32 or w_out.dtype != torch.float32:
        raise ValueError("sgns_exact_step: tables must be float32")
    for name, t in (("block", block), ("cwin", cwin)):
        if t.dtype != torch.int32:
            raise ValueError(f"sgns_exact_step: {name} must be int32, "
                             f"got {t.dtype}")
    require_cuda("sgns_exact_step", w_in, w_out)
    require_slots("sgns_exact_step", w_in, block, cwin, negs)
    if buffer is not None:
        check_buffer("sgns_exact_step", w_in, w_out, buffer)
    if ws is None:
        ws = Workspace(w_in, w_out, S * B * T, window, k)
    elif not ws.serves(w_in, w_out, S * B * T, window, k):
        raise ValueError(f"sgns_exact_step: workspace for {ws.shape} with "
                         f"{ws.rows} delta rows")
    launch_step(ws, w_in, w_out, block, cwin, negs, window, lr,
                buffer=buffer)
    return w_in, w_out


def require_slots(name: str, w_in, *tensors) -> None:
    """The slot arrays on the tables' CUDA device (their layout is
    _slot_layout's)."""
    for t in tensors:
        if t.device != w_in.device:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")


def check_buffer(name: str, w_in, w_out, buffer) -> None:
    """A kernel's check of the reduction buffer for the tables: float32,
    contiguous, on their device (its size is checked where the launch takes
    its addresses, buffer_ptrs)."""
    if w_in.shape != w_out.shape or buffer.dtype != torch.float32:
        raise ValueError(f"{name}: accumulate mode needs tables of one shape "
                         f"and a float32 buffer, got {tuple(w_in.shape)}, "
                         f"{tuple(w_out.shape)}, {buffer.dtype}")
    require_cuda(name, w_in, buffer)


def launch_step(ws: Workspace, w_in, w_out, block, cwin, negs, window: int,
                lr: float, plan: LaunchPlan | None = None,
                stats=None, buffer=None) -> None:
    """The step's kernel on checked tensors under `plan` (launch_plan for
    this card and the S * B rows if none is given): gradients into ws, the
    update, ws emptied. block, cwin, negs: one block, or S slots' (the
    merged update, counted by SGNS_EXACT_MERGED). stats, an int32 [3]
    tensor, gets added the row adds into the blocks' tables, the row adds
    into device memory and the table slots flushed. With a checked
    `buffer` the accumulate entry point runs in place of the update. A
    cooperative launch the card refuses raises KernelLaunchError."""
    S, B, T, k, strides = _slot_layout("launch_step", block, cwin, negs,
                                       window)
    if plan is None:
        plan = launch_plan(w_in.shape[1], S * B, T, window, k,
                           _sms(w_in.device))
    args = (ptr(w_in), ptr(w_out), ptr(block), ptr(cwin), ptr(negs),
            ws._ptrs, S, B * T, *strides, T, window, k, w_in.shape[1],
            plan.blocks, plan.threads, plan.positions, plan.slots,
            float(lr), None if stats is None else ptr(stats))
    if buffer is not None:
        SGNS_EXACT_ACCUMULATE.launch(
            *args, *buffer_ptrs(buffer, *w_in.shape),
            stream(w_in.device))
    elif block.dim() == 2:
        SGNS_EXACT_STEP.launch(*args, stream(w_in.device))
    else:
        SGNS_EXACT_MERGED.launch(*args, stream(w_in.device))
