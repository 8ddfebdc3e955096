"""The hierarchical-softmax skip-gram step: kernel wrapper and plain version.

`hs_step(syn0, syn1, block, cwin, points, labels, pmask, lr, window)`
applies one block's step in place: for each valid pair (center c, context
c + d) of block i32 [B, T] (-1 padded) under the dynamic windows cwin i32
[B, T], and each live level l of the center's Huffman path (points,
labels, pmask [V, L], models/hsoftmax.py::build_huffman),
g = sigmoid(<syn0[ctx], syn1[node_l]>) - label_l; syn1[node_l] gains
g * syn0[ctx] and syn0[ctx] gains g * syn1[node_l]. Every gradient comes
from the tables as they were before the step, and each row then moves by
lr times the mean of its gradients: a path node's count is the valid pairs
of the centers on whose path it lies, a token's the valid pairs in which it
is the context (the JAX package's stellar_rw_tpu/models/hsoftmax.py::
_hs_epoch, one scan body, which it matches to rounding).

CUDA tensors launch csrc/hsoftmax.cu once a step under launch_plan, a
cooperative launch: persistent blocks over halo tiles of a walk; a tile's
centers' path nodes de-duplicated, each claimed and counted once a tile;
the step over the tile as three products over those nodes in chunks
(S = X VO^T and G, d_VO = G^T X into the nodes' compact delta slots,
d_X = G VO into the halo's gradient rows in shared memory); the halo rows
into their tokens' delta slots (HSWorkspace); a grid barrier; the update
of the listed rows, which empties the slots again. It holds no
[B, T, L, D] tensor. CPU tensors run hs_step_ref, the JAX body in torch,
in the tables' dtype (float64 tables give the reference the card's
kernel is held to).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import Kernel, ptr, require_cuda, stream
from ._build import sm_count as _sms
from .sgns_conv import _shift
from .sgns_exact import Workspace, _offsets, _valid_from_cwin

HS_STEP = Kernel(
    "hsoftmax.cu", "srw_hs_step_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
    + [ctypes.c_void_p])

H100_SMS = 132          # launch_plan's default; the wrapper asks the device
THREADS = 256           # kThreads in the source: 8 warps a block
KGROUP = 4              # nodes a warp takes at once (kGroup)
CHUNK = THREADS // 32 * KGROUP  # nodes a chunk of a tile's nodes (kChunk)
TILES = (32, 16, 8, 4, 2, 1)    # centers a tile (a 32-bit mask), widest first
# (blocks an SM, the shared memory each may take): two as the exact step's
# (half an SM's 233,472 bytes less the 1,024 reserved a block), or one
SMEM_BUDGETS = ((2, 233_472 // 2 - 1_024), (1, 233_472 - 1_024))


class LaunchPlan(NamedTuple):
    """How csrc/hsoftmax.cu cuts one block [B, T]."""

    tile: int          # centers a tile at most (one walk's consecutive
    #                    positions; a walk's ceil(T / tile) tiles are of
    #                    near equal sizes)
    tiles: int         # tiles of the block: B * ceil(T / tile)
    halo_rows: int     # syn0 rows a tile holds: tile + 2 * window
    blocks: int        # persistent blocks (all resident)
    blocks_per_sm: int
    smem_bytes: int    # dynamic shared memory a block


def smem_bytes(tile: int, window: int, D: int, levels: int) -> int:
    """The kernel's shared memory: the halo's syn0 rows and their gradient
    rows (rows of D padded to 32 floats), a chunk's node rows (at most 128
    columns: one register slice), the chunk's G [halo rows, CHUNK], the
    halo's tokens, pair counts and center masks, two counts a center, four
    words a path entry and four a node of the tile's `tile` x `levels`
    entries, and the block's next tile."""
    H = tile + 2 * window
    dpad = -(-D // 32) * 32
    E = tile * levels
    return 4 * (2 * H * dpad + CHUNK * min(dpad, 128) + H * CHUNK + 3 * H
                + 2 * tile + 8 * E + 1)


def launch_plan(D: int, B: int, T: int, window: int,
                sm_count: int = H100_SMS, *, levels: int) -> LaunchPlan:
    """The step's plan for a block [B, T] at dim D and window w, on paths of
    at most `levels` levels, on a card of `sm_count` SMs: the widest tile
    of TILES whose B * ceil(T / tile) tiles give every SM two blocks (the
    narrowest of 32, 16, 8 when none does; never wider than T), two
    blocks an SM; where that does not fit the budget, narrower tiles, then
    one block an SM. Persistent blocks: at most the resident ones, never
    more than the tiles."""
    if D < 1 or B < 1 or T < 1 or window < 1 or sm_count < 1 or levels < 1:
        raise ValueError(f"hsoftmax launch_plan: D={D} B={B} T={T} "
                         f"window={window} sm_count={sm_count} "
                         f"levels={levels}")
    first = next((t for t in TILES[:3] if B * -(-T // t) >= 2 * sm_count),
                 TILES[2])
    tiles = [min(t, T) for t in TILES if t <= first]
    for bps, budget in SMEM_BUDGETS:
        for tile in tiles:
            need = smem_bytes(tile, window, D, levels)
            if need <= budget:
                n = B * -(-T // tile)
                return LaunchPlan(tile, n, tile + 2 * window,
                                  min(n, bps * sm_count), bps, need)
    raise ValueError(f"hsoftmax launch_plan: D {D} at window {window} and "
                     f"{levels} levels leaves no room for a tile of one "
                     f"center in {SMEM_BUDGETS[-1][1]} bytes")


class HSWorkspace(Workspace):
    """The step's scratch for tables syn0 [V, D] and syn1 [V1, D] and blocks
    of `positions` center positions on paths of at most `levels` levels:
    the exact step's compact delta slots (ops/sgns_exact.py::Workspace),
    bounded by the block: a block touches at most min(V, positions) rows of
    syn0 and min(V1, positions * levels) of syn1; and three counts, the
    slots taken in each table and the tiles the kernel's blocks have
    taken. The kernel leaves it empty again, so one serves every step of a
    run."""

    def __init__(self, syn0: torch.Tensor, syn1: torch.Tensor,
                 positions: int, levels: int):
        super().__init__(syn0, syn1, positions,
                         rows=(min(syn0.shape[0], positions),
                               min(syn1.shape[0], positions * levels)),
                         counts=3)
        self._labels = None     # the labels last found binary, their version

    def binary_labels(self, labels: torch.Tensor) -> bool:
        """Whether every label is 0 or 1, as the kernel takes them (it
        counts a node's label-1 centers by bit masks): read once a labels
        tensor, and again only after that tensor is written."""
        seen = (labels, labels._version)
        if (self._labels is not None and self._labels[0] is labels
                and self._labels[1] == seen[1]):
            return True
        ok = bool(((labels == 0) | (labels == 1)).all())
        self._labels = seen if ok else None
        return ok

    def serves_hs(self, syn0, syn1, positions: int, levels: int) -> bool:
        return (self.shape == (syn0.shape[0], syn1.shape[0], syn0.shape[1])
                and min(syn0.shape[0], positions) <= self.rows[0]
                and min(syn1.shape[0], positions * levels) <= self.rows[1])


def hs_step_ref(syn0, syn1, block, cwin, points, labels, pmask, lr: float,
                window: int):
    """Plain torch version, in place, in the tables' dtype: the JAX scan
    body (stellar_rw_tpu/models/hsoftmax.py:104-154) with its order of
    work: the [B, T, L, D] path rows gathered, one pass a window offset,
    then syn1's scatter-mean over path nodes and syn0's over tokens."""
    B, T = block.shape
    D = syn0.shape[1]
    L = points.shape[1]
    N = B * T
    dt = syn0.dtype
    valid, _ = _valid_from_cwin(block, cwin, window)
    vf = valid.to(dt)                                   # [B, T, 2w]
    tok = block.reshape(-1).clamp_min(0).long()
    ein = syn0[tok].reshape(B, T, D)
    pts = points[tok].long()                            # [N, L]
    lbl = labels[tok].to(dt).reshape(B, T, L)
    pmk = pmask[tok].to(dt).reshape(B, T, L)
    vo = syn1[pts.reshape(-1)].reshape(B, T, L, D)
    d_vo = torch.zeros_like(vo)
    acc0 = torch.zeros_like(ein)
    offs = _offsets(window)
    for i, d in enumerate(offs):
        xd = _shift(ein, d)
        g = ((torch.sigmoid(torch.einsum("btd,btld->btl", xd, vo)) - lbl)
             * vf[..., i, None] * pmk)
        d_vo += g[..., None] * xd[:, :, None, :]
        acc0 += _shift(torch.einsum("btl,btld->btd", g, vo), -d)
    vcnt = vf.sum(-1)
    ptsf = pts.reshape(N * L)
    cnt1 = torch.zeros(syn1.shape[0], dtype=dt, device=syn1.device
                       ).index_add_(0, ptsf,
                                    (vcnt[..., None] * pmk).reshape(N * L))
    syn1.index_add_(0, ptsf, -lr * d_vo.reshape(N * L, D)
                    / cnt1.clamp_min(1.0)[ptsf][:, None])
    cnt0_pos = sum(_shift(vf[..., i], -d) for i, d in enumerate(offs))
    cnt0 = torch.zeros(syn0.shape[0], dtype=dt, device=syn0.device
                       ).index_add_(0, tok, cnt0_pos.reshape(N))
    syn0.index_add_(0, tok, -lr * acc0.reshape(N, D)
                    / cnt0.clamp_min(1.0)[tok][:, None])
    return syn0, syn1


def hs_step(syn0, syn1, block, cwin, points, labels, pmask, lr: float,
            window: int, ws: HSWorkspace | None = None):
    """One hierarchical-softmax step in place (see the module). CUDA
    tensors launch csrc/hsoftmax.cu once with the scratch `ws` (a new
    HSWorkspace if none is given), and raise on labels other than 0 and 1;
    CPU tensors run hs_step_ref."""
    if syn0.device.type == "cpu":
        return hs_step_ref(syn0, syn1, block, cwin, points, labels, pmask,
                           lr, window)
    HS_STEP.fn()
    B, T = block.shape
    V, D = syn0.shape
    L = points.shape[1]
    if (syn1.dim() != 2 or syn1.shape[1] != D or cwin.shape != (B, T)
            or points.shape != (V, L) or labels.shape != (V, L)
            or pmask.shape != (V, L) or window < 1):
        raise ValueError(f"hs_step: shapes syn0 {tuple(syn0.shape)} syn1 "
                         f"{tuple(syn1.shape)} block {(B, T)} cwin "
                         f"{tuple(cwin.shape)} points {tuple(points.shape)}"
                         f" labels {tuple(labels.shape)} pmask "
                         f"{tuple(pmask.shape)} window {window}")
    for name, t, want in (("syn0", syn0, torch.float32),
                          ("syn1", syn1, torch.float32),
                          ("labels", labels, torch.float32),
                          ("pmask", pmask, torch.float32),
                          ("block", block, torch.int32),
                          ("cwin", cwin, torch.int32),
                          ("points", points, torch.int32)):
        if t.dtype != want:
            raise ValueError(f"hs_step: {name} must be {want}, got "
                             f"{t.dtype}")
    require_cuda("hs_step", syn0, syn1, block, cwin, points, labels, pmask)
    if ws is None:
        ws = HSWorkspace(syn0, syn1, B * T, L)
    elif not ws.serves_hs(syn0, syn1, B * T, L):
        raise ValueError(f"hs_step: workspace for {ws.shape} with "
                         f"{ws.rows} delta rows")
    if not ws.binary_labels(labels):
        raise ValueError("hs_step: the kernel takes labels of 0 or 1 "
                         "(models/hsoftmax.py::build_huffman's)")
    launch_step(ws, syn0, syn1, block, cwin, points, labels, pmask, window,
                lr)
    return syn0, syn1


def launch_step(ws: HSWorkspace, syn0, syn1, block, cwin, points, labels,
                pmask, window: int, lr: float,
                plan: LaunchPlan | None = None, kernel: Kernel = HS_STEP
                ) -> None:
    """The step's kernel on checked tensors under `plan` (launch_plan for
    this card if none is given): gradients into ws, the update, ws
    emptied. `kernel`: HS_STEP, or a variant of its source built with the
    same entry point. A cooperative launch the card refuses raises
    KernelLaunchError."""
    B, T = block.shape
    D = syn0.shape[1]
    if plan is None:
        plan = launch_plan(D, B, T, window, _sms(syn0.device),
                           levels=points.shape[1])
    kernel.launch(
        ptr(syn0), ptr(syn1), ptr(block), ptr(cwin), ptr(points),
        ptr(labels), ptr(pmask), ws._ptrs, B, T, window, points.shape[1], D,
        plan.tile, plan.blocks, plan.smem_bytes,
        float(lr), stream(syn0.device))
