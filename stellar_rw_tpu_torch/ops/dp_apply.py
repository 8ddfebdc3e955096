"""The data-parallel trainer's merged update: kernel and plain version.

A merged update of the data-parallel trainer (models/word2vec.py,
parallel/dp.py) runs each of its slots' steps in accumulate mode: their
gradient sums and counts go into one reduction buffer instead of the
tables. `dp_apply(w_in, w_out, buffer, lr)` then moves every row of both
tables by lr times the mean of its gradients,

    w = w - (lr * acc) / max(cnt, 1)

in the order of the JAX package's psum'd step
(stellar_rw_tpu/models/word2vec.py:200-201, :485-486), and empties the
buffer. The buffer is one flat tensor of 2·V·D + 2·V elements, so that
one all-reduce sums it across ranks: acc_in [V, D] | acc_out [V, D] |
cnt_in [V] | cnt_out [V]. This module alone knows that layout: the
kernels get the four arrays (buffer_ptrs) as pointers of their own.

CUDA tensors launch csrc/dp_apply.cu, which reads the 2·V counts and
moves, and zeroes, only the rows whose count is not 0 (sectors of 4 rows
dealt to the warps in turn, launch_plan); CPU tensors run dp_apply_ref, the
dense expression, in the tables' dtype. A row whose count is 0 has acc
exactly 0 in every buffer the steps' accumulate modes fill (each gradient
comes with a count), so the dense expression leaves it as it is too. Both
round each operation once in the same order, so they agree bit for bit in
float32 on such a buffer; on a buffer with acc not 0 at a count of 0 they
differ (the kernel leaves that row and its acc).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import Kernel, ptr, require_cuda, stream
from ._build import sm_count as _sms

DP_APPLY = Kernel("dp_apply.cu", "srw_dp_apply_launch",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                  + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])

THREADS = 128            # kThreads in the source: 4 warps
SECTOR = 4               # kSector: the rows of a lane's count load
BLOCKS_PER_SM = 5        # kBlocksPerSm: the launch bounds' resident blocks
H100_SMS = 132           # launch_plan's default; the wrapper asks the device


def launch_plan(V: int, sm_count: int = H100_SMS) -> int:
    """The blocks of csrc/dp_apply.cu for tables of V rows: a warp a
    sector of SECTOR of the 2·V rows where one wave of resident blocks
    (BLOCKS_PER_SM an SM) holds that many warps, else one wave, its warps
    taking the sectors in turn."""
    sectors = -(-2 * V // SECTOR)
    return max(1, min(-(-sectors // (THREADS // 32)),
                      BLOCKS_PER_SM * sm_count))


def buffer_numel(V: int, D: int) -> int:
    """Elements of the reduction buffer for tables [V, D]."""
    return 2 * V * D + 2 * V


def _starts(buffer: torch.Tensor, V: int, D: int) -> tuple[int, ...]:
    """The first elements of acc_in, acc_out, cnt_in, cnt_out in the flat
    buffer, whose size is checked against tables [V, D]."""
    if buffer.shape != (buffer_numel(V, D),):
        raise ValueError(f"reduction buffer of {tuple(buffer.shape)} "
                         f"elements for tables [{V}, {D}]")
    return 0, V * D, 2 * V * D, 2 * V * D + V


def buffer_views(buffer: torch.Tensor, V: int, D: int):
    """(acc_in [V, D], acc_out [V, D], cnt_in [V], cnt_out [V]): views of
    the flat buffer."""
    a, b, c, d = _starts(buffer, V, D)
    return (buffer[a:b].view(V, D), buffer[b:c].view(V, D), buffer[c:d],
            buffer[d:])


def buffer_ptrs(buffer: torch.Tensor, V: int, D: int):
    """The addresses of buffer_views' four arrays in a contiguous buffer,
    for a kernel's arguments: no views made on a step's host path."""
    base, size = buffer.data_ptr(), buffer.element_size()
    return tuple(ctypes.c_void_p(base + i * size)
                 for i in _starts(buffer, V, D))


def f32_lr(lr: float) -> float:
    """The learning rate as the float32 the JAX step multiplies by."""
    return float(np.float32(lr))


def dp_apply_ref(w_in, w_out, buffer, lr: float):
    """Plain torch version, in place, in the tables' dtype."""
    V, D = w_in.shape
    lr = f32_lr(lr)
    acc_in, acc_out, cnt_in, cnt_out = buffer_views(buffer, V, D)
    for w, acc, cnt in ((w_in, acc_in, cnt_in), (w_out, acc_out, cnt_out)):
        w.sub_((lr * acc) / cnt.clamp_min(1.0)[:, None])
    buffer.zero_()
    return w_in, w_out


def dp_apply(w_in, w_out, buffer, lr: float):
    """The merged update in place (see the module). CUDA tensors launch
    csrc/dp_apply.cu, which reads no row whose count is 0 (its acc must be
    0, as every accumulate step leaves it); CPU tensors run dp_apply_ref."""
    if w_in.device.type == "cpu":
        return dp_apply_ref(w_in, w_out, buffer, lr)
    DP_APPLY.fn()
    V, D = w_in.shape
    if w_out.shape != (V, D):
        raise ValueError(f"dp_apply: tables {tuple(w_in.shape)} and "
                         f"{tuple(w_out.shape)}")
    for name, t in (("w_in", w_in), ("w_out", w_out), ("buffer", buffer)):
        if t.dtype != torch.float32:
            raise ValueError(f"dp_apply: {name} must be float32, got "
                             f"{t.dtype}")
    require_cuda("dp_apply", w_in, w_out, buffer)
    # the counts as one [2V] array: cnt_in, then cnt_out
    acc_in, acc_out, cnt, _ = buffer_ptrs(buffer, V, D)
    DP_APPLY.launch(ptr(w_in), ptr(w_out), acc_in, acc_out, cnt, V, D,
                    f32_lr(lr), launch_plan(V, _sms(w_in.device)),
                    stream(w_in.device))
    return w_in, w_out
