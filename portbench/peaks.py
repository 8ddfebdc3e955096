"""Published peaks of one NVIDIA H100 SXM and the roofline arithmetic.

A frozen copy of chip_smoke.py's constants and `bound`: the device memory
rate, float32 outside the tensor cores (an FMA counts as two operations),
and the f32 lanes' instruction rate taken for int32 work (the card's int32
rate is not published; this one is at least it, so a bound stays a lower
bound). One threefry-2x32 draw is counted as 83 integer operations (20
rounds of add, rotate, xor; 5 key injections of 3 adds; 4 to open it; 4 to
make the float).
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT_OPS_PER_S = F32_FLOPS / 2
OPS_PER_DRAW = 20 * 3 + 5 * 3 + 4 + 4


def bound_seconds(nbytes: float, flops: float = 0.0,
                  int_ops: float = 0.0) -> float:
    """The least time the card could take for this work: the larger of the
    bytes over the memory rate and each kind of operation over its peak."""
    return max(nbytes / MEM_BYTES_PER_S, flops / F32_FLOPS,
               int_ops / INT_OPS_PER_S)
