"""The device trace of a run's traced calls, read from torch.profiler.

A traced run profiles the window's calls that start in its first
TRACE_SECONDS, with CUDA activity alone: the kernels, copies and sets on
the device, and the host's CUDA runtime calls. (CPU activity, which records
every torch operation, made a trainer job 2.5x slower on the card; CUDA
activity alone 1.2x.) Then it runs the rest of the window untraced. From
the profiler's events: the traced window (the first event's start to the
last one's end), the seconds in which any operation ran on the device, each
kernel source's summed device time, the device operations that took most
time, and the longest idle gaps by the runtime call that spans them.
Nothing is written to disk.
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

TRACE_SECONDS = 2.0
HOST_CODE = "(host code between CUDA calls)"


class Event(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    calls: int
    device: list         # Event of every device operation in the window
    host: list           # Event of every CUDA runtime call in the window

    def seconds_of(self, pattern: re.Pattern) -> float:
        return sum(e.end - e.start for e in self.device
                   if pattern.search(e.name)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0) + e.end - e.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
                "idle_gaps": [[n[:200], t / 1e9]
                              for n, t in self.idle_gaps(top)]}

    def idle_gaps(self, top: int = 10) -> list:
        """(host operation, ns) of the `top` longest gaps between device
        operations in the window; the host operation is the innermost
        runtime call that spans the gap's middle, else HOST_CODE."""
        lo = min(e.start for e in self.device + self.host)
        hi = max(e.end for e in self.device + self.host)
        gaps, end = [], lo
        for e in sorted(self.device, key=lambda e: e.start):
            if e.start > end:
                gaps.append((end, e.start))
            end = max(end, e.end)
        if hi > end:
            gaps.append((end, hi))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) // 2
            spans = [h for h in self.host if h.start <= mid <= h.end]
            name = (min(spans, key=lambda h: h.end - h.start).name
                    if spans else HOST_CODE)
            out.append((name, b - a))
        return out


def summarize(prof, calls: int) -> Trace:
    """The Trace of a finished torch.profiler.profile over `calls` calls."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (device if "CUDA" in str(e.device_type()) else host).append(ev)
    if not device:
        raise RuntimeError("the trace holds no device operation")
    lo = min(e.start for e in device + host)
    hi = max(e.end for e in device + host)
    busy, end = 0, lo
    for e in sorted(device, key=lambda e: e.start):
        a, b = max(e.start, end), e.end
        if b > a:
            busy += b - a
            end = b
    return Trace((hi - lo) / 1e9, busy / 1e9, calls, device, host)


@lru_cache(maxsize=None)
def source_pattern(source: str) -> re.Pattern:
    """The trace names of the kernels that a CUDA source of the program
    defines: every __global__ function of csrc/<source>, matched as a
    symbol, so that a kernel split or renamed inside the file stays
    counted."""
    import stellar_rw_tpu_torch

    text = (Path(stellar_rw_tpu_torch.__file__).parent / "csrc" / source
            ).read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
        text)
    if not names:
        raise ValueError(f"csrc/{source} defines no kernel")
    alts = "|".join(sorted(set(names)))
    return re.compile(rf"(?:^|[\s:])(?:{alts})[<(]")
