"""One run of one cell: set-up, the measured window, the check, the line.

The window drives the cell's entry back to back for `seconds` and ends at
the end of the call in flight; only completed calls count, and the window's
length is the host clock's from the first call's start to the last one's
end. With trace, the calls that start in the window's first
trace.TRACE_SECONDS run under torch.profiler and the per-layer metrics are
read from them; without, the end-to-end metrics are reported. After the
window: the modules loaded are checked for JAX, the device's peak memory
is read, and then the reference checks what the window produced.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

from . import spec
from .trace import TRACE_SECONDS, summarize

FORBIDDEN = {"jax", "jaxlib", "flax", "stellar_rw_tpu"}


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_start() -> float | None:
    """The wall-clock time at which this process started: its start in
    clock ticks after boot against the seconds since boot (both to 10 ms),
    or None where /proc does not say."""
    try:
        import os
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class RunView:
    """What a per-layer metric's reader sees of a run (metrics/*.py):
    the entry (its kind and what it counts), the host prep, the trace, the
    facts the check gathered, the window's calls and seconds, and
    (untraced_calls, untraced_s) of the window after the trace."""

    def __init__(self, entry, trace, facts, calls, window_s,
                 untraced=(0, 0.0)):
        self.entry = entry
        self.kind = entry.kind
        self.sampler = getattr(entry, "sampler", None)
        self.host_prep_s = entry.host_prep_s
        self.trace = trace
        self.facts = facts
        self.calls = calls
        self.window_s = window_s
        self.untraced_calls, self.untraced_s = untraced

    def bound_per_call(self) -> float:
        return self.entry.bound_per_call(self.facts)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench: dict | None = None, base: Path = spec.HERE,
             started: float | None = None, patch=None) -> dict:
    """The result line of one run, as a dict. `patch`, given, is called
    with the entry after set-up (the tests' faults)."""
    started = time.time() if started is None else started
    bench = spec.benchmark() if bench is None else bench
    cell = spec.cell(name, bench, base)
    dev = torch.device(device)
    entry = spec.entry_module(cell["workload"]["entry"], base).make(
        cell, seed, dev)
    entry.setup()
    if patch is not None:
        patch(entry)
    entry.warmup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - started

    prof = None
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    traced = None
    calls = 0
    t0 = time.perf_counter()
    after_trace = (0, t0)
    while True:
        entry.call(calls)
        calls += 1
        elapsed = time.perf_counter() - t0
        if prof is not None and (elapsed >= TRACE_SECONDS
                                 or elapsed >= seconds):
            prof.__exit__(None, None, None)
            traced, prof = prof, None
            after_trace = (calls, time.perf_counter())
        if elapsed >= seconds:
            break
    t_end = time.perf_counter()
    window_s = t_end - t0
    # the calls after the traced ones, which the profiler did not slow
    untraced = (calls - after_trace[0], t_end - after_trace[1])

    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"loaded after the window: {bad}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    tr = summarize(traced, after_trace[0]) if traced is not None else None
    del traced
    t_check = time.perf_counter()
    numbers, facts = entry.check()
    facts["check_s"] = time.perf_counter() - t_check
    limits = cell["workload"]["check"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    e2e = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9,
           **entry.end_to_end(calls, window_s)}
    metrics = {}
    if trace:
        view = RunView(entry, tr, facts, calls, window_s, untraced)
        reported = {m["name"] for m in bench["end_to_end"]
                    if spec.applies(m, name) and m["name"] in e2e}
        for m in bench["per_layer"]:
            if "workloads" in m:
                if name not in m["workloads"]:
                    continue
            elif m["moves"] not in reported:
                continue
            value = spec.metric_reader(m["name"], base)(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if spec.applies(m, name):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": (power_limit_w() if dev.type == "cuda"
                                     else None)}
    line = {"correct": correct, "attempted": calls, "failed": 0,
            "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["facts"] = {"window_s": window_s, "setup_s": setup_s,
                     "host_prep_s": entry.host_prep_s, **facts}
    line["checks"] = checks
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"loaded by the end of the run: {bad}")
    return line
