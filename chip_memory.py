"""Which device buffers make a node2vec job's peak, stored and streamed.

Runs chip_smoke.py phase 15's four CLI jobs (phase 4's walk_10k graph,
conv kB 128 and exact negatives, each stored and with --streaming true)
with torch's CUDA allocator history on, replays each job's allocations and
frees, and prints at the job's peak the live bytes by the port's innermost
call site that allocated them (file:line and the caller chain within the
port), beside the job's `report["peak_device_bytes"]`. The recorded run is
slower than an unrecorded one, so it prints no times.

    python3 chip_memory.py   # on one CUDA card: a JSON line a job, each
                             # starting {"job": ...}, among the CLI's lines
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def site(frames) -> tuple[str, str]:
    """(innermost port frame, the port's frames innermost first)."""
    mine = [f for f in frames if "stellar_rw_tpu_torch" in f["filename"]]
    name = lambda f: f"{os.path.relpath(f['filename'], ROOT)}:{f['line']}"
    if not mine:
        return "(outside the port)", ""
    return (f"{name(mine[0])} {mine[0]['name']}",
            " < ".join(name(f) for f in mine[1:]))


def job_peak(torch, cli, argv: list[str]) -> dict:
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000)
    report = {}
    if cli.main(argv, report=report) != 0:
        raise SystemExit(f"chip_memory: {argv} failed")
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, best, at_best = {}, 0, 0, {}
    for e in snap["device_traces"][torch.cuda.current_device()]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            cur += e["size"]
            if cur > best:
                best, at_best = cur, dict(live)
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])[0]
    by_site, chain = collections.Counter(), {}
    for size, frames in at_best.values():
        where, callers = site(frames)
        by_site[where] += size
        chain.setdefault(where, callers)
    return {"peak_bytes_replayed": best,
            "peak_device_bytes": report.get("peak_device_bytes"),
            "live_at_peak": [{"bytes": b, "site": w, "callers": chain[w]}
                             for w, b in by_site.most_common()]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_memory: torch sees no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from stellar_rw_tpu_torch import cli

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = cs.synth_power_law_arcs(10_000, 334_000, seed=0)
        edges = os.path.join(tmp, "blogcatalog_shaped.txt")
        np.savetxt(edges, np.stack([src, dst], 1), fmt="%d")
        for name, flags in (("conv", cs.STREAM_FLAGS),
                            ("exact", cs.STREAM_EXACT_FLAGS)):
            for mode in ("stored", "streamed"):
                out = os.path.join(tmp, f"out_{mode}_{name}")
                peak = job_peak(torch, cli, ["--input", edges, "--output",
                                             out] + flags
                                + (["--streaming", "true"]
                                   if mode == "streamed" else []))
                print(json.dumps({"job": f"{name} {mode}", **peak,
                                  "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
