"""The control of a cell's comparison, run at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--seconds <s>] [--wrong <name> ...]

For each seed: the cell's set-up, its entry driven for `seconds` as a run's
window drives it, then the numbers its check compares: once for the
program's output (the lower readings), and once for each wrong program
named, the plain reference put in the program's place (the upper
readings). The control is the reference computed in the precision below
the configuration's: "bf16" for the walks' float32, "tf32" for the
trainer's float32 with TF32 off; "half" is the trainer's planted fault of
half of every block left out. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import spec


def control(name: str, seed: int, seconds: float, wrongs=None,
            device="cuda", bench=None, base=spec.HERE) -> dict:
    """wrongs None: the entry's control alone."""
    cell = spec.cell(name, bench, base)
    module = spec.entry_module(cell["workload"]["entry"], base)
    wrongs = (module.CONTROL,) if wrongs is None else wrongs
    entry = module.make(cell, seed, torch.device(device))
    entry.setup()
    entry.warmup()
    calls, t0 = 0, time.perf_counter()
    while True:
        entry.call(calls)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    program, facts = entry.check()
    out = {"workload": name, "seed": seed, "calls": calls,
           "program": program, "facts": facts,
           "check_s": time.perf_counter() - t1}
    for wrong in wrongs:
        t1 = time.perf_counter()
        out[wrong] = entry.check(wrong)[0]
        out[f"{wrong}_s"] = time.perf_counter() - t1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--wrong", nargs="*", default=None,
                    help="the wrong programs to read (default: the "
                    "entry's CONTROL: bf16 for a walk cell, tf32 for a trainer)")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    seconds = (bench["run_seconds"] if args.seconds is None
               else args.seconds)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, seconds, args.wrong,
                                 "cuda", bench)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
