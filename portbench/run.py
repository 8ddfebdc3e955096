"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (stellar_rw_tpu_torch).
The last line of standard output is the run's JSON result; the numbers
compared for `correct`, each with its limit, are the last lines of standard
error. Exits with another code than 0, and prints no result, without the
CUDA cards the cell asks for, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

_CLOCK = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

# the compile caches of anything the run builds: fixed places in the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(spec.ROOT / "build" / _dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .harness import ForbiddenImport, process_start, run_cell

    started = process_start()
    if started is None or not _CLOCK - 60 < started <= _CLOCK:
        started = _CLOCK    # no /proc, or one that disagrees with the clock
    bench = spec.benchmark()
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", bench, started=started)
    except ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
