#!/usr/bin/env python3
"""Where the GNN-feed segment sum's time goes on one GPU: csrc/spmm.cu with
one part changed at a time, beside the first design's kernel and
torch.sparse.mm.

    python3 chip_spmm_parts.py [OTHER_CHECKOUT]

A variant is csrc/spmm.cu with pieces of text replaced (VARIANTS; a piece
that is not exactly once in the source stops the script), built under
build/spmm_parts/ and launched through ops/spmm.py::segment_sum (under the
grid of its own blocks an SM where it changes them). A variant that keeps
the design is held to the float64 plain version (rtol 1e-5, atol 1e-5, as
chip_smoke's phase 20 holds the kernels) before it is timed; one with a
part taken out is timed alone. The parts:

  * the rows a lane has in flight (kRows): 4, 8 (base), 16;
  * the blocks an SM (kSegBlocks, the register cap of __launch_bounds__
    and the persistent grid): 2, 3 (base), 4;
  * a float a lane (32 lanes a row) in place of a 16-byte load;
  * a split segment's partials: groups of kFan 8, 16 (base) or 32, or
    every partial summed by the one warp that arrives last (the first
    design's combine, with kFan loads in flight);
  * taken out: the split segments' combine, all but the launch;
  * with OTHER_CHECKOUT (the parent commit unpacked under build/, as for
    chip_compare.py), the first design's kernel: a warp an item, a float
    a lane, 8 rows in flight, its partials summed by the warp that arrives
    last.

Each is timed on bench.py::measure_spmm's graph (chip_smoke's
synth_power_law_graph(10_000, 334_000, seed=0), 664,650 arcs) at D 128
and 64, on the CSR order (spmm) and on the transposed order (its
backward), with items of 128 and 256 arcs: mean device ms of 20 launches
back to back (chip_smoke's cuda_ms), every variant twice, in turns, beside
torch.sparse.mm on the same CSR matrix. One JSON object a line, the card's
name and power limit in each, and ptxas' registers of every variant.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_compare import load_package
from chip_smoke import (check, cuda_ms, edited, source_kernel,
                        synth_power_law_graph)

ROWS = ("constexpr int kRows = 8;", "constexpr int kRows = {};")
BLOCKS = ("constexpr int kSegBlocks = 3;", "constexpr int kSegBlocks = {};")
FAN = ("constexpr int kFan = 16;", "constexpr int kFan = {};")
# name -> [(text in csrc/spmm.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    **{f"kRows {n}": [(ROWS[0], ROWS[1].format(n))] for n in (4, 16)},
    **{f"{n} blocks an SM": [(BLOCKS[0], BLOCKS[1].format(n))]
       for n in (2, 4)},
    "a float a lane": [
        ("  const bool vec = D % 4 == 0 &&",
         "  const bool vec = D < 0 &&")],
    **{f"kFan {n}": [(FAN[0], FAN[1].format(n))] for n in (8, 32)},
    "the partials summed by the warp that arrives last": [
        ("    const int n_grp = (n_seg + kFan - 1) / kFan;\n"
         "    const int g0 = p0 + (k / kFan) * kFan;    // the group's first "
         "row\n"
         "    const int g_n = min(kFan, p0 + n_seg - g0);",
         "    const int n_grp = 1;\n"
         "    const int g0 = p0 + 0 * k;\n"
         "    const int g_n = n_seg;")],
    "taken out: the split segments' combine": [
        ("    if (part < 0) continue;\n    // a split segment:",
         "    continue;\n    // a split segment:")],
    "taken out: all but the launch": [
        ("  const int warps = gridDim.x * kWarps;\n"
         "  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); "
         "it < n_items;",
         "  const int warps = gridDim.x * kWarps;\n"
         "  if (D > 0) return;\n"
         "  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); "
         "it < n_items;")],
}
WRONG_BY_DESIGN = {name for name in VARIANTS if name.startswith("taken")}
OTHER = "the first design's kernel (the other checkout)"
CHUNKS = (128, 256)


def blocks_per_sm(edits) -> int | None:
    """The blocks an SM a variant's source asks for, where it changes them."""
    for old, new in edits:
        if old == BLOCKS[0]:
            return int(new.split("=")[1].strip(" ;"))
    return None


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_spmm_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import spmm as sp

    other = (load_package(os.path.realpath(argv[0]), "srw_other")("ops.spmm")
             if argv else None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    k = sp.SPMM_SEGMENT_SUM
    text = k.path.read_text()
    kernels = {name: source_kernel(f"spmm_{i}", edited(text, edits),
                                   k.symbol, k.argtypes, "spmm_parts")
               for i, (name, edits) in enumerate(VARIANTS.items())}
    builds = list(kernels.values()) + ([other.SPMM_SEGMENT_SUM] if other
                                       else [])
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda k: k.fn(), builds))
    for name, kern in kernels.items():
        regs = [line.strip() for line in kern.build_log.splitlines()
                if "segment_sum" in line or "registers" in line]
        print(json.dumps({"variant": name, "ptxas": regs, "card": smi}))
    names = [*VARIANTS, *([OTHER] if other else [])]
    g = synth_power_law_graph(10_000, 334_000, seed=0)
    V = g.num_vertices
    rng = np.random.default_rng(0)
    base_blocks = sp.SEGMENT_BLOCKS_PER_SM

    def launch(name, es, order, x):
        if name == OTHER:
            oes = other_es[es.csr.chunk]
            if order == "csr":
                return other.segment_sum(oes.csr, x, idx=oes.col,
                                         w=oes.weight)
            return other.segment_sum(oes.trans, x, idx=oes.t_row,
                                     w=oes.weight, widx=oes.t_order)
        sp.SEGMENT_BLOCKS_PER_SM = (blocks_per_sm(VARIANTS[name])
                                    or base_blocks)
        try:
            if order == "csr":
                return sp.segment_sum(es.csr, x, idx=es.col, w=es.weight,
                                      kernel=kernels[name])
            return sp.segment_sum(es.trans, x, idx=es.t_row, w=es.weight,
                                  widx=es.t_order, kernel=kernels[name])
        finally:
            sp.SEGMENT_BLOCKS_PER_SM = base_blocks

    other_es = ({c: other.EdgeStructure.from_csr(g, chunk=c) for c in CHUNKS}
                if other else {})
    for D in (128, 64):
        x = torch.as_tensor(rng.standard_normal((V, D)).astype(np.float32)
                            ).cuda()
        for chunk in CHUNKS:
            es = sp.EdgeStructure.from_csr(g, chunk=chunk)
            want = {"csr": sp.spmm_ref(es, x.double()),
                    "transposed": torch.zeros_like(x, dtype=torch.float64)
                    .index_add_(0, es.col, x.double()[es.row]
                                * es.weight.double()[:, None])}
            for order in ("csr", "transposed"):
                err = {}
                for name in names:
                    if name in WRONG_BY_DESIGN:
                        continue
                    got = launch(name, es, order, x).double()
                    err[name] = float((got - want[order]).abs().max())
                    check(torch.allclose(got, want[order], rtol=1e-5,
                                         atol=1e-5),
                          f"{name} differs from float64 at D {D} chunk "
                          f"{chunk} ({order}): max abs err {err[name]:.3g}")
                ms = {name: [] for name in names}
                for _ in range(2):
                    for name in names:
                        ms[name].append(cuda_ms(
                            lambda: launch(name, es, order, x), 20))
                for name in names:
                    print(json.dumps({"D": D, "chunk": chunk, "order": order,
                                      "variant": name, "ms_in_turns":
                                      ms[name], "max_abs_err_f64":
                                      err.get(name), "card": smi}))
        csr = torch.sparse_csr_tensor(es.csr.offsets, es.col, es.weight,
                                      size=(V, V))
        print(json.dumps({"D": D, "library": "torch.sparse.mm",
                          "ms_in_turns": [cuda_ms(lambda: torch.sparse.mm(
                              csr, x), 20) for _ in range(2)],
                          "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
