#!/usr/bin/env python3
"""Where the GNN-feed segment sum's time goes on one GPU: csrc/spmm.cu with
one part changed at a time, beside torch.sparse.mm.

    python3 chip_spmm_parts.py

A variant is csrc/spmm.cu with pieces of text replaced (VARIANTS; a piece
that is not exactly once in the source stops the script), built under
build/spmm_parts/ and launched through ops/spmm.py::segment_sum. A variant
that keeps the design is held to the float64 plain version (rtol 1e-5,
atol 1e-5, as chip_smoke's phase 20 holds the kernels) before it is timed;
one with a part taken out is timed alone. The parts:

  * the gathered rows a lane has in flight (kRows): 1, 2, 4, 8 (base), 16;
  * the sums in float instead of double (not held to float64: its error
    is printed beside its time);
  * taken out: all but the launch.

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
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (check, cuda_ms, edited, source_kernel,
                        synth_power_law_graph)

ROWS = ("constexpr int kRows = 8;", "constexpr int kRows = {};")
# name -> [(text in csrc/spmm.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    **{f"kRows {n}": [(ROWS[0], ROWS[1].format(n))] for n in (1, 2, 4, 16)},
    "sums in float": [
        ("      double acc[NV];\n", "      float acc[NV];\n"),
        ("              acc[m] = fma(wv[q], static_cast<double>(v[q][m]), "
         "acc[m]);",
         "              acc[m] = fmaf(static_cast<float>(wv[q]), v[q][m], "
         "acc[m]);")],
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
# sums in f32 are not held to float64 (that is why the kernel sums in
# double): their error is printed beside their time
NOT_HELD = {"sums in float"}
CHUNKS = (128, 256)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_spmm_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import spmm as sp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    k = sp.SPMM_SEGMENT_SUM
    text = k.path.read_text()
    kernels = {name: source_kernel(f"spmm_{i}", edited(text, edits),
                                   k.symbol, k.argtypes, "spmm_parts")
               for i, (name, edits) in enumerate(VARIANTS.items())}
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.fn(), kernels.values()))
    for name, kern in kernels.items():
        regs = [line.strip() for line in kern.build_log.splitlines()
                if "segment_sum" in line or "registers" in line]
        print(json.dumps({"variant": name, "ptxas": regs, "card": smi}))
    g = synth_power_law_graph(10_000, 334_000, seed=0)
    V = g.num_vertices
    rng = np.random.default_rng(0)
    for D in (128, 64):
        x = torch.as_tensor(rng.standard_normal((V, D)).astype(np.float32)
                            ).cuda()
        for chunk in CHUNKS:
            es = sp.EdgeStructure.from_csr(g, chunk=chunk)
            orders = {
                "csr": lambda kern: sp.segment_sum(
                    es.csr, x, idx=es.col, w=es.weight, kernel=kern),
                "transposed": lambda kern: sp.segment_sum(
                    es.trans, x, idx=es.t_row, w=es.weight, widx=es.t_order,
                    kernel=kern)}
            want = {"csr": sp.spmm_ref(es, x.double()),
                    "transposed": torch.zeros_like(x, dtype=torch.float64)
                    .index_add_(0, es.col, x.double()[es.row]
                                * es.weight.double()[:, None])}
            for order, fn in orders.items():
                err = {}
                for name in VARIANTS:
                    if name in WRONG_BY_DESIGN:
                        continue
                    got = fn(kernels[name]).double()
                    err[name] = float((got - want[order]).abs().max())
                    check(name in NOT_HELD or torch.allclose(
                              got, want[order], rtol=1e-5, atol=1e-5),
                          f"{name} differs from float64 at D {D} chunk "
                          f"{chunk} ({order}): max abs err {err[name]:.3g}")
                ms = {name: [] for name in VARIANTS}
                for _ in range(2):
                    for name in VARIANTS:
                        ms[name].append(cuda_ms(
                            lambda: fn(kernels[name]), 20))
                for name in VARIANTS:
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
    sys.exit(main())
