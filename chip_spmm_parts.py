#!/usr/bin/env python3
"""Where the GNN-feed kernels' time goes on one GPU: csrc/spmm.cu with one
part changed at a time, beside the other checkout's kernels and the
library calls.

    python3 chip_spmm_parts.py [OTHER_CHECKOUT]

A variant is csrc/spmm.cu with pieces of text replaced (VARIANTS; a piece
that is not exactly once in the source stops the script), built under
build/spmm_parts/ and launched through ops/spmm.py::segment_sum,
sddmm_rows or row_softmax (under the grid of its own blocks an SM where
it changes them). A variant that keeps the design is held to the float64
plain version (rtol 1e-5, atol 1e-5, as chip_smoke's phase 20 holds the
kernels; the softmax atol 1e-6, as phase 20 holds the split rows) before
it is timed; one whose precision is the question (PRECISION) has its
error printed beside whether it holds; one with a part taken out is timed
alone. The segment sum's parts (VARIANTS):

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

The SDDMM's (SDDMM_VARIANTS):

  * rows in flight a lane (kDotRows): 2, 4 (base), 8;
  * blocks an SM (kDotBlocks): 2, 3 (base), 4;
  * the dots' precision: products in double (the first design's), or the lanes'
    shares summed in float (Sum = float);
  * items of 32, 64 (base) and 128 arcs;
  * a float a lane in place of a 16-byte load;
  * taken out: the transposed butterfly's later steps, all but the launch;
  * with OTHER_CHECKOUT, its kernel (the first design: a warp an item,
    the arcs one at a time, a dot in double).

The row softmax's (SOFTMAX_VARIANTS), forward and backward modes:

  * the split rows' second pass after a grid barrier in one cooperative
    launch (all blocks resident: kSoftBlocks an SM) in place of a second
    launch, or in an ordinary second launch in place of a programmatic
    dependent one;
  * blocks an SM (kSoftBlocks): 4, 6 (base), 8;
  * a split row's partials a lane has in flight in the second pass
    (kLoads): 1 (the loads one after another), 4 (base), 8, 16;
  * items of 64 arcs (the base's source);
  * __expf in place of expf;
  * taken out: the split rows' second pass, all but the launch;
  * with OTHER_CHECKOUT, its kernel (the first design: a warp a row).

Each is timed on bench.py::measure_spmm's graph (chip_smoke's
synth_power_law_graph(10_000, 334_000, seed=0), 664,650 arcs): the
segment sum at D 128 and 64, on the CSR order (spmm) and on the
transposed order (its backward), with items of 128 and 256 arcs; the
SDDMM at D 128 and 64, the softmax on N(0, 1) scores x3 (and x30 for the
error), both with items of 128: mean device ms of 20 launches back to
back (chip_smoke's cuda_ms), every variant twice, in turns, beside
torch.sparse.mm, sampled_addmm and torch.sparse.softmax. One JSON object
a line, the card's name and power limit in each, and ptxas' registers of
every variant. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

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
        ("  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(xx) "
         "% 16 == 0;",
         "  const bool vec = D < 0;")],
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
        ("  Arc* stage = stage_all[threadIdx.x >> 5];\n"
         "  const int warps = gridDim.x * kWarps;\n",
         "  Arc* stage = stage_all[threadIdx.x >> 5];\n"
         "  const int warps = gridDim.x * kWarps;\n"
         "  if (D > 0) return;\n")],
}
DOT_ROWS = ("constexpr int kDotRows = 4;", "constexpr int kDotRows = {};")
DOT_BLOCKS = ("constexpr int kDotBlocks = 3;",
              "constexpr int kDotBlocks = {};")
SDDMM_VARIANTS = {
    "base": [],
    **{f"kDotRows {n}": [(DOT_ROWS[0], DOT_ROWS[1].format(n))]
       for n in (2, 8)},
    **{f"{n} blocks an SM": [(DOT_BLOCKS[0], DOT_BLOCKS[1].format(n))]
       for n in (2, 4)},
    "products in double": [("using Part = float; ", "using Part = double;")],
    "lanes' shares summed in float": [("using Sum = double; ",
                                       "using Sum = float;  ")],
    "a float a lane": [
        ("reinterpret_cast<uintptr_t>(yy) % 16 == 0;",
         "reinterpret_cast<uintptr_t>(yy) % 16 == 0 && D < 0;")],
    "taken out: the butterfly's later steps": [
        ("      if constexpr (H > 1) fold<H / 2>(s, r);\n      const int j",
         "      const int j")],
    "taken out: all but the launch": [
        ("  const int r = lane % G;\n  const int warps = gridDim.x * kWarps;",
         "  const int r = lane % G;\n  const int warps = gridDim.x * kWarps;"
         "\n  if (D > 0) return;")],
}
LOADS = ("constexpr int kLoads = 4;", "constexpr int kLoads = {};")
SOFT_BLOCKS = ("constexpr int kSoftBlocks = 6;",
               "constexpr int kSoftBlocks = {};")
SOFTMAX_VARIANTS = {
    "base": [],
    # pass 3: both passes, a grid barrier between them
    "one cooperative launch": [
        ("#include <cuda_runtime.h>",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>"),
        ("  if (!(pass & 2)) return;",
         "  if (pass == 3) cooperative_groups::this_grid().sync();\n"
         "  if (!(pass & 2)) return;"),
        ("  row_softmax<<<blocks, kThreads, 0, st>>>(",
         "  if (parts > 0) {\n"
         "    int pass = 3;\n"
         "    void* args[] = {&o, &aa, &dd, &n_items, &sa, &pt, &pd, &parts,"
         " &pa, &mode, &pass};\n"
         "    return static_cast<int>(cudaLaunchCooperativeKernel(\n"
         "        reinterpret_cast<const void*>(row_softmax), dim3(blocks),\n"
         "        dim3(kThreads), args, 0, st));\n"
         "  }\n"
         "  row_softmax<<<blocks, kThreads, 0, st>>>(")],
    "the second launch an ordinary one": [
        ("programmaticStreamSerializationAllowed = 1;",
         "programmaticStreamSerializationAllowed = 0;")],
    **{f"{n} blocks an SM": [(SOFT_BLOCKS[0], SOFT_BLOCKS[1].format(n))]
       for n in (4, 8)},
    **{f"kLoads {n}": [(LOADS[0], LOADS[1].format(n))] for n in (1, 8, 16)},
    "__expf": [("{ return expf(v); }", "{ return __expf(v); }")],
    "taken out: the split rows' second pass": [
        ("  if (parts == 0) return static_cast<int>(cudaGetLastError());",
         "  if (parts >= 0) return static_cast<int>(cudaGetLastError());")],
    "taken out: all but the launch": [
        ("  const int warps = gridDim.x * kWarps;\n  float v[kPer], w[kPer];",
         "  const int warps = gridDim.x * kWarps;\n  float v[kPer], w[kPer];"
         "\n  if (mode >= 0) return;")],
}
WRONG_BY_DESIGN = {name for table in (VARIANTS, SDDMM_VARIANTS,
                                      SOFTMAX_VARIANTS)
                   for name in table if name.startswith("taken")}
# variants whose error against float64 is the question: printed, not held
PRECISION = {"lanes' shares summed in float"}
OTHER = "the first design's kernel (the other checkout)"
OTHER_SDDMM = "the other checkout's kernel"
OTHER_SOFTMAX = OTHER_SDDMM
CHUNKS = (128, 256)
# the base kernels over items of other lengths
ITEMS = {f"items of {n} arcs": n for n in (32, 128)}
SOFT_ITEMS = "items of 64 arcs"


def blocks_per_sm(edits, which=BLOCKS) -> int | None:
    """The blocks an SM a variant's source asks for, where it changes them
    (`which`: the constant's line and its pattern)."""
    for old, new in edits:
        if old == which[0]:
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
    text = sp.SPMM_SEGMENT_SUM.path.read_text()

    def variants(table, k, tag):
        return {name: source_kernel(f"{tag}_{i}", edited(text, edits),
                                    k.symbol, k.argtypes, "spmm_parts")
                for i, (name, edits) in enumerate(table.items())}
    kernels = variants(VARIANTS, sp.SPMM_SEGMENT_SUM, "spmm")
    sddmm_kernels = variants(SDDMM_VARIANTS, sp.SPMM_SDDMM, "sddmm")
    softmax_kernels = variants(SOFTMAX_VARIANTS, sp.SPMM_ROW_SOFTMAX,
                               "softmax")
    builds = [*kernels.values(), *sddmm_kernels.values(),
              *softmax_kernels.values(),
              *([other.SPMM_SEGMENT_SUM] if other else [])]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda k: k.fn(), builds))
    for kernel, table in (("segment_sum", kernels),
                          ("sddmm_rows", sddmm_kernels),
                          ("row_softmax", softmax_kernels)):
        for name, kern in table.items():
            regs = [line.strip() for line in kern.build_log.splitlines()
                    if kernel in line or "registers" in line
                    or "spill" in line]
            print(json.dumps({"kernel": kernel, "variant": name,
                              "ptxas": regs, "card": smi}))
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
    es = sp.EdgeStructure.from_csr(g)
    oes = other.EdgeStructure.from_csr(g) if other else None
    parts_sddmm(torch, sp, other, es, oes, sddmm_kernels, rng, smi)
    parts_softmax(torch, sp, other, es, oes, softmax_kernels, rng, smi)
    return 0


def in_turns(torch, names, launch, want, atol, what, smi, **key) -> None:
    """Each of `names` held to float64 (`want`) unless wrong by design,
    then timed twice in turns; one JSON line each."""
    err, held = {}, {}
    for name in names:
        if name in WRONG_BY_DESIGN:
            continue
        got = launch(name).double()
        err[name] = float((got - want).abs().max())
        held[name] = bool(torch.allclose(got, want, rtol=1e-5, atol=atol))
        check(held[name] or name in PRECISION,
              f"{name} differs from float64 ({what}): max abs err "
              f"{err[name]:.3g}")
    ms = {name: [] for name in names}
    for _ in range(2):
        for name in names:
            ms[name].append(cuda_ms(lambda: launch(name), 20))
    for name in names:
        print(json.dumps({**key, "variant": name, "ms_in_turns": ms[name],
                          "max_abs_err_f64": err.get(name),
                          "held": held.get(name), "card": smi}))


def parts_sddmm(torch, sp, other, es, oes, kernels, rng, smi) -> None:
    """The SDDMM's variants at D 128 and 64, beside the other checkout's
    kernel and sampled_addmm."""
    V = es.num_vertices
    names = [*kernels, *ITEMS, *([OTHER_SDDMM] if other else [])]
    base_blocks = sp.SDDMM_BLOCKS_PER_SM
    by_items = {name: replace(es, dots=sp.Order.build(
        es.csr.offsets.cpu().numpy(), "cuda", chunk))
        for name, chunk in ITEMS.items()}
    for D in (128, 64):
        x, y = (torch.as_tensor(rng.standard_normal((V, D)).astype(
            np.float32)).cuda() for _ in range(2))

        def launch(name):
            if name == OTHER_SDDMM:
                return other.sddmm_rows(oes, x, y)
            if name in ITEMS:
                return sp.sddmm_rows(by_items[name], x, y)
            sp.SDDMM_BLOCKS_PER_SM = (blocks_per_sm(SDDMM_VARIANTS[name],
                                                    DOT_BLOCKS)
                                      or base_blocks)
            try:
                return sp.sddmm_rows(es, x, y, kernel=kernels[name])
            finally:
                sp.SDDMM_BLOCKS_PER_SM = base_blocks
        in_turns(torch, names, launch,
                 sp.sddmm_ref(es, x.double(), y.double()), 1e-5,
                 f"sddmm D {D}", smi, kernel="sddmm_rows", D=D)
        ones = torch.sparse_csr_tensor(es.csr.offsets, es.col,
                                       torch.ones_like(es.weight),
                                       size=(V, V))
        yt = y.t().contiguous()
        print(json.dumps({"D": D, "library": "sampled_addmm",
                          "ms_in_turns": [cuda_ms(
                              lambda: torch.sparse.sampled_addmm(
                                  ones, x, yt, beta=0.0), 20)
                              for _ in range(2)], "card": smi}))


def parts_softmax(torch, sp, other, es, oes, kernels, rng, smi) -> None:
    """The row softmax's variants, forward (scores x3, then x30 for the
    error alone) and backward, beside the other checkout's kernel and
    torch.sparse.softmax."""
    V, E = es.num_vertices, es.col.numel()
    names = [*kernels, SOFT_ITEMS, *([OTHER_SOFTMAX] if other else [])]
    base_blocks = sp.SOFTMAX_BLOCKS_PER_SM
    es64 = replace(es, soft=sp.Order.build(es.csr.offsets.cpu().numpy(),
                                           "cuda", 64))
    f = lambda: torch.as_tensor(rng.standard_normal(E).astype(np.float32)
                                ).cuda()
    da = f()
    for scale in (3, 30):
        s = f() * scale
        a = sp.row_softmax(es, s)
        ad, dad = a.double(), da.double()
        dot = torch.zeros(V, dtype=torch.float64, device="cuda").index_add_(
            0, es.row, ad * dad)
        for mode, want in (("forward", sp.sddmm_softmax_ref(es, s.double())),
                           ("backward", ad * (dad - dot[es.row]))):
            args = (s,) if mode == "forward" else (a, da)

            def launch(name):
                if name == OTHER_SOFTMAX:
                    return other.row_softmax(oes, *args)
                if name == SOFT_ITEMS:
                    return sp.row_softmax(es64, *args)
                sp.SOFTMAX_BLOCKS_PER_SM = (
                    blocks_per_sm(SOFTMAX_VARIANTS[name], SOFT_BLOCKS)
                    or base_blocks)
                try:
                    return sp.row_softmax(es, *args, kernel=kernels[name])
                finally:
                    sp.SOFTMAX_BLOCKS_PER_SM = base_blocks
            in_turns(torch, names, launch, want, 1e-6,
                     f"softmax {mode}, scores x{scale}", smi,
                     kernel="row_softmax", mode=mode, scores=f"x{scale}")
    coo = torch.sparse_coo_tensor(torch.stack([es.row, es.col]).long(), s,
                                  (V, V)).coalesce()
    print(json.dumps({"library": "torch.sparse.softmax",
                      "ms_in_turns": [cuda_ms(lambda: torch.sparse.softmax(
                          coo, 1), 20) for _ in range(2)], "card": smi}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
