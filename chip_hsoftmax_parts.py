#!/usr/bin/env python3
"""Where the hierarchical-softmax step's time goes on one GPU: the kernel
source with one part changed at a time, beside the first design's kernel,
on blocks of chip_smoke's phase 18.

    python3 chip_hsoftmax_parts.py [OTHER_CHECKOUT]

A variant is csrc/hsoftmax.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script, so the list
is kept beside the kernel), built under build/hs_parts/ of the checkout
and launched through ops/hsoftmax.py::launch_step under the launch plan
of the card. A variant that keeps the design computes the same step and
is held to the plain step in float64 (rtol 1e-5, atol 1e-6, as phase 18
holds the kernel) before it is timed; one with a part taken out gives
wrong tables by design (and may leave its workspace dirty: each timing
takes a new one), and only its time is read. The parts:

  * the dots of S: four halo rows at a time (base), one, two or eight;
    d_X's node rows four at a time (base), one or eight; the next chunk's
    node rows prefetched toward L1 (base) or not;
  * a tile's path nodes de-duplicated (base), or a node a (center,
    level) (each claimed, counted and added on its own, as the first
    design did);
    d_VO made with S and G from the rows the dots read (base) or in a
    pass of its own over G;
  * __expf and __fdividef (base), or expf and a division;
  * the halo's rows and a wide row's slices copied by cp.async (base) or
    through the registers;
  * one block an SM (__launch_bounds__ without the two-block register cap
    of 128 a thread); a walk's tiles of near equal sizes (base) or of
    `tile` centers with a short last one; tiles taken from a counter
    (base) or by the grid's stride; the update four rows a warp at
    a time (base) or one;
  * taken out: S and G (the dots, the sigmoids and the labels), d_VO (the
    node rows' sums and device adds), the node rows' device adds alone,
    d_X (the halo rows' products), the three products (the chunks), the
    node rows' delta-slot claims, the halo rows' device adds, and
    everything but the launch, the barriers and the update;
  * the three products on the tensor cores (chip_hsoftmax_mma.cu: S, G,
    d_VO and d_X as dense mma.sync tiles in 3xTF32 over the tile's halo
    rows and a chunk's nodes, the rest of the step as csrc/hsoftmax.cu),
    under the base plan's tile and blocks with its own shared-memory
    layout (mma_smem_bytes), where D <= 128;
  * with OTHER_CHECKOUT (the parent commit unpacked under build/, as for
    chip_compare.py), the first design's kernel under its own plan: a
    warp a center's path, four levels at a time against its contexts;
  * the phase clocks: the base with thread 0 of each block adding its
    clock64 cycles since the last mark to the phase it ends (PHASES; marks
    after block-wide barriers, so a phase counts the block's own time to
    it), read out by srw_hs_clocks: mean cycles a block and step.

Each is timed on phase 19's block (the 100,000-vertex corpus of chip_smoke
phase 19 under its Huffman tree: B 256, T 82, w 10, D 128), at D 64, on
the one-token block (every center on one path) and on 32 walks at D 768
(rows of six slices): mean device ms of 10
launches back to back (chip_smoke's cuda_ms), every variant twice, in
turns. One JSON object a line, the card's name and power limit in each,
and ptxas' registers of every variant. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_compare import load_package
from chip_smoke import (ROOT, check, cuda_ms, edited, hs_block, hs_corpus,
                        source_kernel)

SIGMOID = "__fdividef(1.f, 1.f + __expf(-dot))"
# name -> [(text in csrc/hsoftmax.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    **{f"the dots of S {n} halo rows at a time": [
        ("constexpr int kDotRows = 4;", f"constexpr int kDotRows = {n};")]
       for n in (1, 2, 8)},
    **{f"d_X {n} node rows at a time": [
        ("constexpr int kBatch = 4;", f"constexpr int kBatch = {n};")]
       for n in (1, 8)},
    "copies through the registers, not cp.async": [
        ("  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4, %2;\\n\" "
         "::\"r\"(d),\n               \"l\"(src), \"r\"(on ? 4 : 0));",
         "  (void)d;\n  *dst = on ? *src : 0.f;")],
    "tiles by stride of the grid, not from a counter": [
        ("    if (threadIdx.x == 0) *tile_next = atomicAdd(s.counts + 2, 1);",
         "    if (threadIdx.x == 0) *tile_next = blockIdx.x + round * "
         "gridDim.x;")],
    "a walk's tiles of `tile` centers, the last short (the first "
    "design's tiling)": [
        ("  const int t_base = T / per_walk, t_extra = T % per_walk;",
         "  const int t_base = tile, t_extra = 0;")],
    "d_VO in a pass of its own after S and G": [
        ("        const bool fuse = one_slice;",
         "        const bool fuse = D < 0 && one_slice;")],
    "the update a row a warp at a time": [
        ("constexpr int kApply = 4;", "constexpr int kApply = 1;")],
    "no prefetch of the next chunk's node rows": [
        ("          prefetch_l1(syn1 +",
         "          if (D < 0) prefetch_l1(syn1 +")],
    "a node a (center, level), not de-duplicated": [
        ("        for (int c2 = 0; c2 < ci; ++c2)",
         "        for (int c2 = 0; c2 < 0; ++c2)")],
    "expf and a division (the exact sigmoid)": [
        (SIGMOID, "1.f / (1.f + expf(-dot))")],
    "one block an SM (no register cap)": [
        ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
    "taken out: S and G": [
        ("dvo[g][m] = 0.f;\n        for (int hb = lo; hb <= hi; hb += 32) {",
         "dvo[g][m] = 0.f;\n        for (int hb = lo; hb < lo; hb += 32) {")],
    "taken out: d_VO": [
        ("            if (fuse) {\n#pragma unroll\n"
         "              for (int k = 0;",
         "            if (fuse && D < 0) {\n#pragma unroll\n"
         "              for (int k = 0;"),
        ("        if (fuse) {\n#pragma unroll\n          for (int g = 0; "
         "g < kGroup; ++g)\n            if (g < nt) add_node",
         "        if (fuse && D < 0) {\n#pragma unroll\n          for (int g = "
         "0; g < kGroup; ++g)\n            if (g < nt) add_node"),
        ("        for (int c0 = 0; c0 < D && !fuse; c0 += kSlice) {",
         "        for (int c0 = 0; c0 < 0 && !fuse; c0 += kSlice) {")],
    "taken out: the node rows' device adds": [
        ("            if (g < nt) add_node<NV>(s, uslot[ug + g], 0, D, lane, "
         "dvo[g]);",
         "            if (g < nt && D < 0) add_node<NV>(s, uslot[ug + g], 0, "
         "D, lane, dvo[g]);"),
        ("            if (g < nt) add_node<NV>(s, uslot[ug + g], c0, D, lane, "
         "dvo[g]);",
         "            if (g < nt && D < 0) add_node<NV>(s, uslot[ug + g], c0, "
         "D, lane, dvo[g]);")],
    "taken out: d_X": [
        ("        for (int h = lo + warp; h <= hi; h += kWarps) {",
         "        for (int h = lo + warp; h < lo; h += kWarps) {")],
    "taken out: the three products": [
        ("    for (int u0 = 0; u0 < nU; u0 += kChunk) {",
         "    for (int u0 = 0; u0 < 0; u0 += kChunk) {")],
    "taken out: the node rows' slot claims": [
        ("      const int slot = claim(s, 1, unode[u]);",
         "      const int slot = u;")],
    "taken out: the halo rows' flush": [
        ("    for (int h = warp; h < H; h += kWarps) {\n"
         "      const int n = cnth[h];",
         "    for (int h = warp; h < 0; h += kWarps) {\n"
         "      const int n = cnth[h];")],
    "taken out: all but the launch, the barriers and the update": [
        ("    if (ti >= n_tiles) break;", "    if (ti >= 0) break;")],
}
MARK = ("    if (threadIdx.x == 0) {{ const long long now = clock64(); "
        "atomicAdd(srw_clk + {}, static_cast<unsigned long long>(now - "
        "srw_t)); srw_t = now; }}\n")
# the phases whose clocks CLOCKS reads: each mark adds thread 0's clock
# since the last mark to its phase (block-wide points: after a barrier)
PHASES = ["the halo rows, their pairs (and the last tile's wait)",
          "the path entries, nodes, their claims and counts",
          "S, G and d_VO (a chunk, to its barrier)",
          "d_X (a chunk, to its barrier)", "the halo rows' flush",
          "the first grid barrier", "the update", "the second grid barrier"]
CLOCKS = "phase clocks (thread 0 of each block, clock64)"
VARIANTS[CLOCKS] = [
    ("namespace {\n\nnamespace cg = cooperative_groups;",
     "namespace {\n\n__device__ unsigned long long srw_clk[8];\n\n"
     "namespace cg = cooperative_groups;"),
    ("  const int n_tiles = B * per_walk;\n",
     "  const int n_tiles = B * per_walk;\n  long long srw_t = clock64();\n"),
    ("    __syncthreads();\n    // the live path entries",
     "    __syncthreads();\n" + MARK.format(0)
     + "    // the live path entries"),
    ("    for (int u0 = 0; u0 < nU; u0 += kChunk) {",
     MARK.format(1) + "    for (int u0 = 0; u0 < nU; u0 += kChunk) {"),
    ("      __syncthreads();\n      // d_X of the halo rows",
     "      __syncthreads();\n" + MARK.format(2)
     + "      // d_X of the halo rows"),
    ("        __syncthreads();  // G and the node rows are read before reuse\n",
     "        __syncthreads();  // G and the node rows are read before reuse\n"
     + MARK.format(3)),
    ("      for (int c = lane; c < D; c += 32) atomicAdd(dst + c, src[c]);\n"
     "    }\n  }\n",
     "      for (int c = lane; c < D; c += 32) atomicAdd(dst + c, src[c]);\n"
     "    }\n" + MARK.format(4) + "  }\n"),
    ("  cg::this_grid().sync();\n  apply_slots(syn0, syn1, s, D, lr);\n",
     "  cg::this_grid().sync();\n" + MARK.format(5)
     + "  apply_slots(syn0, syn1, s, D, lr);\n" + MARK.format(6)),
    ("  cg::this_grid().sync();\n  if (blockIdx.x == 0 && threadIdx.x == 0) {",
     "  cg::this_grid().sync();\n" + MARK.format(7)
     + "  if (blockIdx.x == 0 && threadIdx.x == 0) {"),
    ("  cudaGetLastError();  // a refused launch leaves no error for later "
     "calls\n  return static_cast<int>(err);\n}\n",
     "  cudaGetLastError();  // a refused launch leaves no error for later "
     "calls\n  return static_cast<int>(err);\n}\n\n"
     "// the phases' clock sums into out[8] (host memory), then zeroed\n"
     "extern \"C\" int srw_hs_clocks(void* out) {\n"
     "  const unsigned long long zero[8] = {};\n"
     "  cudaMemcpyFromSymbol(out, srw_clk, sizeof(zero));\n"
     "  cudaMemcpyToSymbol(srw_clk, zero, sizeof(zero));\n"
     "  return static_cast<int>(cudaGetLastError());\n}\n")]
WRONG_BY_DESIGN = {name for name in VARIANTS if name.startswith("taken")}
MMA = "the three products on the tensor cores (3xTF32, chip_hsoftmax_mma.cu)"
MMA_SOURCE = "chip_hsoftmax_mma.cu"
CHUNK = 32          # nodes a chunk (kChunk in chip_hsoftmax_mma.cu)
OTHER = "the first design's kernel (the other checkout)"
# (tokens, B, T, window, D) of chip_smoke's HS_SHAPES
CASES = [("corpus", 256, 82, 10, 128), ("corpus", 256, 82, 10, 64),
         ("hub", 32, 82, 10, 128), ("corpus", 32, 82, 10, 768)]
LR = 0.025


def mma_smem_bytes(tile: int, window: int, D: int, levels: int) -> int:
    """chip_hsoftmax_mma.cu's shared memory (its smem_words): X, dX and a
    chunk's node rows with rows of D rounded up to 8 plus 4 floats, halo
    rows rounded up to 16, G [halo rows, CHUNK + 4], then the base
    kernel's halo, center and path-entry words."""
    H = tile + 2 * window
    Hp = -(-H // 16) * 16
    xs = -(-D // 8) * 8 + 4
    return 4 * (2 * Hp * xs + CHUNK * xs + Hp * (CHUNK + 4) + 3 * H
                + 2 * tile + 8 * tile * levels + 1)


def mma_plan(base, window: int, D: int, levels: int):
    """The tensor-core variant under the base plan's tile and blocks (the
    same work cut the same way), or None where it does not run: D over
    128, or its layout past the shared memory of the base plan's blocks
    an SM."""
    from stellar_rw_tpu_torch.ops import hsoftmax as ho

    need = mma_smem_bytes(base.tile, window, D, levels)
    budget = dict(ho.SMEM_BUDGETS)[base.blocks_per_sm]
    if D > 128 or need > budget:
        return None
    return base._replace(smem_bytes=need)


def clocks_reader(kernel):
    """The clocks variant's read-out: a call returns the 8 phase sums of
    cycles since the last call (and zeroes them)."""
    fn = ctypes.CDLL(str(kernel._build())).srw_hs_clocks   # built: cached
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def read():
        out = (ctypes.c_ulonglong * 8)()
        check(fn(out) == 0, "srw_hs_clocks failed")
        return list(out)
    return read


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_hsoftmax_parts: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import hsoftmax as ho

    other = (load_package(os.path.realpath(argv[0]), "srw_other")(
        "ops.hsoftmax") if argv else None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    text = ho.HS_STEP.path.read_text()
    kernels = {
        name: source_kernel(f"hs_{i}", edited(text, edits),
                            ho.HS_STEP.symbol, ho.HS_STEP.argtypes,
                            "hs_parts")
        for i, (name, edits) in enumerate(VARIANTS.items())}
    with open(os.path.join(ROOT, MMA_SOURCE)) as f:
        kernels[MMA] = source_kernel("hs_mma", f.read(), ho.HS_STEP.symbol,
                                     ho.HS_STEP.argtypes, "hs_parts")
    builds = list(kernels.values()) + ([other.HS_STEP] if other else [])
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda k: k.fn(), builds))
    for name, k in kernels.items():
        regs = [line.strip() for line in k.build_log.splitlines()
                if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "ptxas": regs, "card": smi}))
    all_names = [*VARIANTS, MMA, *([OTHER] if other else [])]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    corpus = hs_corpus(torch)
    for case in CASES:
        _, B, T, win, D = case
        syn0, syn1, block, cwin, pts, lbl, pmk = hs_block(torch, *case, 0,
                                                          corpus)
        L = pts.shape[1]
        a0, a1 = syn0.double(), syn1.double()
        ho.hs_step_ref(a0, a1, block, cwin, pts, lbl, pmk, LR, win)
        base = ho.launch_plan(D, B, T, win, sms, levels=L)
        mma = mma_plan(base, win, D, L)
        names = [n for n in all_names if n != MMA or mma is not None]

        def plan_of(name):
            if name.startswith("one block an SM"):
                return base._replace(blocks=min(base.tiles, sms),
                                     blocks_per_sm=1)
            return mma if name == MMA else base

        def step(name, b0, b1):
            """A variant's step on tables b0, b1 and a workspace of its
            own."""
            mod = other if name == OTHER else ho
            ws = mod.HSWorkspace(b0, b1, B * T, L)
            if name == OTHER:
                return lambda: other.launch_step(ws, b0, b1, block, cwin,
                                                 pts, lbl, pmk, win, LR)
            return lambda: ho.launch_step(ws, b0, b1, block, cwin, pts, lbl,
                                          pmk, win, LR, plan_of(name),
                                          kernels[name])

        errs = {}
        for name in names:
            if name in WRONG_BY_DESIGN:
                continue
            b0, b1 = syn0.clone(), syn1.clone()
            step(name, b0, b1)()
            torch.cuda.synchronize()
            err = max(float((b0.double() - a0).abs().max()),
                      float((b1.double() - a1).abs().max()))
            check(torch.allclose(b0.double(), a0, rtol=1e-5, atol=1e-6)
                  and torch.allclose(b1.double(), a1, rtol=1e-5, atol=1e-6),
                  f"variant {name!r} differs from the float64 step at {case}:"
                  f" max abs err {err:.3g}")
            errs[name] = err
        ms = {name: [] for name in names}
        for _ in range(2):
            for name in names:
                b0, b1 = syn0.clone(), syn1.clone()
                ms[name].append(cuda_ms(step(name, b0, b1), 10))
                del b0, b1
        # the clocks variant's phases over 10 more steps
        b0, b1 = syn0.clone(), syn1.clone()
        run = step(CLOCKS, b0, b1)
        run()
        torch.cuda.synchronize()
        read = clocks_reader(kernels[CLOCKS])
        read()
        for _ in range(10):
            run()
        torch.cuda.synchronize()
        cyc = read()
        blocks = plan_of(CLOCKS).blocks
        print(json.dumps({
            "case": list(case), "clocks": "thread 0's cycles a block and "
            "step by phase (mean over blocks, 10 steps)",
            "phases": {ph: c / blocks / 10 for ph, c in zip(PHASES, cyc)},
            "card": smi}))
        for name in names:
            print(json.dumps({
                "case": list(case), "L": L, "variant": name,
                "ms_in_turns": ms[name],
                "max_abs_err_f64": errs.get(name),
                "plan": None if name == OTHER else plan_of(name)._asdict(),
                "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
