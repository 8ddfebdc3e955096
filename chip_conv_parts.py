#!/usr/bin/env python3
"""Where the conv step's kernels' time goes on one GPU, and the accumulate
kernel's forms side by side.

    python3 chip_conv_parts.py [PARENT_CHECKOUT] [--step0 | --forms |
                                                 --split-parts]

PARENT_CHECKOUT (build/parent when not given) is the root of a checkout of
this repository under this checkout's build/ (the parent commit, unpacked by
`git archive`); its package is loaded beside this one and its step is timed
in turns with the forms. A variant is csrc/sgns_conv.cu with pieces of text
replaced (VARIANTS), or the same source with a file appended and pieces of
that file replaced: the cluster a walk that splits its columns
(chip_conv_split.cu, SPLIT_VARIANTS, under split_plan at each of
SPLIT_CLUSTERS thread blocks a walk) and the cluster a walk that splits
its positions (chip_conv_cluster.cu, CLUSTER_VARIANTS, under
cluster_plan); each cluster plan is placed first
(cudaOccupancyMaxActiveClusters). A piece that is not exactly once in its
text stops the script. A variant that keeps its design computes the same
step and is held to the plain step in float64 (rtol 1e-5, atol 1e-6, as
chip_smoke's phase 14 holds the kernels) before it is timed (--forms: one
that misses is reported and not timed); one with a part taken out gives
wrong tables by design, and only its time is read. Each is timed on
chip_smoke's phase-14 block (B 32, T 82, w 10, kB 128, V 10,000, D 128,
Zipf tokens), its one-token block, at D 768, at T 201 (Zipf and one token),
at window 20 (CASES) and on a slot's block (B 16) at D 128 and 768: each
launch of a step between CUDA events (chip_smoke's cuda_ms_split) and the
accumulate launch back to back, every design twice, in turns.

  --step0        the parent's accumulate kernel alone (its source edited,
                 PARENT_VARIANTS, and launched through its own wrapper): its
                 parts taken out or changed, clock64 cycles a block by phase
                 (PARENT_CLOCKS), ptxas' registers and the blocks an SM holds,
                 and the gather-and-store probe (chip_conv_probe.cu: each
                 row gathered once and stored as the three outputs, no
                 arithmetic); then the kept kernel's clock64 cycles by phase
                 (ACC_CLOCKS); on the main block.
  --forms        the forms and their variants on the main block, at D 768
                 and on the slot's blocks.
  --split-parts  form (a) at C 4 and 8: its clock64 cycles by phase
                 (SPLIT_CLOCKS) and its parts taken out.
  (no flag)      the forms at every case, and at each the kept kernel by
                 tile (TILES_TRIED), the position-split cluster by size
                 (CLUSTER_SIZES),
                 the scatter-update by hub threshold (HUBS) and the scatter
                 in accumulate mode in ACCUMULATE_FORMS (chip_conv_runs.cu,
                 on a slot's block, held to the float64 merged update).

One JSON object a line, the card's name and power limit in each, and
ptxas' registers, stack frame and spills of every kernel of every variant.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_compare import conv_step_fns, load_package
from chip_smoke import (check, conv_block, cuda_ms, cuda_ms_split, edited,
                        source_kernel)

PARENT = os.path.join("build", "parent")
SPLIT_SOURCE = "chip_conv_split.cu"
CLUSTER_SOURCE = "chip_conv_cluster.cu"
RUNS_SOURCE = "chip_conv_runs.cu"
PROBE_SOURCE = "chip_conv_probe.cu"

# blocks an SM the scatter-update's launch bounds ask of ptxas in the
# variants (the base: kThreads, 2; kThreads alone asks none)
UPDATE_BOUNDS = ("kThreads", "kThreads, 3", "kThreads, 4")
# the accumulate kernel's 16-byte row copies through L1 (its own), or from
# L2 alone
CA16 = ('asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\\n" '
        '::"r"(s),')
CG16 = CA16.replace(".ca.", ".cg.")

# name -> [(text in csrc/sgns_conv.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    # kThreads: the scatters' threads a block
    "128 threads a block": [("constexpr int kThreads = 256;",
                             "constexpr int kThreads = 128;")],
    "384 threads a block": [("constexpr int kThreads = 256;",
                             "constexpr int kThreads = 384;")],
    **{f"accumulate: {n} threads a block at one chunk (kAccThreads)": [
        ("constexpr int kAccThreads = 128;",
         f"constexpr int kAccThreads = {n};")] for n in (64, 256)},
    "accumulate: 16-byte copies from L2 alone (cp.async.cg)": [
        (CA16, CG16)],
    "accumulate: one build, kAccThreads threads a block at every width": [
        ("  const auto kernel = cols > 128 ? sgns_conv_accumulate<2 * "
         "kAccThreads>\n"
         "                                  : sgns_conv_accumulate<"
         "kAccThreads>;",
         "  const auto kernel = sgns_conv_accumulate<kAccThreads>;"),
        ("  const int threads = cols > 128 ? 2 * kAccThreads : kAccThreads;",
         "  const int threads = kAccThreads;")],
    # a block's own negative row loaded at its start and stored after the
    # gather, the end loop taking the rest
    "accumulate: wn's own row through registers at the start": [
        ("constexpr int kAccBlocks = 3;\n",
         "constexpr int kAccBlocks = 3;\nconstexpr int kAccWnRegs = 4;\n"),
        ("  if (threadIdx.x == 0) s_valid = 0;\n  for (int h = threadIdx.x;",
         "  const bool wn_early =\n"
         "      cta < kB && D <= kAccWnRegs * static_cast<int>(blockDim.x);\n"
         "  float wv[kAccWnRegs];\n"
         "  if (wn_early) {\n"
         "    const float* src = w_out + static_cast<size_t>(negs[cta]) * D;\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < kAccWnRegs; ++j) {\n"
         "      const int c = threadIdx.x + j * blockDim.x;\n"
         "      wv[j] = c < D ? __ldg(src + c) : 0.f;\n"
         "    }\n  }\n"
         "  if (threadIdx.x == 0) s_valid = 0;\n  for (int h = threadIdx.x;"),
        ("    __syncthreads();\n    for (int tl = warp; tl < nt; "
         "tl += nwarps) {\n      const int h = window + tl;\n"
         "      for (int o0",
         "    __syncthreads();\n    if (s == 0 && wn_early) {\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < kAccWnRegs; ++j) {\n"
         "        const int c = threadIdx.x + j * blockDim.x;\n"
         "        if (c < D) o.wn[static_cast<size_t>(cta) * D + c] = wv[j];\n"
         "      }\n    }\n"
         "    for (int tl = warp; tl < nt; tl += nwarps) {\n"
         "      const int h = window + tl;\n      for (int o0"),
        ("  for (int k = cta; k < kB; k += nctas) {",
         "  for (int k = wn_early ? cta + nctas : cta; k < kB; k += nctas) {")],
    "scatter: a unit's rows read one at a time (kBatch 1)": [
        ("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")],
    "scatter: a unit's rows read 16 at a time (kBatch 16)": [
        ("constexpr int kBatch = 8;", "constexpr int kBatch = 16;")],
    "scatter: a unit's rows read from L2 alone (ld.cg)": [
        ("        if (total == 0) continue;\n"
         "        sum = sum_rows<false>(",
         "        if (total == 0) continue;\n"
         "        sum = sum_rows<true>("),
        ("        const int mine_cnt = group_count(c_t, order, a, b, lane);\n"
         "        sum = sum_rows<false>(",
         "        const int mine_cnt = group_count(c_t, order, a, b, lane);\n"
         "        sum = sum_rows<true>(")],
    **{f"scatter-update: launch bounds ({b})": [
        ("__global__ void __launch_bounds__(kThreads, 2)\n"
         "    sgns_conv_scatter(",
         f"__global__ void __launch_bounds__({b})\n"
         "    sgns_conv_scatter(")] for b in UPDATE_BOUNDS},
    "taken out: the dots": [
        ("      for (int o0 = 0; o0 < W2; o0 += 32) {\n"
         "        float vc[32], vx[32];",
         "      for (int o0 = 0; o0 < W2 && D < 0; o0 += 32) {\n"
         "        float vc[32], vx[32];")],
    "taken out: the accumulations": [
        ("        float4 ai = make_float4(0.f, 0.f, 0.f, 0.f), ao = ai;\n"
         "        for (int oi = 0; oi < W2; ++oi) {",
         "        float4 ai = make_float4(0.f, 0.f, 0.f, 0.f), ao = ai;\n"
         "        for (int oi = 0; oi < W2 && D < 0; ++oi) {")],
    "taken out: all of the accumulate kernel but the launch": [
        ("  const int W2 = 2 * window, H = tile + W2;\n",
         "  if (D > 0) return;\n  const int W2 = 2 * window, H = tile + W2;\n")],
    "taken out: all of the scatter-update but the launch": [
        ("  const int chunks = (D + 127) / 128;   // 128 columns a warp",
         "  if (D > 0) return;\n"
         "  const int chunks = (D + 127) / 128;   // 128 columns a warp")],
}

# clock64 by phase: thread 0 of each block reads the clock where a phase
# ends (after a __syncthreads) and adds each phase's cycles into g_clk[j],
# the blocks into g_clk[15]; read and zeroed by srw_conv_clocks
CLOCK_TAIL = """
extern "C" int srw_conv_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_clk, zero, sizeof(zero)));
}
"""
CLOCK_DECL = "__device__ unsigned long long g_clk[16];\n"


def clock_record(n: int, indent: str = "  ") -> str:
    """The kernel's last lines under clock64: thread 0 adds the cycles of
    phases k0..k{n-1} to the clock at its end."""
    ks = ", ".join(f"k{j}" for j in range(n))
    return (f"{indent}__syncthreads();\n{indent}if (threadIdx.x == 0) {{\n"
            f"{indent}  const long long k[{n + 1}] = {{{ks}, clock64()}};\n"
            f"{indent}  for (int j = 0; j < {n}; ++j)\n"
            f"{indent}    atomicAdd(&g_clk[j],\n"
            f"{indent}              static_cast<unsigned long long>(k[j + 1] "
            f"- k[j]));\n"
            f"{indent}  atomicAdd(&g_clk[15], 1ull);\n{indent}}}\n")


# the kept accumulate kernel's phases (csrc/sgns_conv.cu, kernel (a))
ACC_PHASES = ("the tokens and windows", "the gather", "the dots",
              "g_pos and the pair counts",
              "the accumulations with their stores",
              "the negatives' wn copy")
ACC_CLOCKS = [
    ("constexpr int kAccBlocks = 3;\n", "constexpr int kAccBlocks = 3;\n"
     + CLOCK_DECL),
    ("  const int slices = (D + cols - 1) / cols;\n"
     "  const int chunks = (cols + 127) / 128;\n",
     "  const int slices = (D + cols - 1) / cols;\n"
     "  const int chunks = (cols + 127) / 128;\n"
     "  const long long k0 = clock64();\n"),
    ("  __syncthreads();\n\n  const bool vec = D % 4 == 0 && "
     "reinterpret_cast<uintptr_t>(w_in) % 16 == 0\n",
     "  __syncthreads();\n  const long long k1 = clock64();\n"
     "  long long k2 = 0;\n\n  const bool vec = D % 4 == 0 && "
     "reinterpret_cast<uintptr_t>(w_in) % 16 == 0\n"),
    ("    __syncthreads();\n    for (int tl = warp; tl < nt; tl += nwarps) "
     "{\n      const int h = window + tl;\n      for (int o0",
     "    __syncthreads();\n    if (s == 0) k2 = clock64();\n"
     "    for (int tl = warp; tl < nt; tl += nwarps) {\n"
     "      const int h = window + tl;\n      for (int o0"),
    ("  // g_pos of both sides by the lane of each offset, the pair counts "
     "by\n",
     "  __syncthreads();\n  const long long k3 = clock64();\n"
     "  // g_pos of both sides by the lane of each offset, the pair counts "
     "by\n"),
    ("  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);\n"
     "  __syncwarp();\n",
     "  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);\n"
     "  __syncthreads();\n  const long long k4 = clock64();\n"),
    ("  __syncthreads();\n  if (threadIdx.x == 0) o.valid[cta] = s_valid;\n"
     "  for (int k = cta; k < kB; k += nctas) {\n",
     "  __syncthreads();\n  const long long k5 = clock64();\n"
     "  if (threadIdx.x == 0) o.valid[cta] = s_valid;\n"
     "  for (int k = cta; k < kB; k += nctas) {\n"),
    ("    for (int c = threadIdx.x; c < D; c += blockDim.x) dst[c] = "
     "__ldg(src + c);\n  }\n}\n",
     "    for (int c = threadIdx.x; c < D; c += blockDim.x) dst[c] = "
     "__ldg(src + c);\n  }\n" + clock_record(6) + "}\n")]

# the parent's kernel (its csrc/sgns_conv.cu, the halo tiles a thread a
# dot): name -> [(text in that file, its replacement)]
PARENT_VARIANTS = {
    "the parent's kernel": [],
    "the parent, 128 threads a block": [("constexpr int kThreads = 256;",
                                         "constexpr int kThreads = 128;")],
    "the parent, 384 threads a block": [("constexpr int kThreads = 256;",
                                         "constexpr int kThreads = 384;")],
    "the parent, a tile's row loads one at a time (kTileReads 1)": [
        ("constexpr int kTileReads = 4;", "constexpr int kTileReads = 1;")],
    "the parent, a tile's row loads 8 at a time (kTileReads 8)": [
        ("constexpr int kTileReads = 4;", "constexpr int kTileReads = 8;")],
    "the parent, taken out: the dots": [
        ("      const int hc = window + tl - side * d, hx = hc + d;\n"
         "      if (!pair_ok(s_tok, s_win, hc, hx)) continue;",
         "      const int hc = window + tl - side * d, hx = hc + d;\n"
         "      if (D > 0 || !pair_ok(s_tok, s_win, hc, hx)) continue;")],
    "the parent, taken out: the accumulations": [
        ("    for (int i = threadIdx.x; i < nt * w; i += blockDim.x) {",
         "    for (int i = threadIdx.x; i < nt * w && D < 0; "
         "i += blockDim.x) {")],
    "the parent, taken out: all but the launch": [
        ("  const int W2 = 2 * window, H = tile + W2;\n",
         "  if (D > 0) return;\n"
         "  const int W2 = 2 * window, H = tile + W2;\n")],
}
# the parent's phases, in the order clock64 closes them; the halo gather
# is the first slice's (one slice at D 128)
PARENT_PHASES = ("the negatives' wn copy", "the tokens and windows",
                 "the halo gather (load_halo)", "the dots",
                 "the sigmoid and counts",
                 "the accumulations with their stores")
PARENT_CLOCKS = [
    ("constexpr int kTileReads = 4;       // a thread's row loads in "
     "flight, (a)\n",
     "constexpr int kTileReads = 4;       // a thread's row loads in "
     "flight, (a)\n" + CLOCK_DECL),
    ("  if (threadIdx.x == 0) s_valid = 0;\n  for (int k = cta; k < kB; "
     "k += nctas) {",
     "  const long long k0 = clock64();\n"
     "  if (threadIdx.x == 0) s_valid = 0;\n  for (int k = cta; k < kB; "
     "k += nctas) {"),
    ("  for (int h = threadIdx.x; h < H; h += blockDim.x) {\n"
     "    const int t = hb + h;\n",
     "  __syncthreads();\n  const long long k1 = clock64();\n"
     "  for (int h = threadIdx.x; h < H; h += blockDim.x) {\n"
     "    const int t = hb + h;\n"),
    ("  for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) s_cnt[i] = "
     "0;\n  __syncthreads();\n",
     "  for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) s_cnt[i] = "
     "0;\n  __syncthreads();\n  const long long k2 = clock64();\n"
     "  long long k3 = 0;\n"),
    ("    load_halo(s_in, s_out, s_tok, w_in, w_out, H, ld, D, c0, w, vec);\n"
     "    __syncthreads();\n    for (int it",
     "    load_halo(s_in, s_out, s_tok, w_in, w_out, H, ld, D, c0, w, vec);\n"
     "    __syncthreads();\n    if (s == 0) k3 = clock64();\n"
     "    for (int it"),
    ("  __syncthreads();\n  for (int it = threadIdx.x; it < 2 * items; "
     "it += blockDim.x) {\n",
     "  __syncthreads();\n  const long long k4 = clock64();\n"
     "  for (int it = threadIdx.x; it < 2 * items; it += blockDim.x) {\n"),
    ("  if (threadIdx.x == 0) o.valid[cta] = s_valid;\n\n",
     "  if (threadIdx.x == 0) o.valid[cta] = s_valid;\n"
     "  const long long k5 = clock64();\n\n"),
    ("      o.ein[e] = s_in[h * ld + c];\n    }\n  }\n}\n",
     "      o.ein[e] = s_in[h * ld + c];\n    }\n  }\n" + clock_record(6)
     + "}\n")]

# form (a), the cluster a walk that splits its columns (chip_conv_split.cu):
# name -> [(text in that file, its replacement)]
SPLIT_VARIANTS = {
    "(a) split": [],
    **{f"(a) split, {n} threads a block": [
        ("constexpr int kSplitThreads = 512;",
         f"constexpr int kSplitThreads = {n};")] for n in (256, 1024)},
    "(a) split, every rank sums every pair": [
        ("constexpr bool kReduceScatter = true;",
         "constexpr bool kReduceScatter = false;")],
    "(a) split, 16-byte copies from L2 alone (cp.async.cg)": [(CA16, CG16)],
}
SPLIT_CLUSTERS = (2, 4, 8)
SPLIT_PHASES = ("the tokens and windows", "the gather and wn's first row",
                "the partial dots", "the first cluster barrier",
                "the exchange", "the second cluster barrier",
                "the pair counts", "the accumulations with their stores",
                "wn's other rows")
SPLIT_CLOCKS = [
    ("constexpr bool kReduceScatter = true;\n",
     "constexpr bool kReduceScatter = true;\n" + CLOCK_DECL),
    ("  constexpr int P = 32 / G;                 // positions a warp at "
     "once\n",
     "  constexpr int P = 32 / G;                 // positions a warp at "
     "once\n  const long long k0 = clock64();\n"),
    ("  __syncthreads();\n\n  const bool vec",
     "  __syncthreads();\n  const long long k1 = clock64();\n"
     "  long long k2 = 0, k5 = 0, k6 = 0;\n\n  const bool vec"),
    ("        if (c < D) o.wn[static_cast<size_t>(cta) * D + c] = wv[j];\n"
     "      }\n    }\n",
     "        if (c < D) o.wn[static_cast<size_t>(cta) * D + c] = wv[j];\n"
     "      }\n    }\n    if (s == 0) {\n      __syncthreads();\n"
     "      k2 = clock64();\n    }\n"),
    ("  cl.sync();   // every rank's partials are final\n",
     "  __syncthreads();\n  const long long k3 = clock64();\n"
     "  cl.sync();   // every rank's partials are final\n"
     "  const long long k4 = clock64();\n"),
    ("    cl.sync();   // g_pos complete in every rank; no remote access "
     "after it\n",
     "    __syncthreads();\n    k5 = clock64();\n"
     "    cl.sync();   // g_pos complete in every rank; no remote access "
     "after it\n    k6 = clock64();\n"),
    ("  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);\n\n",
     "  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);\n"
     "  __syncthreads();\n  const long long k7 = clock64();\n\n"),
    ("  __syncthreads();\n  if (threadIdx.x == 0) o.valid[cta] = s_valid;\n",
     "  __syncthreads();\n  const long long k8 = clock64();\n"
     "  if (threadIdx.x == 0) o.valid[cta] = s_valid;\n"),
    ("  if (!kReduceScatter) split_cluster_wait();   // no rank leaves while "
     "read\n",
     "  if (!kReduceScatter) split_cluster_wait();   // no rank leaves while "
     "read\n" + clock_record(9))]
SPLIT_TAKEN_OUT = {
    "(a) split, taken out: the partial dots": [
        ("    for (int tb = warp * P; tb < T; tb += nwarps * P) {",
         "    for (int tb = warp * P; tb < T && D < 0; tb += nwarps * P) {")],
    "(a) split, taken out: the exchange": [
        ("    for (int i = rank + C * threadIdx.x; i < n; i += C * "
         "blockDim.x) {",
         "    for (int i = rank + C * threadIdx.x; i < n && D < 0; "
         "i += C * blockDim.x) {")],
    "(a) split, taken out: the accumulations": [
        ("    for (int t = warp * P + sub; t < T; t += nwarps * P) {",
         "    for (int t = warp * P + sub; t < T && D < 0; "
         "t += nwarps * P) {")],
    "(a) split, taken out: all but the launch": [
        ("  constexpr int P = 32 / G;                 // positions a warp at "
         "once\n",
         "  constexpr int P = 32 / G;                 // positions a warp at "
         "once\n  if (D > 0) return;\n")],
}

# (c), the cluster a walk that splits its positions
# (chip_conv_cluster.cu): name -> [(text in that file, its replacement)]
CLUSTER_VARIANTS = {
    "cluster a walk": [],
    "cluster, neighbour rows and g_pos read in place (kCopyHalo false)": [
        ("constexpr bool kCopyHalo = true;",
         "constexpr bool kCopyHalo = false;")],
    "cluster, row gathers through registers (kAsync false)": [
        ("constexpr bool kAsync = true;", "constexpr bool kAsync = false;")],
    "cluster, 8 lanes a dot": [("constexpr int kDotLanes = 4;",
                                "constexpr int kDotLanes = 8;")],
    "taken out: all of the cluster kernel but the launch": [
        ("  cg::cluster_group cl = cg::this_cluster();\n",
         "  if (D > 0) return;\n"
         "  cg::cluster_group cl = cg::this_cluster();\n")],
}
# cluster variants that read the neighbours' rows in place (no halo rows)
IN_PLACE = {name for name, edits in CLUSTER_VARIANTS.items()
            if ("constexpr bool kCopyHalo = true;",
                "constexpr bool kCopyHalo = false;") in edits}
CLUSTER_SIZES = (1, 2, 4, 8, 16)
TILES_TRIED = (4, 8, 16, 32)
HUBS = (8, 16, 32, 64, 128, None)
# (tokens, T, window, D)
CASES = [("zipf", 82, 10, 128), ("hub", 82, 10, 128), ("zipf", 82, 10, 768),
         ("zipf", 201, 10, 128), ("hub", 201, 10, 128),
         ("zipf", 82, 20, 128)]
V, B, KB, LR = 10_000, 32, 128, 0.025
B_SLOT = 16    # a slot's block at --w2vPartitions 2
# the scatter in accumulate mode: (name, in token order, positions a run;
# None: the trainer's kernel, a position a thread)
ACCUMULATE_FORMS = [("a position a thread (the trainer's)", False, None),
                    ("runs of 8, position order", False, 8),
                    ("runs of 8, token order", True, 8)]
RUNS_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p]
                 + [ctypes.c_int] + [ctypes.c_float] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 5)
PROBE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                  + [ctypes.c_void_p])
# resident blocks an SM of KERNEL (THREADS a block) at smem bytes
OCCUPANCY_TAIL = """
extern "C" int srw_conv_occupancy(int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, KERNEL, THREADS, smem));
}
"""


def ptxas_by_kernel(log: str) -> dict:
    """ptxas -v's report a kernel ({name: [frame and spills, registers]}):
    its lines follow the kernel's "Compiling entry function" line."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"\d+([a-z_]+)E", entry.group(1))
            name = m.group(1) if m else entry.group(1)
            out[name] = []
        elif name and ("registers" in line or "stack frame" in line):
            out[name].append(line.split(":", 1)[-1].strip())
    return out


def split_plan(sc, B: int, T: int, D: int, window: int, cluster: int):
    """Form (a)'s plan as a LaunchPlan (tile: the columns a rank, `span`;
    tiles: the ranks a cluster, C): span = ceil(D / C) rounded up to 4, a
    slice of `cols` columns (a multiple of 32, 8 lanes a position, or 16
    where span <= 16, 4 lanes), the widest within sc.SMEM_BUDGET."""
    span = -(-(-(-D // cluster)) // 4) * 4
    unit = 32 if span > 16 else 16
    smem = lambda cols: 4 * (2 * T * cols + 2 * T * 2 * window + 2 * T)
    cols = -(-span // unit) * unit
    while cols > unit and smem(cols) > sc.SMEM_BUDGET:
        cols -= unit
    if smem(cols) > sc.SMEM_BUDGET:
        raise ValueError(f"split_plan: no room for a slice at T {T}")
    return sc.LaunchPlan(span, cluster, cluster * B, T, cols,
                         -(-span // cols), smem(cols), 512)


def cluster_smem_bytes(positions: int, window: int, cols: int, T: int,
                       halo: int) -> int:
    """The position-split cluster's shared memory a thread block: the ein and
    eout slices of its rows and of `halo` rows each side, their g_pos (2w
    a row), the walk's tokens and windows and its own positions' two pair
    counts."""
    R = positions + 2 * halo
    return 4 * (2 * R * cols + R * 2 * window + 2 * T + 2 * positions)


def cluster_plan(sc, B: int, T: int, D: int, window: int, sm_count: int,
                 clusters=(2, 4, 8), halo: bool = True):
    """The position-split cluster's plan as a LaunchPlan (tile: positions a
    thread block, tiles: thread blocks a cluster, a walk): the fewest
    thread blocks a walk of `clusters` whose grid of B clusters gives every
    SM two (the most when none does; never more than T), the walk's
    positions split evenly over them, and the widest row slice, a multiple
    of 32 columns, within sc.SMEM_BUDGET."""
    c = next((c for c in clusters if B * min(c, T) >= 2 * sm_count),
             clusters[-1])
    positions = -(-T // min(c, T))
    c = -(-T // positions)
    hw = window if halo else 0
    cols = -(-D // 32) * 32
    while cols >= 32 and cluster_smem_bytes(positions, window, cols, T,
                                            hw) > sc.SMEM_BUDGET:
        cols -= 32
    if cols < 32:
        raise ValueError(f"cluster_plan: no room for a row slice at T {T}")
    return sc.LaunchPlan(positions, c, c * B, positions + 2 * hw, cols,
                         -(-D // cols),
                         cluster_smem_bytes(positions, window, cols, T, hw),
                         256)


class Design:
    """One accumulate kernel of a design: its Kernel (`kernel`), the
    launch plans it runs under (`plans(b, T, D, window)`: [(tag, plan, or
    None for the package's own)], each placed first where `query` is its
    cluster occupancy entry, called with query_args(plan)), whether it
    keeps the step (`keeps`), and the checkout whose wrapper launches it
    (`pkg`; None: this one)."""

    def __init__(self, kernel, plans, keeps: bool, query=None,
                 query_args=None, pkg=None):
        self.kernel, self.plans, self.keeps = kernel, plans, keeps
        self.query, self.query_args, self.pkg = query, query_args, pkg


def build_designs(sc, build, root: str, sms: int, which: str) -> dict:
    """{name: Design} of this checkout: the kept kernel's VARIANTS and the
    forms' variants (`which`: "all"; or "forms": the kept kernel's own
    variants and parts and the forms' variants that keep their design)."""
    source = (build.CSRC / sc.SGNS_CONV_ACCUMULATE.source).read_text()
    text_of = lambda f: open(os.path.join(root, f)).read()
    acc = sc.SGNS_CONV_ACCUMULATE
    own = lambda b, T, D, w: [(None, None)]
    out = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        if which == "forms" and not (name == "base" or "accumulat" in name
                                     or name == "taken out: the dots"):
            continue
        out[name] = Design(source_kernel(f"v{i}", edited(source, edits),
                                         acc.symbol, acc.argtypes,
                                         "conv_parts"),
                           own, not name.startswith("taken"))
    for i, (name, edits) in enumerate(SPLIT_VARIANTS.items()):
        text = source + "\n" + edited(text_of(SPLIT_SOURCE), edits)
        out[name] = Design(
            source_kernel(f"s{i}", text, "srw_sgns_conv_accumulate_split_"
                          "launch", acc.argtypes, "conv_parts"),
            lambda b, T, D, w: [(f"C {c}", split_plan(sc, b, T, D, w, c))
                                for c in SPLIT_CLUSTERS],
            True, source_kernel(f"s{i}", text,
                                "srw_sgns_conv_split_clusters",
                                [ctypes.c_int] * 3 + [ctypes.c_void_p],
                                "conv_parts"),
            lambda p: (p.tiles, p.cols, p.smem_bytes))
    for i, (name, edits) in enumerate(CLUSTER_VARIANTS.items()):
        if which == "forms" and edits:
            continue
        text = source + "\n" + edited(text_of(CLUSTER_SOURCE), edits)
        out[name] = Design(
            source_kernel(f"c{i}", text, "srw_sgns_conv_accumulate_cluster_"
                          "launch", acc.argtypes, "conv_parts"),
            lambda b, T, D, w, halo=name not in IN_PLACE: [
                (None, cluster_plan(sc, b, T, D, w, sms, halo=halo))],
            not name.startswith("taken"),
            source_kernel(f"c{i}", text, "srw_sgns_conv_max_clusters",
                          [ctypes.c_int] * 2 + [ctypes.c_void_p],
                          "conv_parts"),
            lambda p: (p.tiles, p.smem_bytes))
    return out


def under(sc, plan):
    """A workspace factory of `sc` (a checkout's ops/sgns_conv.py) whose
    accumulate kernel runs under `plan`."""
    def make(*args):
        made = sc.launch_plan
        sc.launch_plan = lambda *a, **k: plan
        try:
            return sc.ConvWorkspace(*args)
        finally:
            sc.launch_plan = made
    return make


def launches_of(tables, window: int, kernel=None, plan=None, pkg=None):
    """A function that makes one step's launches and the tables they move,
    on a workspace and tables of their own: this checkout's, or another
    checkout's (`pkg`), with its accumulate kernel replaced by `kernel`
    (None: its own) under `plan` (None: its own)."""
    pkg = pkg or (lambda sub: importlib.import_module(
        f"stellar_rw_tpu_torch.{sub}"))
    sc = pkg("ops.sgns_conv")
    normal = sc.SGNS_CONV_ACCUMULATE

    def make():
        kw = {} if plan is None else {"workspace": under(sc, plan)}
        fns, moved = conv_step_fns(pkg, tables, window, LR, 5 / KB, **kw)
        if kernel is None:
            return fns, moved

        def run():
            sc.SGNS_CONV_ACCUMULATE = kernel
            try:
                fns[0]()
            finally:
                sc.SGNS_CONV_ACCUMULATE = normal
        return [run, *fns[1:]], moved
    return make


def run_forms(torch, designs: dict, parent, cases, say,
              strict: bool) -> list:
    """Each design at `cases` ((tokens, T, window, D, B)) and the parent's
    step: each design that keeps the step held to the float64 step (strict:
    a miss stops the script; else it is reported and not timed), then every
    launch of each step between CUDA events and the accumulate launch back
    to back, in turns. Returns the labels that missed."""
    from stellar_rw_tpu_torch.ops import sgns_conv as sc

    failed = []
    for ci, (tokens, T, win, D, b) in enumerate(cases):
        tables = conv_block(torch, V, b, T, win, KB, D, ci, tokens)
        w_in, w_out, block, cwin, negs = tables
        want = (w_in.double(), w_out.double())
        sc.sgns_conv_step_ref(*want, block, cwin, negs, LR, 5 / KB, win)
        case = dict(tokens=tokens, B=b, T=T, window=win, kB=KB, D=D)
        makers, plans, errs = {}, {}, {}

        def held(label, make, keeps):
            fns, moved = make()
            err = _try(lambda: [fn() for fn in fns]
                       + [torch.cuda.synchronize()])
            if err:
                check(not strict, f"{label} at {case}: {err}")
                say(**case, form=label, launch_error=err[-2000:])
                return False
            if not keeps:
                return True
            errs[label] = max(float((a.double() - w).abs().max())
                              for a, w in zip(moved, want))
            if all(torch.allclose(a.double(), w, rtol=1e-5, atol=1e-6)
                   for a, w in zip(moved, want)):
                return True
            check(not strict, f"{label} misses the float64 step at {case}: "
                  f"max abs err {errs[label]:.3g}")
            say(**case, form=label, misses_float64=errs[label])
            return False

        if parent is not None:
            make = launches_of(tables, win, pkg=parent)
            if held("the parent's step", make, True):
                makers["the parent's step"] = make
        for name, d in designs.items():
            try:
                options = d.plans(b, T, D, win)
            except ValueError as e:
                say(**case, form=name, no_plan=str(e))
                continue
            for tag, plan in options:
                label = name if tag is None else f"{name}, {tag}"
                if plan is not None:
                    plans[label] = plan._asdict()
                if d.query is not None:
                    n = ctypes.c_int(0)
                    code = d.query.fn()(*d.query_args(plan), ctypes.byref(n))
                    check(code == 0, f"cluster occupancy query: CUDA error "
                          f"{code}")
                    plans[label]["placeable_clusters"] = n.value
                    if not n.value:     # a launch would be refused
                        continue
                make = launches_of(tables, win, d.kernel, plan, d.pkg)
                if held(label, make, d.keeps):
                    makers[label] = make
                else:
                    failed.append(label)
        names = list(makers)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            fns = makers[name]()[0]
            turns[name].append({"between_events": cuda_ms_split(fns, 20),
                                "back_to_back": cuda_ms(fns[0], 20)})
        say(**case, plans=plans, max_abs_err_f64=errs, ms_in_turns=turns)
    return failed


def _try(fn) -> str | None:
    """fn(), and None; or the error it raised, as text."""
    try:
        fn()
    except Exception as e:   # a form's launch, reported
        return f"{type(e).__name__}: {e}"
    return None


def accumulate_forms(torch, runs_kernel, tokens: str, T: int, win: int,
                     D: int, seed: int) -> dict:
    """The scatter in accumulate mode on a slot's conv block in each of
    ACCUMULATE_FORMS (`runs_kernel`: chip_conv_runs.cu's entry): each held
    to the float64 plain merged update of that slot (rtol 1e-5, atol 1e-6),
    then timed back to back in turns. Returns {"max_abs_err": {form: err},
    "ms_back_to_back_in_turns": {form: [ms, ms]}}."""
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import dp_apply as da
    from stellar_rw_tpu_torch.ops import sgns_conv as sc
    from stellar_rw_tpu_torch.ops import sgns_exact as se

    w_in, w_out, block, cwin, negs = conv_block(torch, V, B_SLOT, T, win,
                                                KB, D, seed, tokens)
    nw = 5 / KB
    want = (w_in.double(), w_out.double())
    buf64 = torch.zeros(da.buffer_numel(V, D), dtype=torch.float64,
                        device="cuda")
    sc.sgns_conv_accumulate_ref(*want, block, cwin, negs, nw, win, buf64)
    da.dp_apply_ref(*want, buf64, LR)
    ws = sc.ConvWorkspace(w_in, w_out, B_SLOT, T, win, KB)
    sc.launch_accumulate(ws, w_in, w_out, block, cwin, negs, win, nw)
    sc.launch_negative_half(ws)
    order = sc.group_blocks(block[None]).order[0]
    buf = torch.zeros(da.buffer_numel(V, D), device="cuda")
    forms, errs = {}, {}
    N, kB = B_SLOT * T, negs.shape[0]
    g = -(-D // 4)

    def runs(o, run):
        blocks = max(1, min(se.APPLY_BLOCKS,
                            -(-(kB + -(-N // run) * 2) * g // sc.THREADS)))
        runs_kernel.launch(
            build.ptr(block), None if o is None else build.ptr(o),
            build.ptr(ws.d_in), build.ptr(ws.acc_out), build.ptr(ws.cnt),
            build.ptr(ws.d_wn), build.ptr(negs), kB, build.ptr(ws.valid),
            ws.valid.numel(), float(nw), N, D, run, blocks,
            *da.buffer_ptrs(buf, V, D), build.stream(block.device))

    for name, by_token, run in ACCUMULATE_FORMS:
        forms[name] = (
            (lambda: sc.launch_scatter_accumulate(ws, block, negs, nw, buf))
            if run is None else
            (lambda o=order if by_token else None, run=run: runs(o, run)))
        forms[name]()
        got = (w_in.double(), w_out.double())
        da.dp_apply_ref(*got, buf.double(), LR)
        buf.zero_()
        errs[name] = max(float((a - b).abs().max())
                         for a, b in zip(got, want))
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                  for a, b in zip(got, want)),
              f"the accumulate-mode scatter ({name}) misses the float64 "
              f"merged update at {tokens, T, win, D}: max abs err "
              f"{errs[name]:.3g}")
    turns = {name: [] for name in forms}
    for name in list(forms) + list(forms)[::-1]:
        turns[name].append(cuda_ms(forms[name], 20))
    return {"max_abs_err": errs, "ms_back_to_back_in_turns": turns}


def probe_fn(torch, probe, tables):
    """The gather-and-store probe (chip_conv_probe.cu) on a conv block: one
    launch as a function, on outputs of its own."""
    from stellar_rw_tpu_torch.ops import _build as build

    w_in, w_out, block, _, negs = tables
    N, D, kB = block.numel(), w_in.shape[1], negs.shape[0]
    outs = [torch.empty((N, D), device="cuda") for _ in range(3)]
    wn = torch.empty((kB, D), device="cuda")
    blocks = max(1, min(4 * 132, -(-(N + kB) * (D // 4) // 256)))
    return lambda: probe.launch(
        build.ptr(w_in), build.ptr(w_out), build.ptr(block), build.ptr(negs),
        kB, N, D, *(build.ptr(t) for t in (*outs, wn)), blocks,
        build.stream(w_in.device))


def clocked(torch, launch, clocks, phases) -> dict:
    """clock64 cycles a block by phase of one launch (`launch`, a clocked
    kernel's; `clocks`, its srw_conv_clocks), after the warm-up's are read
    away."""
    clk = (ctypes.c_ulonglong * 16)()
    for _ in range(2):
        launch()
        torch.cuda.synchronize()
        check(clocks.fn()(clk) == 0, "reading g_clk failed")
    n = max(clk[15], 1)
    return {"blocks": clk[15], "cycles_a_block": {
        p: clk[j] / n for j, p in enumerate(phases)}}


def step0(torch, sc, build, root: str, parent, parent_root: str,
          say) -> None:
    """The parent's accumulate kernel (its csrc/sgns_conv.cu, launched
    through its own wrapper) at phase 14's main block: PARENT_VARIANTS,
    each launch between CUDA events and back to back, in turns, with the
    gather-and-store probe; clock64 cycles a block by phase
    (PARENT_CLOCKS); ptxas' registers and the blocks an SM holds. Then the
    kept kernel's clock64 cycles (ACC_CLOCKS) and blocks an SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    source = (build.CSRC / sc.SGNS_CONV_ACCUMULATE.source).read_text()
    psc = parent("ops.sgns_conv")
    pacc, acc = psc.SGNS_CONV_ACCUMULATE, sc.SGNS_CONV_ACCUMULATE
    ptext = open(os.path.join(parent_root, "stellar_rw_tpu_torch", "csrc",
                              pacc.source)).read()
    own = lambda *a: [(None, None)]
    designs = {name: Design(source_kernel(
        f"p{i}", edited(ptext, edits), pacc.symbol, pacc.argtypes,
        "conv_parts"), own, "taken out" not in name, pkg=parent)
        for i, (name, edits) in enumerate(PARENT_VARIANTS.items())}
    occ = lambda name, text: source_kernel(
        name, text, "srw_conv_occupancy", [ctypes.c_int, ctypes.c_void_p],
        "conv_parts")
    extra = {
        "parent": occ("p_occ", ptext + OCCUPANCY_TAIL.replace(
            "KERNEL", "sgns_conv_accumulate").replace("THREADS", "kThreads")),
        "kept": occ("a_occ", source + OCCUPANCY_TAIL.replace(
            "KERNEL", "sgns_conv_accumulate<kAccThreads>").replace(
            "THREADS", "kAccThreads"))}
    texts = {"parent": (edited(ptext, PARENT_CLOCKS) + CLOCK_TAIL, pacc),
             "kept": (edited(source, ACC_CLOCKS) + CLOCK_TAIL, acc)}
    clocks = {name: (source_kernel(f"{name}_clk", text, k.symbol, k.argtypes,
                                   "conv_parts"),
                     source_kernel(f"{name}_clk", text, "srw_conv_clocks",
                                   [ctypes.c_void_p], "conv_parts"))
              for name, (text, k) in texts.items()}
    probe = source_kernel("probe", open(os.path.join(
        root, PROBE_SOURCE)).read(), "srw_conv_probe_launch", PROBE_ARGTYPES,
        "conv_parts")
    every = ([d.kernel for d in designs.values()]
             + [k for k, _ in clocks.values()] + [*extra.values(), probe])
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), every))
    for _, k in clocks.values():
        k.fn()
    say(step0="ptxas", **{name: ptxas_by_kernel(d.kernel.build_log)
                          for name, d in designs.items()},
        kept=ptxas_by_kernel(clocks["kept"][0].build_log))

    tokens, T, win, D = CASES[0]
    tables = conv_block(torch, V, B, T, win, KB, D, 0, tokens)
    case = dict(tokens=tokens, B=B, T=T, window=win, kB=KB, D=D)
    plans = {"parent": psc.launch_plan(B, T, D, win, sms),
             "kept": sc.launch_plan(B, T, D, win, sms)}
    for name, phases, pkg in (("parent", PARENT_PHASES, parent),
                              ("kept", ACC_PHASES, None)):
        n = ctypes.c_int(0)
        check(extra[name].fn()(plans[name].smem_bytes, ctypes.byref(n))
              == 0, "cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
        make = launches_of(tables, win, clocks[name][0], pkg=pkg)
        say(step0=f"clock64 cycles a block by phase, one launch: {name}",
            **case, plan=plans[name]._asdict(), blocks_an_sm=n.value,
            **clocked(torch, make()[0][0], clocks[name][1], phases))
    failed = run_forms(torch, designs, None, [(*CASES[0], B)],
                       lambda **kw: None, True)
    check(not failed, f"step 0: {failed}")
    names = list(designs)
    probe_run = probe_fn(torch, probe, tables)
    turns = {name: [] for name in [*names, "gather-and-store probe"]}
    for name in names + names[::-1]:
        fns = launches_of(tables, win, designs[name].kernel, pkg=parent)()[0]
        turns[name].append({"between_events": cuda_ms_split(fns, 20)[0],
                            "back_to_back": cuda_ms(fns[0], 20)})
        if name == names[-1]:
            turns["gather-and-store probe"].append(
                {"between_events": cuda_ms_split([probe_run], 20)[0],
                 "back_to_back": cuda_ms(probe_run, 20)})
    say(step0="the parent's accumulate kernel, ms in turns", **case,
        plan=plans["parent"]._asdict(), ms_in_turns=turns)


def split_parts(torch, sc, build, root: str, say, cases) -> None:
    """Form (a) at `cases` ((tokens, T, window, D, B, C)): clock64 cycles a
    block by phase (SPLIT_CLOCKS) for one launch, and its parts taken out
    (SPLIT_TAKEN_OUT) beside it, back to back and between CUDA events, in
    turns."""
    source = (build.CSRC / sc.SGNS_CONV_ACCUMULATE.source).read_text()
    split = open(os.path.join(root, SPLIT_SOURCE)).read()
    acc = sc.SGNS_CONV_ACCUMULATE
    symbol = "srw_sgns_conv_accumulate_split_launch"
    kernels = {"(a) split": source_kernel(
        "s_base", source + "\n" + split, symbol, acc.argtypes, "conv_parts")}
    for i, (name, edits) in enumerate(SPLIT_TAKEN_OUT.items()):
        kernels[name] = source_kernel(
            f"s_out{i}", source + "\n" + edited(split, edits), symbol,
            acc.argtypes, "conv_parts")
    clock_text = source + "\n" + edited(split, SPLIT_CLOCKS) + CLOCK_TAIL
    clock = source_kernel("s_clk", clock_text, symbol, acc.argtypes,
                          "conv_parts")
    clocks = source_kernel("s_clk", clock_text, "srw_conv_clocks",
                           [ctypes.c_void_p], "conv_parts")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), [*kernels.values(), clock]))
    clocks.fn()
    say(split_parts="ptxas", **{name: ptxas_by_kernel(k.build_log)
                                for name, k in kernels.items()})
    for ci, (tokens, T, win, D, b, c) in enumerate(cases):
        tables = conv_block(torch, V, b, T, win, KB, D, ci, tokens)
        plan = split_plan(sc, b, T, D, win, c)
        case = dict(tokens=tokens, B=b, T=T, window=win, kB=KB, D=D, C=c,
                    plan=plan._asdict())
        say(**case, **clocked(torch, launches_of(
            tables, win, clock, plan)()[0][0], clocks, SPLIT_PHASES))
        names = list(kernels)
        turns = {k: [] for k in names}
        for name in names + names[::-1]:
            fns = launches_of(tables, win, kernels[name], plan)()[0]
            turns[name].append({"between_events": cuda_ms_split(fns, 20)[0],
                                "back_to_back": cuda_ms(fns[0], 20)})
        say(**case, ms_in_turns=turns)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import sgns_conv as sc

    root = os.path.dirname(os.path.realpath(__file__))
    args = [a for a in argv if not a.startswith("--")]
    parent_root = os.path.realpath(args[0] if args
                                   else os.path.join(root, PARENT))
    if not parent_root.startswith(os.path.join(root, "build") + os.sep):
        print("chip_conv_parts: PARENT_CHECKOUT must lie under this "
              "checkout's build/", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    if "--step0" in argv:
        step0(torch, sc, build, root, load_package(parent_root, "srw_parent"),
              parent_root, say)
        return 0
    if "--split-parts" in argv:
        split_parts(torch, sc, build, root, say,
                    [(*CASES[0], B, 4), (*CASES[0], B, 8),
                     (*CASES[0], B_SLOT, 8), (*CASES[2], B, 8)])
        return 0
    parent = load_package(parent_root, "srw_parent")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forms_only = "--forms" in argv
    designs = build_designs(sc, build, root, sms,
                            "forms" if forms_only else "all")
    runs_kernel = source_kernel(
        "runs", (build.CSRC / sc.SGNS_CONV_ACCUMULATE.source).read_text()
        + "\n" + open(os.path.join(root, RUNS_SOURCE)).read(),
        "srw_sgns_conv_scatter_accumulate_runs_launch", RUNS_ARGTYPES,
        "conv_parts")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(),
                      [d.kernel for d in designs.values()] + [runs_kernel]))
    for name, d in designs.items():
        if d.query is not None:
            d.query.fn()
        say(variant=name, ptxas=ptxas_by_kernel(d.kernel.build_log))
    if forms_only:
        failed = run_forms(torch, designs, parent,
                           [(*CASES[0], B), (*CASES[2], B),
                            (*CASES[0], B_SLOT), (*CASES[2], B_SLOT)],
                           say, False)
        say(forms_failed=failed)
        return 1 if failed else 0
    run_forms(torch, designs, parent, [(*c, B) for c in CASES]
              + [(*CASES[0], B_SLOT), (*CASES[2], B_SLOT)], say, True)
    this = lambda sub: importlib.import_module(f"stellar_rw_tpu_torch.{sub}")
    base, cluster = designs["base"], designs["cluster a walk"]
    for ci, (tokens, T, win, D) in enumerate(CASES):
        tables = conv_block(torch, V, B, T, win, KB, D, ci, tokens)
        case = dict(tokens=tokens, B=B, T=T, window=win, kB=KB, D=D)
        tried = {f"the kept kernel, tiles of {t}": Design(
            base.kernel, lambda *a, t=t: [(None, sc.launch_plan(
                B, T, D, win, sms, tiles=(t,)))], True)
            for t in TILES_TRIED}
        for c in CLUSTER_SIZES:
            tried[f"the position-split cluster, {c} blocks a walk"] = Design(
                cluster.kernel, lambda *a, c=c: [(None, cluster_plan(
                    sc, B, T, D, win, sms, clusters=(c,)))], True,
                cluster.query, cluster.query_args)
        run_forms(torch, tried, None, [(tokens, T, win, D, B)], say, True)
        hubs = {}
        for hub in HUBS:
            h = hub or B * T
            fns, _ = conv_step_fns(this, tables, win, LR, 5 / KB, hub=h)
            hubs[str(hub)] = cuda_ms_split(fns, 20)[2]
        say(**case, scatter_ms_by_hub=hubs)
        say(**{**case, "B": B_SLOT}, accumulate_scatter=accumulate_forms(
            torch, runs_kernel, tokens, T, win, D, ci))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
