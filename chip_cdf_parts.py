#!/usr/bin/env python3
"""Where the exact-CDF walk kernel's time goes on one GPU, and the forms of
its redesign: the parent checkout's kernel and this checkout's, each with
parts changed or taken out, at chip_smoke's phase-10 corpus.

    python3 chip_cdf_parts.py [PARENT_CHECKOUT] [--step0]

PARENT_CHECKOUT (build/parent when not given) is the root of a checkout of
the commit before (a `git archive` of it unpacked under build/, which
.gitignore lists). A kernel text is a checkout's csrc/cdf_walk.cu with its
csrc/cdf_pick.cuh written in where it is included (kernel_text), with
pieces of text replaced (a piece that is not exactly once in the text stops
the script; tests/test_torch_kernel_plans.py holds this checkout's VARIANTS
to its text), built under build/cdf_parts/. The parent's texts are launched
through the parent's own wrapper (its ops/cdf_walk.py), this checkout's
through its own.

Step 0 (the parent alone; with --step0 nothing else runs):
  (i)   the row entries of the corpus's steps by class of deg(cur) (< 256,
        256-1,023, 1,024-8,191, >= 8,192): steps and entries, and their
        shares;
  (ii)  clock64 cycles a step of the chunked pick's total pass and of its
        find pass, by class, read through srw_cdf_clocks (CLOCKS: the pick
        returns by one exit that adds its warp's cycles to a class);
  (iii) ptxas' registers of every instantiation and the resident blocks an
        SM of the chunked f32 and f64 kernels
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's
        shared memory, srw_cdf_occupancy), for every text built;
  (iv)  the row-stream probe (chip_cdf_probe.cu): one warp a walker reads
        each step's row whole, then again up to the picked vertex's first
        entry, no weighing: the card's own floor for reading these rows in
        the kernel's order, beside phase 10's bound (operations);
  (v)   the parent with the bucket read, or the find pass after its first
        piece, taken out (TAKEN_OUT; the corpus walks elsewhere, so the
        entries its walks scanned stand beside its time).

Then this checkout's kernel and its forms (VARIANTS: parts taken out of
the bitmap form; WORDS: the bitmap padded as a larger V would need it),
each held bit for bit to the parent's corpus but for the parts taken out
(WRONG_BY_DESIGN), with clock64 cycles by class of this checkout's
kernel, timed in turns with the parent: the parent first, each form, then
back, twice. The bound stands beside them twice: every entry at
chip_smoke's OPS_PER_ENTRY (the parent's scan), and the entries of this
checkout's bitmap steps at OPS_PER_BITMAP_ENTRY (cdf_scan_ops). Last, a 16-regular graph's rows (one piece a step)
in the chunked and padded forms, the parent beside this checkout, and this
checkout's bitmap form there (which its wrapper does not launch: no row
reaches the gate).

The corpus is phase 10's: chip_smoke's walk_10k graph, 10,000 walkers x 10
rounds x walk length 80 at (p, q) = (1/16, 4), the chunked form, float32.
Times are chip_smoke's cuda_ms (CUDA events around 3 launches queued behind
a long product). One JSON object a line, the card's name and power limit in
each. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (INT_OPS_PER_S, cdf_registers, cdf_row_probe,
                        cdf_scan_ops, check, cuda_ms, edited, regular_graph,
                        source_kernel, synth_power_law_graph)
from chip_compare import load_package

PARENT = os.path.join("build", "parent")
# the classes of deg(cur): their upper ends
CLASSES = (256, 1024, 8192)
CLASS_NAMES = ("< 256", "256-1,023", "1,024-8,191", ">= 8,192")

# the bucket read of a second-order weight, and a constant-time stand-in
BUCKET_READ = (
    "    const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;\n"
    "    const int4 b = __ldg(&buckets[pv.bucket_base +\n"
    "                                  static_cast<int>(h & pv.bucket_mask)]);"
    "\n    f = (b.x == e.x || b.y == e.x || b.z == e.x || b.w == e.x) ? T(1) "
    ": inv_q;\n")
NO_BUCKET_READ = "taken out: the bucket read (f from the entry's low bit)"
NO_FIND = "taken out: the find pass after its first piece"
NO_BITMAP_READ = "taken out: the bitmap read (f from the entry's low bit)"
NO_FIND_BITS = "taken out: pick_bits's find pass after its first piece"
# parts of the bucket form (pick's), taken out of the parent's text
TAKEN_OUT = {
    NO_BUCKET_READ: [(BUCKET_READ, "    f = (e.x & 1) ? T(1) : inv_q;\n")],
    NO_FIND: [
        ("      cum = __shfl_sync(kFull, c, 31);\n    }\n    return -1;",
         "      cum = __shfl_sync(kFull, c, 31);\n      break;\n    }\n"
         "    return -1;")],
}

# clock64 cycles by class of deg(cur): a row class's total pass, find pass,
# bitmap marks and clears, steps (g_clk), added by lane 0 of each warp
CLOCK_DECL = [(
    "constexpr uint32_t kHashMult = 2654435761u;\n",
    "constexpr uint32_t kHashMult = 2654435761u;\n"
    "__device__ unsigned long long g_clk[4][4];\n"
    "__device__ __forceinline__ int clock_class(int d) {\n"
    "  return d < 256 ? 0 : d < 1024 ? 1 : d < 8192 ? 2 : 3;\n"
    "}\n"
    "__device__ __forceinline__ void clock_step(int d, long long c0,\n"
    "                                           long long c1, int lane) {\n"
    "  const long long c2 = clock64();\n"
    "  if (lane == 0) {\n"
    "    const int k = clock_class(d);\n"
    "    atomicAdd(&g_clk[k][0], (unsigned long long)(c1 - c0));\n"
    "    atomicAdd(&g_clk[k][1], (unsigned long long)(c2 - c1));\n"
    "    atomicAdd(&g_clk[k][3], 1ull);\n"
    "  }\n"
    "}\n")]
# pick's chunked form (the bucket branch; the parent's only form)
PICK_CLOCKS = [
    ("  if (kChunked) {\n    T acc = T(0);\n",
     "  if (kChunked) {\n    const long long c0 = clock64();\n"
     "    T acc = T(0);\n"),
    ("    const T thresh = O::mul(u, butterfly(acc));\n    T cum = T(0);\n",
     "    const T thresh = O::mul(u, butterfly(acc));\n"
     "    const long long c1 = clock64();\n    T cum = T(0);\n"),
    ("      if (hit) return base + __ffs(hit) - 1;\n"
     "      cum = __shfl_sync(kFull, c, 31);\n    }\n    return -1;\n",
     "      if (hit) {\n        clock_step(d, c0, c1, lane);\n"
     "        return base + __ffs(hit) - 1;\n      }\n"
     "      cum = __shfl_sync(kFull, c, 31);\n    }\n"
     "    clock_step(d, c0, c1, lane);\n    return -1;\n"),
]
# pick_bits, and the kernel's bitmap branch (marks and clears)
BITS_CLOCKS = [
    ("  T acc = T(0);\n  for (int i = lane; i < d; i += 32)\n"
     "    acc = O::add(acc, weigh_bits(",
     "  const long long c0 = clock64();\n"
     "  T acc = T(0);\n  for (int i = lane; i < d; i += 32)\n"
     "    acc = O::add(acc, weigh_bits("),
    ("  const T thresh = O::mul(u, butterfly(acc));\n  T cum = T(0);\n",
     "  const T thresh = O::mul(u, butterfly(acc));\n"
     "  const long long c1 = clock64();\n  T cum = T(0);\n"),
    ("    if (hit) return base + __ffs(hit) - 1;\n"
     "    cum = __shfl_sync(kFull, c, 31);\n  }\n  return -1;  // the row head\n",
     "    if (hit) {\n      clock_step(d, c0, c1, lane);\n"
     "      return base + __ffs(hit) - 1;\n    }\n"
     "    cum = __shfl_sync(kFull, c, 31);\n  }\n"
     "  clock_step(d, c0, c1, lane);\n  return -1;  // the row head\n"),
    ("      mark_neighbors(pv, buckets, bm, lane);\n"
     "      j = pick_bits<T>(rows, cm.x, cm.y, u, prev, bm, inv_p, inv_q, lane);\n"
     "      if (words < kClearByWords * (pv.bucket_mask + 1))\n"
     "        zero_bitmap(bm, words, lane);\n"
     "      else\n"
     "        clear_neighbors(pv, buckets, bm, lane);\n",
     "      const long long m0 = clock64();\n"
     "      mark_neighbors(pv, buckets, bm, lane);\n"
     "      const long long m1 = clock64();\n"
     "      j = pick_bits<T>(rows, cm.x, cm.y, u, prev, bm, inv_p, inv_q, lane);\n"
     "      const long long m2 = clock64();\n"
     "      if (words < kClearByWords * (pv.bucket_mask + 1))\n"
     "        zero_bitmap(bm, words, lane);\n"
     "      else\n"
     "        clear_neighbors(pv, buckets, bm, lane);\n"
     "      if (lane == 0)\n"
     "        atomicAdd(&g_clk[clock_class(cm.y)][2],\n"
     "                  (unsigned long long)((m1 - m0) + (clock64() - m2)));\n"),
]
CLOCK_TAIL = """
// g_clk since the last call: [class][total, find, marks and clears, steps]
extern "C" void srw_cdf_clocks(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  const unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}
"""
OCCUPANCY_TAIL = """
// resident blocks an SM of the chunked kernel (f64 or f32) at smem bytes of
// dynamic shared memory
extern "C" int srw_cdf_occupancy(int f64, int smem, int* blocks) {
  return static_cast<int>(
      f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, KERNEL_F64,
                                                          256, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, KERNEL_F32,
                                                          256, smem));
}
"""
# KERNEL_F32 / KERNEL_F64: the chunked kernel of a text (this checkout's:
# the bitmap form)
CHUNKED_FORM = {"parent": "cdf_walk_kernel<T, true>",
                "this": "cdf_walk_bitmap_kernel<T, false>"}

# name -> [(text in this checkout's kernel text, its replacement), ...]
VARIANTS = {
    "base": [],
    NO_BITMAP_READ: [(
        "  const T f = e.x == prev                           ? inv_p\n"
        "              : (bm[e.x >> 5] >> (e.x & 31)) & 1u ? T(1)\n",
        "  const T f = e.x == prev                           ? inv_p\n"
        "              : (e.x & 1)                          ? T(1)\n")],
    NO_FIND_BITS: [(
        "    cum = __shfl_sync(kFull, c, 31);\n  }\n  return -1;  // the row "
        "head\n",
        "    cum = __shfl_sync(kFull, c, 31);\n    break;\n  }\n  return -1;"
        "  // the row head\n")],
}
WRONG_BY_DESIGN = {NO_BUCKET_READ, NO_FIND, NO_BITMAP_READ, NO_FIND_BITS}
# this checkout's base with a warp's bitmap padded to more words (a larger
# V's shared memory; the first ceil(V / 32) are read)
WORDS = {"the bitmap padded to 512 words (V 16,384)": 512,
         "the bitmap padded to 768 words (V 24,576)": 768}
L, R, P, Q = 80, 10, 0.0625, 4.0


def kernel_text(root: str | None = None) -> str:
    """A checkout's csrc/cdf_walk.cu with its csrc/cdf_pick.cuh written in
    where it is included (this checkout's when root is None): the one text
    the edits apply to."""
    from stellar_rw_tpu_torch.ops import _build as build

    csrc = (build.CSRC if root is None
            else build.Path(root) / "stellar_rw_tpu_torch" / "csrc")
    source = (csrc / "cdf_walk.cu").read_text()
    header = (csrc / "cdf_pick.cuh").read_text()
    include = '#include "cdf_pick.cuh"\n'
    if source.count(include) != 1:
        raise RuntimeError("cdf_walk.cu does not include cdf_pick.cuh once")
    return source.replace(include, header.replace("#pragma once\n", ""))


def step_classes(torch, corpus, vmeta) -> dict:
    """The corpus's steps (cur = column t, a live column t + 1) by class of
    deg(cur): steps and row entries, with their shares."""
    live = corpus[:, 1:] >= 0
    deg = vmeta[corpus[:, :-1].clamp_min(0).long(), 1].long() * live
    bounds = torch.tensor(CLASSES, device=deg.device)
    cls = torch.bucketize(deg, bounds, right=True)
    steps = [int(((cls == k) & live).sum()) for k in range(4)]
    entries = [int((deg * (cls == k)).sum()) for k in range(4)]
    return {name: {"steps": s, "entries": e,
                   "share_of_steps": s / max(sum(steps), 1),
                   "share_of_entries": e / max(sum(entries), 1)}
            for name, s, e in zip(CLASS_NAMES, steps, entries)}


def main() -> int:
    import torch

    args = [a for a in sys.argv[1:] if a != "--step0"]
    step0_only = "--step0" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_cdf_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import cdf_walk as cw
    from stellar_rw_tpu_torch.ops import prng, sampling
    from stellar_rw_tpu_torch.walk import engine

    here = os.path.dirname(os.path.realpath(__file__))
    parent_root = os.path.realpath(args[0] if args
                                   else os.path.join(here, PARENT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    parent = load_package(parent_root, "srw_parent")
    pcw = parent("ops.cdf_walk")
    parent_text = kernel_text(parent_root)
    this_text = kernel_text()

    def build(name, text, argtypes, form, clocks=False):
        tail = OCCUPANCY_TAIL.replace(
            "KERNEL_F32", CHUNKED_FORM[form].replace("<T", "<float")).replace(
            "KERNEL_F64", CHUNKED_FORM[form].replace("<T", "<double"))
        return source_kernel(
            name, text + tail + (CLOCK_TAIL if clocks else ""),
            cw.CDF_WALK_KERNEL.symbol, argtypes, "cdf_parts")

    P_ARGS, T_ARGS = pcw.CDF_WALK_KERNEL.argtypes, cw.CDF_WALK_KERNEL.argtypes
    kernels = {"parent": (build("parent", parent_text, P_ARGS, "parent"),
                          pcw),
               "parent clocks": (build("parent_clocks", edited(
                   parent_text, CLOCK_DECL + PICK_CLOCKS), P_ARGS, "parent",
                   True), pcw)}
    for i, (name, edits) in enumerate(TAKEN_OUT.items()):
        kernels[f"parent, {name}"] = (build(f"parent_{i}", edited(
            parent_text, edits), P_ARGS, "parent"), pcw)
    if not step0_only:
        for i, (name, edits) in enumerate(VARIANTS.items()):
            kernels[name] = (build(f"variant_{i}", edited(this_text, edits),
                                   T_ARGS, "this"), cw)
        kernels["clocks"] = (build("clocks", edited(
            this_text, CLOCK_DECL + PICK_CLOCKS + BITS_CLOCKS), T_ARGS,
            "this", True), cw)
    probe = cdf_row_probe()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(),
                      [k for k, _ in kernels.values()] + [probe]))

    graph = synth_power_law_graph(10_000, 334_000, seed=0)
    V = graph.num_vertices
    key = prng.prng_key(0)
    spec = engine.walk_spec(graph, L, R, P, Q, "cdf", 16, "float32", V)
    dg = sampling.device_put_graph(graph, "cuda", cdf=True)
    starts = torch.arange(V, dtype=torch.int32, device="cuda")
    words = cw.bitmap_words(V, spec.cdf_chunk)

    def run(name, n_words=None):
        kernel, mod = kernels[name]

        def fn():
            saved = mod.CDF_WALK_KERNEL
            saved_words = getattr(mod, "bitmap_words", None)
            mod.CDF_WALK_KERNEL = kernel
            if n_words is not None:
                mod.bitmap_words = lambda V, chunk: n_words
            try:
                return mod.cdf_walk_rounds(dg, starts, key, 0, R, L, P, Q,
                                           spec.max_degree, spec.cdf_chunk)
            finally:
                mod.CDF_WALK_KERNEL = saved
                if n_words is not None:
                    mod.bitmap_words = saved_words
        return fn

    def occupancy(kernel, smem):
        lib = ctypes.CDLL(str(kernel._build()))
        lib.srw_cdf_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
        out = {}
        for f64 in (0, 1):
            blocks = ctypes.c_int(0)
            code = lib.srw_cdf_occupancy(f64, smem, ctypes.byref(blocks))
            out["f64" if f64 else "f32"] = (blocks.value * 8 if code == 0
                                            else f"CUDA error {code}")
        return out

    def clocks_of(name, fn):
        kernel = kernels[name][0]
        lib = ctypes.CDLL(str(kernel._build()))
        lib.srw_cdf_clocks.argtypes = [ctypes.c_void_p]
        lib.srw_cdf_clocks.restype = None
        buf = (ctypes.c_ulonglong * 16)()
        fn()
        torch.cuda.synchronize()
        lib.srw_cdf_clocks(buf)
        got = fn()
        torch.cuda.synchronize()
        lib.srw_cdf_clocks(buf)
        out = {}
        for k, cname in enumerate(CLASS_NAMES):
            tot, find, marks, n = (int(buf[4 * k + j]) for j in range(4))
            e = max(classes[cname]["entries"], 1)
            out[cname] = {
                "steps": n, "total_pass_cycles_a_step": tot / max(n, 1),
                "find_pass_cycles_a_step": find / max(n, 1),
                "marks_and_clears_cycles_a_step": marks / max(n, 1),
                "total_pass_cycles_an_entry": tot / e,
                "find_pass_cycles_an_entry": find / e}
        return got, out

    # step 0: the parent
    want = run("parent")()
    torch.cuda.synchronize()
    deg = dg.vmeta[:, 1].long()
    live = want[:, 1:] >= 0
    scanned = int((deg[want[:, :-1].clamp_min(0).long()] * live).sum())
    steps = int(live.sum())
    second = want[:, 2:] >= 0
    on = cw.bitmap_steps(dg.vmeta, want[:, 1:-1].clamp_min(0),
                         want[:, :-2].clamp_min(0), spec.cdf_chunk) & second
    classes = step_classes(torch, want, dg.vmeta)
    say(step0="the corpus's steps by class of deg(cur)", steps=steps,
        entries=scanned, classes=classes,
        bitmap_steps_by_this_checkout_gate=int(on.sum()),
        bitmap_entries=int((deg[want[:, 1:-1].clamp_min(0).long()]
                            * on).sum()), words=words)
    got, clk = clocks_of("parent clocks", run("parent clocks"))
    check(torch.equal(got, want), "the parent's clocked kernel differs")
    say(step0="clock64 cycles a chunked step, the parent", classes=clk)
    for name, (kernel, mod) in kernels.items():
        say(kernel=name, registers=cdf_registers(kernel.build_log),
            resident_warps_an_sm=occupancy(
                kernel, 0 if mod is pcw else 4 * 8 * words))
    if not step0_only:
        say(kernel="base", resident_warps_an_sm_by_words={
            n: occupancy(kernels["base"][0], 4 * 8 * n)
            for n in WORDS.values()})
    out = torch.empty(want.shape[0], dtype=torch.int32, device="cuda")
    from stellar_rw_tpu_torch.ops._build import ptr, stream

    def probe_fn():
        probe.launch(ptr(want), ptr(dg.vmeta), ptr(dg.cdf_rows), ptr(out),
                     want.shape[0], L, stream(want.device))
        return out
    bitmap_entries = int((deg[want[:, 1:-1].clamp_min(0).long()]
                          * on).sum())
    bound_ms = {
        "every entry at OPS_PER_ENTRY (the parent's scan)":
            cdf_scan_ops(scanned, 0) / INT_OPS_PER_S * 1e3,
        "this checkout's bitmap entries at OPS_PER_BITMAP_ENTRY":
            cdf_scan_ops(scanned, bitmap_entries) / INT_OPS_PER_S * 1e3}
    parent_ms = [cuda_ms(run("parent"), 3), cuda_ms(run("parent"), 3)]
    probe_ms = [cuda_ms(probe_fn, 3), cuda_ms(probe_fn, 3)]
    say(step0="the row-stream probe", probe_ms=probe_ms, parent_ms=parent_ms,
        bound_ms=bound_ms, bound_by="operations", entries=scanned)
    names = ["parent"] + [n for n in kernels
                          if n.startswith("parent, ")]
    entries = {}
    for name in names[1:]:
        got = run(name)()
        entries[name] = int((deg[got[:, :-1].clamp_min(0).long()]
                             * (got[:, 1:] >= 0)).sum())
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(cuda_ms(run(name), 3))
    say(step0="the parent's parts taken out", ms_in_turns=turns,
        entries_scanned=entries)
    if step0_only:
        return 0

    # this checkout's forms, held bit for bit to the parent's corpus
    forms = {n: (lambda n=n: run(n)) for n in VARIANTS}
    for name, n in WORDS.items():
        forms[name] = lambda n=n: run("base", n)
    entries = {}
    for name, make in forms.items():
        got = make()()
        torch.cuda.synchronize()
        if name not in WRONG_BY_DESIGN:
            check(torch.equal(got, want), f"form {name!r} changes the corpus")
        entries[name] = int((deg[got[:, :-1].clamp_min(0).long()]
                             * (got[:, 1:] >= 0)).sum())
        del got
    got, clk = clocks_of("clocks", run("clocks"))
    check(torch.equal(got, want), "the clocked kernel differs")
    say(kernel="this checkout's clocks", classes=clk)
    order = ["parent"] + list(forms)
    turns = {name: [] for name in order}
    fns = {"parent": run("parent"), **{n: m() for n, m in forms.items()}}
    for name in (order + order[::-1]) * 2:
        turns[name].append(cuda_ms(fns[name], 3))
    say(graph="walk_10k", chunk=spec.cdf_chunk, max_degree=spec.max_degree,
        words=words, ms_in_turns=turns, entries_scanned=entries)

    # rows shorter than a warp: one piece a step, chunked and padded
    reg = regular_graph(10_000, 16, seed=0)
    dreg = sampling.device_put_graph(reg, "cuda", cdf=True)
    res = {}
    for chunk in (sampling.CDF_CHUNK, 0):
        for name, (kernel, mod) in (("parent", kernels["parent"]),
                                    ("this", kernels["base"])):
            def fn(kernel=kernel, mod=mod, chunk=chunk):
                saved = mod.CDF_WALK_KERNEL
                mod.CDF_WALK_KERNEL = kernel
                try:
                    return mod.cdf_walk_rounds(dreg, starts, key, 0, R, L, P,
                                               Q, 16, chunk)
                finally:
                    mod.CDF_WALK_KERNEL = saved
            res[f"{name} {'chunked' if chunk else 'padded'}"] = fn

    def forced():
        # this checkout's kernel given the bitmap its wrapper leaves out
        # where no row reaches the gate (the kernel's gate takes no step)
        saved = cw.BITMAP_MIN_ENTRIES
        cw.BITMAP_MIN_ENTRIES = 0
        try:
            return res["this chunked"]()
        finally:
            cw.BITMAP_MIN_ENTRIES = saved
    res["this chunked, given its bitmap"] = forced
    check(torch.equal(res["parent chunked"](), res["this chunked"]())
          and torch.equal(res["parent chunked"](), forced())
          and torch.equal(res["parent padded"](), res["this padded"]()),
          "the 16-regular corpora differ")
    say(graph="16-regular, 10,000 vertices", ms_in_turns={
        name: [cuda_ms(fn, 3), cuda_ms(fn, 3)] for name, fn in res.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
