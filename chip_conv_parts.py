#!/usr/bin/env python3
"""Where the conv step's two kernels' time goes on one GPU: the kernel
source with one part changed at a time, other launch plans and hub
thresholds, the thread-block cluster design of the accumulate kernel, and
the delta-slot scatter design the grouped update replaced, on blocks that
differ in one input at a time.

    python3 chip_conv_parts.py [OTHER_CHECKOUT]

A variant is csrc/sgns_conv.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script, so the list
is kept beside the kernel), built under build/ of the checkout. A cluster
variant is the same source with chip_conv_cluster.cu appended, pieces of
that file replaced (CLUSTER_VARIANTS), its accumulate kernel launched
through srw_sgns_conv_accumulate_cluster_launch under cluster_plan. A
variant that keeps the design computes the same step and is held to the
plain step in float64 (rtol 1e-5, atol 1e-6, as chip_smoke's phase 14 holds
the kernels) before it is timed; one with a phase taken out gives wrong
tables by design, and only its time is read. The parts:

  * the threads a block (256 in the base; 128, 384);
  * a tile's row loads in flight a thread (4 in the base; 1, 8);
  * the scatter-update's reads in flight a warp (8 in the base; 1, 16),
    and its rows read through L1 (base) or from L2 alone;
  * the accumulate kernel without its dots or its accumulations, either
    kernel with all but its launch taken out;
  * the tile: each of TILES_TRIED positions a block;
  * the hub threshold: the scatter-update over group_blocks' units of
    HUBS positions (None: no group split);
  * the accumulate kernel as a cluster a walk (chip_conv_cluster.cu): each
    row read once and each dot taken once, the neighbours' rows and g_pos
    copied into a local halo (base) or read in place, gathered by cp.async
    (base) or through registers, 4 or 8 lanes a dot, all but its launch;
    and each of CLUSTER_SIZES thread blocks a walk (above 8 with the
    non-portable attribute), each placed first
    (cudaOccupancyMaxActiveClusters);
  * with OTHER_CHECKOUT (the parent commit unpacked under build/, as for
    chip_compare.py), the earlier step: its halo tiles, its scatter into
    delta slots and the apply kernel;
  * the scatter-update's launch bounds (UPDATE_BOUNDS: the blocks an SM
    that ptxas must fit, 2 in the base);
  * the scatter in accumulate mode (the data-parallel trainer's, into a
    reduction buffer) in ACCUMULATE_FORMS: a position a thread (the
    trainer's kernel), or runs of 8 positions a thread in position order
    or in group_blocks' token order, consecutive positions of one token
    summed before their add (chip_conv_runs.cu, appended to the source and
    launched through srw_sgns_conv_scatter_accumulate_runs_launch); on a
    slot's block (B 16) of each case, each held to the float64 plain
    merged update of that slot, back to back, in turns.

Each is timed on chip_smoke's phase-14 block (B 32, T 82, w 10, kB 128,
V 10,000, D 128, Zipf tokens), and on its one-token block, at D 768, at T
201 (Zipf and one token) and at window 20 (CASES): each launch of a step
between CUDA events (chip_smoke's cuda_ms_split), every variant twice, in
turns. One JSON object a line, the card's name and power limit in each, and
ptxas' registers, stack frame and spills of every kernel of every variant. Needs a CUDA device; imports nothing of
JAX.
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
from chip_smoke import check, conv_block, cuda_ms, cuda_ms_split

# blocks an SM the scatter-update's launch bounds ask of ptxas in the
# variants (the base: kThreads, 2; kThreads alone asks none)
UPDATE_BOUNDS = ("kThreads", "kThreads, 3", "kThreads, 4")

# name -> [(text in csrc/sgns_conv.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    "128 threads a block": [("constexpr int kThreads = 256;",
                             "constexpr int kThreads = 128;")],
    "384 threads a block": [("constexpr int kThreads = 256;",
                             "constexpr int kThreads = 384;")],
    "a tile's row loads one at a time (kTileReads 1)": [
        ("constexpr int kTileReads = 4;", "constexpr int kTileReads = 1;")],
    "a tile's row loads 8 at a time (kTileReads 8)": [
        ("constexpr int kTileReads = 4;", "constexpr int kTileReads = 8;")],
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
        ("      const int hc = window + tl - side * d, hx = hc + d;\n"
         "      if (!pair_ok(s_tok, s_win, hc, hx)) continue;",
         "      const int hc = window + tl - side * d, hx = hc + d;\n"
         "      if (D > 0 || !pair_ok(s_tok, s_win, hc, hx)) continue;")],
    "taken out: the accumulations": [
        ("    for (int i = threadIdx.x; i < nt * w; i += blockDim.x) {",
         "    for (int i = threadIdx.x; i < nt * w && D < 0; "
         "i += blockDim.x) {")],
    "taken out: all of the accumulate kernel but the launch": [
        ("  const int W2 = 2 * window, H = tile + W2;\n",
         "  if (D > 0) return;\n  const int W2 = 2 * window, H = tile + W2;\n")],
    "taken out: all of the scatter-update but the launch": [
        ("  const int chunks = (D + 127) / 128;   // 128 columns a warp",
         "  if (D > 0) return;\n"
         "  const int chunks = (D + 127) / 128;   // 128 columns a warp")],
}
# name -> [(text in chip_conv_cluster.cu, its replacement), ...]
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
# variants whose tables are wrong by design (their time alone is read)
WRONG_BY_DESIGN = {name for name in [*VARIANTS, *CLUSTER_VARIANTS]
                   if name.startswith("taken")}
# cluster variants that read the neighbours' rows in place (no halo rows)
IN_PLACE = {name for name, edits in CLUSTER_VARIANTS.items()
            if ("constexpr bool kCopyHalo = true;",
                "constexpr bool kCopyHalo = false;") in edits}
CLUSTER_SOURCE = "chip_conv_cluster.cu"
CLUSTER_SIZES = (1, 2, 4, 8, 16)
TILES_TRIED = (4, 8, 16, 32)
HUBS = (8, 16, 32, 64, 128, None)
# (tokens, T, window, D)
CASES = [("zipf", 82, 10, 128), ("hub", 82, 10, 128), ("zipf", 82, 10, 768),
         ("zipf", 201, 10, 128), ("hub", 201, 10, 128),
         ("zipf", 82, 20, 128)]
V, B, KB, LR = 10_000, 32, 128, 0.025
# the scatter in accumulate mode: (name, in token order, positions a run;
# None: the trainer's kernel, a position a thread)
ACCUMULATE_FORMS = [("a position a thread (the trainer's)", False, None),
                    ("runs of 8, position order", False, 8),
                    ("runs of 8, token order", True, 8)]
B_SLOT = 16    # a slot's block at --w2vPartitions 2
RUNS_SOURCE = "chip_conv_runs.cu"
RUNS_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p]
                 + [ctypes.c_int] + [ctypes.c_float] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 5)


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



def cluster_smem_bytes(positions: int, window: int, cols: int, T: int,
                       halo: int) -> int:
    """The cluster kernel's shared memory a thread block: the ein and eout
    slices of its rows and of `halo` rows each side, their g_pos (2w a
    row), the walk's tokens and windows and its own positions' two pair
    counts."""
    R = positions + 2 * halo
    return 4 * (2 * R * cols + R * 2 * window + 2 * T + 2 * positions)


def cluster_plan(sc, B: int, T: int, D: int, window: int, sm_count: int,
                 clusters=(2, 4, 8), halo: bool = True):
    """The cluster kernel's plan as an ops/sgns_conv.py LaunchPlan (tile:
    positions a thread block, tiles: thread blocks a cluster, a walk): the
    fewest thread blocks a walk of `clusters` whose grid of B clusters gives
    every SM two (the most when none does; never more than T), the walk's
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
                         cluster_smem_bytes(positions, window, cols, T, hw))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import sgns_conv as sc

    root = os.path.dirname(os.path.realpath(__file__))
    other = None
    if argv:
        other_root = os.path.realpath(argv[0])
        if not other_root.startswith(os.path.join(root, "build") + os.sep):
            print("chip_conv_parts: OTHER_CHECKOUT must lie under this "
                  "checkout's build/", file=sys.stderr)
            return 2
        other = load_package(other_root, "srw_other")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    source = (build.CSRC / sc.SGNS_CONV_ACCUMULATE.source).read_text()
    cluster_text = open(os.path.join(root, CLUSTER_SOURCE)).read()
    runs_text = open(os.path.join(root, RUNS_SOURCE)).read()
    out_dir = os.path.join(root, "build", "conv_parts")
    os.makedirs(out_dir, exist_ok=True)

    def edited(text, edits):
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"not once in the source: {old!r}")
            text = text.replace(old, new)
        return text

    class Variant(build.Kernel):
        def __init__(self, index: int, text: str, symbol: str, argtypes):
            super().__init__(f"variant_{index}.cu", symbol, argtypes)
            self._path = build.Path(out_dir) / self.source
            self._path.write_text(text)

        @property
        def path(self):
            return self._path

    acc, scat = sc.SGNS_CONV_ACCUMULATE, sc.SGNS_CONV_SCATTER
    kernels = {}    # name -> (accumulate, scatter[, cluster query])
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = edited(source, edits)
        kernels[name] = (Variant(i, text, acc.symbol, acc.argtypes),
                         Variant(i, text, scat.symbol, scat.argtypes))
    for i, (name, edits) in enumerate(CLUSTER_VARIANTS.items(),
                                      len(VARIANTS)):
        text = source + "\n" + edited(cluster_text, edits)
        kernels[name] = (
            Variant(i, text, "srw_sgns_conv_accumulate_cluster_launch",
                    acc.argtypes),
            Variant(i, text, scat.symbol, scat.argtypes),
            Variant(i, text, "srw_sgns_conv_max_clusters",
                    [ctypes.c_int] * 2 + [ctypes.c_void_p]))
    runs_kernel = Variant(len(kernels), source + "\n" + runs_text,
                          "srw_sgns_conv_scatter_accumulate_runs_launch",
                          RUNS_ARGTYPES)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(),
                      [k[0] for k in kernels.values()] + [runs_kernel]))
    for name, (a, *rest) in kernels.items():
        for k in rest:
            k.fn()
        say(variant=name, ptxas=ptxas_by_kernel(a.build_log))
    say(variant=RUNS_SOURCE, ptxas=ptxas_by_kernel(runs_kernel.build_log))
    normal = (acc, scat)
    this = lambda sub: importlib.import_module(f"stellar_rw_tpu_torch.{sub}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def placed(name, plan) -> int:
        """The plan's clusters the card holds at once (0: refused)."""
        out = ctypes.c_int(0)
        code = kernels[name][2].fn()(plan.tiles, plan.smem_bytes,
                                     ctypes.byref(out))
        check(code == 0, f"cudaOccupancyMaxActiveClusters: CUDA error "
              f"{code}")
        return out.value

    def under(plan):
        """A workspace factory whose accumulate kernel runs under `plan`."""
        def make(*args):
            made = sc.launch_plan
            sc.launch_plan = lambda *a, **k: plan
            try:
                return sc.ConvWorkspace(*args)
            finally:
                sc.launch_plan = made
        return make

    for ci, (tokens, T, win, D) in enumerate(CASES):
        tables = conv_block(torch, V, B, T, win, KB, D, ci, tokens)
        w_in, w_out, block, cwin, negs = tables
        nw = 5 / KB
        want = (w_in.double(), w_out.double())
        sc.sgns_conv_step_ref(*want, block, cwin, negs, LR, nw, win)
        case = dict(tokens=tokens, B=B, T=T, window=win, kB=KB, D=D)

        def held(moved):
            return [all(torch.allclose(a.double(), b, rtol=1e-5, atol=1e-6)
                        for a, b in zip(moved, want)),
                    max(float((a.double() - b).abs().max())
                        for a, b in zip(moved, want))]

        def step(name=None, pkg=this, plan=None, **kw):
            """(the launches, the tables) of one design: this checkout's
            under variant `name` and `plan`, or another checkout's."""
            if plan is not None:
                kw["workspace"] = under(plan)
            if name is None:
                return conv_step_fns(pkg, tables, win, LR, nw, **kw)
            a, s = kernels[name][:2]
            fns, moved = conv_step_fns(pkg, tables, win, LR, nw, **kw)

            def patched(fn):
                def run():
                    sc.SGNS_CONV_ACCUMULATE, sc.SGNS_CONV_SCATTER = a, s
                    try:
                        fn()
                    finally:
                        sc.SGNS_CONV_ACCUMULATE, sc.SGNS_CONV_SCATTER = normal
                return run
            return [patched(fn) for fn in fns], moved

        def checked(label, fns, moved):
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            result = held(moved)
            check(result[0], f"{label} misses the float64 step at {case}: "
                  f"max abs err {result[1]:.3g}")
            return result

        designs = {}
        for name in [*VARIANTS, *CLUSTER_VARIANTS]:
            plan = (cluster_plan(sc, B, T, D, win, sms,
                                 halo=name not in IN_PLACE)
                    if name in CLUSTER_VARIANTS else None)
            if plan is not None:
                check(placed(name, plan) > 0, f"the card cannot place a "
                      f"cluster of {plan}")
            if name not in WRONG_BY_DESIGN:
                checked(name, *step(name, plan=plan))
            designs[name] = lambda name=name, plan=plan: step(
                name, plan=plan)[0]
        if other is not None:
            checked("the other checkout's step", *step(pkg=other))
            designs["other checkout: halo tiles, delta slots, apply"] = (
                lambda: step(pkg=other)[0])
        names = list(designs)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms_split(designs[name](), 20))
        say(**case, ms_each_launch_in_turns=turns)

        tiles = {}
        for t in TILES_TRIED:
            plan = sc.launch_plan(B, T, D, win, sms, tiles=(t,))
            result = checked(f"tiles of {t}", *step("base", plan=plan))
            tiles[t] = [plan._asdict(), result,
                        cuda_ms_split(step("base", plan=plan)[0], 20)[0]]
        say(**case, accumulate_ms_by_tile=tiles)
        sizes = {}
        for c in CLUSTER_SIZES:
            plan = cluster_plan(sc, B, T, D, win, sms, clusters=(c,))
            n = placed("cluster a walk", plan)
            if not n:     # a launch would be refused
                sizes[c] = [plan._asdict(), n]
                continue
            result = checked(f"clusters of {c}",
                             *step("cluster a walk", plan=plan))
            sizes[c] = [plan._asdict(), n, result, cuda_ms_split(
                step("cluster a walk", plan=plan)[0], 20)[0]]
        say(**case, cluster_accumulate_ms_by_cluster_size=sizes)
        hubs = {}
        for hub in HUBS:
            h = hub or B * T
            result = checked(f"units of {hub}", *step(hub=h))
            hubs[str(hub)] = [result, cuda_ms_split(step(hub=h)[0], 20)[2]]
        say(**case, scatter_ms_by_hub=hubs)
        say(**{**case, "B": B_SLOT}, accumulate_scatter=accumulate_forms(
            torch, runs_kernel, tokens, T, win, D, ci))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
