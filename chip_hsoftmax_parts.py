#!/usr/bin/env python3
"""Where the hierarchical-softmax step's time goes on one GPU: the kernel
source with one part changed at a time, on blocks of chip_smoke's phase 18.

    python3 chip_hsoftmax_parts.py

A variant is csrc/hsoftmax.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script, so the list
is kept beside the kernel), built under build/hs_parts/ of the checkout
and launched through ops/hsoftmax.py::launch_step under the launch plan
of the card. A variant that keeps the design computes the same step and
is held to the plain step in float64 (rtol 1e-5, atol 1e-6, as phase 18
holds the kernel) before it is timed; one with a part taken out gives
wrong tables by design (and leaves its workspace dirty: each timing takes
a new one), and only its time is read. The parts:

  * the level group's g: one sigmoid a lane after a reduction that halves
    the dots a lane holds twice (base), or the first design's butterfly of
    every dot with all kGroup sigmoids in each lane; __expf and
    __fdividef (base), or expf and a division;
  * kGroup, the path levels a warp holds at once: 2, 4 (base), 8 (with
    the butterfly);
  * one block an SM (__launch_bounds__ without the two-block register
    cap of 128 a thread);
  * taken out: the contexts' gradient sums in shared memory (atomics made
    plain adds), the sigmoid, the node rows' device adds, the node rows'
    delta-slot claims, the contexts' loop, the level groups, and
    everything but the launch, the barriers and the update.

Each is timed on phase 19's block (the 100,000-vertex corpus of chip_smoke
phase 19 under its Huffman tree: B 256, T 82, w 10, D 128), at D 64, and
on the one-token block (every center on one path): mean device ms of 10
launches back to back (chip_smoke's cuda_ms), every variant twice, in
turns. One JSON object a line, the card's name and power limit in each,
and ptxas' registers of every variant. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (check, cuda_ms, edited, hs_block, hs_corpus,
                        source_kernel)

# the first design's g: every dot reduced by a butterfly, each lane taking
# all kGroup sigmoids
BUTTERFLY = (
    """  static_assert(kGroup == 4, "the halving reduction takes 4 levels");
  const int lane = threadIdx.x & 31;""",
    """#pragma unroll
  for (int sh = 16; sh; sh >>= 1)
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      dot[g] += __shfl_xor_sync(kFull, dot[g], sh);
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
    gr[g] = g < nt ? __fdividef(1.f, 1.f + __expf(-dot[g])) - lab[g] : 0.f;
  return;
  const int lane = threadIdx.x & 31;""")
SIGMOID = "__fdividef(1.f, 1.f + __expf(-v))"
KGROUP = ("constexpr int kGroup = 4;", "constexpr int kGroup = {};")
# kGroup other than 4: the butterfly (the halving reduction takes 4)
OTHER_GROUP = lambda n: [BUTTERFLY, (KGROUP[0], KGROUP[1].format(n))]

# name -> [(text in csrc/hsoftmax.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    "the first design's g: a butterfly of every dot, 4 sigmoids a lane": [
        BUTTERFLY],
    "expf and a division (the exact sigmoid)": [
        (SIGMOID, "1.f / (1.f + expf(-v))")],
    "kGroup 2": OTHER_GROUP(2),
    "kGroup 8": OTHER_GROUP(8),
    "one block an SM (no register cap)": [
        ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
    "taken out: the contexts' shared-memory atomics (plain adds)": [
        ("                const int c = lane + 32 * m;\n"
         "                if (c < D) atomicAdd(dr + c, dx);",
         "                const int c = lane + 32 * m;\n"
         "                if (c < D) dr[c] += dx;")],
    "taken out: the sigmoid (g = dot - label)": [(SIGMOID, "v")],
    "taken out: the node rows' device adds": [
        ("    if (c < D) atomicAdd(s.dt(1) + static_cast<size_t>(slot) * D + c,"
         " v[m]);", "    (void)v;")],
    "taken out: the node rows' slot claims": [
        ("            my_slot = claim(s, 1, nd);",
         "            my_slot = nd & 1023;")],
    "taken out: the contexts' loop": [
        ("          int np = 0;\n          for (int d = -win; d <= win; ++d) {",
         "          int np = 0;\n          for (int d = -win; d < -win; ++d) {")],
    "taken out: the level groups": [
        ("        while (rem) {", "        while (rem && D < 0) {")],
    "taken out: all but the launch, the barriers and the update": [
        ("  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {",
         "  for (int ti = blockIdx.x; ti < 0; ti += gridDim.x) {")],
}
WRONG_BY_DESIGN = {name for name in VARIANTS if name.startswith("taken")}
# (tokens, B, T, window, D) of chip_smoke's HS_SHAPES
CASES = [("corpus", 256, 82, 10, 128), ("corpus", 256, 82, 10, 64),
         ("hub", 32, 82, 10, 128)]
LR = 0.025


def kgroup_of(edits) -> int:
    for old, new in edits:
        if old == KGROUP[0]:
            return int(new.split("=")[1].strip(" ;"))
    return 4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_hsoftmax_parts: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import hsoftmax as ho

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
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.fn(), kernels.values()))
    for name, k in kernels.items():
        regs = [line.strip() for line in k.build_log.splitlines()
                if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "ptxas": regs, "card": smi}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    corpus = hs_corpus(torch)
    for case in CASES:
        _, B, T, win, D = case
        syn0, syn1, block, cwin, pts, lbl, pmk = hs_block(torch, *case, 0,
                                                          corpus)
        L = pts.shape[1]
        a0, a1 = syn0.double(), syn1.double()
        ho.hs_step_ref(a0, a1, block, cwin, pts, lbl, pmk, LR, win)
        base = ho.launch_plan(D, B, T, win, sms)

        def plan_of(name):
            kg = kgroup_of(VARIANTS[name])
            one = name.startswith("one block an SM")
            return base._replace(
                smem_bytes=ho.smem_bytes(base.tile, win, D)
                + 4 * 8 * 2 * win * (kg - ho.KGROUP),
                blocks=min(base.tiles, sms) if one else base.blocks,
                blocks_per_sm=1 if one else base.blocks_per_sm)

        def run(name, b0, b1, ws):
            ho.launch_step(ws, b0, b1, block, cwin, pts, lbl, pmk, win, LR,
                           plan_of(name), kernels[name])

        errs = {}
        for name in VARIANTS:
            if name in WRONG_BY_DESIGN:
                continue
            b0, b1 = syn0.clone(), syn1.clone()
            run(name, b0, b1, ho.HSWorkspace(b0, b1, B * T, L))
            torch.cuda.synchronize()
            err = max(float((b0.double() - a0).abs().max()),
                      float((b1.double() - a1).abs().max()))
            check(torch.allclose(b0.double(), a0, rtol=1e-5, atol=1e-6)
                  and torch.allclose(b1.double(), a1, rtol=1e-5, atol=1e-6),
                  f"variant {name!r} differs from the float64 step at {case}:"
                  f" max abs err {err:.3g}")
            errs[name] = err
        ms = {name: [] for name in VARIANTS}
        for _ in range(2):
            for name in VARIANTS:
                b0, b1 = syn0.clone(), syn1.clone()
                ws = ho.HSWorkspace(b0, b1, B * T, L)
                ms[name].append(cuda_ms(lambda: run(name, b0, b1, ws), 10))
                del b0, b1, ws
        for name in VARIANTS:
            print(json.dumps({
                "case": list(case), "L": L, "variant": name,
                "ms_in_turns": ms[name],
                "max_abs_err_f64": errs.get(name),
                "plan": plan_of(name)._asdict(), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
