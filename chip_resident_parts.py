#!/usr/bin/env python3
"""Where the resident-row walk kernel's time goes on one GPU: the kernel
source with one part of its design changed at a time, and the built kernel
under other launch plans, row placements, walk lengths, draws and (p, q).

    python3 chip_resident_parts.py

A variant is csrc/resident_walk.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script, so the list is
kept beside the kernel). A variant that changes the design computes the same
corpus, and is held bitwise to the base kernel's before it is timed (the one
that stores the corpus by columns is timed with the transposition it then
needs); a variant with a part taken out gives a wrong corpus by design, and
only its time is read. Times are chip_smoke's
cuda_ms (CUDA events around 20 launches queued behind a long product) of the
kernel alone (ops/resident_walk.py::launch_kernel), on
chip_smoke's three phase-7 shapes. One JSON object a line, the card's name
and power limit in each. Variants are written and built under build/ of the
checkout. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import RESIDENT_SHAPES, check, cuda_ms, regular_graph

AHEAD = "constexpr int kAhead = 1;"
BY_COLUMNS = "corpus stored by columns, then transposed by torch"
# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "base": [],
    "kAhead = 2": [(AHEAD, "constexpr int kAhead = 2;")],
    "kAhead = 4": [(AHEAD, "constexpr int kAhead = 4;")],
    "draws at need, on the step's chain (no look-ahead)": [
        ("              draw_ahead(u, t0 + kAhead, L, T, nup, nuk);",
         "              draw_ahead(u, t0, L, T, nup, nuk);"),
        ("            int cand = sample(rows, lay, r0, deg, up[i], uk[i]);\n"
         "            // the next",
         "            // the next"),
        ("            float f = bias(",
         "            int cand = sample(rows, lay, r0, deg, nup[i], nuk[i]);\n"
         "            float f = bias(")],
    "draws not held above the step's branches (the compiler sinks them)": [
        ("                pin(nup[n]);\n                pin(nuk[n]);\n", "")],
    "u_acc drawn in every first trial": [
        ("            for (int j = 0; f < max_f && j < T - 1; ++j) {",
         "            for (int j = 0; (f < max_f || u.at(1u + (uint32_t)t * T,"
         " 2) > 2.0f) && j < T - 1; ++j) {")],
    "table copied word by word by all threads": [
        ("  if (kShared && threadIdx.x == 0)\n"
         "    start_table_copy(tab_s, tab_g, table_bytes, &bar);\n",
         "  if (kShared)\n"
         "    for (uint32_t i = threadIdx.x; i < table_bytes / 4; "
         "i += blockDim.x)\n      tab_s[i] = tab_g[i];\n"),
        ("    wait_table_copy(&bar);\n", "")],
    "a row's degree read from the row, not taken from the id word": [
        ("            deg = (int)((uint32_t)cand >> kIdBits);\n",
         "            deg = rows.word((cand & kIdMask) * lay.stride + "
         "lay.deg);\n")],
    "prev's ids read in the step that compares them": [
        ("            pids = load_ids(rows, r0);\n", ""),
        ("            int cand = sample(rows, lay, r0, deg, up[i], uk[i]);\n",
         "            pids = load_ids(rows, (prev & kIdMask) * lay.stride);\n"
         "            int cand = sample(rows, lay, r0, deg, up[i], uk[i]);\n")],
    BY_COLUMNS: [
        ("  uint32_t gid, cols;\n", "  uint32_t gid, cols, w_pad;\n"),
        ("    CorpusRow row{out, gid, (uint32_t)L + 2u, (L & 1) == 0, 0};\n",
         "    CorpusRow row{out, gid, (uint32_t)L + 2u, w_pad, (L & 1) == 0, "
         "0};\n"),
        ("    int* row = out + (size_t)gid * cols;\n",
         "    out[(size_t)c * w_pad + gid] = v;\n    return;\n"
         "    int* row = out + (size_t)gid * cols;\n")],
}
# parts taken out: these variants' corpora are wrong by design, only their
# times are read
NO_COLD = "taken out: the cold path (trial 0 always wins)"
NO_THREEFRY = "taken out: threefry (a draw is one multiply of its index)"
NO_STORES = "taken out: the corpus stores (all but the last column)"
VARIANTS.update({
    NO_COLD: [("            for (int j = 0; f < max_f && j < T - 1; ++j) {",
               "            for (int j = 0; f < -1.0f && j < T - 1; ++j) {")],
    NO_THREEFRY: [
        ("    return kExt ? __ldg(ext + i) : srw::uniform_at(key, i);",
         "    return kExt ? __ldg(ext + i) : __uint_as_float(((i * "
         "2654435761u + key.x) >> 9) | 0x3F800000u) - 1.0f;")],
    NO_STORES: [("    int* row = out + (size_t)gid * cols;\n",
                 "    if (c + 1u < cols) return;\n"
                 "    int* row = out + (size_t)gid * cols;\n")],
})
WRONG_BY_DESIGN = (NO_COLD, NO_THREEFRY, NO_STORES)
PQ = [(0.25, 0.25), (4.0, 0.25), (0.25, 4.0)]
L, T, MD, SEED = 80, 8, 16, 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_resident_parts: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import _build
    from stellar_rw_tpu_torch.ops import resident_walk as rw
    from stellar_rw_tpu_torch.ops.walk_step import warp_max

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clock = lambda: subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    source = (_build.CSRC / rw.RESIDENT_WALK_KERNEL.source).read_text()
    out_dir = _build.BUILD_DIR.parent / "resident_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())

    class Variant(_build.Kernel):
        def __init__(self, index: int, edits):
            super().__init__(f"variant_{index}.cu",
                             rw.RESIDENT_WALK_KERNEL.symbol,
                             rw.RESIDENT_WALK_KERNEL.argtypes)
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"not once in the source: {old!r}")
                text = text.replace(old, new)
            self._path = out_dir / self.source
            self._path.write_text(text)

        @property
        def path(self):
            return self._path

    kernels = {name: Variant(i, edits)
               for i, (name, edits) in enumerate(VARIANTS.items())}
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), kernels.values()))
    for name, k in kernels.items():
        say(variant=name, ptxas=[
            line.split(":", 1)[-1].strip()
            for line in k.build_log.splitlines()
            if "registers" in line or "spill" in line])
    base = kernels["base"]

    for V, R in RESIDENT_SHAPES:
        g = regular_graph(V, MD, seed=V)
        W = R * V
        W_pad = -(-W // 256) * 256
        tab = torch.as_tensor(rw.build_row_tables(g, MD)).cuda()
        lay = rw.row_layout(MD)
        place = rw.row_placement(tab)
        plan = rw.launch_plan(W_pad, place, sms)
        shape = dict(vertices=V, walkers=W)

        def run(kernel=base, p=0.25, q=0.25, length=L, uniforms=None,
                place=place, plan=plan):
            return lambda: rw.launch_kernel(
                tab, SEED, V, W, length, p, q, lay, W_pad, T, uniforms, place,
                plan, kernel)

        want = run()()
        torch.cuda.synchronize()

        # 1. one part of the design changed at a time
        names = list(kernels)
        fns = {name: run(kernels[name]) for name in names}
        by_columns = fns[BY_COLUMNS]
        fns[BY_COLUMNS] = lambda: by_columns().view(L + 2, W_pad).t(
            ).contiguous()
        for name in names:
            check(torch.equal(fns[name](), want) != (name in WRONG_BY_DESIGN),
                  f"variant {name!r}: corpus at V={V}")
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms(fns[name], 20))
        say(**shape, rows=place, plan=plan._asdict(), ms_in_turns=turns,
            sm_clock_after=sm_clock())

        # 2. placements and launch plans
        plans = {}
        for where in ("shared", "global"):
            if where == "shared" and place != "shared":
                continue
            mine = rw.launch_plan(W_pad, where, sms)
            fixed = {f"{t} threads a block": rw.LaunchPlan(
                -(-W_pad // t), t, 1) for t in (32, 64, 128, 256)}
            for label, pl in {"launch_plan": mine, **fixed}.items():
                if where == "shared" and pl.blocks > 4 * sms:
                    continue        # hundreds of table copies: not a plan
                fn = run(place=where, plan=pl)
                check(torch.equal(fn(), want), f"{where} {label}: corpus")
                plans[f"{where}, {label} {tuple(pl)}"] = cuda_ms(fn, 20)
        say(**shape, ms_by_placement_and_plan=plans)

        # 3. the split: launch and table copy alone, no threefry, the
        # wrapper around the launch
        ext = torch.rand(rw.uniforms_shape(L, T, W_pad), device="cuda")
        say(**shape, rows=place, split_ms={
            "kernel": cuda_ms(run(), 20),
            "walk_length 0": cuda_ms(run(length=0), 20),
            "external uniforms": cuda_ms(run(uniforms=ext), 20),
            "wrapper": cuda_ms(lambda: rw.walk_corpus_resident(
                tab, SEED, V, W, L, 0.25, 0.25, MD, W_pad, T), 20)})
        del ext

        # 4. (p, q) where the cold path is rare, common, the rule
        for p, q in PQ:
            counts = {}
            ref = rw.walk_corpus_resident_ref(tab, SEED, V, W, L, p, q, MD,
                                              W_pad, T, counts=counts)
            check(torch.equal(run(p=p, q=q)(), ref),
                  f"kernel differs from the plain version at p={p} q={q}")
            warps = -(-W_pad // 32)
            walker = counts.pop("walker_trials")
            say(**shape, p=p, q=q, ms=cuda_ms(run(p=p, q=q), 20),
                **counts, warps=warps,
                trials_a_step=counts["trials"] / max(counts["steps"], 1),
                warp_slowest_lane_total_mean=float(
                    warp_max(walker).float().mean()),
                warp_step_max_sum_mean=counts["step_warp_max"] / warps,
                warp_cold_steps_mean=counts["warp_cold_steps"] / warps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
