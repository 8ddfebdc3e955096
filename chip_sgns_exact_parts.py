#!/usr/bin/env python3
"""Where the exact-negative step's time goes on one GPU: the kernel source
with one part changed at a time, and other launch plans, on blocks that
differ in one input at a time; then the merged update of S slots.

    python3 chip_sgns_exact_parts.py

A variant is csrc/sgns_exact.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script, so the list
is kept beside the kernel), built under build/ of the checkout. A variant
that keeps the design computes the same step and is held to the plain step
in float64 (rtol 1e-5, atol 1e-6, as chip_smoke's phase 11 holds the
kernels) before it is timed; one with a part taken out gives wrong tables
by design, and only its time is read. A variant whose launch the card
refuses (the ring of 3 stages of 6 rows at D 128 asks for more shared
memory than two blocks an SM have) is printed as refused, with its CUDA
error. The ring variants (RING_VARIANTS) are the source with
chip_sgns_exact_ring.cu appended, a design measured slower: the target
rows of the group kStages ahead copied into a ring in shared memory, by
cp.async or cp.async.bulk, at 1, 2 and 3 stages and groups of 3 and 6
targets, launched through its own entry points (rows wider than D 128 run
the source's step); the base is the ring taken out. Each other launch
plan's tables are held likewise, and whether they keep the tolerance,
with their largest error, is printed beside its time; a plan the card refuses as a
cooperative launch (more blocks than can be resident) is printed as
refused, with its CUDA error.

Each variant is timed on chip_smoke's phase-11 block (B 32, T 82, w 10, k 5,
V 10,000, Zipf tokens) at D = 128, 32 and 768, on blocks of uniform tokens
and of one token alone at D = 128, and on trainer blocks cut from real walk
corpora at D = 128 (CORPORA: the main path's walk_10k walks and a star
graph's, whose hub is every other token; the block's draws as the trainer
makes them from the corpus's unigram table): the step's one launch between
CUDA events (chip_smoke's cuda_ms_split), each followed by torch ops that
empty the workspace (not counted: a variant without the update leaves it
full), every variant twice, in turns. A
corpus block's line also gives its most frequent row's share of the
block's center and target row adds. Last, the merged update of S = 1, 2
and 4 slots of B = 32, 16 and 8 rows (the same positions; Zipf blocks, D
128) as one launch of the source and of the cp.async ring variant, and
each in accumulate mode into a reduction buffer, held to the plain
merged update in float64 first, in turns. One JSON object a line, the
card's name and power limit in each, and ptxas' registers of every
variant. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (check, cuda_ms_split, edited, exact_block,
                        source_kernel, star_graph, synth_power_law_graph,
                        workspace_empty)

# the slot counts zeroed by the block that finishes last: an arrival
# counter of the variant's own, left at zero
ARRIVAL = [
    ("constexpr int kProbes = 2;",
     "constexpr int kProbes = 2;\n__device__ int arrived = 0;"),
    ("  cg::this_grid().sync();\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    s.counts[0] = 0;\n"
     "    s.counts[1] = 0;\n"
     "  }",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    __threadfence();\n"
     "    if (atomicAdd(&arrived, 1) == static_cast<int>(gridDim.x) - 1) {\n"
     "      __threadfence();\n"
     "      s.counts[0] = 0;\n"
     "      s.counts[1] = 0;\n"
     "      arrived = 0;\n"
     "    }\n"
     "  }")]
# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "base": [],
    "targets one at a time (kGroup 1)": [
        ("constexpr int kGroup = 3;", "constexpr int kGroup = 1;")],
    "targets six at a time (kGroup 6)": [
        ("constexpr int kGroup = 3;", "constexpr int kGroup = 6;")],
    "eight probes, not two (kProbes 8)": [
        ("constexpr int kProbes = 2;", "constexpr int kProbes = 8;")],
    "taken out: the table's atomics (racy plain adds)": [
        ("        atomicAdd(tab + static_cast<size_t>(dest) * dpad + c, "
         "v[m]);",
         "        tab[static_cast<size_t>(dest) * dpad + c] += v[m];")],
    "taken out: the flush": [
        ("  for (int base = warp * 32; base < slots; base += nwarps * 32)"
         " {",
         "  for (int base = warp * 32; base < slots && D < 0; "
         "base += nwarps * 32) {")],
    "taken out: the target adds": [
        ("          add_row<NV>(tab, dpad, s, 1, dst[g], c0, D, lane, v);",
         "")],
    "the gradient phase alone (no update; the counts' barrier kept)": [
        ("  cg::this_grid().sync();\n  apply_slots(w_in, w_out, s, D, lr);",
         "")],
    "__ldg kept (the tables through the read-only path)": [
        ("    v[m] = c < D ? row[c] : 0.f;",
         "    v[m] = c < D ? __ldg(row + c) : 0.f;")],
    "tables as __restrict__ pointers (writable)": [
        ("    sgns_exact_step(float* w_in, float* w_out, const int* "
         "__restrict__ block,",
         "    sgns_exact_step(float* __restrict__ w_in, "
         "float* __restrict__ w_out, const int* __restrict__ block,")],
    "counts zeroed by the last block to finish (an arrival counter), not "
    "after a second grid barrier": ARRIVAL,
    "the arrival counter without its fences (unordered: time only)": [
        (old, new.replace("      __threadfence();\n", "")
         .replace("    __threadfence();\n", ""))
        for old, new in ARRIVAL],
}
RING_SOURCE = "chip_sgns_exact_ring.cu"
# its entry points: the step's and the accumulate mode's, with their
# arguments
RING_SYMBOLS = ("srw_sgns_exact_ring_step_launch",
                "srw_sgns_exact_ring_accumulate_launch")
STAGES_3 = ("constexpr int kStages = 2;", "constexpr int kStages = 3;")
GROUP_6 = ("constexpr int kGroup = 3;", "constexpr int kGroup = 6;")
# name -> [(text in the source with RING_SOURCE appended, its
# replacement), ...]
RING_VARIANTS = {
    "the ring: rows a group ahead by cp.async, 2 stages": [],
    "the ring, 1 stage": [
        ("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "the ring, 3 stages": [STAGES_3],
    "the ring, kGroup 6": [GROUP_6],
    "the ring, 3 stages, kGroup 6": [STAGES_3, GROUP_6],
    "the ring by cp.async.bulk on an mbarrier, 2 stages": [
        ("constexpr bool kBulk = false;", "constexpr bool kBulk = true;")],
}
# variants whose tables are wrong by design (their time alone is read)
WRONG_BY_DESIGN = {"taken out: the table's atomics (racy plain adds)",
                   "taken out: the flush", "taken out: the target adds",
                   "the gradient phase alone (no update; the counts' barrier kept)",
                   "the arrival counter without its fences (unordered: time "
                   "only)"}
# walk corpora at the main path's walk (walkLength 80, p = q = 0.25):
# name -> (graph maker, numWalks, trainer blocks cut from it)
CORPORA = {
    "walk_10k": (lambda: synth_power_law_graph(10_000, 334_000, seed=0), 10,
                 (0, 1562)),
    "star50k": (lambda: star_graph(50_000), 1, (0, 781)),
}
# (tokens, D): the trainer's block, narrow, without hubs, one hub alone,
# wider than a register slice; then the corpus blocks
CASES = [("zipf", 128), ("zipf", 32), ("uniform", 128), ("hub", 128),
         ("zipf", 768)] + [(f"{name}:{i}", 128)
                           for name, (_, _, blocks) in CORPORA.items()
                           for i in blocks]
V, B, T, WIN, K, LR = 10_000, 32, 82, 10, 5, 0.025


def corpus_block(torch, name: str, index: int, D: int, seed: int = 0):
    """Trainer block `index` of CORPORA[name]'s walks (B rows of the
    corpus in its order, T = walkLength + 2), its window and negative draws
    as _train_epoch makes them for that block from the corpus's unigram^0.75
    table, random tables over the graph's vertices; and the share of the
    block's center and target row adds its most frequent row takes."""
    import numpy as np

    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops.alias import build_alias
    from stellar_rw_tpu_torch.ops.sgns_exact import (_pairs_from_valid,
                                                    _valid_from_cwin)
    from stellar_rw_tpu_torch.walk import engine

    make, num_walks, _ = CORPORA[name]
    graph = make()
    nv = graph.num_vertices
    corpus = engine.random_walks(graph, T - 2, num_walks, 0.25, 0.25,
                                 seed=seed, as_numpy=False, device="cuda")
    flat = corpus.reshape(-1)
    counts = torch.bincount(flat[flat >= 0].long(), minlength=nv)
    keep, alias = build_alias(counts.cpu().numpy().astype(np.float64)
                              ** 0.75 + 1e-12)
    block = corpus[index * B:(index + 1) * B].contiguous()
    kb = prng.fold_in(prng.fold_in(prng.prng_key(seed), 0).cuda(), index)
    cwin = prng.randint(kb, (B, T), 1, WIN + 1)
    negs = w2v._draw_negatives(
        prng.fold_in(kb, 2), (B * T * 2 * WIN, K),
        torch.as_tensor(keep, dtype=torch.float32).cuda(),
        torch.as_tensor(alias, dtype=torch.int64).cuda()).to(torch.int32)
    valid, ctx = _valid_from_cwin(block, cwin, WIN)
    c, x, v = _pairs_from_valid(block, valid, ctx)
    targets = torch.cat([x[v], negs[v].reshape(-1)])
    top = lambda rows: float(torch.bincount(rows.long()).max() / rows.numel())
    shares = {"center_adds": top(c[v]), "target_adds": top(targets)}
    rng = np.random.default_rng(seed)
    w = lambda: torch.as_tensor((rng.standard_normal((nv, D)) * 0.3)
                                .astype(np.float32)).cuda()
    return (w(), w(), block, cwin, negs), shares


def ring_text(edits) -> str:
    """csrc/sgns_exact.cu with RING_SOURCE appended, `edits` applied."""
    from stellar_rw_tpu_torch.ops import _build as build

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           RING_SOURCE)) as f:
        ring = f.read()
    return edited((build.CSRC / "sgns_exact.cu").read_text() + "\n" + ring,
                  edits)


def ring_kernel(index: int, symbol: str, argtypes):
    """Entry point `symbol` of ring variant `index` (RING_VARIANTS'
    order)."""
    return source_kernel(f"ring_{index}",
                         ring_text(list(RING_VARIANTS.values())[index]),
                         symbol, argtypes, "sgns_exact_parts")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_sgns_exact_parts: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import sgns_exact as se

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    source = (build.CSRC / se.SGNS_EXACT_STEP.source).read_text()
    kernels = {name: source_kernel(f"variant_{i}", edited(source, edits),
                                   se.SGNS_EXACT_STEP.symbol,
                                   se.SGNS_EXACT_STEP.argtypes,
                                   "sgns_exact_parts")
               for i, (name, edits) in enumerate(VARIANTS.items())}
    kernels.update({name: ring_kernel(i, RING_SYMBOLS[0],
                                      se.SGNS_EXACT_STEP.argtypes)
                    for i, name in enumerate(RING_VARIANTS)})
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), kernels.values()))
    for name, k in kernels.items():
        say(variant=name, ptxas=[
            line.split(":", 1)[-1].strip()
            for line in k.build_log.splitlines()
            if "registers" in line or "spill" in line])
    normal = se.SGNS_EXACT_STEP
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    for tokens, D in CASES:
        if ":" in tokens:
            name, index = tokens.split(":")
            tables, shares = corpus_block(torch, name, int(index), D)
        else:
            tables = exact_block(torch, V, B, T, WIN, K, D, tokens=tokens)
            shares = None
        w_in, w_out, block, cwin, negs = tables
        ws = se.Workspace(w_in, w_out, B * T, WIN, K)
        case = dict(tokens=tokens, D=D, most_frequent_row_share=shares)

        def reset():
            for t in (*ws.d, *ws.cnt, ws.counts):
                t.zero_()
            for m in ws.map:
                m.fill_(-1)

        def step_fns(kernel, plan=None):
            a_in, a_out = w_in.clone(), w_out.clone()

            def step():
                se.SGNS_EXACT_STEP = kernel
                try:
                    se.launch_step(ws, a_in, a_out, block, cwin, negs, WIN,
                                   LR, plan=plan)
                finally:
                    se.SGNS_EXACT_STEP = normal
            return step, reset, (a_in, a_out)

        def one_step(kernel, plan=None):
            step, _, tables = step_fns(kernel, plan)
            step()
            torch.cuda.synchronize()
            return tables

        # the plain step in float64, as chip_smoke's phase 11 holds the
        # kernels to it
        want = (w_in.double(), w_out.double())
        se.sgns_exact_step_ref(*want, block, cwin, negs, LR, WIN)

        def err(tables):
            return max(float((a.double() - b).abs().max())
                       for a, b in zip(tables, want))

        def held(tables):
            return all(torch.allclose(a.double(), b, rtol=1e-5, atol=1e-6)
                       for a, b in zip(tables, want))

        errors, refused = {}, set()
        for name, k in kernels.items():
            if name in WRONG_BY_DESIGN:
                continue
            try:
                got = one_step(k)
            except build.KernelLaunchError as e:
                errors[name] = f"refused: {e}"
                refused.add(name)
                continue
            errors[name] = [held(got), err(got)]
            check(errors[name][0], f"variant {name!r} misses the float64 "
                  f"step ({tokens}, D {D})")
            check(workspace_empty(torch, ws), f"variant {name!r} left the "
                  f"workspace dirty ({tokens}, D {D})")
        names = [name for name in kernels if name not in refused]
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            step, empty, _ = step_fns(kernels[name])
            turns[name].append(cuda_ms_split((step, empty), 20)[0])
            empty()
        say(**case, held_and_max_abs_err=errors, step_ms_in_turns=turns)
        # other plans: the table's size, none, one block an SM
        base = se.launch_plan(D, B, T, WIN, K, sms)
        table = lambda n: base._replace(slots=n,
                                        smem_bytes=n * se.slot_bytes(D))
        one_sm = -(-B * T // sms)
        plans = {}
        for label, plan in {
                "launch_plan": base,
                "no table (every add to a delta slot)": table(0),
                "a table of 64 rows": table(64),
                "the largest table shared memory holds": table(
                    se.TABLE_BUDGET // se.slot_bytes(D)),
                "one block an SM": base._replace(
                    blocks=-(-B * T // one_sm), positions=one_sm)}.items():
            # a plan may miss the tolerance where a hub row's adds pile up
            # in one float sum: recorded, not raised; a plan the card
            # refuses as a cooperative launch, likewise
            try:
                got = one_step(kernels["base"], plan)
            except build.KernelLaunchError as e:
                check(label != "launch_plan", f"launch_plan refused: {e}")
                plans[label] = [plan._asdict(), f"refused: {e}"]
                continue
            check(held(got) or label != "launch_plan",
                  f"launch_plan misses the float64 step ({tokens}, D {D})")
            step, empty, _ = step_fns(kernels["base"], plan)
            plans[label] = [plan._asdict(), held(got), err(got),
                            cuda_ms_split((step, empty), 20)[0]]
        say(**case, step_ms_by_plan=plans)
    merged_slots(torch, se, say)
    return 0


def merged_slots(torch, se, say) -> None:
    """The merged update of S = 1, 2, 4 slots of B = 32, 16, 8 rows (Zipf
    blocks of the phase-11 shape, D 128) as one launch, and in accumulate
    mode into a reduction buffer, by the source and by the cp.async ring
    variant: held to the plain merged update in float64 (rtol 1e-5, atol
    1e-6; the accumulate mode's buffer applied in float64), then timed
    between CUDA events in turns."""
    from stellar_rw_tpu_torch.ops import dp_apply as da

    ring = list(RING_VARIANTS)[0]
    pairs = {"base": (se.SGNS_EXACT_MERGED, se.SGNS_EXACT_ACCUMULATE),
             ring: tuple(ring_kernel(0, symbol, k.argtypes)
                         for symbol, k in zip(RING_SYMBOLS, (
                             se.SGNS_EXACT_MERGED,
                             se.SGNS_EXACT_ACCUMULATE)))}
    normal = pairs["base"]
    D = 128
    for S, Bs in ((1, 32), (2, 16), (4, 8)):
        parts = [exact_block(torch, V, Bs, T, WIN, K, D, seed=s)
                 for s in range(S)]
        w_in, w_out = parts[0][:2]
        slots = [torch.stack([p[i] for p in parts]) for i in (2, 3, 4)]
        want = (w_in.double(), w_out.double())
        se.sgns_exact_merged_ref(*want, *slots, LR, WIN)
        ws = se.Workspace(w_in, w_out, S * Bs * T, WIN, K)
        buf = torch.zeros(da.buffer_numel(V, D), device="cuda")

        def with_pair(pair, fn):
            def run():
                se.SGNS_EXACT_MERGED, se.SGNS_EXACT_ACCUMULATE = pair
                try:
                    fn()
                finally:
                    se.SGNS_EXACT_MERGED, se.SGNS_EXACT_ACCUMULATE = normal
            return run
        fns, errors = {}, {}
        for name, pair in pairs.items():
            t = (w_in.clone(), w_out.clone())
            with_pair(pair, lambda: se.launch_step(ws, *t, *slots, WIN,
                                                   LR))()
            got = (w_in.double(), w_out.double())
            with_pair(pair, lambda: se.launch_step(ws, w_in, w_out, *slots,
                                                   WIN, LR, buffer=buf))()
            da.dp_apply_ref(*got, buf.double(), LR)
            buf.zero_()
            torch.cuda.synchronize()
            for label, tables in (("merged", t), ("accumulate", got)):
                e = max(float((a.double() - b).abs().max())
                        for a, b in zip(tables, want))
                check(all(torch.allclose(a.double(), b, rtol=1e-5, atol=1e-6)
                          for a, b in zip(tables, want))
                      and workspace_empty(torch, ws),
                      f"{name} {label} misses the float64 merged update at "
                      f"S {S}: {e:.3g}")
                errors[f"{name}: {label}"] = e
            fns[f"{name}: merged"] = with_pair(
                pair, lambda t=t: se.launch_step(ws, *t, *slots, WIN, LR))
            fns[f"{name}: accumulate"] = with_pair(
                pair, lambda: se.launch_step(ws, w_in, w_out, *slots, WIN,
                                             LR, buffer=buf))
        names = list(fns)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms_split((fns[name],), 20)[0])
        say(slots=S, B=Bs, D=D, max_abs_err=errors, ms_in_turns=turns)


if __name__ == "__main__":
    sys.exit(main())
