#!/usr/bin/env python3
"""Where the exact-negative gradient kernel's time goes on one GPU: the
kernel source with one part changed at a time, and other launch plans, on
blocks that differ in one input at a time.

    python3 chip_sgns_exact_parts.py

A variant is csrc/sgns_exact.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script, so the list
is kept beside the kernel), built under build/ of the checkout. A variant
that keeps the design computes the same step and is held to the plain step
in float64 (rtol 1e-5, atol 1e-6, as chip_smoke's phase 11 holds the
kernels) before it is timed; one with a part taken out gives wrong tables
by design, and only its time is read. Each other launch plan's tables are
held likewise, and whether they keep the tolerance, with their largest
error, is printed beside its time.

Each variant is timed on chip_smoke's phase-11 block (B 32, T 82, w 10, k 5,
V 10,000, Zipf tokens) at D = 128, 32 and 768, on blocks of uniform tokens
and of one token alone at D = 128, and on trainer blocks cut from real walk
corpora at D = 128 (CORPORA: the main path's walk_10k walks and a star
graph's, whose hub is every other token; the block's draws as the trainer
makes them from the corpus's unigram table): the gradient kernel alone (CUDA
events between it and the update kernel, which each step needs to empty the
scratch; chip_smoke's cuda_ms_split), every variant twice, in turns. A
corpus block's line also gives its most frequent row's share of the
block's center and target row adds. One JSON object a line, the card's name
and power limit in each, and ptxas' registers of every variant. Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (check, cuda_ms_split, exact_block, star_graph,
                        synth_power_law_graph)

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
        ("            add_row<NV>(tab, dpad, s, 1, dst[g], c0, D, lane, v);",
         "")],
}
# variants whose tables are wrong by design (their time alone is read)
WRONG_BY_DESIGN = {"taken out: the table's atomics (racy plain adds)",
                   "taken out: the flush", "taken out: the target adds"}
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
    source = (build.CSRC / se.SGNS_EXACT_GRADS.source).read_text()
    root = os.path.dirname(os.path.realpath(__file__))
    out_dir = os.path.join(root, "build", "sgns_exact_parts")
    os.makedirs(out_dir, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        with open(os.path.join(out_dir, header.name), "w") as f:
            f.write(header.read_text())

    class Variant(build.Kernel):
        def __init__(self, index: int, edits):
            super().__init__(f"variant_{index}.cu",
                             se.SGNS_EXACT_GRADS.symbol,
                             se.SGNS_EXACT_GRADS.argtypes)
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"not once in the source: {old!r}")
                text = text.replace(old, new)
            self._path = build.Path(out_dir) / self.source
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
    normal = se.SGNS_EXACT_GRADS
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

        def step_fns(kernel, plan=None):
            a_in, a_out = w_in.clone(), w_out.clone()

            def grads():
                se.SGNS_EXACT_GRADS = kernel
                try:
                    se.launch_grads(ws, a_in, a_out, block, cwin, negs, WIN,
                                    plan=plan)
                finally:
                    se.SGNS_EXACT_GRADS = normal
            return grads, lambda: se.launch_apply(ws, a_in, a_out, LR), \
                (a_in, a_out)

        def one_step(kernel, plan=None):
            grads, apply, tables = step_fns(kernel, plan)
            grads()
            apply()
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

        errors = {}
        for name, k in kernels.items():
            if name in WRONG_BY_DESIGN:
                continue
            got = one_step(k)
            errors[name] = [held(got), err(got)]
            check(errors[name][0], f"variant {name!r} misses the float64 "
                  f"step ({tokens}, D {D})")
        names = list(kernels)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            grads, apply, _ = step_fns(kernels[name])
            g_ms, a_ms = cuda_ms_split((grads, apply), 20)
            turns[name].append([g_ms, a_ms])
        say(**case, held_and_max_abs_err=errors,
            grads_and_apply_ms_in_turns=turns)
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
            # in one float sum: recorded, not raised
            got = one_step(kernels["base"], plan)
            check(held(got) or label != "launch_plan",
                  f"launch_plan misses the float64 step ({tokens}, D {D})")
            grads, apply, _ = step_fns(kernels["base"], plan)
            plans[label] = [plan._asdict(), held(got), err(got),
                            cuda_ms_split((grads, apply), 20)]
        say(**case, grads_and_apply_ms_by_plan=plans)
    return 0


if __name__ == "__main__":
    sys.exit(main())
