#!/usr/bin/env python3
"""Time two checkouts' kernels of the PyTorch/CUDA port on one GPU, in turns.

    python3 chip_compare.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another checkout of this repository under this
checkout's build/ (say the parent commit, unpacked by `git archive` into
build/parent; .gitignore lists build/). Its package is loaded beside this checkout's under another name and
builds its own kernels into its own build/kernels/. At the main path's
shapes of chip_smoke.py the script times, with chip_smoke's cuda_ms (CUDA
events around launches queued behind a long product):

  * sgns_shared_grads at (2624, 128, 128): plain, other, this, this, other,
    plain;
  * the walk kernel on the walk_10k graph (10 rounds, L = 80, p = q = 0.25):
    other, this, this, other, after checking the two corpora equal;
  * the trial-key table as each checkout's walk_corpus gets it: host wall
    time of the call, synchronized;
  * the resident-row walk kernel (walk_corpus_resident, whatever it runs
    around its launch) on chip_smoke's three phase-7 shapes: other, this,
    this, other, after checking the two corpora equal; then each checkout's
    time with walk_length 0 (launch, table copy, two columns) and with
    external uniforms (no threefry, but reads that miss the cache), and the
    time torch takes to transpose a [walk_length + 2, walkers] corpus (a
    checkout whose kernel stores by columns pays it inside its wrapper);
  * the exact-negative step's two kernels on chip_smoke's phase-11 block
    at D = 128 and D = 768, each launch timed between CUDA events, after checking the two checkouts'
    tables agree (rtol 1e-5): other, this, this, other, twice, each turn
    with a workspace and tables allocated for it;
  * the exact-CDF walk kernel on phase 10's corpus (the walk_10k graph,
    10 rounds, L = 80, p = 1/16, q = 4, chunked): other, this, this,
    other, after checking the two corpora equal;
  * the trainer's per-block draws as each checkout's epoch makes them, on
    the main path's chunks (the conv trainer's 1,524 blocks of kB 128, the
    exact trainer's 15 blocks of 5 negatives a pair): other, this, this,
    other, after checking the draws equal;
  * one trainer epoch of each checkout on the walk_10k corpus (100,000
    walks of 81 tokens, dim 128, window 10, 5 negatives), the conv trainer
    (--sharedNegatives 128) and the exact one, host wall time synchronized:
    other, this, this, other, with the largest difference of the two
    checkouts' tables after the epoch.

One JSON object a line, the card's name and power limit in each. Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

from chip_smoke import (RESIDENT_SHAPES, SGNS_SHAPES, check, cuda_ms,
                        regular_graph, synth_power_law_graph)


def load_package(root: str, name: str):
    """The port's package of the checkout at `root`, imported as `name`."""
    pkg = os.path.join(root, "stellar_rw_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return lambda sub: importlib.import_module(f"{name}.{sub}")


def on_card(walk_step) -> bool:
    """Whether a checkout's trial_keys builds the table on a given device."""
    return "device" in inspect.signature(walk_step.trial_keys).parameters


def has_draws_kernel(pkg) -> bool:
    """Whether a checkout draws the trainer's windows and negatives by a
    kernel (ops/trainer_draws.py)."""
    try:
        pkg("ops.trainer_draws")
    except ImportError:
        return False
    return True


def wall_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if len(argv) != 1 or not os.path.isdir(argv[0]):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.realpath(__file__))
    other_root = os.path.realpath(argv[0])
    if not other_root.startswith(os.path.join(root, "build") + os.sep):
        print("chip_compare: OTHER_CHECKOUT must lie under this checkout's "
              "build/ (it is imported, and builds its kernels there)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compare: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    this = load_package(root, "srw_this")
    other = load_package(other_root, "srw_other")

    # sgns_shared_grads
    P, D, kB = SGNS_SHAPES[0]
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
    vi, vo, wn = t(P, D), t(P, D), t(kB, D)
    valid = torch.as_tensor(rng.random(P) > 0.3).cuda().float()
    args = (vi, vo, wn, t(P) * valid, valid * 0.125)
    fns = {"plain": lambda: this("ops.sgns").sgns_shared_grads_ref(*args),
           "other": lambda: other("ops.sgns").sgns_shared_grads(*args),
           "this": lambda: this("ops.sgns").sgns_shared_grads(*args)}
    for a, b in zip(fns["this"](), fns["other"]()):
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
              "the two checkouts' sgns_shared_grads disagree")
    order = ("plain", "other", "this", "this", "other", "plain")
    runs = [(name, cuda_ms(fns[name], 50)) for name in order]
    print(json.dumps({"kernel": "sgns_shared_grads", "shape": [P, D, kB],
                      "ms_in_turns": runs, "card": smi}))

    # the walk kernel and its key table
    graph = synth_power_law_graph(10_000, 334_000, seed=0)
    V, R, L, p, q = graph.num_vertices, 10, 80, 0.25, 0.25
    walkers = {}
    for name, pkg in (("other", other), ("this", this)):
        sampling, engine = pkg("ops.sampling"), pkg("walk.engine")
        dg = sampling.device_put_graph(graph, "cuda")
        starts = torch.arange(V, dtype=torch.int32, device="cuda")
        _, max_rounds = sampling.plan_sampler("rejection", p, q)
        spec = engine.WalkSpec(walk_length=L, p=p, q=q,
                               max_rounds=max_rounds, n_stream=V)
        key = pkg("ops.prng").prng_key(0)
        walkers[name] = (pkg, dg, starts, spec, key)
    corpus = {name: pkg("walk.engine").walk_corpus(dg, starts, key, spec, R)
              for name, (pkg, dg, starts, spec, key) in walkers.items()}
    check(torch.equal(corpus["this"], corpus["other"]),
          "the two checkouts' walk corpora differ")

    def kernel_only(name):
        pkg, dg, starts, spec, key = walkers[name]
        ws = pkg("ops.walk_step")
        T = spec.max_rounds * spec.k_candidates
        if on_card(ws):
            keys = ws.trial_keys(key, 0, R, L, T, device="cuda")
        else:
            keys = ws.trial_keys(key, 0, R, L, T).cuda()
        return lambda: ws.walk_rounds(dg, starts, keys, L, p, q, V)

    kern = {name: kernel_only(name) for name in walkers}
    order = ("other", "this", "this", "other")
    runs = [(name, cuda_ms(kern[name], 5)) for name in order]
    print(json.dumps({"kernel": "walk", "walkers": R * V, "walk_length": L,
                      "ms_in_turns": runs, "card": smi}))

    def key_table(name):
        pkg, dg, starts, spec, key = walkers[name]
        ws = pkg("ops.walk_step")
        T = spec.max_rounds * spec.k_candidates
        if on_card(ws):
            return lambda: ws.trial_keys(key, 0, R, L, T, device="cuda")
        # a checkout that builds the table on the CPU: as its walk_corpus
        # and walk_rounds get it
        return lambda: ws._keys_u32(ws.trial_keys(key.cpu(), 0, R, L, T).to(
            "cuda")).contiguous()

    runs = [(name, wall_ms(torch, key_table(name), 10)) for name in order]
    print(json.dumps({"step": "trial-key table, host wall ms a call",
                      "ms_in_turns": runs, "card": smi}))

    # the resident-row walk kernel
    L, T, md = 80, 8, 16
    for V, R in RESIDENT_SHAPES:
        g = regular_graph(V, md, seed=V)
        W = R * V
        W_pad = -(-W // 256) * 256
        ext = torch.rand((1 + L * T, 3, W_pad), device="cuda")

        def wrapper(pkg):
            rw = pkg("ops.resident_walk")
            tab = torch.as_tensor(rw.build_row_tables(g, md)).cuda()
            return lambda length=L, uniforms=None: rw.walk_corpus_resident(
                tab, 0, V, W, length, p, q, md, W_pad, T, uniforms)

        fns = {"other": wrapper(other), "this": wrapper(this)}
        check(torch.equal(fns["this"](), fns["other"]()),
              f"the two checkouts' resident corpora differ at V={V}")
        check(torch.equal(fns["this"](L, ext), fns["other"](L, ext)),
              f"the two checkouts' resident corpora differ at V={V} under "
              f"external uniforms")
        runs = [(name, cuda_ms(fns[name], 20)) for name in order]
        split = {name: {
            "walk_length_0": cuda_ms(lambda: fns[name](0), 20),
            "external_uniforms": cuda_ms(lambda: fns[name](L, ext), 20)}
            for name in ("other", "this")}
        buf = torch.empty((L + 2, W_pad), dtype=torch.int32, device="cuda")
        print(json.dumps({
            "kernel": "resident_walk", "vertices": V, "walkers": W,
            "walk_length": L, "ms_in_turns": runs, "split_ms": split,
            "transpose_ms": cuda_ms(lambda: buf.t().contiguous(), 20),
            "card": smi}))
        del ext

    # the exact-negative step's two kernels at phase 11's block
    from chip_smoke import cuda_ms_split, exact_block

    B, T, win, k, lr = 32, 82, 10, 5, 0.025
    for D in (128, 768):
        tables = exact_block(torch, 10_000, B, T, win, k, D)
        w_in, w_out, block, cwin, negs = tables
        steps, results = {}, {}
        for name, pkg in (("other", other), ("this", this)):
            se = pkg("ops.sgns_exact")
            ws = se.Workspace(w_in, w_out, B * T, win, k)
            a_in, a_out = w_in.clone(), w_out.clone()
            se.sgns_exact_step(a_in, a_out, block, cwin, negs, lr, win, ws)
            results[name] = (a_in, a_out)

            def turn(se=se):
                # a turn's own workspace and tables (moved by the steps)
                ws = se.Workspace(w_in, w_out, B * T, win, k)
                t_in, t_out = w_in.clone(), w_out.clone()
                return (lambda: se.launch_grads(ws, t_in, t_out, block, cwin,
                                                negs, win),
                        lambda: se.launch_apply(ws, t_in, t_out, lr))
            steps[name] = turn
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in
                  zip(results["this"], results["other"])),
              f"the two checkouts' exact steps disagree at D={D}")
        runs = [(name, cuda_ms_split(steps[name](), 20))
                for name in order + order]
        print(json.dumps({"kernel": "sgns_exact_grads, sgns_exact_apply",
                          "block": [B, T, win, k, D],
                          "ms_grads_apply_in_turns": runs, "card": smi}))

    # the exact-CDF walk kernel at phase 10's corpus
    V, R, L, p, q = graph.num_vertices, 10, 80, 0.0625, 4.0
    fns = {}
    for name, pkg in (("other", other), ("this", this)):
        sampling, engine = pkg("ops.sampling"), pkg("walk.engine")
        dg = sampling.device_put_graph(graph, "cuda", cdf=True)
        spec = engine.walk_spec(graph, L, R, p, q, "cdf", 16, "float32", V)
        starts = torch.arange(V, dtype=torch.int32, device="cuda")
        key = pkg("ops.prng").prng_key(0)
        fns[name] = (lambda cw=pkg("ops.cdf_walk"), dg=dg, spec=spec,
                     starts=starts, key=key: cw.cdf_walk_rounds(
                         dg, starts, key, 0, R, L, p, q, spec.max_degree,
                         spec.cdf_chunk))
    check(torch.equal(fns["this"](), fns["other"]()),
          "the two checkouts' exact-CDF corpora differ")
    runs = [(name, cuda_ms(fns[name], 3)) for name in order]
    print(json.dumps({"kernel": "cdf_walk", "walkers": R * V,
                      "walk_length": L, "p": p, "q": q,
                      "ms_in_turns": runs, "card": smi}))

    # the trainer's draws, as each checkout's _train_epoch makes them
    from chip_smoke import draw_tables

    keep, alias = draw_tables(torch, 10_000, 0)
    key = this("ops.prng").fold_in(this("ops.prng").prng_key(1), 0).cuda()
    B, T, win, k = 32, 82, 10, 5

    def draws(pkg, n, shape):
        if has_draws_kernel(pkg):
            td = pkg("ops.trainer_draws")
            return lambda: td.trainer_draws(key, 0, n, B, T, win, shape,
                                            keep, alias)
        prng, w2v = pkg("ops.prng"), pkg("models.word2vec")

        def plain():       # the parent's chunk, as its _train_epoch drew it
            kb = prng.fold_in(key, torch.arange(n, device="cuda"))
            cwin = prng.randint(kb, (B, T), 1, win + 1)
            negs = w2v._draw_negatives(prng.fold_in(kb, 2), shape, keep,
                                       alias.long())
            return cwin, negs.to(torch.int32)
        return plain

    for name_, shape, n in (("conv", (128,), 1524),
                            ("exact", (B * T * 2 * win, k), 15)):
        fns = {name: draws(pkg, n, shape) for name, pkg in
               (("other", other), ("this", this))}
        check(all(torch.equal(a, b) for a, b in
                  zip(fns["this"](), fns["other"]())),
              f"the two checkouts' {name_} draws differ")
        runs = [(name, cuda_ms(fns[name], 3)) for name in order]
        print(json.dumps({"step": f"trainer draws, a {name_} chunk",
                          "blocks": n, "shape": list(shape),
                          "ms_in_turns": runs, "card": smi}))

    # one trainer epoch of each checkout on the walk_10k corpus
    walks = this("walk.engine").random_walks(
        graph, 80, 10, 0.25, 0.25, seed=0, as_numpy=False, device="cuda")
    for kB in (128, 0):
        tables, fns = {}, {}
        for name, pkg in (("other", other), ("this", this)):
            w2v = pkg("models.word2vec")
            cfg = w2v.SGNSConfig(dim=128, window=10, negatives=5, iters=1,
                                 seed=1, shared_negatives=kB)
            fns[name] = (lambda w2v=w2v, cfg=cfg, corpus=walks:
                         w2v.train_skipgram(corpus, graph.num_vertices, cfg,
                                            device="cuda"))
            fns[name](corpus=walks[:64])     # builds the kernels first
        runs = []
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tables[name] = fns[name]()
            torch.cuda.synchronize()
            runs.append((name, time.perf_counter() - t0))
        diff = max(float(np.abs(a - b).max()) for a, b in
                   zip(tables["this"], tables["other"]))
        print(json.dumps({"step": "trainer epoch, host wall s",
                          "trainer": f"conv kB {kB}" if kB else "exact",
                          "walks": int(walks.shape[0]),
                          "s_in_turns": runs, "max_abs_table_diff": diff,
                          "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
