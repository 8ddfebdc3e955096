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
  * the exact-negative step's launches on chip_smoke's phase-11 block at
    D = 128 and D = 768 (one cooperative kernel, or a checkout's gradient
    and update kernels), each launch timed between CUDA events, after
    checking the two checkouts' tables agree (rtol 1e-5): other, this,
    this, other, twice, each turn with a workspace and tables allocated for
    it;
  * the conv step's kernels on chip_smoke's phase-14 block (B 32, T 82,
    w 10, kB 128, D 128, Zipf), each launch timed between CUDA events,
    after checking the two checkouts' tables agree (rtol 1e-5, atol 1e-6):
    other, this, this, other, twice;
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
    checkouts' tables after the epoch;
  * the GNN-feed kernels (K8, ops/spmm.py) on bench.py::measure_spmm's
    graph at D 128: the segment sum on the CSR order (spmm) and the
    transposed order (its backward), the SDDMM, and the row softmax's
    forward (scores N(0, 1) x3) and backward modes, after checking the two
    checkouts agree (rtol 1e-5; atol 1e-5, the softmax's 1e-6): other,
    this, this, other; then chip_smoke phase 20's GAT-style layer and its
    gradient through each checkout's public ops (its kernels and the torch
    ops between them);
  * the hierarchical-softmax step (K9, ops/hsoftmax.py::launch_step) on
    chip_smoke's phase-19 block (B 256, T 82, w 10, D 128 on the
    100,000-vertex corpus's tree) and its one-token block, after checking
    the two checkouts' tables agree (rtol 1e-5, atol 1e-6): other, this,
    this, other, each turn on tables and a workspace of its own;
  * the data-parallel merged update's kernels (compare_dp): K5's scatter
    in accumulate mode on chip_smoke phase 21's slot block (Zipf and one
    token), each checkout's merged update held to the float64 plain one,
    and K13 on chip_smoke's fills a-c (V 10,000 and 1,000,000 from two
    slots' steps, and every count nonzero), the two checkouts' tables bit
    for bit: other, this, this, other, back to back.

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

from chip_smoke import (HS_SHAPES, RESIDENT_SHAPES, SGNS_SHAPES, check,
                        cuda_ms, hs_block, hs_corpus, regular_graph,
                        synth_power_law_graph)


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


def conv_step_fns(pkg, tables, window: int, lr: float, nw: float,
                  hub=None, workspace=None):
    """One checkout's conv step on a block as its kernels' launches, on a
    workspace and tables of its own: this design's three (accumulate, the
    negative half, the scatter-update over the block's token groups, cut at
    `hub` if given) or the delta-slot design's four (accumulate,
    sgns_shared_grads, scatter into delta slots, apply). `workspace(a_in,
    a_out, B, T, window, kB)` makes the workspace if given.
    Returns (the launches, in step order; the tables they move)."""
    sc = pkg("ops.sgns_conv")
    w_in, w_out, block, cwin, negs = tables
    B, T = block.shape
    kB = negs.shape[0]
    a_in, a_out = w_in.clone(), w_out.clone()
    ws = (workspace or sc.ConvWorkspace)(a_in, a_out, B, T, window, kB)
    acc = lambda: sc.launch_accumulate(ws, a_in, a_out, block, cwin, negs,
                                       window, nw)
    if hasattr(sc, "group_blocks"):
        g = sc.group_blocks(block[None], *(() if hub is None else (hub,)))
        return [acc, lambda: sc.launch_negative_half(ws),
                lambda: sc.launch_scatter(ws, a_in, a_out, block, g.order[0],
                                          g.units[0], negs, nw, lr)
                ], (a_in, a_out)
    sgns, se = pkg("ops.sgns"), pkg("ops.sgns_exact")
    hold = {}
    return [acc,
            lambda: hold.update(d=sgns.sgns_shared_grads(
                ws.ein, ws.acc_in, ws.wn, ws.ones, ws.mask)),
            lambda: sc.launch_scatter(ws, a_out, block, hold["d"][0],
                                      hold["d"][2], negs, nw, lr),
            lambda: se.launch_apply(ws.slots, a_in, a_out, lr)], (a_in, a_out)


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

    # the exact-negative step's launches at phase 11's block
    from chip_smoke import cuda_ms_split, exact_block

    def exact_launches(se, ws, t_in, t_out, block, cwin, negs, win, lr):
        """A checkout's step as its launches: one kernel, or a gradient
        kernel then an update kernel."""
        if hasattr(se, "launch_step"):
            return (lambda: se.launch_step(ws, t_in, t_out, block, cwin,
                                           negs, win, lr),)
        return (lambda: se.launch_grads(ws, t_in, t_out, block, cwin, negs,
                                        win),
                lambda: se.launch_apply(ws, t_in, t_out, lr))

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
                return exact_launches(se, ws, t_in, t_out, block, cwin, negs,
                                      win, lr)
            steps[name] = turn
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in
                  zip(results["this"], results["other"])),
              f"the two checkouts' exact steps disagree at D={D}")
        runs = [(name, cuda_ms_split(steps[name](), 20))
                for name in order + order]
        print(json.dumps({"kernel": "the exact step's launches (this: "
                          "sgns_exact_step; a two-kernel checkout: "
                          "sgns_exact_grads, sgns_exact_apply)",
                          "block": [B, T, win, k, D],
                          "ms_each_launch_in_turns": runs,
                          "ms_a_step_in_turns": [(n, sum(t)) for n, t in runs],
                          "card": smi}))

    # the conv step's kernels at phase 14's main block: this checkout's
    # three launches against the delta-slot design's four, each between
    # CUDA events
    from chip_smoke import CONV_SHAPES, conv_block

    V, B, T, win, kB, D, tokens = CONV_SHAPES[0]
    tables = conv_block(torch, V, B, T, win, kB, D, 0, tokens)
    nw, lr = 5 / kB, 0.025
    results = {}
    for name, pkg in (("other", other), ("this", this)):
        fns, moved = conv_step_fns(pkg, tables, win, lr, nw)
        for fn in fns:
            fn()
        results[name] = moved
    check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in
              zip(results["this"], results["other"])),
          "the two checkouts' conv steps disagree")
    runs = [(name, cuda_ms_split(conv_step_fns(
        {"other": other, "this": this}[name], tables, win, lr, nw)[0], 20))
        for name in order + order]
    print(json.dumps({"kernel": "the conv step's launches (this: "
                      "accumulate, sgns_shared_grads, scatter-update; the "
                      "delta-slot design: accumulate, sgns_shared_grads, "
                      "scatter, apply)",
                      "block": [B, T, win, kB, D],
                      "ms_each_launch_in_turns": runs, "card": smi}))

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
    compare_spmm(torch, np, this, other, graph, order, smi)
    compare_hs(torch, this, other, order, smi)
    compare_dp(torch, this, other, order, smi)
    return 0


def compare_spmm(torch, np, this, other, graph, order, smi) -> None:
    """K8's kernels of each checkout on measure_spmm's graph at D 128: the
    segment sum on the CSR order and the transposed order, the SDDMM, the
    row softmax forward and backward."""
    V, E = graph.num_vertices, graph.num_edges
    rng = np.random.default_rng(0)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
        np.float32)).cuda()
    x, y, s, da = f(V, 128), f(V, 128), f(E) * 3, f(E)
    fns = {}
    for name, pkg in (("other", other), ("this", this)):
        sp = pkg("ops.spmm")
        es = sp.EdgeStructure.from_csr(graph, device="cuda")
        a = sp.row_softmax(es, s)
        fns[name] = {
            "segment_sum csr": lambda sp=sp, es=es: sp.segment_sum(
                es.csr, x, idx=es.col, w=es.weight),
            "segment_sum transposed": lambda sp=sp, es=es: sp.segment_sum(
                es.trans, x, idx=es.t_row, w=es.weight, widx=es.t_order),
            "sddmm_rows": lambda sp=sp, es=es: sp.sddmm_rows(es, x, y),
            "row_softmax": lambda sp=sp, es=es: sp.row_softmax(es, s),
            # each checkout's backward on the same softmax (this one's)
            "row_softmax backward": lambda sp=sp, es=es: sp.row_softmax(
                es, fns["this"]["a"], da),
            "a": a}
    for which in ("segment_sum csr", "segment_sum transposed", "sddmm_rows",
                  "row_softmax", "row_softmax backward"):
        a, b = fns["this"][which](), fns["other"][which]()
        atol = 1e-6 if which.startswith("row_softmax") else 1e-5
        check(torch.allclose(a, b, rtol=1e-5, atol=atol),
              f"the two checkouts' {which} disagree: max abs diff "
              f"{float((a - b).abs().max()):.3g}")
        runs = [(name, cuda_ms(fns[name][which], 20)) for name in order]
        print(json.dumps({"kernel": f"spmm {which}", "vertices": V,
                          "arcs": E, "D": 128, "ms_in_turns": runs,
                          "card": smi}))
    # chip_smoke phase 20's GAT-style layer and its gradient through each
    # checkout's public ops: every kernel launch and the torch ops between
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()

    def layer(sp, es):
        h = sp.spmm_mean(es, xg)
        a = sp.sddmm_softmax(es, sp.sddmm(es, h, yg))
        out = sp.scatter_add_rows(es, sp.gather_rows(es, xg) * a[:, None])
        (out ** 2).sum().backward()

    layers = {}
    for name, pkg in (("other", other), ("this", this)):
        sp = pkg("ops.spmm")
        layers[name] = (lambda sp=sp, es=sp.EdgeStructure.from_csr(
            graph, device="cuda"): layer(sp, es))
    runs = [(name, cuda_ms(layers[name], 5)) for name in order]
    print(json.dumps({"step": "GAT-style layer, forward and backward",
                      "vertices": V, "arcs": E, "D": 128,
                      "ms_in_turns": runs, "card": smi}))


def compare_hs(torch, this, other, order, smi) -> None:
    """K9 of each checkout on phase 19's block and the one-token block
    (chip_smoke's HS_SHAPES[0] and its "hub" shape)."""
    corpus = hs_corpus(torch)
    lr = 0.025
    for shape in (HS_SHAPES[0], next(s for s in HS_SHAPES if s[0] == "hub")):
        _, B, T, win, D = shape
        syn0, syn1, block, cwin, pts, lbl, pmk = hs_block(torch, *shape, 0,
                                                          corpus)
        L = pts.shape[1]
        results, steps = {}, {}
        for name, pkg in (("other", other), ("this", this)):
            ho = pkg("ops.hsoftmax")
            b0, b1 = syn0.clone(), syn1.clone()
            ho.launch_step(ho.HSWorkspace(b0, b1, B * T, L), b0, b1, block,
                           cwin, pts, lbl, pmk, win, lr)
            results[name] = (b0, b1)

            def turn(ho=ho):
                # a turn's own tables and workspace (moved by the steps)
                b0, b1 = syn0.clone(), syn1.clone()
                ws = ho.HSWorkspace(b0, b1, B * T, L)
                return lambda: ho.launch_step(ws, b0, b1, block, cwin, pts,
                                              lbl, pmk, win, lr)
            steps[name] = turn
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in
                  zip(results["this"], results["other"])),
              f"the two checkouts' HS steps disagree at {shape}")
        runs = [(name, cuda_ms(steps[name](), 10)) for name in order]
        print(json.dumps({"kernel": "hs_step", "block": list(shape),
                          "levels": L, "ms_in_turns": runs, "card": smi}))


def compare_dp(torch, this, other, order, smi) -> None:
    """The data-parallel merged update's kernels of each checkout: K5's
    scatter in accumulate mode on chip_smoke phase 21's slot block (B 16, T
    82, w 10, kB 128, D 128; Zipf, and one token alone), each into a
    buffer of its own, after checking each buffer's merged update against
    the float64 plain one (rtol 1e-5, atol 1e-6); then K13 on
    chip_smoke's fills a, b and c (dp_fill: V 10,000 and 1,000,000 from
    two slots' steps, and every count nonzero), each launch on a copy of
    the fill of its own, after checking the two checkouts' tables equal
    bit for bit. Back to back, in turns."""
    from chip_smoke import conv_block, dp_fill

    V, B, T, win, kB, D, lr = 10_000, 16, 82, 10, 128, 128, 0.025
    nw = 5 / kB
    for tokens in ("zipf", "hub"):
        w_in, w_out, block, cwin, negs = conv_block(torch, V, B, T, win, kB,
                                                    D, 0, tokens)
        fns, bufs = {}, {}
        for name, pkg in (("other", other), ("this", this)):
            sc, da = pkg("ops.sgns_conv"), pkg("ops.dp_apply")
            ws = sc.ConvWorkspace(w_in, w_out, B, T, win, kB)
            sc.launch_accumulate(ws, w_in, w_out, block, cwin, negs, win, nw)
            sc.launch_negative_half(ws)
            buf = torch.zeros(da.buffer_numel(V, D), device="cuda")
            if hasattr(sc, "launch_scatter_accumulate"):
                fn = (lambda sc=sc, ws=ws, buf=buf:
                      sc.launch_scatter_accumulate(ws, block, negs, nw, buf))
            else:     # the grouped scatter's accumulate entry point
                g = sc.group_blocks(block[None])
                fn = (lambda sc=sc, ws=ws, buf=buf, g=g: sc.launch_scatter(
                    ws, w_in, w_out, block, g.order[0], g.units[0], negs, nw,
                    lr, buf))
            fn()
            fns[name], bufs[name] = fn, buf
        # each checkout's buffer applied in float64 against the float64
        # plain merged update of the slot (chip_smoke phase 21's gate)
        sc, da = this("ops.sgns_conv"), this("ops.dp_apply")
        want = (w_in.double(), w_out.double())
        buf64 = torch.zeros(da.buffer_numel(V, D), dtype=torch.float64,
                            device="cuda")
        sc.sgns_conv_accumulate_ref(*want, block, cwin, negs, nw, win, buf64)
        da.dp_apply_ref(*want, buf64, lr)
        for name, buf in bufs.items():
            got = (w_in.double(), w_out.double())
            da.dp_apply_ref(*got, buf.double(), lr)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                      for a, b in zip(got, want)),
                  f"{name}'s accumulate-mode scatter misses the float64 "
                  f"merged update ({tokens}): max abs err {err:.3g}")
        runs = [(name, cuda_ms(fns[name], 20)) for name in order]
        print(json.dumps({"kernel": "sgns_conv scatter, accumulate mode, "
                          "back to back", "tokens": tokens,
                          "block": [B, T, win, kB, D], "ms_in_turns": runs,
                          "card": smi}))
    for fill_name, V, every in (("a", 10_000, False),
                                ("b", 1_000_000, False),
                                ("c", 10_000, True)):
        w_in, w_out, fill, _ = dp_fill(torch, V, D, 40, every_row=every)
        got = {}
        for name, pkg in (("other", other), ("this", this)):
            t_in, t_out = w_in.clone(), w_out.clone()
            pkg("ops.dp_apply").dp_apply(t_in, t_out, fill.clone(), lr)
            got[name] = (t_in, t_out)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got["this"],
                                                      got["other"])),
              f"the two checkouts' dp_apply differ on fill {fill_name}")
        del got
        iters = 20 if V <= 10_000 else 5

        def on_copies(pkg):
            bufs = iter([fill.clone() for _ in range(iters + 1)])
            da = pkg("ops.dp_apply")
            return lambda: da.dp_apply(w_in, w_out, next(bufs), lr)
        runs = [(name, cuda_ms(on_copies({"other": other,
                                          "this": this}[name]), iters))
                for name in order]
        touched = int((fill[2 * V * D:] != 0).sum())
        print(json.dumps({"kernel": "dp_apply, back to back",
                          "fill": fill_name, "V": V, "D": D,
                          "touched_rows": touched, "ms_in_turns": runs,
                          "card": smi}))
        del w_in, w_out, fill
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
