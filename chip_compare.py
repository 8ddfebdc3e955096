#!/usr/bin/env python3
"""Time two checkouts' kernels of the PyTorch/CUDA port on one GPU, in turns.

    python3 chip_compare.py OTHER_CHECKOUT [--only cdf|shard]

OTHER_CHECKOUT is the root of another checkout of this repository under this
checkout's build/ (say the parent commit, unpacked by `git archive` into
build/parent; .gitignore lists build/). Its package is loaded beside this checkout's under another name and
builds its own kernels into its own build/kernels/. At the main path's
shapes of chip_smoke.py the script times, with chip_smoke's cuda_ms (CUDA
events around launches queued behind a long product):

  * sgns_shared_grads at (2624, 128, 128) and at chip_smoke's SGNS_WIDE
    (P 2624, kB 128, D 384, 512, 768, 1,025, 1,536): plain (f32, TF32
    off), other, this, this, other, plain;
  * the walk kernel on the walk_10k graph (10 rounds, L = 80, p = q = 0.25):
    other, this, this, other, after checking the two corpora equal;
  * the trial-key table as each checkout's walk_corpus gets it: host wall
    time of the call, synchronized; then its device time alone, and the
    table followed by the walk kernel it feeds, after checking the corpus
    equal: other, this, this, other, twice; then this checkout's launch
    forms against text edits of its sources (compare_launch_forms): the
    walk kernel as the table's programmatic dependent, and K11's serve (a
    programmatic dependent) as an ordinary launch after the emit;
  * K11's emit at chip_smoke phase 22's superstep (compare_shard_emit:
    rank 0's walkers, the first round, the three layouts), then its serve
    (compare_shard_serve: rank 0's local walkers and the buffer it
    receives, one launch of this checkout against the two of a checkout
    whose serve takes each half alone, or against the one launch of a
    checkout that serves the requests alone, from the emit's list of the
    local walkers) on the same tables: other, this, this, other, twice,
    after checking the two checkouts' outputs equal; then phase 22 (b)'s
    timed walk on two gloo ranks (compare_shard_superstep: K11's ms a
    superstep by the engine's CUDA events and the wrappers' host ms) for
    each checkout. With --only shard, these three and nothing else;
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
    w 10, kB 128, Zipf) at D 128 and 768, each launch timed between CUDA
    events,
    after checking the two checkouts' tables agree (rtol 1e-5, atol 1e-6):
    other, this, this, other, twice;
  * the exact-CDF walk kernel on phase 10's corpus (the walk_10k graph,
    10 rounds, L = 80, p = 1/16, q = 4, chunked): other, this, this,
    other, after checking the two corpora equal;
  * the CDF serve (compare_cdf_serve) at chip_smoke phase 25 (a)'s
    superstep of that corpus, hash and vertex cut: rank 0's local walkers
    and the whole received buffer as each checkout's walk serves them, and
    star50k's hub row at one request and at 2,048, after checking the two
    checkouts' steps equal: other, this, this, other, twice. With --only
    cdf, these two (the CDF serve, then K7 in four turns each) and nothing
    else;
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
    for bit: other, this, this, other, back to back;
  * the exact form's merged update of phase 21's two slots
    (compare_dp_exact): this checkout's launches against the other's, each
    merged update held to the float64 plain one first, and the accumulate
    launch over one slot: other, this, this, other, twice, between CUDA
    events.

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

from chip_smoke import (HS_SHAPES, RESIDENT_SHAPES, SGNS_SHAPES, SGNS_WIDE,
                        check, cuda_ms, hs_block, hs_corpus, regular_graph,
                        shard_graph, synth_power_law_graph)


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


# this checkout's sources with the launch form changed: the walk kernel as
# the key table's programmatic dependent (it waits for the table first),
# and K11's serve as an ordinary launch
WALK_AS_DEPENDENT = [
    ("    walk_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0, "
     "(cudaStream_t)stream>>>(\n        starts,",
     "    const cudaError_t err = srw::launch_dependent(\n        walk_kernel,"
     " dim3((N + kBlock - 1) / kBlock), dim3(kBlock),\n        "
     "(cudaStream_t)stream, starts,"),
    ("        inv_q, max_f, mode);\n  }\n  return (int)cudaGetLastError();\n}"
     "\n\nextern \"C\" int srw_trial_keys_launch",
     "        inv_q, max_f, mode);\n    if (err != cudaSuccess) return (int)err;"
     "\n  }\n  return (int)cudaGetLastError();\n}\n\nextern \"C\" int "
     "srw_trial_keys_launch"),
    ("            float inv_p, float inv_q, float max_f, int mode) {\n"
     "  const int row",
     "            float inv_p, float inv_q, float max_f, int mode) {\n"
     "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
     "  const int row"),
]
SERVE_ORDINARY = [
    ("    const cudaError_t err = srw::launch_dependent(\n"
     "        shard_serve_kernel,\n"
     "        dim3((unsigned)((items + kServeThreads - 1) / kServeThreads)),\n"
     "        dim3(kServeThreads), (cudaStream_t)stream, a);",
     "    shard_serve_kernel<<<(unsigned)((items + kServeThreads - 1) /\n"
     "                                    kServeThreads),\n"
     "                         kServeThreads, 0, (cudaStream_t)stream>>>(a);\n"
     "    const cudaError_t err = cudaSuccess;"),
]


def compare_launch_forms(torch, this, walker, graph, R, L, p, q,
                         smi) -> None:
    """The launch forms, each against this checkout's source in turns (this,
    variant, variant, this, twice), outputs bit for bit: the key table +
    the walk kernel at walk_10k with the walk as the table's programmatic
    dependent; the emit + K11's serve of the local walkers it flags at
    chip_smoke phase 22's superstep (hash route, rank 0's walkers) with the
    serve as an ordinary launch."""
    from chip_smoke import edited, shard_superstep, source_kernel

    build = this("ops._build")
    ws, sw = this("ops.walk_step"), this("ops.shard_walk")
    pkg, dg, starts, spec, key = walker
    T = spec.max_rounds * spec.k_candidates
    V = graph.num_vertices
    text = (build.CSRC / "walk.cu").read_text()
    dep = {k.symbol: source_kernel("walk_dependent", edited(
        text, WALK_AS_DEPENDENT), k.symbol, k.argtypes, "walk_dependent")
        for k in (ws.WALK_KERNEL, ws.KEYS_KERNEL)}
    saved = (ws.WALK_KERNEL, ws.KEYS_KERNEL)

    def walk_with(kernels):
        def run():
            ws.WALK_KERNEL, ws.KEYS_KERNEL = kernels
            keys = ws.trial_keys(key, 0, R, L, T, device="cuda")
            out = ws.walk_rounds(dg, starts, keys, L, p, q, V)
            ws.WALK_KERNEL, ws.KEYS_KERNEL = saved
            return out
        return run

    fns = {"source": walk_with(saved), "dependent": walk_with(
        (dep[saved[0].symbol], dep[saved[1].symbol]))}
    check(torch.equal(fns["source"](), fns["dependent"]()),
          "the walk as a programmatic dependent differs")
    order = ("source", "dependent", "dependent", "source") * 2
    runs = [(name, cuda_ms(fns[name], 10)) for name in order]
    print(json.dumps({"launch form": "trial_keys + walk, the walk as the "
                      "table's programmatic dependent", "ms_in_turns": runs,
                      "card": smi}))

    corpus = fns["source"]().reshape(R * V, L + 2)
    keys = ws.trial_keys(key, 0, R, L, T, device="cuda")
    tabs, cur, prev, alive, _, S, Ln, C, W_pad = shard_superstep(
        torch, graph, "hash", corpus)
    text = (build.CSRC / "shard_walk.cu").read_text()
    ordinary = source_kernel("serve_ordinary", edited(text, SERVE_ORDINARY),
                             sw.SERVE_KERNEL.symbol, sw.SERVE_KERNEL.argtypes,
                             "serve_ordinary")
    saved_serve = sw.SERVE_KERNEL
    n = cur.shape[0]
    pend, loc = (torch.zeros(n, dtype=torch.int32, device="cuda")
                 for _ in range(2))
    kw = dict(W_pad=W_pad, W_total=R * W_pad, n_stream=V, p=p, q=q)
    work = sw.emit_work(n, S * Ln, C, "cuda")

    def serve_with(kernel):
        def run():
            sw.SERVE_KERNEL = kernel
            sw.emit(tabs[0], cur, prev, pend, alive, loc, Ln, S * Ln, 0, C,
                    work)
            out, _ = sw.serve(tabs[0], keys, 5, False,
                              local=(cur, prev, loc), **kw)
            sw.SERVE_KERNEL = saved_serve
            return out
        return run

    fns = {"source": serve_with(saved_serve), "ordinary": serve_with(ordinary)}
    check(torch.equal(fns["source"](), fns["ordinary"]()),
          "K11's serve as an ordinary launch differs")
    order = ("source", "ordinary", "ordinary", "source") * 2
    runs = [(name, cuda_ms(fns[name], 20)) for name in order]
    print(json.dumps({"launch form": "shard_emit + shard_serve, the serve "
                      "as an ordinary launch", "ms_in_turns": runs,
                      "card": smi}))


def k11_superstep(torch, this, graph):
    """chip_smoke phase 22's superstep as this checkout builds it: the
    corpus and key table of phase 4's walk, each layout's walkers of ranks
    0 and 1 (chip_smoke.shard_superstep), each rank's emit (the first round
    at the auto capacity) into a work of its own, and rank 0's requests:
    its walkers with their local flags and the buffer it receives. Returns
    (keys, {layout: (rank 0's superstep, its local flags, the received
    buffer [2, C, 3])})."""
    from chip_smoke import SHARD_LAYOUTS, shard_superstep

    ws, sw = this("ops.walk_step"), this("ops.shard_walk")
    R, Lw, p, q = 10, 80, 0.25, 0.25
    corpus = this("walk.engine").random_walks(
        graph, walk_length=Lw, num_walks=R, p=p, q=q, seed=0,
        as_numpy=False, device="cuda")
    _, max_rounds = this("ops.sampling").plan_sampler("rejection", p, q)
    keys = ws.trial_keys(this("ops.prng").prng_key(0), 0, R, Lw,
                         4 * max_rounds, device="cuda")
    out = {}
    for layout in SHARD_LAYOUTS:
        ranks = [shard_superstep(torch, graph, layout, corpus, rank=r)
                 for r in range(2)]
        sends = []
        for rk, (tabs, cur, prev, alive, _, S, L, C, W_pad) in \
                enumerate(ranks):
            n = cur.shape[0]
            flags = torch.zeros(n, dtype=torch.int32, device="cuda")
            send, _, _ = sw.emit(
                tabs[rk // L], cur, prev, torch.zeros_like(flags), alive,
                flags, L, S * L, rk * n, C, sw.emit_work(n, S * L, C, "cuda"))
            sends.append(send.clone())
            if rk == 0:
                local = flags
        recv = torch.stack([sends[0][0], sends[1][0]]).contiguous()
        out[layout] = (ranks[0], local, recv)
    return keys, out


def compare_shard_emit(torch, this, other, graph, smi) -> None:
    """K11's emit at chip_smoke phase 22's superstep (rank 0's walkers, the
    first round at the auto capacity) in the three layouts against the
    other checkout's, each into buffers of its own, after checking the
    buffers, slots, counts and flags equal: other, this, this, other,
    twice."""
    from chip_smoke import SHARD_LAYOUTS, shard_superstep

    corpus = this("walk.engine").random_walks(
        graph, walk_length=80, num_walks=10, p=0.25, q=0.25, seed=0,
        as_numpy=False, device="cuda")
    order = ("other", "this", "this", "other") * 2
    for layout in SHARD_LAYOUTS:
        tabs, cur, prev, alive, _, S, L, C, _ = shard_superstep(
            torch, graph, layout, corpus)
        n, D = cur.shape[0], S * L
        fns, flags = {}, {}
        for name, pkg in (("other", other), ("this", this)):
            sw = pkg("ops.shard_walk")
            pend, loc = (torch.zeros(n, dtype=torch.int32, device="cuda")
                         for _ in range(2))
            work = sw.emit_work(n, D, C, "cuda")
            fns[name] = (lambda sw=sw, pend=pend, loc=loc, work=work:
                         sw.emit(tabs[0], cur, prev, pend, alive, loc, L, D,
                                 0, C, work))
            flags[name] = (pend, loc)
        a, b = fns["this"](), fns["other"]()
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
              and torch.equal(a[2][:2], b[2][:2])
              and all(torch.equal(x, y) for x, y in zip(flags["this"],
                                                        flags["other"])),
              f"the two checkouts' emits differ ({layout})")
        runs = [(name, cuda_ms(fns[name], 20)) for name in order]
        print(json.dumps({"kernel": "shard_emit", "layout": layout,
                          "walkers": n, "capacity": C,
                          "requests": int(a[2][0]), "ms_in_turns": runs,
                          "card": smi}))


def compare_shard_serve(torch, this, other, graph, smi) -> None:
    """K11's serve at chip_smoke phase 22's superstep (k11_superstep) in
    the three layouts: this checkout's serve of rank 0's walkers with their
    local flags and the buffer it receives against the other checkout's,
    on the same shard tables and key table. A checkout whose serve takes
    one half a call serves them in two launches (the walkers by their
    local flags, then every slot of the received buffer), timed together;
    one whose serve takes the local walkers as a list (the local walkers'
    indices and their count) gets it from the flags. The steps bit for
    bit: other, this, this, other, twice."""
    from chip_smoke import SHARD_STEP

    keys, steps = k11_superstep(torch, this, graph)
    order = ("other", "this", "this", "other") * 2
    t = SHARD_STEP
    for layout, (sup, flags, recv) in steps.items():
        tabs, cur, prev, alive, _, S, L, C, W_pad = sup
        n = cur.shape[0]
        kw = dict(W_pad=W_pad, W_total=10 * W_pad,
                  n_stream=graph.num_vertices, p=0.25, q=0.25)
        listed = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        idx = flags.nonzero().squeeze(1)
        listed[:idx.shape[0]] = idx.to(torch.int32)
        count = torch.tensor([idx.shape[0]], dtype=torch.int32,
                             device="cuda")
        fns = {}
        for name, pkg in (("other", other), ("this", this)):
            sw = pkg("ops.shard_walk")
            dst = torch.full((n,), -1, dtype=torch.int32, device="cuda")
            if not hasattr(sw, "serve_plain"):
                fns[name] = (lambda sw=sw: (
                    sw.serve(tabs[0], (cur, prev, None), flags, 0, keys, t,
                             False, **kw),
                    sw.serve(tabs[0], recv.reshape(-1, 3), None, 0, keys, t,
                             False, **kw)))
            else:
                local = ((cur, prev, listed, count)
                         if "local_list" in inspect.getsource(sw.EmitWork)
                         else (cur, prev, flags))
                fns[name] = (lambda sw=sw, dst=dst, local=local: sw.serve(
                    tabs[0], keys, t, False, local=local, recv=recv,
                    dst=dst, **kw))
        a, b = fns["this"](), fns["other"]()
        check(torch.equal(a[0][flags != 0], b[0][flags != 0])
              and torch.equal(a[1], b[1]),
              f"the two checkouts' K11 serves differ ({layout})")
        runs = [(name, cuda_ms(fns[name], 20)) for name in order]
        print(json.dumps({"kernel": "shard_serve", "layout": layout,
                          "local": int(count),
                          "received": int((recv[..., 2] >= 0).sum()),
                          "slots": recv.shape[0] * recv.shape[1],
                          "ms_in_turns": runs, "card": smi}))


# phase 22 (b)'s timed run on two gloo ranks sharing the card: K11's ms a
# superstep by the engine's CUDA events (timing=), the host ms inside the
# emit and serve wrappers a superstep, the walk's seconds, the corpus's
# digest
SUPERSTEP_WORKER = r"""
import hashlib, json, sys, time
import torch, torch.distributed as dist
from stellar_rw_tpu_torch.graph import io as gio
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.ops import shard_walk
from stellar_rw_tpu_torch.parallel import dp
from stellar_rw_tpu_torch.utils.config import parse

rank, port, edges, out, runs = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4], int(sys.argv[5]))
dp.init_group(rank, 2, ["cuda:0", "cuda:0"], f"tcp://localhost:{port}")
host = {"emit": 0.0, "serve": 0.0}


def timed(name, fn):
    def run(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        host[name] += time.perf_counter() - t0
        return out
    return run


shard_walk.emit = timed("emit", shard_walk.emit)
shard_walk.serve = timed("serve", shard_walk.serve)
params = parse(["--input", edges, "--output", out] + json.loads(sys.argv[6]))
graph = gio.load_edge_list(edges)
res = []
for _ in range(runs + 1):     # the first builds the kernels
    timing = {}
    host.update(emit=0.0, serve=0.0)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    walks = n2v.run_walks(graph, params, "cuda", timing=timing)
    torch.cuda.synchronize()
    sup = timing["supersteps"]
    res.append({"walk_seconds": time.perf_counter() - t0,
                "k11_ms": (timing["emit_ms"] + timing["serve_ms"]) / sup,
                "emit_ms": timing["emit_ms"] / sup,
                "serve_ms": timing["serve_ms"] / sup,
                "serve_calls": timing["serve_calls"],
                "host_ms": (host["emit"] + host["serve"]) * 1e3 / sup,
                "collective_host_ms": timing["collective_host_ms"] / sup,
                "corpus": hashlib.sha1(
                    walks.cpu().numpy().tobytes()).hexdigest()})
print("RESULT " + json.dumps(res[1:]), flush=True)
dist.destroy_process_group()
"""


def compare_shard_superstep(this_root: str, other_root: str, smi,
                            runs: int = 3) -> None:
    """Phase 22 (b)'s timed run (the hash route over 2 shards, phase 4's
    graph and walk) on two gloo ranks sharing the card, as each checkout's
    engine runs it: other, this, this, other, `runs` timed walks each after
    one that builds the kernels; the corpora equal. A line a form and rank: K11's ms a superstep by CUDA
    events, the wrappers' host ms a superstep, the collectives' host ms
    and the walk's seconds."""
    import tempfile

    import numpy as np

    from chip_smoke import (SHARD_FLAGS, SHARD_LAYOUTS, free_port,
                            synth_power_law_arcs)

    roots = {"other": other_root, "this": this_root}
    flags = json.dumps(SHARD_FLAGS + SHARD_LAYOUTS["hash"])
    digests = set()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = synth_power_law_arcs(10_000, 334_000, seed=0)
        edges = os.path.join(tmp, "edges.txt")
        np.savetxt(edges, np.stack([src, dst], 1), fmt="%d")
        for name in ("other", "this", "this", "other"):
            port = str(free_port())
            env = dict(os.environ, PYTHONPATH=roots[name])
            procs = [subprocess.Popen(
                [sys.executable, "-c", SUPERSTEP_WORKER, str(r), port, edges,
                 os.path.join(tmp, name), str(runs), flags], env=env,
                cwd=roots[name], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for r in range(2)]
            try:
                outs = [p.communicate(timeout=600) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for p, (out, err) in zip(procs, outs):
                check(p.returncode == 0, f"{name}: a rank failed: "
                      f"{err[-3000:]}")
            for rank, (out, _) in enumerate(outs):
                res = json.loads([ln for ln in out.splitlines()
                                  if ln.startswith("RESULT ")][-1][7:])
                digests.update(r.pop("corpus") for r in res)
                print(json.dumps({"superstep": name, "rank": rank,
                                  "runs": res, "card": smi}), flush=True)
    check(len(digests) == 1, "the checkouts' corpora differ")


def compare_cdf_walk(torch, this, other, graph, order, smi) -> None:
    """The exact-CDF walk kernel (K7) at phase 10's corpus (the walk_10k
    graph, 10 rounds, L = 80, p = 1/16, q = 4, chunked) against the other
    checkout's, after checking the two corpora equal."""
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


def compare_cdf_serve(torch, this, other, smi) -> None:
    """The CDF serve at chip_smoke phase 25 (a)'s superstep (phase 10's
    corpus, superstep SHARD_STEP, hash and vertex cut over 2 shards): rank
    0's local walkers, and the whole received buffer (rank 0's send buffer,
    served on shard 1) as each checkout's walk serves it; then star50k's
    hub row at one request and at 2,048;
    each checkout on its own shard tables, the steps bit for bit: other,
    this, this, other, twice."""
    from chip_smoke import SHARD_STEP, shard_home, shard_superstep, star_graph

    graph = synth_power_law_graph(10_000, 334_000, seed=0)
    V, R, L, p, q = graph.num_vertices, 10, 80, 0.0625, 4.0
    engine = this("walk.engine")
    spec = engine.walk_spec(graph, L, R, p, q, "cdf", 16, "float32", V)
    corpus = engine.random_walks(graph, walk_length=L, num_walks=R, p=p,
                                 q=q, seed=0, as_numpy=False, device="cuda")
    t = SHARD_STEP
    order = ("other", "this", "this", "other") * 2

    def serves(graph, route, cdf_kw):
        """Each checkout's (shard tables, cdf_serve)."""
        out = {}
        for name, pkg in (("other", other), ("this", this)):
            sw = pkg("ops.shard_walk")
            plan = pkg("graph.partition").plan_shards(graph, 2, route)
            tabs = [sw.shard_tables(graph, plan, s, "cuda", cdf=True)
                    for s in range(2)]

            counters = "work" in inspect.signature(sw.cdf_serve).parameters

            def serve(tab, req, valid, segments=0, sw=sw,
                      counters=counters):
                # as each checkout's walk serves it: this one counts a
                # received buffer over its buckets' prefixes
                extra = ({"work": torch.zeros(2, dtype=torch.int32,
                                              device="cuda"),
                          "segments": segments} if counters else {})
                return lambda: sw.cdf_serve(tab, req, valid, 0, key, 0, t,
                                            False, **cdf_kw, **extra)
            out[name] = (tabs, serve)
        return out

    key = this("ops.prng").prng_key(0)
    for layout in ("hash", "vcut"):
        tabs, cur, prev, alive, rows, S, Ln, C, W_pad = shard_superstep(
            torch, graph, layout, corpus, cdf=True)
        n = cur.shape[0]
        lk = torch.zeros(n, dtype=torch.int32, device="cuda")
        send, *_ = this("ops.shard_walk").emit(
            tabs[0], cur, prev, torch.zeros_like(lk), alive, lk, Ln, S * Ln,
            0, C)
        recv = send.reshape(-1, 3).clone()
        route = shard_home(graph) % S if layout == "vcut" else None
        kw = dict(W_pad=W_pad, W_total=R * W_pad, p=p, q=q,
                  cdf_chunk=spec.cdf_chunk, dtype="float32")
        each = serves(graph, route, kw)
        for what, make in (
                ("local walkers", lambda tabs, serve: serve(
                    tabs[0], (cur, prev, None), lk)),
                ("received buffer", lambda tabs, serve: serve(
                    tabs[1], recv, None, S * Ln))):
            fns = {name: make(*each[name]) for name in each}
            check(torch.equal(fns["this"](), fns["other"]()),
                  f"the two checkouts' CDF serves differ ({layout}, {what})")
            runs = [(name, cuda_ms(fns[name], 10)) for name in order]
            print(json.dumps({"kernel": "shard_cdf_serve", "layout": layout,
                              "requests": what, "slots": n if what[0] == "l"
                              else recv.shape[0],
                              "ms_in_turns": runs, "card": smi}))
    star = star_graph(50_000)
    Vs = star.num_vertices
    each = serves(star, None, dict(W_pad=Vs, W_total=Vs, p=p, q=q,
                                   cdf_chunk=this("ops.sampling").CDF_CHUNK,
                                   dtype="float32"))
    leaves = torch.arange(1, 2049, dtype=torch.int32, device="cuda")
    many = torch.stack([torch.zeros_like(leaves), leaves, leaves], 1)
    for k in (1, 2048):
        req = many[:k].contiguous()
        fns = {name: serve(tabs[0], req, None)
               for name, (tabs, serve) in each.items()}
        check(torch.equal(fns["this"](), fns["other"]()),
              f"the two checkouts' CDF serves differ (star50k, {k})")
        runs = [(name, cuda_ms(fns[name], 10)) for name in order]
        print(json.dumps({"kernel": "shard_cdf_serve",
                          "requests": f"star50k's hub, {k}",
                          "ms_in_turns": runs, "card": smi}))


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

    only = argv[2] if argv[1:2] == ["--only"] and len(argv) == 3 else None
    if only not in (None, "cdf", "shard"):
        print(__doc__, file=sys.stderr)
        return 2
    if len(argv) != (3 if only else 1) or not os.path.isdir(argv[0]):
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
    if only == "shard":
        compare_shard_emit(torch, this, other, shard_graph(), smi)
        compare_shard_serve(torch, this, other, shard_graph(), smi)
        compare_shard_superstep(root, other_root, smi)
        return 0
    if only:
        compare_cdf_serve(torch, this, other, smi)
        compare_cdf_walk(torch, this, other,
                         synth_power_law_graph(10_000, 334_000, seed=0),
                         ("other", "this", "this", "other") * 2, smi)
        return 0

    # sgns_shared_grads at the main shape and at each D of the split form
    order = ("plain", "other", "this", "this", "other", "plain")
    for P, D, kB in [SGNS_SHAPES[0], *SGNS_WIDE]:
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
                  f"the two checkouts' sgns_shared_grads disagree at "
                  f"{(P, D, kB)}")
        runs = [(name, cuda_ms(fns[name], 50 if D == 128 else 20))
                for name in order]
        print(json.dumps({"kernel": "sgns_shared_grads",
                          "shape": [P, D, kB], "ms_in_turns": runs,
                          "card": smi}))

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
    # the table alone on the card, and the table with the walk it feeds
    # (this checkout launches the walk as the table's programmatic
    # dependent), device time by CUDA events
    runs = [(name, cuda_ms(key_table(name), 20)) for name in order]
    print(json.dumps({"kernel": "trial_keys", "shape": [R, L + 1, 64],
                      "ms_in_turns": runs, "card": smi}))

    def keys_and_walk(name):
        pkg, dg, starts, spec, key = walkers[name]
        ws = pkg("ops.walk_step")
        table = key_table(name)
        return lambda: ws.walk_rounds(dg, starts, table(), L, p, q, V)

    both = {name: keys_and_walk(name) for name in walkers}
    check(torch.equal(both["this"](), corpus["other"]),
          "this checkout's table and walk differ from the other's corpus")
    runs = [(name, cuda_ms(both[name], 5)) for name in order * 2]
    print(json.dumps({"kernel": "trial_keys + walk", "walkers": R * V,
                      "walk_length": L, "ms_in_turns": runs, "card": smi}))
    compare_launch_forms(torch, this, walkers["this"], graph, R, L, p, q,
                         smi)
    compare_shard_emit(torch, this, other, shard_graph(), smi)
    compare_shard_serve(torch, this, other, shard_graph(), smi)
    compare_shard_superstep(root, other_root, smi)

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

    for V, B, T, win, kB, D, tokens in (CONV_SHAPES[0], CONV_SHAPES[2]):
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
              f"the two checkouts' conv steps disagree at D {D}")
        runs = [(name, cuda_ms_split(conv_step_fns(
            {"other": other, "this": this}[name], tables, win, lr, nw)[0],
            20)) for name in order + order]
        print(json.dumps({"kernel": "the conv step's launches (this: "
                          "accumulate, sgns_shared_grads, scatter-update; "
                          "the delta-slot design: accumulate, "
                          "sgns_shared_grads, scatter, apply)",
                          "block": [B, T, win, kB, D],
                          "ms_each_launch_in_turns": runs, "card": smi}))

    compare_cdf_walk(torch, this, other, graph, order, smi)
    compare_cdf_serve(torch, this, other, smi)

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
    compare_dp_exact(torch, this, other, order, smi)
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


def compare_dp_exact(torch, this, other, order, smi) -> None:
    """The exact form's merged update of chip_smoke phase 21's two Zipf
    slots (B 16, T 82, w 10, k 5, D 128): this checkout's one launch over
    both slots against the other's accumulate path (a slot's accumulate
    launch each into the reduction buffer, then K13), each held first to
    the plain merged update in float64 (rtol 1e-5, atol 1e-6); then the
    accumulate launch over one slot (the ranks' case) of each checkout.
    Each launch between CUDA events, in turns, each turn on tables, a
    workspace and a buffer of its own."""
    from chip_smoke import cuda_ms_split, dp_slots

    lr = 0.025
    (w_in, w_out), slots, (V, B, T, win, k, _) = dp_slots(
        torch, "exact", 128, ("zipf", "zipf"), 0)
    stacked = [torch.stack(x) for x in zip(*slots)]
    se, da = this("ops.sgns_exact"), this("ops.dp_apply")
    want = (w_in.double(), w_out.double())
    se.sgns_exact_merged_ref(*want, *stacked, lr, win)

    def merged(pkg, name, accumulate_only=False):
        """A turn's launches: this checkout's one merged launch, or the
        other's accumulate launch a slot and K13."""
        se, da = pkg("ops.sgns_exact"), pkg("ops.dp_apply")
        t = (w_in.clone(), w_out.clone())
        buf = torch.zeros(da.buffer_numel(V, 128), device="cuda")
        if accumulate_only:
            ws = se.Workspace(*t, B * T, win, k)
            return (lambda: se.launch_step(ws, *t, *slots[0], win, lr,
                                           buffer=buf),), t
        if name == "this":
            ws = se.Workspace(*t, 2 * B * T, win, k)
            return (lambda: se.launch_step(ws, *t, *stacked, win, lr),), t
        ws = se.Workspace(*t, B * T, win, k)
        return tuple(
            (lambda slot=slot: se.launch_step(ws, *t, *slot, win, lr,
                                              buffer=buf))
            for slot in slots) + (lambda: da.dp_apply(*t, buf, lr),), t

    pkgs = {"other": other, "this": this}
    for name, pkg in pkgs.items():
        fns, t = merged(pkg, name)
        for fn in fns:
            fn()
        err = max(float((a.double() - b).abs().max())
                  for a, b in zip(t, want))
        check(all(torch.allclose(a.double(), b, rtol=1e-5, atol=1e-6)
                  for a, b in zip(t, want)),
              f"{name}'s exact merged update misses the float64 one: {err:.3g}")
    runs = [(name, cuda_ms_split(merged(pkgs[name], name)[0], 20))
            for name in order + order]
    print(json.dumps({"kernel": "the exact form's merged update (this: one "
                      "sgns_exact merged launch over both slots; other: "
                      "sgns_exact accumulate a slot, then dp_apply)",
                      "slots": 2, "block": [B, T, win, k, 128],
                      "ms_each_launch_in_turns": runs,
                      "ms_a_merged_update_in_turns": [(n, sum(t))
                                                      for n, t in runs],
                      "card": smi}))
    runs = [(name, cuda_ms_split(merged(pkgs[name], name, True)[0], 20)[0])
            for name in order + order]
    print(json.dumps({"kernel": "sgns_exact accumulate over one slot",
                      "block": [B, T, win, k, 128], "ms_in_turns": runs,
                      "card": smi}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
