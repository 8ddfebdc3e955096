#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellar_rw_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a, one process for
each of the seven sources, in parallel; walk.cu, sgns_exact.cu and
sgns_conv.cu hold two kernels each), holds each against its plain PyTorch
version on the card, and drives the port's paths once each through the
entry points a user calls:

  phases 2-5  `node2vec --sharedNegatives 128` through the CLI on a
              BlogCatalog-shaped graph (10,000 vertices, 334,000 sampled
              edges; the node2vec paper's BlogCatalog has 10,312 vertices
              and 333,983 edges) with walkLength 80, numWalks 10, dim 128:
              the conv trainer's epoch with its launches a block (the
              trainer's draws, the conv step's accumulate and scatter
              kernels, sgns_shared_grads, the apply kernel); then the
              karate quality gate, `--sharedNegatives 128 --dim 768` on
              karate through the CLI and the same gate, and the labeled
              synthetic graph (1,500 vertices, 6 communities) held to
              micro-F1 > 0.55 with kB = 64;
  phases 6-7  the resident-row walks (`resident_walks`): kernel against
              plain version bit for bit with rows in shared memory and in
              device memory, then 16-regular graphs of 4,096 and 1,024
              vertices at numWalks 10 and of 1,024 vertices at numWalks 80,
              walkLength 80, beside the general walk kernel on the same
              graphs;
  phase 8     `--cmd embedding` through the CLI on phase 4's walks;
  phases 9-10 the exact-CDF walks: kernel against plain version bit for bit
              at the edges (a hub row of 50,000 entries among them), then
              `--cmd randomwalk --p 0.0625 --q 4` through the CLI on phase
              4's graph (a bias ratio of 64: the chunked exact CDF), with
              walk-round checkpoints cut and resumed;
  phases 11-12 the exact-negative SGNS step: its two kernels against the
              plain step in float64 on blocks of the main shape (D = 128,
              100 and 768; Zipf, uniform and one-token blocks), with the
              tables' hit rate and flushes, then `node2vec` through the CLI
              with the default trainer (no --sharedNegatives), the karate
              gate with exact negatives, and a `--dim 768` karate run
              through the CLI held to the same gate;
  phase 13    the trainer's draws kernel bit for bit against
              trainer_draws_ref: exact and shared shapes, ragged chunks,
              window 1 and 10, a one-row vocabulary, more blocks than a
              grid's y extent; timed on the main path's chunks;
  phase 14    the conv step's kernels (accumulate, sgns_shared_grads,
              scatter, apply) against the plain step in float32 (rtol 1e-5
              atol 1e-6) and in float64 at D = 64, 128 and 768 (and ragged
              and sliced shapes) on Zipf, one-token and padded blocks;
              each kernel timed at the main shape.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Every failure raises and the script exits non-zero. It
needs a CUDA device and the repository around it; it imports nothing of JAX
and nothing of the JAX package. The last line is {"ok": true, "device":
{...}}; the line before it lists each kernel with its launches, its error
against its plain version, its times and its bound.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# (P, D, kB): the main path's shape; ragged D and kB; wn in two chunks;
# several tiles a block; the widest D; five chunks at the third width
SGNS_SHAPES = [(2624, 128, 128), (300, 50, 37), (7, 128, 256),
               (20000, 128, 128), (1000, 512, 64), (100, 200, 300),
               # above D = 512, in column slices: the conv step at D 768, a
               # ragged odd D, three slices
               (2624, 768, 128), (257, 1025, 70), (40, 1536, 256)]
# every trial mode of csrc/walk.cu: general, p == q == 1, q == 1
WALK_PQ = [(0.25, 0.25), (1.0, 1.0), (1.0, 4.0), (4.0, 0.25), (0.5, 1.0)]
# phase 7's 16-regular graphs: (vertices, numWalks). Rows in device memory;
# rows in shared memory with fewer warps than the card has schedulers; rows
# in shared memory with five warps a scheduler
RESIDENT_SHAPES = [(4096, 10), (1024, 10), (1024, 80)]
# published H100 SXM peaks: device memory rate, and f32 outside the tensor
# cores (an FMA counts as two operations)
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the walk kernels' integer work is counted in draws. One draw is one
# threefry-2x32 block (20 rounds of add, rotate, xor; 5 key injections of 3
# adds; 4 operations to open it) and 4 operations to make the float. The
# card's int32 rate is not published; the f32 lanes' instruction rate,
# F32_FLOPS / 2, is at least that, so the bound stays a lower bound.
OPS_PER_DRAW = 20 * 3 + 5 * 3 + 4 + 4
INT_OPS_PER_S = F32_FLOPS / 2
MAIN_FLAGS = ["--cmd", "node2vec", "--walkLength", "80", "--numWalks", "10",
              "--p", "0.25", "--q", "0.25", "--dim", "128", "--window", "10",
              "--negatives", "5", "--sharedNegatives", "128", "--iter", "1",
              "--validate", "true"]
# phase 12: the CLI's default trainer, exact negatives
EXACT_FLAGS = (MAIN_FLAGS[:MAIN_FLAGS.index("--sharedNegatives")]
               + MAIN_FLAGS[MAIN_FLAGS.index("--sharedNegatives") + 2:])
# phase 12's karate run above the old 512 limit of the exact kernel: the
# gate's trainer settings (dim aside) and walks
DIM768_FLAGS = ["--dim", "768", "--window", "5", "--negatives", "5", "--lr",
                "0.2", "--iter", "20", "--walkLength", "20", "--numWalks",
                "10", "--seed", "2"]
# phase 10: a bias ratio of 64 sends plan_sampler to the exact CDF
CDF_FLAGS = ["--cmd", "randomwalk", "--walkLength", "80", "--numWalks", "10",
             "--p", "0.0625", "--q", "4", "--validate", "true"]
# a row entry of the CDF scan: the hash multiply, mask and base add, four
# compares and their or, the select of f, the product and the sum
OPS_PER_ENTRY = 12
EMBED_FLAGS = ["--cmd", "embedding", "--dim", "128", "--window", "10",
               "--negatives", "5", "--sharedNegatives", "128", "--iter", "1"]
# phase 5's karate run of shared negatives above the old 512 limit
SHARED768_FLAGS = DIM768_FLAGS + ["--sharedNegatives", "128"]
# phase 13: (B, T, window, k or None, kB or None, V, c0, n). The main
# path's exact chunk and a ragged conv chunk; window 1 at the epoch's end;
# one-row vocabularies; more blocks than a grid's y extent (65,535)
DRAW_CASES = [(32, 82, 10, 5, None, 10_000, 0, 15),
              (32, 82, 10, None, 128, 10_000, 1524, 77),
              (32, 82, 1, 5, None, 10_000, 3120, 5),
              (4, 23, 10, 5, None, 1, 0, 3),
              (6, 23, 5, None, 64, 1, 7, 2),
              (1, 5, 2, None, 3, 50, 11, 70_000)]
# phase 14: (V, B, T, window, kB, D, tokens). The main shape; D 64 and 768;
# one token alone; walks padded with -1; small ragged blocks, one whose D
# takes row slices in both kernels
CONV_SHAPES = [(10_000, 32, 82, 10, 128, 128, "zipf"),
               (10_000, 32, 82, 10, 128, 64, "zipf"),
               (10_000, 32, 82, 10, 128, 768, "zipf"),
               (10_000, 32, 82, 10, 128, 128, "hub"),
               (10_000, 32, 81, 10, 128, 128, "padded"),
               (10_000, 32, 82, 10, 128, 768, "padded"),
               (300, 7, 30, 3, 37, 100, "zipf"),
               (50, 3, 11, 5, 16, 1536, "hub")]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def synth_power_law_arcs(num_vertices: int, num_edges: int, seed: int = 0):
    """Arcs of bench.synth_power_law_graph (Zipf-weighted endpoints,
    self-loops dropped), before symmetrization."""
    rng = np.random.default_rng(seed)
    draw = lambda: np.minimum(
        (num_vertices * rng.random(num_edges) ** (1 / 0.3)).astype(np.int64),
        num_vertices - 1)
    src = draw()
    dst = draw()
    keep = src != dst
    return src[keep], dst[keep]


def synth_power_law_graph(num_vertices: int, num_edges: int, seed: int = 0):
    from stellar_rw_tpu_torch.graph.csr import from_edge_arrays

    src, dst = synth_power_law_arcs(num_vertices, num_edges, seed)
    return from_edge_arrays(src, dst, num_vertices=num_vertices,
                            symmetrize=True)


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their peak rate."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def star_graph(leaves: int):
    """Vertex 0 joined to each of `leaves` leaves: one row of `leaves`
    entries, weights 0.25 to 4.25."""
    from stellar_rw_tpu_torch.graph.csr import from_edge_arrays

    rng = np.random.default_rng(leaves)
    dst = np.arange(1, leaves + 1)
    return from_edge_arrays(np.zeros(leaves, np.int64), dst,
                            rng.random(leaves).astype(np.float32) * 4 + 0.25,
                            num_vertices=leaves + 1, symmetrize=True)


def regular_graph(num_vertices: int, degree: int, seed: int,
                  weighted: bool = False):
    """A `degree`-regular multigraph: the union of degree/2 random
    Hamiltonian cycles (no self-loops; a repeated edge stays a multi-edge)."""
    from stellar_rw_tpu_torch.graph.csr import from_edge_arrays

    rng = np.random.default_rng(seed)
    orders = [rng.permutation(num_vertices) for _ in range(degree // 2)]
    src = np.concatenate(orders)
    dst = np.concatenate([np.roll(o, -1) for o in orders])
    weights = (rng.random(len(src)).astype(np.float32) * 4 + 0.25
               if weighted else None)
    return from_edge_arrays(src, dst, weights, num_vertices=num_vertices,
                            symmetrize=True)


_BUSY = []


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms by CUDA events, after one warm-up.

    A wrapper's host side (Python, ctypes) can take longer than a short
    kernel, and events on an idle stream would then time the host. So a
    product of some 20 ms is queued first: the launches pile up behind it
    and run back to back between the two events."""
    import torch

    if not _BUSY:
        _BUSY.append(torch.ones((8192, 8192), device="cuda"))
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.mm(_BUSY[0], _BUSY[0])
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cuda_ms_split(fns, iters: int) -> list[float]:
    """Mean device time in ms of each of fns, called in turn `iters` times
    behind the long product of cuda_ms, with CUDA events between them: the
    time of each launch in a sequence whose launches depend on each
    other."""
    import torch

    if not _BUSY:
        _BUSY.append(torch.ones((8192, 8192), device="cuda"))
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
          for _ in range(iters)]
    torch.mm(_BUSY[0], _BUSY[0])
    for e in ev:
        e[0].record()
        for fn, after in zip(fns, e[1:]):
            fn()
            after.record()
    torch.cuda.synchronize()
    return [sum(e[i].elapsed_time(e[i + 1]) for e in ev) / iters
            for i in range(len(fns))]


def cuda_ms_once(fn):
    """(fn(), its device time in ms) for one call without a warm-up: for the
    plain versions, which take seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def phase_env(torch, kernels) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from stellar_rw_tpu_torch.ops._build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stellar_rw_tpu_torch import native

    t0 = time.perf_counter()
    sources = {k.source: k for k in kernels}.values()  # one nvcc a source
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda k: k.fn(), sources))
    for k in kernels:                       # the rest bind the built library
        k.fn()
    wall = time.perf_counter() - t0
    builds = {k.source: round(k.build_seconds, 2) for k in sources}
    print(f"phase 1 env: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc} | sm_90a build seconds {builds}, "
          f"{wall:.2f} s together | host table builder: "
          f"{'C++ (native/graph_builder.cpp)' if native.available() else 'NumPy (no host compiler)'}")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {k.source}: {line.strip()}")
    return smi


def key_table(torch, seed, round_offset, R, L, T):
    """The trial-key table by the kernel, checked bitwise equal to the
    plain version's."""
    from stellar_rw_tpu_torch.ops import prng, walk_step

    key = prng.prng_key(seed)
    keys = walk_step.trial_keys(key, round_offset, R, L, T, device="cuda")
    ref = walk_step.trial_keys_ref(key, round_offset, R, L, T).cuda()
    torch.cuda.synchronize()
    check(keys.dtype == ref.dtype and torch.equal(keys, ref),
          f"key-table kernel differs from trial_keys_ref (seed {seed}, "
          f"offset {round_offset}, shape {(R, L + 1, T)})")
    return keys, int((keys.long() - ref.long()).abs().max())


def phase_walk(torch) -> None:
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.ops import sampling, walk_step

    graphs = {
        "synth2k": synth_power_law_graph(2048, 32768, seed=1),
        "testgraph": gio.load_edge_list(
            os.path.join(ROOT, "tests", "data", "testgraph.txt"),
            weighted=False, directed=True),
    }
    L, R = 20, 3
    n = 0
    for name, g in graphs.items():
        dg = sampling.device_put_graph(g, "cuda")
        starts = torch.arange(g.num_vertices, dtype=torch.int32,
                              device="cuda")
        for p, q in WALK_PQ:
            _, max_rounds = sampling.plan_sampler("rejection", p, q)
            keys, _ = key_table(torch, 7, 1, R, L, 4 * max_rounds)
            want = walk_step.walk_corpus_ref(dg, starts, keys, L, p, q,
                                             g.num_vertices)
            got = walk_step.walk_rounds(dg, starts, keys, L, p, q,
                                        g.num_vertices)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"walk kernel differs from its plain version on {name} "
                  f"at p={p} q={q}")
            n += 1
    print(f"phase 2 walk kernel: bitwise equal to walk_corpus_ref on the "
          f"card in {n} cases (synth 2K power-law + directed testgraph, "
          f"(p, q) in {WALK_PQ}); key-table kernel bitwise equal to "
          f"trial_keys_ref in each")


def phase_sgns(torch) -> dict:
    from stellar_rw_tpu_torch.ops import sgns

    rng = np.random.default_rng(0)
    err = 0.0
    timing = {}
    for P, D, kB in SGNS_SHAPES:
        t = lambda *s: torch.as_tensor(
            (rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
        vi, vo, wn = t(P, D), t(P, D), t(kB, D)
        valid = torch.as_tensor(rng.random(P) > 0.3).cuda().float()
        g_pos = t(P) * valid
        mask = valid * 0.125
        got = sgns.sgns_shared_grads(vi, vo, wn, g_pos, mask)
        again = sgns.sgns_shared_grads(vi, vo, wn, g_pos, mask)
        want = sgns.sgns_shared_grads_ref(vi, vo, wn, g_pos, mask)
        for a, b in zip(got, want):
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
                  f"sgns_shared_grads differs at {(P, D, kB)}: max abs err "
                  f"{float((a - b).abs().max()):.3g}")
            err = max(err, float((a - b).abs().max()))
        for a, b in zip(got, again):
            check(torch.equal(a, b), f"sgns_shared_grads gave two results "
                  f"for one input at {(P, D, kB)}")
        kern = lambda: sgns.sgns_shared_grads(vi, vo, wn, g_pos, mask)
        plain = lambda: sgns.sgns_shared_grads_ref(vi, vo, wn, g_pos, mask)
        if (P, D, kB) == (2624, 768, 128):     # the conv step at D 768
            runs = [cuda_ms(f, 20) for f in (plain, kern, kern, plain)]
            sliced = {"d768_ms": (runs[1] + runs[2]) / 2,
                      "d768_plain_ms": (runs[0] + runs[3]) / 2}
        if (P, D, kB) == SGNS_SHAPES[0]:
            runs = [cuda_ms(f, 50) for f in (plain, kern, kern, plain)]
            timing = {"ms": (runs[1] + runs[2]) / 2,
                      "plain_ms": (runs[0] + runs[3]) / 2,
                      # three products of 2*P*kB*D flops in f32; each input
                      # read once, each output written once
                      **bound(tensor_bytes(vi, vo, wn, g_pos, mask, *got),
                              3 * 2 * P * kB * D, F32_FLOPS),
                      "library_ms": None}
    print(f"phase 3 sgns_shared_grads: within rtol 1e-5 atol 1e-5 of the "
          f"plain f32 version at {SGNS_SHAPES}, max abs err {err:.3g}, two "
          f"calls bit-identical at each; plan at the main shape "
          f"{sgns.launch_plan(*SGNS_SHAPES[0])._asdict()}; at "
          f"{SGNS_SHAPES[0]} kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms (CUDA events, mean of 2x50), bound "
          f"{timing['bound_ms']:.5f} ms by {timing['bound_by']}; at (2624, "
          f"768, 128), two column slices: kernel {sliced['d768_ms']:.4f} ms, "
          f"plain {sliced['d768_plain_ms']:.4f} ms (mean of 2x20)")
    return {"max_abs_err": err, **timing, **sliced}


def phase_walk_main_shape(torch, graph, keys_kernel) -> tuple[dict, dict]:
    """Kernel vs plain version at the main path's walk shape (all rounds in
    one dispatch), bitwise and timed; the key-table kernel likewise. Returns
    the two kernels' rows."""
    from stellar_rw_tpu_torch.ops import prng, sampling, walk_step

    dg = sampling.device_put_graph(graph, "cuda")
    V = graph.num_vertices
    R, L = 10, 80
    starts = torch.arange(V, dtype=torch.int32, device="cuda")
    _, max_rounds = sampling.plan_sampler("rejection", 0.25, 0.25)
    T = 4 * max_rounds
    keys, keys_err = key_table(torch, 0, 0, R, L, T)
    kern = lambda: walk_step.walk_rounds(dg, starts, keys, L, 0.25, 0.25, V)
    counts = {}
    got = kern()
    want, plain_ms = cuda_ms_once(lambda: walk_step.walk_corpus_ref(
        dg, starts, keys, L, 0.25, 0.25, V, counts=counts))
    check(torch.equal(got, want),
          "walk kernel differs from its plain version at the main shape")
    err = float((got - want).abs().max())
    ms = cuda_ms(kern, 10)
    # draws this corpus needed: 2 for each first-order step; 2 for a trial
    # on the dense draws, 3 (a key fold and 2) for one on per-lane draws,
    # and u_acc where it could decide (f < max_f). Counting u_acc in every
    # trial, as the kernel drew it before, gives `draws_all`.
    first = 2 * int((got[:, 1] >= 0).sum())
    trials = counts["dense_trials"] + counts["lane_trials"]
    draws = (first + 2 * counts["dense_trials"] + 3 * counts["lane_trials"]
             + counts["acc_draws"])
    draws_all = first + 3 * counts["dense_trials"] + 4 * counts["lane_trials"]
    b = bound(tensor_bytes(starts, keys, got, dg.vmeta, dg.alias_packed,
                           dg.hash_buckets),
              draws * OPS_PER_DRAW, INT_OPS_PER_S)
    steps = int((got[:, 2:] >= 0).sum())
    walker = counts["walker_trials"]
    warp_total = walk_step.warp_max(walker)
    print(f"phase 4a walk kernel at the main shape ({V} starts x {R} rounds, "
          f"L={L}, p=q=0.25): bitwise equal; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms (CUDA events, mean of 10; plain one call); "
          f"{draws} draws "
          f"({draws_all} with u_acc in every trial; it could decide in "
          f"{counts['acc_draws']} of {trials} trials), bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
    print(f"  trials: {trials / max(steps, 1):.4f} a second-order step "
          f"({trials} for {steps}); a walker's total "
          f"{float(walker.float().mean()):.1f} mean, {int(walker.max())} "
          f"max; a warp's slowest lane's total "
          f"{float(warp_total.float().mean()):.1f} mean, "
          f"{int(warp_total.max())} max (the flat loop's turns); sum over "
          f"steps of the warp's "
          f"maximum {counts['step_warp_max'] / warp_total.numel():.1f} a warp "
          f"(the nested loop's turns)")
    # the key table: kernel against the plain version's time on the card
    key = prng.prng_key(0)
    kt = lambda: walk_step.trial_keys(key, 0, R, L, T, device="cuda")
    _, kt_plain_ms = cuda_ms_once(
        lambda: walk_step.trial_keys_ref(key.cuda(), 0, R, L, T))
    t0 = time.perf_counter()
    keys_host = walk_step.trial_keys_ref(key, 0, R, L, T).cuda()
    torch.cuda.synchronize()
    kt_host_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(keys_host, keys), "host-built key table differs")
    # threefry blocks the table needs: a round's and a step's key are
    # shared by the keys below them
    blocks = R + R * (L + 1) + R * (L + 1) * T
    kb = bound(tensor_bytes(keys), blocks * OPS_PER_DRAW, INT_OPS_PER_S)
    launches0 = keys_kernel.launches
    kt_ms = cuda_ms(kt, 20)
    check(keys_kernel.launches == launches0 + 21, "key-table launch count")
    print(f"  key table [{R}, {L + 1}, {T}] ({tensor_bytes(keys)} bytes): "
          f"kernel {kt_ms:.4f} ms (CUDA events, mean of 20), plain version "
          f"on the card {kt_plain_ms:.2f} ms (one call), built on the CPU "
          f"and copied {kt_host_ms:.2f} ms of wall (one call), bound "
          f"{kb['bound_ms']:.5f} ms by {kb['bound_by']} ({blocks} threefry "
          f"blocks)")
    walk_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                "library_ms": None,
                "trials_per_step": trials / max(steps, 1),
                "warp_slowest_total_mean": float(warp_total.float().mean()),
                "warp_step_max_sum_mean":
                    counts["step_warp_max"] / warp_total.numel(),
                "draws": draws, "draws_with_u_acc_always": draws_all}
    keys_row = {"max_abs_err": keys_err, "ms": kt_ms, "plain_ms": kt_plain_ms,
                **kb, "library_ms": None, "host_built_ms": kt_host_ms}
    return walk_row, keys_row


def trainer_kernels() -> dict:
    """The kernels a trainer epoch launches, by name."""
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL
    from stellar_rw_tpu_torch.ops.sgns_conv import (SGNS_CONV_ACCUMULATE,
                                                    SGNS_CONV_SCATTER)
    from stellar_rw_tpu_torch.ops.sgns_exact import (SGNS_EXACT_APPLY,
                                                     SGNS_EXACT_GRADS)
    from stellar_rw_tpu_torch.ops.trainer_draws import TRAINER_DRAWS_KERNEL

    return {"trainer_draws": TRAINER_DRAWS_KERNEL,
            "sgns_conv_accumulate": SGNS_CONV_ACCUMULATE,
            "sgns_shared_grads": SGNS_KERNEL,
            "sgns_conv_scatter": SGNS_CONV_SCATTER,
            "sgns_exact_grads": SGNS_EXACT_GRADS,
            "sgns_exact_apply": SGNS_EXACT_APPLY}


def trainer_launches(report: dict) -> tuple[dict, int, float]:
    """Each trainer kernel's launches since the counts were set to 0, the
    epoch's blocks and the launches a block."""
    counts = {name: k.launches for name, k in trainer_kernels().items()}
    blocks = -(-report["paths"] // 32)
    return counts, blocks, sum(counts.values()) / blocks


def phase_main(torch, walk_kernel, keys_kernel, smi, tmp) -> dict:
    """The node2vec path through the CLI. Returns the kernels' launch counts
    in this run and the output directory."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.models import node2vec as n2v

    src, dst = synth_power_law_arcs(10_000, 334_000, seed=0)
    edges = os.path.join(tmp, "blogcatalog_shaped.txt")
    np.savetxt(edges, np.stack([src, dst], 1), fmt="%d")
    out = os.path.join(tmp, "out")
    report = {}
    walk_kernel.launches = 0
    keys_kernel.launches = 0
    for k in trainer_kernels().values():
        k.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["--input", edges, "--output", out] + MAIN_FLAGS,
                  report=report)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc}")
    check(walk_kernel.launches > 0, "the walk kernel was not launched")
    check(keys_kernel.launches > 0, "the key-table kernel was not launched")
    trainer, blocks, per_block = trainer_launches(report)
    for name in ("trainer_draws", "sgns_conv_accumulate",
                 "sgns_shared_grads", "sgns_conv_scatter",
                 "sgns_exact_apply"):
        check(trainer[name] > 0, f"{name} was not launched by the conv "
              f"trainer: {trainer}")
    check(trainer["sgns_exact_grads"] == 0,
          f"the exact step ran in the conv trainer: {trainer}")
    check(per_block <= 8, f"{per_block:.2f} launches a block: {trainer}")
    for sub in ("path/part-00000", "vec/part-00000", "bin/model.npz"):
        check(os.path.exists(os.path.join(out, sub)), f"missing /{sub}")
    check(not any(report["invariants"].values()),
          f"walk invariants {report['invariants']}")
    tokens, w_in, w_out = n2v.load_model(out)
    check(w_in.shape == (report["vertices"], 128)
          and np.isfinite(w_in).all() and np.isfinite(w_out).all(),
          "embeddings not finite or of the wrong shape")
    print(f"phase 4 main path: {report['vertices']} V, {report['edges']} "
          f"arcs, {report['paths']} walks, {report['steps']} steps; walk "
          f"{report['walk_seconds']:.3f} s = "
          f"{report['steps'] / report['walk_seconds']:,.0f} steps/s; "
          f"trainer epoch (conv, kB 128) {report['train_seconds']:.3f} s = "
          f"{report['train_seconds'] / blocks * 1e3:.4f} ms a block over "
          f"{blocks} blocks; CLI wall {wall:.1f} s; launches "
          f"walk={walk_kernel.launches} trial_keys={keys_kernel.launches} "
          f"{trainer} = {per_block:.4f} kernel calls a block (<= 8; "
          f"sgns_shared_grads is two kernels); invariants "
          f"{report['invariants']} [{smi}]")
    return {"walk": walk_kernel.launches,
            "trial_keys": keys_kernel.launches, **trainer,
            "train_seconds": report["train_seconds"], "blocks": blocks,
            "launches_a_block": per_block, "out": out, "edges": edges}


def karate_gate(w_in, g) -> tuple[float, float]:
    """Karate link-prediction AUC and faction accuracy of embeddings."""
    from stellar_rw_tpu_torch.models import eval as ev

    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    return (ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices,
                                   seed=0),
            ev.node_classification_accuracy(w_in, ev.karate_labels(g.ids),
                                            seed=0))


def phase_quality(torch, tmp) -> dict:
    """Phase 5: the karate gate with shared negatives; `--sharedNegatives
    128 --dim 768` on karate through the CLI (the shared-negative kernel in
    column slices) and the same gate; the labeled synthetic graph's micro-F1
    gate (the JAX package's tests/test_datasets.py::
    test_quality_pipeline_small, on the card)."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import datasets
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import eval as ev
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL, launch_plan
    from stellar_rw_tpu_torch.walk import engine

    g = gio.load_edge_list(os.path.join(ROOT, "tests", "data", "karate.txt"),
                           weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2,
                                as_numpy=False, device="cuda")
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                         seed=1, shared_negatives=32)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg, device="cuda")
    auc, acc = karate_gate(w_in, g)
    check(auc > 0.7 and acc >= 0.85, f"karate gate: auc {auc} acc {acc}")
    # shared negatives at --dim 768 through the CLI
    out = os.path.join(tmp, "out_shared768")
    SGNS_KERNEL.launches = 0
    check(cli.main(["--cmd", "node2vec", "--input", os.path.join(
        ROOT, "tests", "data", "karate.txt"), "--output", out]
        + SHARED768_FLAGS) == 0, "--sharedNegatives 128 --dim 768 failed")
    launches768 = SGNS_KERNEL.launches
    check(launches768 > 0, "sgns_shared_grads was not launched at D 768")
    _, w768, _ = n2v.load_model(out)
    check(w768.shape == (g.num_vertices, 768) and np.isfinite(w768).all(),
          "--dim 768 shared-negative embeddings not finite or misshapen")
    auc768, acc768 = karate_gate(w768, g)
    check(auc768 > 0.7 and acc768 >= 0.85,
          f"karate gate at --sharedNegatives 128 --dim 768: auc {auc768} "
          f"acc {acc768}")
    # the labeled synthetic graph, kB 64
    sg, labels = datasets.synth_labeled_graph(1500, 15_000, communities=6,
                                              seed=7)
    swalks = engine.random_walks(sg, walk_length=20, num_walks=3, p=0.25,
                                 q=0.25, seed=1, as_numpy=False,
                                 device="cuda")
    scfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.1, iters=3,
                          seed=1, shared_negatives=64)
    s_in, _ = w2v.train_skipgram(swalks, sg.num_vertices, scfg,
                                 device="cuda")
    f1 = ev.multilabel_micro_f1(s_in, labels, train_frac=0.5, seed=0)
    check(f1 > 0.55, f"labeled synthetic gate: micro-F1 {f1}")
    print(f"phase 5 quality on the card: karate (kB 32) link AUC {auc:.4f} "
          f"(> 0.7), faction accuracy {acc:.4f} (>= 0.85); "
          f"--sharedNegatives 128 --dim 768 through the CLI "
          f"({launches768} sgns_shared_grads launches, plan "
          f"{launch_plan(32 * 21, 768, 128)._asdict()} at a full block): "
          f"AUC {auc768:.4f}, faction accuracy {acc768:.4f}; labeled "
          f"synthetic (1,500 V, 15,000 edges, 6 communities, kB 64, 3 "
          f"epochs) micro-F1 {f1:.4f} (> 0.55)")
    return {"auc768": auc768, "acc768": acc768, "micro_f1": f1}


def phase_resident_check(torch) -> int:
    """Phase 6: the resident-row kernel against its plain version, bit for
    bit, on the card: seeded draws and external uniforms, rows in shared
    memory and rows in device memory."""
    from stellar_rw_tpu_torch.graph import csr
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.ops import resident_walk as rw
    from stellar_rw_tpu_torch.ops import sampling
    from stellar_rw_tpu_torch.walk import engine

    graphs = {
        "karate": gio.load_edge_list(
            os.path.join(ROOT, "tests", "data", "karate.txt"),
            weighted=False, directed=False),
        # the two small graphs of tests/test_pallas.py
        "weighted5": csr.from_adjacency(
            {0: [(1, 1.0)], 1: [(0, 1.0), (2, 2.0), (3, 1.0), (4, 0.5)],
             2: [(1, 1.0), (0, 1.0)], 3: [(1, 1.0)], 4: [(1, 1.0)]}),
        "chain": csr.from_adjacency({0: [(1, 1.0)], 1: [(2, 1.0)], 2: []}),
        "regular2k": regular_graph(2048, 10, seed=2, weighted=True),
    }
    L, T, rounds = 20, 8, 3
    n = 0
    placed = {"shared": 0, "global": 0}
    rng = np.random.default_rng(5)
    for name, g in graphs.items():
        md, V = max(g.max_degree, 1), g.num_vertices
        tab = torch.as_tensor(rw.build_row_tables(g, md)).cuda()
        dg = sampling.device_put_graph(g, "cuda")
        W = rounds * V
        W_pad = -(-max(W, 256) // 256) * 256
        ext = torch.as_tensor(rng.random(rw.uniforms_shape(L, T, W_pad),
                                         dtype=np.float32)).cuda()
        fits = rw.row_placement(tab) == "shared"
        for p, q in WALK_PQ:
            for uniforms in (None, ext):
                want = rw.walk_corpus_resident_ref(tab, 7, V, W, L, p, q, md,
                                                   W_pad, T, uniforms)
                for rows in (("shared", "global") if fits else ("global",)):
                    got = rw.walk_corpus_resident(tab, 7, V, W, L, p, q, md,
                                                  W_pad, T, uniforms, rows)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"resident walk kernel differs from its plain "
                          f"version on {name} at p={p} q={q}, rows in {rows} "
                          f"memory, "
                          f"{'seeded' if uniforms is None else 'external'} "
                          f"draws")
                    bad = engine.corpus_invariants(dg, got[:W]).tolist()
                    check(bad == [0, 0, 0] and bool((got[W:] == -1).all()),
                          f"resident walk invariants {bad} on {name}")
                    placed[rows] += 1
                    n += 1
    check(placed["shared"] > 0 and placed["global"] > 0,
          f"row placements checked: {placed}")
    # what the launch plan and the kernel's paths can get wrong: walkers that
    # do not fill a block or fill one tile, walks of length 0, 1 and odd
    # (single-column stores), one trial a step, a bias that sends most steps
    # down the cold path, and more walkers than one launch has threads
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edge = [  # graph, W_real, W_pad, L, T, (p, q)
        ("karate", 200, 256, L, T, (0.25, 0.25)),
        ("regular2k", 2048 * 3 - 77, 2048 * 3, 5, T, (0.25, 0.25)),
        ("karate", 102, 256, 0, T, (0.25, 0.25)),
        ("karate", 102, 256, 1, T, (0.5, 2.0)),
        ("regular2k", 4000, 4096, 7, T, (4.0, 0.25)),
        ("karate", 102, 256, L, 1, (0.25, 4.0)),
        ("regular2k", 4096, 4096, L, 1, (4.0, 0.25)),
        ("karate", 500, 512, L, T, (0.25, 4.0)),
        ("regular2k", 6144, 6144, L, T, (0.25, 4.0)),
        ("weighted5", 1024 * sms + 300, 1024 * sms + 512, 3, T, (0.25, 4.0)),
    ]
    m = 0
    for name, W, W_pad, L_e, T_e, (p, q) in edge:
        g = graphs[name]
        md, V = max(g.max_degree, 1), g.num_vertices
        tab = torch.as_tensor(rw.build_row_tables(g, md)).cuda()
        ext = torch.as_tensor(rng.random(rw.uniforms_shape(L_e, T_e, W_pad),
                                         dtype=np.float32)).cuda()
        fits = rw.row_placement(tab) == "shared"
        for uniforms in (None, ext):
            want = rw.walk_corpus_resident_ref(tab, 7, V, W, L_e, p, q, md,
                                               W_pad, T_e, uniforms)
            for rows in (("shared", "global") if fits else ("global",)):
                got = rw.walk_corpus_resident(tab, 7, V, W, L_e, p, q, md,
                                              W_pad, T_e, uniforms, rows)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"resident walk kernel differs from its plain version "
                      f"on {name}: W_real={W} W_pad={W_pad} L={L_e} "
                      f"max_trials={T_e} p={p} q={q}, rows in {rows} memory, "
                      f"plan {tuple(rw.launch_plan(W_pad, rows, sms))}")
                m += 1
    check(rw.launch_plan(edge[-1][2], "shared", sms).walkers_a_thread == 2,
          "no case with more walkers than threads")
    print(f"phase 6 resident walk kernel: bitwise equal to "
          f"walk_corpus_resident_ref on the card in {n} cases ({placed}; "
          f"{list(graphs)}, (p, q) in {WALK_PQ}, seeded and external "
          f"draws, L={L}, max_trials={T}), walk invariants zero on each; "
          f"and in {m} cases at the edges (W_real short of a block, one "
          f"tile, L in (0, 1, 5, 7), max_trials 1, (p, q) = (0.25, 4) where "
          f"most steps take the cold path, {edge[-1][2]} walkers for "
          f"{sms} SMs x 1024 threads)")
    return n + m


def phase_resident_main(torch, kernel, smi) -> dict:
    """Phase 7: resident_walks at full width on the 16-regular graphs of
    RESIDENT_SHAPES: walkLength 80, p = q = 0.25, max_trials 8. Then, on
    each, the kernel against its plain version, its time, and the general
    walk kernel's time on the same graph and walk lengths."""
    from stellar_rw_tpu_torch.ops import prng, sampling, walk_step
    from stellar_rw_tpu_torch.ops import resident_walk as rw
    from stellar_rw_tpu_torch.walk import engine

    L, T, p, q, seed = 80, 8, 0.25, 0.25, 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    graphs = {V: regular_graph(V, 16, seed=V) for V, _ in RESIDENT_SHAPES}
    # the path, through its entry point, counted
    kernel.launches = 0
    corpora = [rw.resident_walks(graphs[V], L, R, p, q, seed=seed,
                                 max_trials=T, as_numpy=False)
               for V, R in RESIDENT_SHAPES]
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == len(RESIDENT_SHAPES),
          f"resident_walks launched {launches} kernels in "
          f"{len(RESIDENT_SHAPES)} calls")

    shapes = []
    for (V, R), got in zip(RESIDENT_SHAPES, corpora):
        g = graphs[V]
        md, W = g.max_degree, R * V
        check(md == 16, f"regular graph has max degree {md}")
        tab = torch.as_tensor(rw.build_row_tables(g, md)).cuda()
        W_pad = -(-W // 256) * 256
        place = rw.row_placement(tab)
        check(place == ("global" if V == 4096 else "shared"),
              f"rows of the V={V} table read from {place} memory")
        plan = rw.launch_plan(W_pad, place, sms)
        dg = sampling.device_put_graph(g, "cuda")
        counts = {}
        want, plain_ms = cuda_ms_once(lambda: rw.walk_corpus_resident_ref(
            tab, seed, V, W, L, p, q, md, W_pad, T, counts=counts))
        check(got.shape == (W, L + 2) and torch.equal(got, want[:W]),
              f"resident_walks differs from the plain version at V={V}, "
              f"{W} walkers")
        bad = engine.corpus_invariants(dg, got).tolist()
        check(bad == [0, 0, 0], f"resident_walks invariants {bad} at V={V}")
        kern = lambda: rw.walk_corpus_resident(tab, seed, V, W, L, p, q, md,
                                               W_pad, T)
        # the general walk kernel on the same graph, starts and lengths
        starts = torch.arange(V, dtype=torch.int32, device="cuda")
        _, max_rounds = sampling.plan_sampler("rejection", p, q)
        keys = walk_step.trial_keys(prng.prng_key(seed), 0, R, L,
                                    4 * max_rounds, device="cuda")
        general = lambda: walk_step.walk_rounds(dg, starts, keys, L, p, q, V)
        check(engine.corpus_invariants(dg, general()).tolist() == [0, 0, 0],
              f"general walk invariants at V={V}")
        runs = [cuda_ms(f, 20) for f in (general, kern, kern, general)]
        # draws this corpus needed: 2 for each first-order step, 2 a trial,
        # and u_acc where it could decide (f < max_f before the last trial).
        # Counting u_acc in every trial, as the kernel drew it before, gives
        # `draws_all`.
        first = 2 * int((got[:, 1] >= 0).sum())
        draws = first + 2 * counts["trials"] + counts["acc_draws"]
        draws_all = first + 3 * counts["trials"]
        b = bound(tensor_bytes(tab) + W_pad * (L + 2) * 4,
                  draws * OPS_PER_DRAW, INT_OPS_PER_S)
        walker = counts["walker_trials"]
        warps = -(-W_pad // 32)
        shapes.append({
            "vertices": V, "walkers": W, "steps": counts["steps"],
            "trials": counts["trials"], "acc_draws": counts["acc_draws"],
            "draws": draws, "draws_with_u_acc_always": draws_all,
            "rows": place, "plan": tuple(plan),
            "table_bytes": tensor_bytes(tab),
            "max_abs_err": int((got - want[:W]).abs().max()),
            "ms": (runs[1] + runs[2]) / 2, "plain_ms": plain_ms,
            "general_walk_ms": (runs[0] + runs[3]) / 2, **b,
            "warp_slowest_total_mean": float(
                walk_step.warp_max(walker).float().mean()),
            "warp_step_max_sum_mean": counts["step_warp_max"] / warps,
            "warp_cold_steps_mean": counts["warp_cold_steps"] / warps})
        sh = shapes[-1]
        print(f"phase 7 resident_walks, 16-regular V={V}: {W} walkers, "
              f"{sh['steps']} steps, {sh['trials']} trials, rows in "
              f"{place} memory ({sh['table_bytes']} table bytes), "
              f"{plan.blocks} blocks x {plan.threads} threads; bitwise "
              f"equal to the plain version, invariants zero; kernel "
              f"{sh['ms']:.4f} ms = {sh['steps'] / sh['ms'] / 1e6:.2f} G "
              f"steps/s, plain {plain_ms:.1f} ms, general walk kernel "
              f"{sh['general_walk_ms']:.4f} ms; {draws} draws needed "
              f"({draws_all} with u_acc in every trial; it could decide in "
              f"{sh['acc_draws']} trials), bound {sh['bound_ms']:.5f} ms by "
              f"{sh['bound_by']} (CUDA events, mean of 2x20; plain one "
              f"call) [{smi}]")
        print(f"  trials: {sh['trials'] / max(sh['steps'], 1):.4f} a step; "
              f"a warp's slowest lane's total "
              f"{sh['warp_slowest_total_mean']:.1f} (a flat loop's turns), "
              f"sum over steps of the warp's maximum "
              f"{sh['warp_step_max_sum_mean']:.1f} (the nested loop's "
              f"turns), steps with a lane on the cold path "
              f"{sh['warp_cold_steps_mean']:.1f} of {L} a warp")
    main_shape = shapes[0]
    keep = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"launches": launches, **{k: main_shape[k] for k in keep},
            "library_ms": None, "rows": main_shape["rows"], "shapes": shapes}


def phase_embedding(torch, sgns_kernel, walks_dir: str, out: str) -> None:
    """Phase 8: `--cmd embedding` through the CLI on phase 4's walks."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.models import node2vec as n2v

    report = {}
    sgns_kernel.launches = 0
    rc = cli.main(["--input", walks_dir, "--output", out] + EMBED_FLAGS,
                  report=report)
    check(rc == 0, f"cli.main returned {rc}")
    check(sgns_kernel.launches > 0, "sgns_shared_grads was not launched")
    for sub in ("vec/part-00000", "bin/model.npz"):
        check(os.path.exists(os.path.join(out, sub)), f"missing /{sub}")
    tokens, w_in, w_out = n2v.load_model(out)
    check(report["paths"] == 100_000 and w_in.shape == (len(tokens), 128)
          and len(tokens) == 10_000 and np.isfinite(w_in).all()
          and np.isfinite(w_out).all(),
          "embedding outputs not finite or of the wrong shape")
    print(f"phase 8 --cmd embedding: {report['paths']} walks, "
          f"{report['tokens']} tokens read back, vocabulary {len(tokens)}; "
          f"trainer epoch {report['train_seconds']:.2f} s; launches "
          f"sgns={sgns_kernel.launches}")


def cdf_graphs():
    """Phase 9's graphs: small ones with the edges of the walk semantics and
    two whose rows exceed a warp."""
    from stellar_rw_tpu_torch.graph import csr
    from stellar_rw_tpu_torch.graph import io as gio

    data = os.path.join(ROOT, "tests", "data")
    return {
        "karate": gio.load_edge_list(os.path.join(data, "karate.txt"),
                                     weighted=False, directed=False),
        # directed, with a dead end and an isolated start
        "testgraph": gio.load_edge_list(os.path.join(data, "testgraph.txt"),
                                        weighted=False, directed=True),
        # a self-loop and a multi self-edge (tests/test_engine.py:93)
        "multi": csr.from_adjacency({0: [(0, 1.0), (1, 1.0)],
                                     1: [(0, 1.0), (1, 1.0), (1, 1.0)]}),
        "weighted5": csr.from_adjacency(
            {0: [(1, 1.0)], 1: [(0, 1.0), (2, 2.0), (3, 1.0), (4, 0.5)],
             2: [(1, 1.0), (0, 1.0)], 3: [(1, 1.0)], 4: [(1, 1.0)]}),
        "regular2k_weighted": regular_graph(2048, 10, seed=2, weighted=True),
        "synth2k": synth_power_law_graph(2048, 32768, seed=1),
        # a hub row of 50,000 entries (1,563 pieces of 32), beyond the
        # walk_10k graph's largest (39,303)
        "star50k": star_graph(50_000),
    }


def phase_cdf_check(torch) -> int:
    """Phase 9: the CDF walk kernel against its plain version, bit for bit,
    on the card. Both sum in one order, so every input is held bitwise:
    unit, dyadic and arbitrary weights alike."""
    from stellar_rw_tpu_torch.ops import cdf_walk, prng, sampling

    graphs = cdf_graphs()
    pqs = [(0.25, 4.0), (4.0, 0.25), (1.0, 1.0), (0.0625, 4.0), (0.5, 2.0)]
    n = 0
    key = prng.prng_key(11)

    def held(name, g, starts, R, L, p, q, chunk, dtype, ro=0):
        dg = sampling.device_put_graph(g, "cuda", cdf=True)
        st = torch.as_tensor(starts, dtype=torch.int32, device="cuda")
        md = max(g.max_degree, 1)
        got = cdf_walk.cdf_walk_rounds(dg, st, key, ro, R, L, p, q, md,
                                       chunk, dtype)
        want = cdf_walk.cdf_walk_ref(dg, st, key, ro, R, L, p, q, md, chunk,
                                     dtype)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"cdf walk kernel differs from its plain version on {name}: "
              f"W={len(starts)} R={R} L={L} p={p} q={q} "
              f"{'chunked' if chunk else 'padded'} {dtype}")
        from stellar_rw_tpu_torch.walk import engine
        bad = engine.corpus_invariants(dg, got).tolist()
        check(bad == [0, 0, 0], f"cdf walk invariants {bad} on {name}")

    i = 0
    for name, g in graphs.items():
        starts = np.arange(g.num_vertices, dtype=np.int32)
        # the plain version's padded form loops over the columns of the
        # widest row (6,011 entries on synth2k, 50,000 on star50k): fewer
        # steps there
        L = {"synth2k": 6, "star50k": 4}.get(name, 20)
        if name == "star50k":   # the hub and some leaves, chunked only
            starts = np.arange(0, g.num_vertices, 997, dtype=np.int32)
        for chunk in (256,) if name == "star50k" else (0, 256):
            for dtype in ("float32", "float64"):
                p, q = pqs[i % len(pqs)]
                i += 1
                held(name, g, starts, 2, L, p, q, chunk, dtype)
                n += 1
    # walk lengths 0, 1 and odd; ragged walker counts (a block holds 8
    # walkers); one walker; a round offset
    rng = np.random.default_rng(3)
    for name, L, W, R, ro in (("karate", 0, 34, 3, 0), ("synth2k", 1, 37, 2, 5),
                              ("synth2k", 7, 1, 1, 0),
                              ("regular2k_weighted", 13, 1001, 3, 2),
                              ("testgraph", 9, 3, 4, 0)):
        g = graphs[name]
        starts = rng.integers(0, g.num_vertices, W).astype(np.int32)
        for chunk in (0, 256):
            for dtype in ("float32", "float64"):
                held(name, g, starts, R, L, 0.0625, 4.0, chunk, dtype, ro)
                n += 1
    print(f"phase 9 cdf walk kernel: bitwise equal to cdf_walk_ref on the "
          f"card in {n} cases ({list(graphs)}; padded and chunked, f32 and "
          f"f64, (p, q) in {pqs}, L in (0, 1, 4, 6, 7, 9, 13, 20), W in (1, 3, "
          f"37, 51, 1001, |V|), round offsets 0-5; star50k's hub row is "
          f"50,000 entries), walk invariants zero on each")
    return n


def phase_cdf_main(torch, kernel, smi, tmp, edges) -> dict:
    """Phase 10: `--cmd randomwalk --p 0.0625 --q 4` through the CLI on
    phase 4's graph (plan_sampler: exact CDF, chunked at this corpus size),
    the first 4,096 walkers of round 0 against the plain version, and a
    run with walk-round checkpoints cut at 4 rounds and resumed."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.ops import cdf_walk, prng, sampling
    from stellar_rw_tpu_torch.utils.config import parse
    from stellar_rw_tpu_torch.walk import engine

    out = os.path.join(tmp, "out_cdf")
    report = {}
    kernel.launches = 0
    rc = cli.main(["--input", edges, "--output", out] + CDF_FLAGS,
                  report=report)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(rc == 0, f"cli.main returned {rc}")
    check(launches > 0, "the cdf walk kernel was not launched")
    check(not any(report["invariants"].values()),
          f"cdf walk invariants {report['invariants']}")
    params = parse(CDF_FLAGS + ["--input", edges, "--output", out])
    graph = gio.load_edge_list(edges, weighted=params.weighted,
                               directed=params.directed)
    V, L, R, p, q = graph.num_vertices, 80, 10, 0.0625, 4.0
    spec = engine.walk_spec(graph, L, R, p, q, "cdf", 16, "float32", V)
    check(spec.cdf_chunk == sampling.CDF_CHUNK,
          f"the CLI's spec is not the chunked form: {spec}")
    dg = sampling.device_put_graph(graph, "cuda", cdf=True)
    corpus = engine.random_walks(graph, L, R, p, q, seed=0, device_graph=dg,
                                 as_numpy=False, device="cuda")
    # entries scanned: deg(cur) of every step taken (cur is the column
    # before a live one)
    deg = dg.vmeta[:, 1].long()
    scanned_in = lambda w: int((deg[w[:, :-1].clamp_min(0).long()]
                                * (w[:, 1:] >= 0)).sum())
    scanned = scanned_in(corpus)
    steps = int((corpus[:, 1:] >= 0).sum())
    check(report["paths"] == corpus.shape[0] and report["steps"] == steps,
          "the CLI's corpus and random_walks' differ in size")
    n_chk = 4096
    starts = torch.arange(n_chk, dtype=torch.int32, device="cuda")
    key = prng.prng_key(0)
    sub = lambda: cdf_walk.cdf_walk_ref(dg, starts, key, 0, 1, L, p, q,
                                        spec.max_degree, spec.cdf_chunk)
    want, plain_ms = cuda_ms_once(sub)
    check(torch.equal(corpus[:n_chk], want),
          "cdf walk kernel differs from its plain version on the first "
          f"{n_chk} walkers of round 0")
    kern = lambda: cdf_walk.cdf_walk_rounds(
        dg, torch.arange(V, dtype=torch.int32, device="cuda"), key, 0, R, L,
        p, q, spec.max_degree, spec.cdf_chunk)
    kern_sub = lambda: cdf_walk.cdf_walk_rounds(
        dg, starts, key, 0, 1, L, p, q, spec.max_degree, spec.cdf_chunk)
    ms = cuda_ms(kern, 3)
    ms_sub = cuda_ms(kern_sub, 3)
    b = bound(tensor_bytes(dg.vmeta, dg.cdf_rows, dg.hash_buckets, corpus),
              scanned * OPS_PER_ENTRY, INT_OPS_PER_S)
    # walk-round checkpoints: 4 rounds, then resumed to 10
    ck = os.path.join(tmp, "out_cdf_ckpt")
    flags = ["--input", edges, "--output", ck] + CDF_FLAGS[:-2] + [
        "--checkpointEvery", "2"]
    numw = flags.index("--numWalks") + 1
    cut = list(flags)
    cut[numw] = "4"
    check(cli.main(cut) == 0, "checkpointed cut run failed")
    check(cli.main(flags + ["--resume", "true"]) == 0,
          "resumed run failed")
    with open(os.path.join(out, "path", "part-00000"), "rb") as a, \
            open(os.path.join(ck, "path", "part-00000"), "rb") as c:
        check(a.read() == c.read(), "the resumed walk-round checkpoint run "
              "differs from the uninterrupted one")
    print(f"phase 10 --cmd randomwalk --p {p} --q {q} (exact CDF, chunked): "
          f"{report['paths']} walks, {report['steps']} steps in "
          f"{report['walk_seconds']:.3f} s = "
          f"{report['steps'] / report['walk_seconds']:,.0f} steps/s; "
          f"launches cdf_walk={launches}; row entries in the rows walked "
          f"(sum of deg(cur) over {steps} steps: each weighed in the total "
          f"pass, and again in the find pass up to the crossing) "
          f"{scanned:,} = "
          f"{scanned / max(steps, 1):.1f} a step; kernel {ms:.2f} ms for the "
          f"corpus (CUDA events, mean of 3) = {scanned / ms / 1e6:.2f} G "
          f"entries/s; on the first {n_chk} "
          f"walkers of round 0 kernel {ms_sub:.2f} ms, plain version "
          f"{plain_ms:.0f} ms (one call), bitwise equal; bound "
          f"{b['bound_ms']:.3f} ms by {b['bound_by']}; --checkpointEvery 2 "
          f"cut at 4 rounds and resumed: /path byte-equal [{smi}]")
    # ms and the bound: the whole corpus; plain_ms: the first 4,096
    # walkers of round 0 (the whole corpus would take the plain version
    # minutes), beside the kernel's time on them
    return {"launches": launches, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": None,
            "plain_scope": f"first {n_chk} walkers of round 0",
            "kernel_ms_same_scope": ms_sub,
            "entries_scanned": scanned, "entries_scanned_same_scope":
                scanned_in(want), "steps": steps,
            "walk_seconds": report["walk_seconds"]}


def exact_block(torch, V=10_000, B=32, T=82, window=10, k=5, D=128, seed=0,
                tokens="zipf"):
    """One block of the main shape: Zipf-distributed tokens (so rows
    collide), uniform ones, or one token alone ("hub": every center and
    target is row 0), -1 padding at the end of a walk, the trainer's window
    and negative draws, random tables."""
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops.alias import build_alias

    rng = np.random.default_rng(seed)
    u = {"zipf": rng.random((B, T)) ** (1 / 0.3), "uniform": rng.random((B, T)),
         "hub": np.zeros((B, T))}[tokens]
    block = np.minimum((V * u).astype(np.int32), V - 1)
    block[-1, T - 7:] = -1
    key = prng.fold_in(prng.prng_key(seed), 3).cuda()
    cwin = prng.randint(key, (B, T), 1, window + 1)
    keep, alias = build_alias(np.bincount(block[block >= 0], minlength=V)
                              ** 0.75 + 1e-12)
    negs = w2v._draw_negatives(
        prng.fold_in(key, 2), (B * T * 2 * window, k),
        torch.as_tensor(keep, dtype=torch.float32).cuda(),
        torch.as_tensor(alias, dtype=torch.int64).cuda()).to(torch.int32)
    w = lambda: torch.as_tensor((rng.standard_normal((V, D)) * 0.3)
                                .astype(np.float32)).cuda()
    return w(), w(), torch.as_tensor(block).cuda(), cwin, negs


def phase_exact_check(torch) -> tuple[dict, dict]:
    """Phase 11: sgns_exact_step's two kernels against the plain step (in
    float64) on blocks of the main shape (Zipf tokens at D = 128, ragged
    D = 100, D = 768 above one register slice, one token alone), and on
    small ragged ones; the kernels' times, the tables' hit rate and flushes
    at the main shape."""
    from stellar_rw_tpu_torch.ops import sgns_exact as se

    lr = 0.025
    err = 0.0
    main = (10_000, 32, 82, 10, 5, 128, "zipf")
    shapes = [main, (10_000, 32, 82, 10, 5, 100, "zipf"),
              (300, 7, 30, 3, 2, 16, "zipf"), (50, 5, 11, 5, 7, 512, "zipf"),
              (10_000, 32, 82, 10, 5, 768, "zipf"),
              (10_000, 32, 82, 10, 5, 128, "hub"),
              (10_000, 32, 82, 10, 5, 128, "uniform")]
    f32_err = 0.0
    for i, (V, B, T, win, k, D, tokens) in enumerate(shapes):
        w_in, w_out, block, cwin, negs = exact_block(torch, V, B, T, win, k,
                                                     D, seed=i, tokens=tokens)
        # the plain step in float64 as the reference: in float32 it adds
        # each pair's share into the row one at a time, and a Zipf block's
        # hub rows take ~10^4 of them, each rounded at the row's magnitude
        a_in, a_out = w_in.double(), w_out.double()
        se.sgns_exact_step_ref(a_in, a_out, block, cwin, negs, lr, win)
        p_in, p_out = w_in.clone(), w_out.clone()
        se.sgns_exact_step_ref(p_in, p_out, block, cwin, negs, lr, win)
        b_in, b_out = w_in.clone(), w_out.clone()
        se.sgns_exact_step(b_in, b_out, block, cwin, negs, lr, win)
        torch.cuda.synchronize()
        for got, want, plain, old in ((b_in, a_in, p_in, w_in),
                                      (b_out, a_out, p_out, w_out)):
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6),
                  f"sgns_exact_step differs from the plain step in float64 "
                  f"at {shapes[i]}: max abs err "
                  f"{float((got.double() - want).abs().max()):.3g}")
            check(bool((got != old).any()), "the step moved nothing")
            err = max(err, float((got.double() - want).abs().max()))
            f32_err = max(f32_err, float((plain.double() - want).abs().max()))
    # the main shape: each kernel timed by events around its own launches
    V, B, T, win, k, D, _ = main
    w_in, w_out, block, cwin, negs = exact_block(torch, V, B, T, win, k, D)
    ws = se.Workspace(w_in, w_out, B * T, win, k)
    plan = se.launch_plan(D, B, T, win, k, torch.cuda.get_device_properties(
        0).multi_processor_count)
    grads = lambda: se.launch_grads(ws, w_in, w_out, block, cwin, negs, win)
    apply = lambda: se.launch_apply(ws, w_in, w_out, lr)
    step = lambda: se.sgns_exact_step(w_in, w_out, block, cwin, negs, lr, win,
                                      ws)
    plain = lambda: se.sgns_exact_step_ref(w_in, w_out, block, cwin, negs,
                                           lr, win)
    iters = 20
    g_ms, a_ms = cuda_ms_split((grads, apply), iters)
    runs = [cuda_ms(f, 5) for f in (plain, step, step, plain)]
    stats = torch.zeros(3, dtype=torch.int32, device="cuda")
    se.launch_grads(ws, w_in, w_out, block, cwin, negs, win, stats=stats)
    apply()
    in_table, in_device, flushed = stats.tolist()
    # what this block needs: its valid pairs and the rows they touch
    from stellar_rw_tpu_torch.ops.sgns_exact import (_pairs_from_valid,
                                                    _valid_from_cwin)
    valid, ctx = _valid_from_cwin(block, cwin, win)
    c, x, v = _pairs_from_valid(block, valid, ctx)
    P = int(v.sum())
    rows_in = int(torch.unique(c[v]).numel())
    rows_out = int(torch.unique(torch.cat(
        [x[v], negs.reshape(-1, k)[v].reshape(-1)])).numel())
    # kernel (a): reads the touched rows of both tables and the block's
    # draws, writes a delta row for each touched row; 2*D flops a logit, a
    # center-gradient and a target-gradient row for each of P*(1+k) targets
    in_bytes = tensor_bytes(block, cwin, negs)
    grads_b = bound(in_bytes + (rows_in + rows_out) * D * 4 * 2,
                    2 * P * (1 + k) * D * 3, F32_FLOPS)
    # kernel (b): each touched row read, its delta read, both written
    apply_b = bound((rows_in + rows_out) * D * 4 * 4,
                    (rows_in + rows_out) * D * 3, F32_FLOPS)
    plain_ms = (runs[0] + runs[3]) / 2
    print(f"phase 11 sgns_exact_step: within rtol 1e-5 atol 1e-6 of the "
          f"plain step computed in float64 at {shapes} (V, B, T, w, k, D, "
          f"tokens), max abs err {err:.3g} (the plain step in float32: "
          f"{f32_err:.3g}); at the main shape (B {B}, T {T}, w {win}, k {k}, "
          f"D {D}, V {V}: {P} valid pairs, {rows_in} + {rows_out} rows "
          f"touched; plan {plan._asdict()}) grads {g_ms:.4f} ms, apply "
          f"{a_ms:.4f} ms (CUDA events around each launch, mean of {iters}), "
          f"both through the wrapper {(runs[1] + runs[2]) / 2:.4f} ms, plain "
          f"step {plain_ms:.3f} ms (mean of 2x5); row adds into the blocks' "
          f"tables {in_table} of {in_table + in_device} "
          f"({in_table / max(in_table + in_device, 1):.4f}), slots flushed "
          f"{flushed} = {flushed / plan.blocks:.1f} a block; scratch "
          f"{ws.nbytes:,} B; bounds {grads_b['bound_ms']:.5f} ms by "
          f"{grads_b['bound_by']} / {apply_b['bound_ms']:.5f} ms by "
          f"{apply_b['bound_by']}")
    common = {"max_abs_err": err, "plain_f32_max_abs_err": f32_err,
              "plain_ms": plain_ms, "library_ms": None,
              "valid_pairs": P, "rows_touched": rows_in + rows_out,
              "step_ms": (runs[1] + runs[2]) / 2}
    return ({"ms": g_ms, **grads_b, **common, "table_adds": in_table,
             "device_adds": in_device, "flushes_a_block":
                 flushed / plan.blocks},
            {"ms": a_ms, **apply_b, **common})


def phase_exact_main(torch, smi, tmp, edges) -> dict:
    """Phase 12: `node2vec` through the CLI with its default trainer (exact
    negatives), one epoch; then the karate gate with exact negatives, and a
    `--dim 768` CLI run on karate held to the same gate."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.walk import engine

    out = os.path.join(tmp, "out_exact")
    report = {}
    for k in trainer_kernels().values():
        k.launches = 0
    rc = cli.main(["--input", edges, "--output", out] + EXACT_FLAGS,
                  report=report)
    torch.cuda.synchronize()
    trainer, blocks, per_block = trainer_launches(report)
    check(rc == 0, f"cli.main returned {rc}")
    for name in ("trainer_draws", "sgns_exact_grads", "sgns_exact_apply"):
        check(trainer[name] > 0, f"{name} was not launched by the exact "
              f"trainer: {trainer}")
    check(trainer["sgns_conv_accumulate"] == 0,
          f"the conv step ran in the exact trainer: {trainer}")
    tokens, w_in, w_out = n2v.load_model(out)
    check(w_in.shape == (report["vertices"], 128)
          and np.isfinite(w_in).all() and np.isfinite(w_out).all(),
          "embeddings not finite or of the wrong shape")
    g = gio.load_edge_list(os.path.join(ROOT, "tests", "data", "karate.txt"),
                           weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2,
                                as_numpy=False, device="cuda")
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                         seed=1)
    kw_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg, device="cuda")
    auc, acc = karate_gate(kw_in, g)
    check(auc > 0.7 and acc >= 0.85,
          f"karate gate with exact negatives: auc {auc} acc {acc}")
    # --dim 768 through the CLI (wider than one register slice of the
    # kernel), exact negatives, and its karate gate
    karate = os.path.join(ROOT, "tests", "data", "karate.txt")
    out768 = os.path.join(tmp, "out_768")
    check(cli.main(["--cmd", "node2vec", "--input", karate, "--output",
                    out768] + DIM768_FLAGS) == 0, "--dim 768 run failed")
    _, w768, _ = n2v.load_model(out768)
    check(w768.shape == (g.num_vertices, 768) and np.isfinite(w768).all(),
          "--dim 768 embeddings not finite or of the wrong shape")
    auc768, acc768 = karate_gate(w768, g)
    check(auc768 > 0.7 and acc768 >= 0.85,
          f"karate gate at --dim 768: auc {auc768} acc {acc768}")
    print(f"phase 12 node2vec with the default trainer (exact negatives): "
          f"{report['paths']} walks, trainer epoch "
          f"{report['train_seconds']:.3f} s = "
          f"{report['train_seconds'] / blocks * 1e3:.4f} ms a block over "
          f"{blocks} blocks; launches {trainer} = {per_block:.4f} kernel "
          f"calls a block (each sgns_exact_grads call also clears two slot "
          f"counts); karate gate with exact negatives on the card: AUC "
          f"{auc:.4f} (> 0.7), faction accuracy {acc:.4f} (>= 0.85); --dim "
          f"768 through the CLI: AUC {auc768:.4f}, faction accuracy "
          f"{acc768:.4f} [{smi}]")
    return {**trainer, "train_seconds": report["train_seconds"],
            "blocks": blocks, "launches_a_block": per_block}


def draw_tables(torch, V: int, seed: int):
    """A skewed unigram alias table on the card (keep f32, alias i32)."""
    from stellar_rw_tpu_torch.ops.alias import build_alias

    rng = np.random.default_rng(seed)
    keep, alias = build_alias(rng.random(V) ** 4 * 100 + 1e-3)
    return (torch.as_tensor(keep, dtype=torch.float32).cuda(),
            torch.as_tensor(alias, dtype=torch.int32).cuda())


def phase_draws_check(torch, smi) -> dict:
    """Phase 13: the trainer's draws kernel bit for bit against
    trainer_draws_ref on the card (DRAW_CASES), then timed on the main
    path's chunks: the conv trainer's (1,524 blocks of 128 negatives and
    2,624 windows) and the exact trainer's (15 blocks of 262,400 negatives
    and 2,624 windows)."""
    from stellar_rw_tpu_torch.models.word2vec import _DRAW_BUDGET
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import trainer_draws as td

    key = prng.fold_in(prng.prng_key(1), 0).cuda()
    elements = 0
    for i, (B, T, w, k, kB, V, c0, n) in enumerate(DRAW_CASES):
        keep, alias = draw_tables(torch, V, i)
        shape = (kB,) if kB else (B * T * 2 * w, k)
        got = td.trainer_draws(key, c0, n, B, T, w, shape, keep, alias)
        want = td.trainer_draws_ref(key, c0, n, B, T, w, shape, keep, alias)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("cwin", "negs")):
            check(a.dtype == b.dtype == torch.int32 and torch.equal(a, b),
                  f"trainer_draws' {what} differ from trainer_draws_ref at "
                  f"{DRAW_CASES[i]}")
        elements += got[0].numel() + got[1].numel()
    rows = {}
    keep, alias = draw_tables(torch, 10_000, 0)
    for name, k, kB in (("conv", None, 128), ("exact", 5, None)):
        B, T, w = 32, 82, 10
        shape = (kB,) if kB else (B * T * 2 * w, k)
        M = int(np.prod(shape))
        n = min(3125, _DRAW_BUDGET // (M + B * T))
        kern = lambda: td.trainer_draws(key, 0, n, B, T, w, shape, keep,
                                        alias)
        plain = lambda: td.trainer_draws_ref(key, 0, n, B, T, w, shape,
                                             keep, alias)
        runs = [cuda_ms(f, 3) for f in (plain, kern, kern, plain)]
        # two threefry blocks an element (and four key blocks a block);
        # each element written once, the alias table read once
        draws = n * (2 * (B * T + M) + 5)
        b = bound(n * (B * T + M) * 4 + tensor_bytes(keep, alias, key),
                  draws * OPS_PER_DRAW, INT_OPS_PER_S)
        rows[name] = {"blocks": n, "ms": (runs[1] + runs[2]) / 2,
                      "plain_ms": (runs[0] + runs[3]) / 2, **b,
                      "draws": draws}
    c, e = rows["conv"], rows["exact"]
    print(f"phase 13 trainer_draws: bitwise equal to trainer_draws_ref on "
          f"the card in {len(DRAW_CASES)} cases ({elements:,} elements; "
          f"(B, T, w, k, kB, V, first block, blocks) in {DRAW_CASES}); the "
          f"conv chunk ({c['blocks']} blocks) kernel {c['ms']:.4f} ms, plain "
          f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms by "
          f"{c['bound_by']}; the exact chunk ({e['blocks']} blocks) kernel "
          f"{e['ms']:.4f} ms = {e['ms'] / e['blocks']:.5f} ms a block, plain "
          f"{e['plain_ms']:.3f} ms = {e['plain_ms'] / e['blocks']:.4f} ms a "
          f"block, bound {e['bound_ms']:.5f} ms by {e['bound_by']} (CUDA "
          f"events, mean of 2x3) [{smi}]")
    return {"max_abs_err": 0, **{k: c[k] for k in ("ms", "plain_ms",
                                                    "bound_ms", "bound_by")},
            "library_ms": None, "chunk_blocks": c["blocks"],
            "exact_chunk": e}


def conv_block(torch, V, B, T, window, kB, D, seed, tokens):
    """One conv block: Zipf tokens (rows collide), one token alone ("hub"),
    or Zipf walks that end early ("padded": ragged ends, one walk all
    padding, a gap inside a walk); the trainer's window and negative draws
    (the block's unigram table); random tables."""
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import trainer_draws as td
    from stellar_rw_tpu_torch.ops.alias import build_alias

    rng = np.random.default_rng(seed)
    u = (np.zeros((B, T)) if tokens == "hub"
         else rng.random((B, T)) ** (1 / 0.3))
    block = np.minimum((V * u).astype(np.int32), V - 1)
    block[-1, T - 7:] = -1
    if tokens == "padded":
        ends = rng.integers(1, T + 1, B)
        block[np.arange(T)[None, :] >= ends[:, None]] = -1
        block[0] = -1
        block[1, 5:9] = -1
    keep, alias = build_alias(np.bincount(block[block >= 0], minlength=V)
                              ** 0.75 + 1e-12)
    key = prng.fold_in(prng.prng_key(seed), 3).cuda()
    cwin, negs = td.trainer_draws_ref(
        key, 0, 1, B, T, window, (kB,),
        torch.as_tensor(keep, dtype=torch.float32).cuda(),
        torch.as_tensor(alias, dtype=torch.int32).cuda())
    w = lambda: torch.as_tensor((rng.standard_normal((V, D)) * 0.3)
                                .astype(np.float32)).cuda()
    return w(), w(), torch.as_tensor(block).cuda(), cwin[0], negs[0]


def phase_conv_check(torch, smi) -> tuple[dict, dict]:
    """Phase 14: the conv step's kernels against the plain step in float32
    and in float64 (CONV_SHAPES), two steps on one workspace against two
    plain steps, and each kernel's time at the main shape."""
    from stellar_rw_tpu_torch.ops import sgns_conv as sc
    from stellar_rw_tpu_torch.ops.sgns import sgns_shared_grads
    from stellar_rw_tpu_torch.ops.sgns_exact import launch_apply

    lr = 0.025
    err = k64_err = f32_err = 0.0
    loose = []   # (shape, table, error) where the plain f32 step is off
    for i, (V, B, T, win, kB, D, tokens) in enumerate(CONV_SHAPES):
        w_in, w_out, block, cwin, negs = conv_block(torch, V, B, T, win, kB,
                                                    D, i, tokens)
        nw = 5 / kB
        a_in, a_out = w_in.double(), w_out.double()
        sc.sgns_conv_step_ref(a_in, a_out, block, cwin, negs, lr, nw, win)
        p_in, p_out = w_in.clone(), w_out.clone()
        sc.sgns_conv_step_ref(p_in, p_out, block, cwin, negs, lr, nw, win)
        b_in, b_out = w_in.clone(), w_out.clone()
        sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw, win)
        torch.cuda.synchronize()
        for table, got, want, plain, old in (
                ("w_in", b_in, a_in, p_in, w_in),
                ("w_out", b_out, a_out, p_out, w_out)):
            k_err = float((got.double() - want).abs().max())
            p_err = float((plain.double() - want).abs().max())
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6),
                  f"the conv step differs from the float64 step at "
                  f"{CONV_SHAPES[i]} ({table}): max abs err {k_err:.3g}")
            check(k_err <= p_err, f"the conv step is {k_err:.3g} off the "
                  f"float64 step at {CONV_SHAPES[i]} ({table}), the plain "
                  f"f32 step {p_err:.3g}")
            # the plain f32 step is the reference at that tolerance where it
            # is itself within it of the float64 step: on one token alone
            # its atomics add 2,624 equal per-position shares into one row
            if torch.allclose(plain.double(), want, rtol=1e-5, atol=1e-6):
                check(torch.allclose(got, plain, rtol=1e-5, atol=1e-6),
                      f"the conv step differs from the plain f32 step at "
                      f"{CONV_SHAPES[i]} ({table}): max abs err "
                      f"{float((got - plain).abs().max()):.3g}")
                err = max(err, float((got - plain).abs().max()))
            else:
                loose.append((CONV_SHAPES[i], table, p_err))
            check(bool((got != old).any()), "the step moved nothing")
            k64_err = max(k64_err, k_err)
            f32_err = max(f32_err, p_err)
    # the main shape: two steps on one workspace, then each kernel timed
    V, B, T, win, kB, D, _ = CONV_SHAPES[0]
    nw = 5 / kB
    w_in, w_out, block, cwin, negs = conv_block(torch, V, B, T, win, kB, D,
                                                0, "zipf")
    ws = sc.ConvWorkspace(w_in, w_out, B, T, win, kB)
    p_in, p_out = w_in.clone(), w_out.clone()
    b_in, b_out = w_in.clone(), w_out.clone()
    for _ in range(2):
        sc.sgns_conv_step_ref(p_in, p_out, block, cwin, negs, lr, nw, win)
        sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw, win, ws)
    torch.cuda.synchronize()
    check(torch.allclose(b_in, p_in, rtol=1e-5, atol=1e-6)
          and torch.allclose(b_out, p_out, rtol=1e-5, atol=1e-6),
          "two conv steps on one workspace differ from two plain steps")
    check(int((ws.slots.map[0] >= 0).sum() + (ws.slots.map[1] >= 0).sum())
          == 0, "the workspace's row-to-slot maps were not emptied")
    hold = {}
    acc = lambda: sc.launch_accumulate(ws, b_in, b_out, block, cwin, negs,
                                       win, nw)
    k6 = lambda: hold.update(d=sgns_shared_grads(ws.ein, ws.acc_in, ws.wn,
                                                 ws.ones, ws.mask))
    scat = lambda: sc.launch_scatter(ws, b_out, block, hold["d"][0],
                                     hold["d"][2], negs, nw, lr)
    app = lambda: launch_apply(ws.slots, b_in, b_out, lr)
    iters = 20
    a_ms, k_ms, s_ms, p_ms = cuda_ms_split((acc, k6, scat, app), iters)
    step = lambda: sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw,
                                     win, ws)
    plain = lambda: sc.sgns_conv_step_ref(p_in, p_out, block, cwin, negs,
                                          lr, nw, win)
    runs = [cuda_ms(f, 5) for f in (plain, step, step, plain)]
    # the accumulate kernel under each tile launch_plan could take
    by_tile = {}
    for t in sc.TILES + (4,):
        wt = sc.ConvWorkspace(w_in, w_out, B, T, win, kB, tiles=(t,))
        by_tile[t] = cuda_ms(lambda: sc.launch_accumulate(
            wt, w_in, w_out, block, cwin, negs, win, nw), 20)
    # what this block needs: its valid pairs, its distinct rows
    N = B * T
    P = int(ws.cnt[0].sum())
    tok = block[block >= 0]
    U_in = int(torch.unique(tok[ws.cnt[0].reshape(B, T)[block >= 0] > 0])
               .numel())
    U_out = int(torch.unique(tok[ws.cnt[1].reshape(B, T)[block >= 0] > 0])
                .numel())
    U = int(torch.unique(tok).numel())
    row = D * 4
    # accumulate: the block's rows of both tables and the negatives' rows
    # read, ein / acc_in / acc_out / mask / counts / wn written; a dot of 2D
    # flops a valid pair, a multiply-add an element on each side
    acc_b = bound(tensor_bytes(block, cwin, negs) + 2 * U * row
                  + kB * row * 2 + 3 * N * row + 3 * N * 4,
                  P * 6 * D, F32_FLOPS)
    # scatter: d_in, acc_out and the counts read, the slots written, the
    # negatives' rows read, added and written
    scat_b = bound(2 * N * row + 3 * N * 4 + (U_in + U_out) * row
                   + kB * row * 3, (2 * N + kB) * D, F32_FLOPS)
    app_b = bound((U_in + U_out) * row * 4, (U_in + U_out) * D * 3,
                  F32_FLOPS)
    plan = ws.plan
    print(f"phase 14 the conv step: within rtol 1e-5 atol 1e-6 of the "
          f"float64 step and no farther from it than the plain f32 step at "
          f"{CONV_SHAPES} (V, B, T, w, kB, D, tokens): max abs err against "
          f"the float64 step {k64_err:.3g}, the plain f32 step's "
          f"{f32_err:.3g}; within rtol 1e-5 atol 1e-6 of the plain f32 step "
          f"(max abs err {err:.3g}) wherever that step is within it of the "
          f"float64 step, which it is not at {loose}; two steps on one "
          f"workspace held, its maps "
          f"emptied; at the main shape ({P} valid pairs, {U} distinct rows, "
          f"{U_in} + {U_out} touched; plan {plan._asdict()}) accumulate "
          f"{a_ms:.4f} ms, sgns_shared_grads {k_ms:.4f} ms, scatter "
          f"{s_ms:.4f} ms, apply {p_ms:.4f} ms (CUDA events around each "
          f"launch, mean of {iters}); accumulate by tile {by_tile} (mean of "
          f"20 back to back); the step through its wrapper "
          f"{(runs[1] + runs[2]) / 2:.4f} ms, the plain step "
          f"{(runs[0] + runs[3]) / 2:.3f} ms (mean of 2x5); bounds "
          f"{acc_b['bound_ms']:.5f} ms by {acc_b['bound_by']} / "
          f"{scat_b['bound_ms']:.5f} ms by {scat_b['bound_by']} / "
          f"{app_b['bound_ms']:.5f} ms by {app_b['bound_by']} [{smi}]")
    common = {"max_abs_err": err, "max_abs_err_f64": k64_err,
              "plain_f32_off_f64": f32_err,
              "plain_ms": (runs[0] + runs[3]) / 2, "library_ms": None,
              "step_ms": (runs[1] + runs[2]) / 2,
              "sgns_shared_grads_ms": k_ms, "apply_ms": p_ms,
              "apply_bound_ms": app_b["bound_ms"], "valid_pairs": P,
              "accumulate_ms_by_tile": by_tile}
    return ({"ms": a_ms, **acc_b, **common},
            {"ms": s_ms, **scat_b, **common})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops.cdf_walk import CDF_WALK_KERNEL
    from stellar_rw_tpu_torch.ops.resident_walk import RESIDENT_WALK_KERNEL
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL
    from stellar_rw_tpu_torch.ops.walk_step import KEYS_KERNEL, WALK_KERNEL

    smi = phase_env(torch, (WALK_KERNEL, KEYS_KERNEL, RESIDENT_WALK_KERNEL,
                            CDF_WALK_KERNEL, *trainer_kernels().values()))
    phase_walk(torch)
    sgns_row = phase_sgns(torch)
    walk_row, keys_row = phase_walk_main_shape(
        torch, synth_power_law_graph(10_000, 334_000, seed=0), KEYS_KERNEL)
    with tempfile.TemporaryDirectory() as tmp:
        main_run = phase_main(torch, WALK_KERNEL, KEYS_KERNEL, smi, tmp)
        quality = phase_quality(torch, tmp)
        phase_resident_check(torch)
        resident_row = phase_resident_main(torch, RESIDENT_WALK_KERNEL, smi)
        phase_embedding(torch, SGNS_KERNEL,
                        os.path.join(main_run["out"], "path"),
                        os.path.join(tmp, "out_embedding"))
        phase_cdf_check(torch)
        cdf_row = phase_cdf_main(torch, CDF_WALK_KERNEL, smi, tmp,
                                 main_run["edges"])
        grads_row, apply_row = phase_exact_check(torch)
        exact_run = phase_exact_main(torch, smi, tmp, main_run["edges"])
    draws_row = phase_draws_check(torch, smi)
    accumulate_row, scatter_row = phase_conv_check(torch, smi)
    epochs = {"conv_epoch_s": main_run["train_seconds"],
              "conv_launches_a_block": main_run["launches_a_block"],
              "exact_epoch_s": exact_run["train_seconds"],
              "exact_launches_a_block": exact_run["launches_a_block"]}
    kernels = [
        {"name": "walk", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/walk.cu",
         "replaces": "stellar_rw_tpu/walk/engine.py:176",
         "launches": main_run["walk"], **walk_row},
        {"name": "trial_keys", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/walk.cu",
         "replaces": "stellar_rw_tpu/walk/engine.py:161",
         "launches": main_run["trial_keys"], **keys_row},
        {"name": "sgns_shared_grads", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_shared.cu",
         "replaces": "stellar_rw_tpu/ops/pallas/sgns.py:90",
         "launches": main_run["sgns_shared_grads"], **sgns_row},
        {"name": "resident_walk", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/resident_walk.cu",
         "replaces": "stellar_rw_tpu/ops/pallas/walk.py:238",
         **resident_row},
        {"name": "cdf_walk", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/cdf_walk.cu",
         "replaces": "stellar_rw_tpu/walk/engine.py:226", **cdf_row},
        {"name": "sgns_exact_grads", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_exact.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:154",
         "launches": exact_run["sgns_exact_grads"], **grads_row},
        {"name": "sgns_exact_apply", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_exact.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:154",
         "launches": exact_run["sgns_exact_apply"],
         "launches_conv_path": main_run["sgns_exact_apply"], **apply_row},
        {"name": "trainer_draws", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/trainer_draws.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:116",
         "launches": main_run["trainer_draws"],
         "launches_exact_path": exact_run["trainer_draws"], **draws_row},
        {"name": "sgns_conv_accumulate", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_conv.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:364",
         "launches": main_run["sgns_conv_accumulate"], **accumulate_row},
        {"name": "sgns_conv_scatter", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_conv.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:488",
         "launches": main_run["sgns_conv_scatter"], **scatter_row},
    ]
    print(json.dumps({"epochs": epochs, "quality": quality}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
