#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellar_rw_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a, one process for
each of the eleven sources, in parallel; walk.cu holds two kernels,
shard_walk.cu two (K11's request emit and serve),
sgns_conv.cu two (the scatter with its accumulate mode), sgns_exact.cu one
with its merged and accumulate entry points, spmm.cu three; beside them the threefry probe, chip_draws_probe.cu appended
to a copy of trainer_draws.cu), holds each against its plain PyTorch
version on the card, and drives the port's paths once each through the
entry points a user calls:

  phases 2-5  `node2vec --sharedNegatives 128` through the CLI on a
              BlogCatalog-shaped graph (10,000 vertices, 334,000 sampled
              edges; the node2vec paper's BlogCatalog has 10,312 vertices
              and 333,983 edges) with walkLength 80, numWalks 10, dim 128:
              the conv trainer's epoch with its calls a block (the
              trainer's draws, then three a block: the conv step's
              accumulate kernel, sgns_shared_grads and its scatter-update
              kernel; no apply kernel); then the
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
  phases 11-12 the exact-negative SGNS step, one cooperative kernel
              launch (gradients, a grid barrier, the update): against the
              plain step in float64 on blocks of the main shape (D = 128,
              100 and 768; Zipf, uniform and one-token blocks), its
              workspace empty after every step, with the tables' hit rate
              and flushes, then `node2vec` through the CLI with the default
              trainer (no --sharedNegatives; one launch a block and one a
              chunk of draws), the karate gate with exact negatives, and a
              `--dim 768` karate run through the CLI held to the same gate;
  phase 13    the trainer's draws kernel bit for bit against
              trainer_draws_ref: exact and shared shapes, ragged chunks,
              windows 1, 7, 10 and 1,000, a one-row vocabulary, 70,000
              thread blocks in one grid dimension; timed on the main
              path's chunks beside the card's threefry rate with no memory
              traffic (the probe);
  phase 14    the conv step's kernels (the accumulate kernel's halo
              tiles, sgns_shared_grads, the scatter-update by token
              groups) against the plain step in float32 (rtol 1e-5 atol
              1e-6) and in float64 at D = 64, 128 and 768 (and ragged and
              sliced shapes, T 201, window 20) on Zipf, one-token (also
              with every negative that token, also at T 201), a token at
              every other position and padded blocks; each kernel timed
              at the main shape, the accumulate kernel by tile, and the
              corpus's grouping once;
  phase 15    `node2vec --streaming true` through the CLI on phase 4's
              graph, conv (kB 128) and exact, one epoch each (one walk
              round on the device at a time): /path byte for byte phase
              4's, each round walked once in the pre-pass and once in the
              epoch, each trainer kernel's launches and calls a block, the
              token grouping's ms a round, the job's peak device memory
              above the graph and embedding tables against the stored
              run's, and the labeled synthetic gate on a streamed run;
  phase 16    phase 4's argv with `--profile DIR`: the torch.profiler trace
              names each of the path's kernels by its CUDA symbol as often
              as its wrapper counted launches;
  phase 17    the job server (`serve.JobServer` on port 0): a karate
              node2vec job over REST in a worker process on the card, its
              /path byte for byte the CLI's; a failing job; the next job;
  phase 18    the hierarchical-softmax step's kernel (csrc/hsoftmax.cu, one
              cooperative launch) against the plain step in float64 on
              blocks of phase 19's corpus under its Huffman tree (D 128,
              64 and 768, window 1), padded Zipf walks (D 128 and 200), one
              token alone and a two-token tree, its workspace empty after
              every step, each step timed;
  phase 19    train_skipgram_hs at bench.py::hs_ablation's reference
              protocol (the 100,000-vertex labeled synthetic graph walked
              on the card at walkLength 80, numWalks 10; dim 128, window
              10, row_block 256), one epoch: K9 once a block, the draws
              once a chunk, the job's peak device memory, the conv
              trainer's epoch on the same corpus beside it; the karate HS
              gate on the card;
  phase 20    the GNN-feed ops (csrc/spmm.cu: segment sums, SDDMM, the row
              softmax) forward and backward against their plain versions
              in float64 at bench.py::measure_spmm's graph (D 128 and 64)
              and the directed test graph; the split rows' extremes (a hub
              row of 24 items, rows of one arc, isolates; the softmax's
              max in a hub row's last arc, scores x30, all equal); a
              GAT-style layer through the public ops, its gradients held
              against the plain layer's in float64; the SDDMM and both
              softmax modes run twice, bit for bit; each kernel timed
              beside its plain version, its bound and its library call
              (torch.sparse, and the sparse softmax's backward: timed
              only);
  phase 21    the data-parallel trainer (`--w2vPartitions`): over two
              slots of the main shape (D 128 and 768; Zipf blocks, blocks
              whose negatives are their own tokens, one token alone) the
              exact form's merged update as one launch of K4 over both
              slots (no buffer, no K13), and K4 in accumulate mode (both
              slots in one launch, and a launch a slot) and K5's scatter
              in accumulate mode with dp_apply (K13, csrc/dp_apply.cu),
              against the plain merged update in float64, K13 bit for
              bit against its plain version, the buffer and the
              workspaces empty after every merged update, each timed
              beside its bound (the merged launch beside the parent's
              two accumulate launches and K13; K13 on buffers that two
              slots' steps filled at V 10,000 and 1,000,000 and on one
              with every count nonzero, bit for bit and emptied, beside
              torch.addcdiv; the scatter at a Zipf and a one-token block
              beside index_add_); `node2vec --w2vPartitions 2`
              through the CLI on phase 4's graph, conv and exact (/path
              byte for byte phase 4's; conv: K13 once a merged update;
              exact: one K4 launch a merged update and no K13, no
              accumulate launch, no all-reduce; the epochs beside phases
              4 and 12); the karate gate at four slots; two gloo ranks
              sharing the card (processes of their own) running
              train_skipgram_multiproc, conv and exact (K4's accumulate
              mode, the all-reduce and K13), against the one-process
              two-slot run, with the labeled synthetic micro-F1 gate, then
              one merged update of the main shape by hand in each form
              (the buffers empty after it; K13's precondition, acc 0
              wherever the count is 0, read before it);
  phase 22    the sharded walk engine (parallel/distributed.py, K11):
              shard_emit and shard_serve (csrc/shard_walk.cu) bit for bit
              against their plain versions on one superstep of phase 4's
              corpus in each layout (the emit at the auto capacity and at
              a small one, three launches into one work each; the serve in
              one launch of rank 0's walkers with their local flags and
              the buffer it receives, equal to the corpus's next column;
              one superstep under sync debug "error"), timed beside their
              empty launches, their bounds and (the emit)
              torch.sort(stable=True) + a scatter, the emit also on first
              and next rounds in turn; then run_walks at
              phase 4's graph and walk on two gloo ranks sharing the card
              (processes of their own), hash route over 2 shards, a
              vertex-cut route over 2 shards and 1 shard x 2 lanes: /path
              byte for byte phase 4's, the stats equal to the plain path's
              (the plain versions on the card), one emit and one serve an
              exchange round and none of the walk kernel, walk seconds,
              supersteps, exchange rounds, boundary walkers, replication
              factor, capacity, the kernels' ms and the collectives' host
              ms a superstep;
  phase 23    dim-sharded tables on the card: `node2vec --w2vModelShards
              2` through the CLI on phase 4's graph at its width (/path
              byte for byte phase 4's, the trainer's launches phase 4's,
              no dp kernel, the epoch beside phase 4's), `--w2vPartitions 2
              --w2vModelShards 2` with exact negatives (one K4 launch a
              merged update), the karate gate at model_shards 2, karate
              through the CLI on the card against the CPU's plain run of
              the same flags, and sgns_loss on the card against the CPU on
              phase 4's tables;
  phase 24    the multi-host CLI: two processes joined by SRW_* on the
              card (gloo ranks sharing cuda:0): `python -m
              stellar_rw_tpu_torch --cmd randomwalk` (hash route), then
              through a worker calling cli.main as that module does, the
              vertex-cut route, node2vec at phase 4's flags and embedding
              over phase 4's /path: each rank's parts merged byte for byte
              phase 4's /path, rank 0's stats line phase 4's, the tables
              against train_skipgram_multiproc(num_devices=2) in this
              process, K11's launches and the all-reduces, each rank's walk
              and train seconds.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Every failure raises and the script exits non-zero. It
needs a CUDA device and the repository around it; it imports nothing of JAX
and nothing of the JAX package. The last line is {"ok": true, "device":
{...}}; the line before it lists each kernel with its launches, its error
against its plain version, its times and its bound.
"""

from __future__ import annotations

import ctypes
import dataclasses
import filecmp
import glob
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# (P, D, kB): the main path's shape; ragged D and kB; wn in two chunks;
# several tiles a block; the widest D; five chunks at the third width
SGNS_SHAPES = [(2624, 128, 128), (300, 50, 37), (7, 128, 256),
               (20000, 128, 128), (1000, 512, 64), (100, 200, 300),
               # above D = 256, the split form: the conv step at D 768, a
               # ragged odd D, two passes over the tiles
               (2624, 768, 128), (257, 1025, 70), (40, 1536, 256),
               # the conv step's call at D 384, 512, 1,025 and 1,536
               (2624, 384, 128), (2624, 512, 128), (2624, 1025, 128),
               (2624, 1536, 128)]
# the split form's shapes phase 3 times (the conv step's block at each D)
SGNS_WIDE = [(2624, 384, 128), (2624, 512, 128), (2624, 768, 128),
             (2624, 1025, 128), (2624, 1536, 128)]
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
# phase 15: phase 4's and phase 12's runs without --validate (the streamed
# path has none), streamed and stored; the labeled synthetic graph streamed
# at phase 5's settings
STREAM_FLAGS = MAIN_FLAGS[:MAIN_FLAGS.index("--validate")]
STREAM_EXACT_FLAGS = EXACT_FLAGS[:EXACT_FLAGS.index("--validate")]
SYNTH_FLAGS = ["--walkLength", "20", "--numWalks", "3", "--p", "0.25", "--q",
               "0.25", "--seed", "1", "--dim", "32", "--window", "5",
               "--negatives", "5", "--lr", "0.1", "--iter", "3",
               "--sharedNegatives", "64"]
# phase 17: the job served over REST, on karate
SERVE_FLAGS = ["--cmd", "node2vec", "--walkLength", "20", "--numWalks", "10",
               "--dim", "32", "--window", "5", "--iter", "2", "--seed", "2"]
# phase 12's karate run above the old 512 limit of the exact kernel: the
# gate's trainer settings (dim aside) and walks
DIM768_FLAGS = ["--dim", "768", "--window", "5", "--negatives", "5", "--lr",
                "0.2", "--iter", "20", "--walkLength", "20", "--numWalks",
                "10", "--seed", "2"]
# phase 10: a bias ratio of 64 sends plan_sampler to the exact CDF
CDF_FLAGS = ["--cmd", "randomwalk", "--walkLength", "80", "--numWalks", "10",
             "--p", "0.0625", "--q", "4", "--validate", "true"]
CDF_OUT = "out_cdf"      # phase 10's output under the run's directory
# a row entry of the CDF scan with prev's bucket rows: the hash multiply,
# mask and base add, four compares and their or, the select of f, the
# product and the sum (phases 10 and 25 charge a first-order entry so too)
OPS_PER_ENTRY = 12
# a row entry with prev's neighbors in a bitmap (pick_bits): the compare
# with prev, the word's index, the shared load, the bit's shift and mask,
# the select of f, the product and the sum
OPS_PER_BITMAP_ENTRY = 8
# phase 10's row-stream probe: K7's rows read in its order, no weighing
CDF_PROBE_SOURCE = "chip_cdf_probe.cu"
CDF_PROBE_SYMBOL = "srw_cdf_row_probe_launch"
CDF_PROBE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
EMBED_FLAGS = ["--cmd", "embedding", "--dim", "128", "--window", "10",
               "--negatives", "5", "--sharedNegatives", "128", "--iter", "1"]
# phase 5's karate run of shared negatives above the old 512 limit
SHARED768_FLAGS = DIM768_FLAGS + ["--sharedNegatives", "128"]
# phase 13: (B, T, window, k or None, kB or None, V, c0, n). The main
# path's exact chunk and a ragged conv chunk; window 1 at the epoch's end;
# window 7 (a span that is not a power of two, as 10) in both trainers'
# shapes and 1,000 (a multiplier of 536); one-row vocabularies; 70,000
# thread blocks, more than a grid's y extent (65,535) holds; the HS
# trainer's chunk at phase 19's shape (kB 0: no negatives, no table)
DRAW_CASES = [(32, 82, 10, 5, None, 10_000, 0, 15),
              (32, 82, 10, None, 128, 10_000, 1524, 77),
              (32, 82, 1, 5, None, 10_000, 3120, 5),
              (32, 82, 7, 5, None, 10_000, 40, 4),
              (32, 82, 7, None, 128, 10_000, 0, 300),
              (2, 11, 1000, None, 16, 50, 5, 3),
              (4, 23, 10, 5, None, 1, 0, 3),
              (6, 23, 5, None, 64, 1, 7, 2),
              (1, 5, 2, None, 3, 50, 11, 70_000),
              (256, 82, 10, None, 0, 0, 0, 199)]
# the threefry probe (chip_draws_probe.cu): rounds of its chains a thread,
# chains a thread (kChains there), waves of blocks; the draws kernel's
# blocks of 256 threads an SM holds (32 registers a thread)
PROBE_SOURCE = "chip_draws_probe.cu"
PROBE_SYMBOL = "srw_threefry_probe_launch"
PROBE_ARGTYPES = ([ctypes.c_uint] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 2)
PROBE_ROUNDS, PROBE_CHAINS, PROBE_WAVES = 64, 8, 4
DRAWS_BLOCKS_PER_SM = 8
# phase 14: (V, B, T, window, kB, D, tokens). The main shape; D 64 and 768;
# one token alone, also with every negative that token; walks padded with
# -1; small ragged blocks, one whose D takes row slices in both kernels;
# longer walks (T 201: Zipf, one token alone, a token at every other
# position); a window wider than a tile's positions (20)
CONV_SHAPES = [(10_000, 32, 82, 10, 128, 128, "zipf"),
               (10_000, 32, 82, 10, 128, 64, "zipf"),
               (10_000, 32, 82, 10, 128, 768, "zipf"),
               (10_000, 32, 82, 10, 128, 128, "hub"),
               (10_000, 32, 81, 10, 128, 128, "padded"),
               (10_000, 32, 82, 10, 128, 768, "padded"),
               (300, 7, 30, 3, 37, 100, "zipf"),
               (50, 3, 11, 5, 16, 1536, "hub"),
               (10_000, 32, 201, 10, 128, 128, "zipf"),
               (10_000, 32, 201, 10, 128, 128, "hub"),
               (10_000, 32, 201, 10, 128, 128, "every other"),
               (10_000, 32, 82, 20, 128, 128, "zipf"),
               (10_000, 32, 82, 10, 128, 128, "hub negatives")]


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


def edited(text: str, edits) -> str:
    """A kernel source with each (piece, replacement) of `edits` applied; a
    piece that is not exactly once in the text stops the caller."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"not once in the source: {old!r}")
        text = text.replace(old, new)
    return text


def source_kernel(name: str, text: str, symbol: str, argtypes,
                  subdir: str):
    """A kernel of the port's build machinery (ops/_build.py::Kernel) built
    from `text`, a kernel source edited or with a chip_*.cu file appended,
    written to build/<subdir>/<name>.cu beside copies of csrc's headers."""
    from stellar_rw_tpu_torch.ops import _build as build

    out_dir = build.Path(ROOT) / "build" / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    path = out_dir / f"{name}.cu"
    path.write_text(text)

    class Source(build.Kernel):
        @property
        def path(self):
            return path
    return Source(f"{name}.cu", symbol, argtypes)


def with_probe(text: str) -> str:
    """A draws kernel source with chip_draws_probe.cu appended."""
    with open(os.path.join(ROOT, PROBE_SOURCE)) as f:
        return text + "\n" + f.read()


def draws_probe():
    """The threefry probe's entry point, built from csrc/trainer_draws.cu
    as it stands with chip_draws_probe.cu appended."""
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops.trainer_draws import TRAINER_DRAWS_KERNEL

    text = (build.CSRC / TRAINER_DRAWS_KERNEL.source).read_text()
    return source_kernel("draws_probe", with_probe(text), PROBE_SYMBOL,
                         PROBE_ARGTYPES, "draws_probe")


def cdf_row_probe():
    """Phase 10's row-stream probe (chip_cdf_probe.cu) as a Kernel."""
    with open(os.path.join(ROOT, CDF_PROBE_SOURCE)) as f:
        return source_kernel("cdf_probe", f.read(), CDF_PROBE_SYMBOL,
                             CDF_PROBE_ARGTYPES, "cdf_probe")


def cdf_scan_ops(entries: int, bitmap_entries: int) -> int:
    """The operations of a CDF row scan of `entries` row entries, of which
    `bitmap_entries` read prev's neighbors from a bitmap: those at
    OPS_PER_BITMAP_ENTRY, the others at OPS_PER_ENTRY."""
    return (bitmap_entries * OPS_PER_BITMAP_ENTRY
            + (entries - bitmap_entries) * OPS_PER_ENTRY)


def cdf_registers(build_log: str) -> dict:
    """ptxas' registers of each instantiation of K7's kernels in a build
    log: {"f32 chunked": n, "f32 chunked bitmap": n, ...} (" recording"
    after the recording forms), with a spilling one's stack line."""
    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            # cdf_walk_kernel<T, kChunked, kRecord> or
            # cdf_walk_bitmap_kernel<T, kRecord>, mangled
            m = re.search(r"cdf_walk_(bitmap_)?kernelI([fd])((?:Lb[01]E)*)",
                          line)
            flags = m and re.findall(r"Lb([01])E", m[3])
            name = m and (("f32" if m[2] == "f" else "f64")
                          + (" chunked bitmap" if m[1]
                             else " chunked" if flags[:1] == ["1"]
                             else " padded")
                          + (" recording" if flags[int(not m[1]):][:1]
                             == ["1"] else ""))
        elif name and "Used" in line and "registers" in line:
            out[name] = int(line.split("Used")[1].split("registers")[0])
        elif name and "spill stores" in line and \
                " 0 bytes spill stores" not in line:
            out[name + " spills"] = line.strip()
    return out


def probe_rates(torch, kernel) -> dict:
    """Threefry blocks a second on this card with no memory traffic, by
    cuda_ms: threefry.cuh's block as the walk kernels compile it, and the
    draws kernel's block_fn."""
    from stellar_rw_tpu_torch.ops._build import ptr, stream
    from stellar_rw_tpu_torch.ops.trainer_draws import THREADS

    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = (PROBE_WAVES * DRAWS_BLOCKS_PER_SM
              * torch.cuda.get_device_properties(0).multi_processor_count)
    rates = {}
    for form, label in ((0, "threefry.cuh"), (1, "block_fn")):
        ms = cuda_ms(lambda: kernel.launch(
            0x12345678, 0x9ABCDEF0, form, blocks, PROBE_ROUNDS, ptr(out),
            stream(out.device)), 5)
        rates[label] = blocks * THREADS * PROBE_CHAINS * PROBE_ROUNDS / (
            ms * 1e-3)
    return rates


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
    timing, wide = {}, {}
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
        # three products of 2*P*kB*D flops in f32; each input read once,
        # each output written once
        nbytes = tensor_bytes(vi, vo, wn, g_pos, mask, *got)
        flops = 3 * 2 * P * kB * D
        if (P, D, kB) in SGNS_WIDE:
            runs = [cuda_ms(f, 20) for f in (plain, kern, kern, plain)]
            wide[D] = {"ms": (runs[1] + runs[2]) / 2,
                       "plain_ms": (runs[0] + runs[3]) / 2,
                       **bound(nbytes, flops, F32_FLOPS)}
        if (P, D, kB) == SGNS_SHAPES[0]:
            runs = [cuda_ms(f, 50) for f in (plain, kern, kern, plain)]
            timing = {"ms": (runs[1] + runs[2]) / 2,
                      "plain_ms": (runs[0] + runs[3]) / 2,
                      **bound(nbytes, flops, F32_FLOPS),
                      "library_ms": None}
    d768 = wide[768]
    print(f"phase 3 sgns_shared_grads: within rtol 1e-5 atol 1e-5 of the "
          f"plain f32 version at {SGNS_SHAPES}, max abs err {err:.3g}, two "
          f"calls bit-identical at each; plan at the main shape "
          f"{sgns.launch_plan(*SGNS_SHAPES[0])._asdict()}; at "
          f"{SGNS_SHAPES[0]} kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms (CUDA events, mean of 2x50), bound "
          f"{timing['bound_ms']:.5f} ms by {timing['bound_by']}; the split "
          f"form at (2624, D, 128) (mean of 2x20): " + "; ".join(
              f"D {D} kernel {w['ms']:.4f} ms, plain {w['plain_ms']:.4f}, "
              f"bound {w['bound_ms']:.5f} by {w['bound_by']}"
              for D, w in wide.items()))
    return {"max_abs_err": err, **timing, "d768_ms": d768["ms"],
            "d768_plain_ms": d768["plain_ms"],
            "d768_bound_ms": d768["bound_ms"],
            "d768_bound_by": d768["bound_by"],
            "wide_d": {str(D): w for D, w in wide.items()}}


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
    # the card's floor for a launch of the table's grid: the kernel with its
    # body taken out (a warp returns at once), timed the same way
    from stellar_rw_tpu_torch.ops._build import CSRC, ptr, stream

    empty = source_kernel(
        "keys_empty", edited((CSRC / "walk.cu").read_text(), [
            ("  if (warp >= R * L1) return;", "  if (warp >= 0) return;")]),
        keys_kernel.symbol, keys_kernel.argtypes, "keys_empty")
    scratch = torch.empty_like(keys)
    floor_ms = cuda_ms(lambda: empty.launch(
        ptr(scratch), 0, 0, 0, R, L + 1, T, stream(scratch.device)), 20)
    print(f"  key table [{R}, {L + 1}, {T}] ({tensor_bytes(keys)} bytes): "
          f"kernel {kt_ms:.4f} ms (CUDA events, mean of 20), plain version "
          f"on the card {kt_plain_ms:.2f} ms (one call), built on the CPU "
          f"and copied {kt_host_ms:.2f} ms of wall (one call), bound "
          f"{kb['bound_ms']:.5f} ms by {kb['bound_by']} ({blocks} threefry "
          f"blocks; a warp a (round, step) makes "
          f"{R * (L + 1) * (2 + T)}); the empty launch of its grid "
          f"{floor_ms:.4f} ms")
    walk_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                "library_ms": None,
                "trials_per_step": trials / max(steps, 1),
                "warp_slowest_total_mean": float(warp_total.float().mean()),
                "warp_step_max_sum_mean":
                    counts["step_warp_max"] / warp_total.numel(),
                "draws": draws, "draws_with_u_acc_always": draws_all}
    keys_row = {"max_abs_err": keys_err, "ms": kt_ms, "plain_ms": kt_plain_ms,
                **kb, "library_ms": None, "host_built_ms": kt_host_ms,
                "launch_floor_ms": floor_ms}
    return walk_row, keys_row


def trainer_kernels() -> dict:
    """The kernels a trainer epoch launches, by name."""
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL
    from stellar_rw_tpu_torch.ops.sgns_conv import (SGNS_CONV_ACCUMULATE,
                                                    SGNS_CONV_SCATTER)
    from stellar_rw_tpu_torch.ops.sgns_exact import SGNS_EXACT_STEP
    from stellar_rw_tpu_torch.ops.trainer_draws import TRAINER_DRAWS_KERNEL

    return {"trainer_draws": TRAINER_DRAWS_KERNEL,
            "sgns_conv_accumulate": SGNS_CONV_ACCUMULATE,
            "sgns_shared_grads": SGNS_KERNEL,
            "sgns_conv_scatter": SGNS_CONV_SCATTER,
            "sgns_exact_step": SGNS_EXACT_STEP}


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
                 "sgns_shared_grads", "sgns_conv_scatter"):
        check(trainer[name] > 0, f"{name} was not launched by the conv "
              f"trainer: {trainer}")
    check(trainer["sgns_exact_step"] == 0,
          f"the exact step's kernel ran in the conv trainer: {trainer}")
    check(per_block <= 3.01, f"{per_block:.4f} calls a block: {trainer}")
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
          f"{trainer} = {per_block:.4f} kernel calls a block (<= 3.01; "
          f"sgns_shared_grads is two kernels); invariants "
          f"{report['invariants']} [{smi}]")
    return {"walk": walk_kernel.launches,
            "trial_keys": keys_kernel.launches, **trainer,
            "train_seconds": report["train_seconds"], "blocks": blocks,
            "launches_a_block": per_block, "out": out, "edges": edges,
            "peak_device_bytes": report["peak_device_bytes"]}


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
    128 --dim 768` on karate through the CLI (the shared-negative kernel's
    split form) and the same gate; the labeled synthetic graph's micro-F1
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


def threshold_hubs(n: int):
    """Hub 0 joined to leaves 2 .. n + 1 (a row of n entries) and hub 1 to
    leaves 2 .. n (n - 1 entries), weights 0.25 to 4.25."""
    from stellar_rw_tpu_torch.graph.csr import from_edge_arrays

    rng = np.random.default_rng(n)
    src = np.concatenate([np.zeros(n, np.int64), np.ones(n - 1, np.int64)])
    dst = np.concatenate([np.arange(2, n + 2), np.arange(2, n + 1)])
    return from_edge_arrays(src, dst,
                            rng.random(len(src)).astype(np.float32) * 4
                            + 0.25, num_vertices=n + 2, symmetrize=True)


def twin_hubs(leaves: int, arcs: int, bridge: int, seed: int):
    """Hubs 0 and 1, joined to each other by `bridge` arcs and each by
    `arcs` arcs to leaves drawn with repetition from `leaves` (multi-arcs):
    two rows of arcs + bridge entries, a hub's step to the other common,
    weights 0.25 to 4.25."""
    from stellar_rw_tpu_torch.graph.csr import from_edge_arrays

    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(bridge, np.int64),
                          np.repeat([0, 1], arcs)])
    dst = np.concatenate([np.ones(bridge, np.int64),
                          rng.integers(2, leaves + 2, 2 * arcs)])
    return from_edge_arrays(src, dst,
                            rng.random(len(src)).astype(np.float32) * 4
                            + 0.25, num_vertices=leaves + 2, symmetrize=True)


def cdf_gate_graphs() -> dict:
    """Phase 9's graphs at the edges of K7's bitmap gate: V at the limit
    (BITMAP_WORDS words) and one past it, a row at BITMAP_MIN_ENTRIES
    entries and one entry short, and two hubs of 50,000 arcs joined to each
    other (a hub as cur and as prev, its bitmap cleared word by word)."""
    from stellar_rw_tpu_torch.ops import cdf_walk

    lim, thr = cdf_walk.BITMAP_WORDS * 32, cdf_walk.BITMAP_MIN_ENTRIES
    return {f"star, V {lim} (the limit)": star_graph(lim - 1),
            f"star, V {lim + 1}": star_graph(lim),
            f"hubs of {thr} and {thr - 1} entries": threshold_hubs(thr),
            "twin hubs of 50,000 arcs": twin_hubs(20_000, 50_000, 5_000,
                                                  seed=5)}


def cdf_branches(torch, dg, starts, key, ro, R, L, p, q, md, chunk, dtype,
                 want):
    """K7's recording form on the inputs of a corpus `want`: the branch
    each second-order step took, as the kernel wrote it. Fails unless its
    corpus is `want` and every step took the branch that the gate's mirror
    (cdf_walk.step_branches) gives it."""
    from stellar_rw_tpu_torch.ops import cdf_walk

    branches = torch.empty(want.shape, dtype=torch.uint8, device="cuda")
    got = cdf_walk.cdf_walk_rounds(dg, starts, key, ro, R, L, p, q, md,
                                   chunk, dtype, branches=branches)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "the recording form of the cdf walk "
          "kernel walks another corpus")
    mirror = cdf_walk.step_branches(dg.vmeta, want, md, chunk)
    check(torch.equal(branches, mirror),
          f"the cdf walk kernel's branches differ from the gate's mirror at "
          f"{int((branches != mirror).sum())} steps")
    return branches


def cdf_branch_split(branches, corpus, vmeta) -> dict:
    """K7's second-order steps by the branch the kernel recorded for each
    (cdf_branches): steps and row entries by the bitmap and by prev's
    bucket rows, the first-order entries, and the steps whose cur or prev
    is vertex 0 or 1 (phase 9's hubs)."""
    from stellar_rw_tpu_torch.ops import cdf_walk

    cur, prev = corpus[:, 1:-1].clamp_min(0), corpus[:, :-2].clamp_min(0)
    on = branches[:, 2:] == cdf_walk.BY_BITMAP
    off = branches[:, 2:] == cdf_walk.BY_BUCKETS
    d = vmeta[cur.long(), 1].long()
    first = vmeta[corpus[:, 0].long(), 1].long() * (corpus[:, 1] >= 0)
    return {"second_order_steps": int((corpus[:, 2:] >= 0).sum()),
            "bitmap_steps": int(on.sum()),
            "bitmap_entries": int((d * on).sum()),
            "bucket_steps": int(off.sum()),
            "bucket_entries": int((d * off).sum()),
            "first_order_entries": int(first.sum()),
            "bitmap_at_hub": [int((on & (cur == h)).sum()) for h in (0, 1)],
            "steps_at_hub": [int(((on | off) & (cur == h)).sum())
                             for h in (0, 1)],
            "bitmap_hub_prev": int((on & (prev <= 1) & (cur <= 1)).sum())}


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
        if chunk:
            # the recording form: the same corpus, the gate's branches
            return got, dg, cdf_branches(torch, dg, st, key, ro, R, L, p, q,
                                         md, chunk, dtype, got)
        return got, dg, None

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
    # the bitmap gate's edges, chunked (the bitmap's form), f32 and f64,
    # round offsets 0 and 3: walkers from both hubs and from leaves; the
    # branches as the kernel's recording form wrote them
    gates = {}
    for name, g in cdf_gate_graphs().items():
        V = g.num_vertices
        starts = np.concatenate([[0, 1], np.arange(2, V, max(V // 40, 1))
                                 ]).astype(np.int32)
        words = cdf_walk.bitmap_words(V, sampling.CDF_CHUNK)
        for dtype, ro in (("float32", 0), ("float64", 3)):
            got, dg, branches = held(name, g, starts, 2, 6, 0.0625, 4.0,
                                     sampling.CDF_CHUNK, dtype, ro)
            n += 1
            gates[f"{name} {dtype}"] = split = {
                "words": words, **cdf_branch_split(branches, got, dg.vmeta)}
            if name.startswith("star, V"):
                at_limit = V <= 32 * cdf_walk.BITMAP_WORDS
                check((words > 0) == at_limit
                      and (split["bitmap_at_hub"][0] > 0) == at_limit,
                      f"{name}: the bitmap at V {V}: {split}")
            elif name.startswith("hubs of"):
                check(split["bitmap_at_hub"][0] > 0
                      and split["bitmap_at_hub"][1] == 0
                      and split["steps_at_hub"][1] > 0,
                      f"{name}: the row at the threshold takes the bitmap, "
                      f"the one short of it not: {split}")
            else:
                check(split["bitmap_hub_prev"] > 0,
                      f"{name}: no hub-to-hub step took the bitmap: {split}")
    print(f"phase 9 cdf walk kernel: bitwise equal to cdf_walk_ref on the "
          f"card in {n} cases ({list(graphs)}; padded and chunked, f32 and "
          f"f64, (p, q) in {pqs}, L in (0, 1, 4, 6, 7, 9, 13, 20), W in (1, 3, "
          f"37, 51, 1001, |V|), round offsets 0-5; star50k's hub row is "
          f"50,000 entries), walk invariants zero on each; the chunked "
          f"cases' branches as the recording form wrote them equal to the "
          f"gate's mirror; at the bitmap gate's edges (words, second-order "
          f"steps by the bitmap as the kernel recorded them, at hub 0 / 1, "
          f"hub to hub): " + "; ".join(
              f"{k}: {v['words']}, {v['bitmap_steps']} of "
              f"{v['second_order_steps']}, {v['bitmap_at_hub']}, "
              f"{v['bitmap_hub_prev']}" for k, v in gates.items()))
    return n


def phase_cdf_main(torch, kernel, smi, tmp, edges, probe) -> dict:
    """Phase 10: `--cmd randomwalk --p 0.0625 --q 4` through the CLI on
    phase 4's graph (plan_sampler: exact CDF, chunked at this corpus size),
    the first 4,096 walkers of round 0 against the plain version, and a
    run with walk-round checkpoints cut at 4 rounds and resumed. Beside the
    kernel's time: its bound, the row-stream probe's floor (`probe`,
    chip_cdf_probe.cu, on the same corpus), ptxas' registers, and the
    second-order steps that took the bitmap and the bucket rows, as the
    kernel's recording form wrote them on the same inputs."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.ops import cdf_walk, prng, sampling
    from stellar_rw_tpu_torch.utils.config import parse
    from stellar_rw_tpu_torch.walk import engine

    out = os.path.join(tmp, CDF_OUT)
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
    branches = cdf_branches(torch, dg, torch.arange(V, dtype=torch.int32,
                                                    device="cuda"),
                            key, 0, R, L, p, q, spec.max_degree,
                            spec.cdf_chunk, "float32", corpus)
    split = cdf_branch_split(branches, corpus, dg.vmeta)
    check(split["bitmap_steps"] + split["bucket_steps"]
          == split["second_order_steps"]
          and split["bitmap_entries"] + split["bucket_entries"]
          + split["first_order_entries"] == scanned,
          f"the recorded branches do not cover the corpus's steps: {split}")
    nbytes = tensor_bytes(dg.vmeta, dg.cdf_rows, dg.hash_buckets, corpus)
    b = bound(nbytes, cdf_scan_ops(scanned, split["bitmap_entries"]),
              INT_OPS_PER_S)
    # the count of PRs 5-22: every entry at OPS_PER_ENTRY
    b12 = bound(nbytes, scanned * OPS_PER_ENTRY, INT_OPS_PER_S)
    from stellar_rw_tpu_torch.ops._build import ptr, stream

    sums = torch.empty(corpus.shape[0], dtype=torch.int32, device="cuda")
    probe_ms = cuda_ms(lambda: probe.launch(
        ptr(corpus), ptr(dg.vmeta), ptr(dg.cdf_rows), ptr(sums),
        corpus.shape[0], L, stream(corpus.device)), 3)
    regs = cdf_registers(kernel.build_log)
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
        path = a.read()
        check(path == c.read(), "the resumed walk-round checkpoint run "
              "differs from the uninterrupted one")
    digest = hashlib.sha256(path).hexdigest()
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
          f"{plain_ms:.0f} ms (one call), bitwise equal; second-order "
          f"steps as the kernel's recording form took them (each the "
          f"gate's branch): by the bitmap {split['bitmap_steps']:,} "
          f"({split['bitmap_entries']:,} entries), by prev's bucket rows "
          f"{split['bucket_steps']:,} ({split['bucket_entries']:,} "
          f"entries), first-order entries "
          f"{split['first_order_entries']:,}; bound {b['bound_ms']:.3f} ms "
          f"by {b['bound_by']} (bitmap entries x {OPS_PER_BITMAP_ENTRY}, "
          f"the others x {OPS_PER_ENTRY}; every entry x {OPS_PER_ENTRY}, "
          f"the count of PRs 5-22: {b12['bound_ms']:.3f} ms); the "
          f"row-stream probe (rows read in the kernel's order, no "
          f"weighing) {probe_ms:.2f} ms; registers {regs}; "
          f"--checkpointEvery 2 cut at 4 "
          f"rounds and resumed: /path byte-equal; /path sha256 {digest} "
          f"[{smi}]")
    # ms and the bound: the whole corpus; plain_ms: the first 4,096
    # walkers of round 0 (the whole corpus would take the plain version
    # minutes), beside the kernel's time on them
    return {"launches": launches, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, **b, "library_ms": None,
            "plain_scope": f"first {n_chk} walkers of round 0",
            "kernel_ms_same_scope": ms_sub,
            "entries_scanned": scanned, "entries_scanned_same_scope":
                scanned_in(want), "steps": steps,
            "bound_ms_every_entry_at_12": b12["bound_ms"],
            **{k: split[k] for k in ("bitmap_steps", "bitmap_entries",
                                     "bucket_steps", "bucket_entries",
                                     "first_order_entries")},
            "probe_ms": probe_ms, "registers": regs, "path_sha256": digest,
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


def workspace_empty(torch, ws) -> bool:
    """Whether an exact-step Workspace is as a step must leave it: delta
    slots and their counts 0, every map entry -1, the counts 0."""
    torch.cuda.synchronize()
    return (all(not bool(t.any()) for t in (*ws.d, *ws.cnt, ws.counts))
            and all(bool((m == -1).all()) for m in ws.map))


def phase_exact_check(torch) -> dict:
    """Phase 11: sgns_exact_step's kernel against the plain step (in
    float64) on blocks of the main shape (Zipf tokens at D = 128, ragged
    D = 100, D = 768 above one register slice, one token alone), and on
    small ragged ones, its workspace empty after every step; the kernel's
    time against the plain step, the tables' hit rate and flushes at the
    main shape."""
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
        ws = se.Workspace(b_in, b_out, B * T, win, k)
        se.sgns_exact_step(b_in, b_out, block, cwin, negs, lr, win, ws)
        check(workspace_empty(torch, ws),
              f"sgns_exact_step left its workspace dirty at {shapes[i]}")
        for got, want, plain, old in ((b_in, a_in, p_in, w_in),
                                      (b_out, a_out, p_out, w_out)):
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6),
                  f"sgns_exact_step differs from the plain step in float64 "
                  f"at {shapes[i]}: max abs err "
                  f"{float((got.double() - want).abs().max()):.3g}")
            check(bool((got != old).any()), "the step moved nothing")
            err = max(err, float((got.double() - want).abs().max()))
            f32_err = max(f32_err, float((plain.double() - want).abs().max()))
    # the main shape: the kernel timed by events around its own launches
    V, B, T, win, k, D, _ = main
    w_in, w_out, block, cwin, negs = exact_block(torch, V, B, T, win, k, D)
    ws = se.Workspace(w_in, w_out, B * T, win, k)
    plan = se.launch_plan(D, B, T, win, k, torch.cuda.get_device_properties(
        0).multi_processor_count)
    launch = lambda: se.launch_step(ws, w_in, w_out, block, cwin, negs, win,
                                    lr)
    step = lambda: se.sgns_exact_step(w_in, w_out, block, cwin, negs, lr, win,
                                      ws)
    plain = lambda: se.sgns_exact_step_ref(w_in, w_out, block, cwin, negs,
                                           lr, win)
    iters = 20
    (k_ms,) = cuda_ms_split((launch,), iters)
    runs = [cuda_ms(f, 5) for f in (plain, step, step, plain)]
    stats = torch.zeros(3, dtype=torch.int32, device="cuda")
    se.launch_step(ws, w_in, w_out, block, cwin, negs, win, lr, stats=stats)
    check(workspace_empty(torch, ws), "sgns_exact_step left its workspace "
          "dirty after the timed steps")
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
    # the step reads the block's draws and the touched rows of both tables
    # and writes those rows; 2*D flops a logit, a center-gradient and a
    # target-gradient row for each of P*(1+k) targets, 3 a touched row's
    # column to update it
    in_bytes = tensor_bytes(block, cwin, negs)
    step_b = bound(in_bytes + (rows_in + rows_out) * D * 4 * 2,
                   2 * P * (1 + k) * D * 3 + (rows_in + rows_out) * D * 3,
                   F32_FLOPS)
    plain_ms = (runs[0] + runs[3]) / 2
    print(f"phase 11 sgns_exact_step: within rtol 1e-5 atol 1e-6 of the "
          f"plain step computed in float64 at {shapes} (V, B, T, w, k, D, "
          f"tokens), max abs err {err:.3g} (the plain step in float32: "
          f"{f32_err:.3g}), the workspace empty after every step; at the "
          f"main shape (B {B}, T {T}, w {win}, k {k}, D {D}, V {V}: {P} "
          f"valid pairs, {rows_in} + {rows_out} rows touched; plan "
          f"{plan._asdict()}, one cooperative launch) the kernel {k_ms:.4f} "
          f"ms (CUDA events around each launch, mean of {iters}), through "
          f"the wrapper {(runs[1] + runs[2]) / 2:.4f} ms, plain step "
          f"{plain_ms:.3f} ms (mean of 2x5); row adds into the blocks' "
          f"tables {in_table} of {in_table + in_device} "
          f"({in_table / max(in_table + in_device, 1):.4f}), slots flushed "
          f"{flushed} = {flushed / plan.blocks:.1f} a block; scratch "
          f"{ws.nbytes:,} B; bound {step_b['bound_ms']:.5f} ms by "
          f"{step_b['bound_by']}")
    return {"ms": k_ms, **step_b, "max_abs_err": err,
            "plain_f32_max_abs_err": f32_err, "plain_ms": plain_ms,
            "library_ms": None, "valid_pairs": P,
            "rows_touched": rows_in + rows_out,
            "wrapper_ms": (runs[1] + runs[2]) / 2, "table_adds": in_table,
            "device_adds": in_device,
            "flushes_a_block": flushed / plan.blocks}


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
    check(trainer["trainer_draws"] > 0 and trainer["sgns_exact_step"] ==
          blocks, f"the exact trainer's launches over {blocks} blocks: "
          f"{trainer}")
    check(trainer["sgns_conv_accumulate"] == 0,
          f"the conv step ran in the exact trainer: {trainer}")
    check(per_block <= 1.07, f"{per_block:.4f} stream operations a block: "
          f"{trainer}")
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
    # the reference fixture's gate (tests/test_word2vec.py)
    auc, acc = karate_gate(kw_in, g)
    check(auc > 0.75 and acc >= 0.90,
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
          f"{blocks} blocks; launches {trainer} = {per_block:.4f} stream "
          f"operations a block (one sgns_exact_step launch a block, no "
          f"memset, no apply kernel; one draws launch a chunk); karate gate "
          f"with exact negatives on the card: AUC "
          f"{auc:.4f} (> 0.75), faction accuracy {acc:.4f} (>= 0.90); --dim "
          f"768 through the CLI: AUC {auc768:.4f}, faction accuracy "
          f"{acc768:.4f} [{smi}]")
    return {**trainer, "train_seconds": report["train_seconds"],
            "blocks": blocks, "launches_a_block": per_block,
            "peak_device_bytes": report["peak_device_bytes"]}


def draw_tables(torch, V: int, seed: int):
    """A skewed unigram alias table on the card (keep f32, alias i32)."""
    from stellar_rw_tpu_torch.ops.alias import build_alias

    rng = np.random.default_rng(seed)
    keep, alias = build_alias(rng.random(V) ** 4 * 100 + 1e-3)
    return (torch.as_tensor(keep, dtype=torch.float32).cuda(),
            torch.as_tensor(alias, dtype=torch.int32).cuda())


def phase_draws_check(torch, smi, probe) -> dict:
    """Phase 13: the trainer's draws kernel bit for bit against
    trainer_draws_ref on the card (DRAW_CASES), then timed on the main
    path's chunks: the conv trainer's (1,524 blocks of 128 negatives and
    2,624 windows) and the exact trainer's (15 blocks of 262,400 negatives
    and 2,624 windows), beside the time the probe's rate gives the same
    threefry blocks."""
    from stellar_rw_tpu_torch.models.word2vec import _DRAW_BUDGET
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import trainer_draws as td

    key = prng.fold_in(prng.prng_key(1), 0).cuda()
    elements = 0
    for i, (B, T, w, k, kB, V, c0, n) in enumerate(DRAW_CASES):
        # kB 0: the HS trainer's draws, windows alone and no alias table
        keep, alias = draw_tables(torch, V, i) if V else (None, None)
        shape = (kB,) if kB is not None else (B * T * 2 * w, k)
        got = td.trainer_draws(key, c0, n, B, T, w, shape, keep, alias)
        want = td.trainer_draws_ref(key, c0, n, B, T, w, shape, keep, alias)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("cwin", "negs")):
            check(a.dtype == b.dtype == torch.int32 and torch.equal(a, b),
                  f"trainer_draws' {what} differ from trainer_draws_ref at "
                  f"{DRAW_CASES[i]}")
        elements += got[0].numel() + got[1].numel()
    rates = probe_rates(torch, probe)
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
                      "draws": draws, "probe_ms": {
                          label: draws / rate * 1e3
                          for label, rate in rates.items()}}
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
          f"events, mean of 2x3); the probe (threefry blocks with no memory "
          f"traffic) {', '.join(f'{l} {r:.4g}/s' for l, r in rates.items())}"
          f": the chunks' blocks at the block_fn rate "
          f"{c['probe_ms']['block_fn']:.4f} / "
          f"{e['probe_ms']['block_fn']:.4f} ms [{smi}]")
    return {"max_abs_err": 0, **{k: c[k] for k in ("ms", "plain_ms",
                                                    "bound_ms", "bound_by")},
            "library_ms": None, "chunk_blocks": c["blocks"],
            "probe_blocks_per_s": rates, "probe_ms": c["probe_ms"],
            "exact_chunk": e}


def conv_block(torch, V, B, T, window, kB, D, seed, tokens):
    """One conv block: Zipf tokens (rows collide), one token alone ("hub";
    "hub negatives": every negative that token too), one token at every
    other position between Zipf tokens ("every other"), or Zipf walks that
    end early ("padded": ragged ends, one walk all padding, a gap inside a
    walk); the trainer's window and negative draws (the block's unigram
    table); random tables."""
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import trainer_draws as td
    from stellar_rw_tpu_torch.ops.alias import build_alias

    rng = np.random.default_rng(seed)
    u = (np.zeros((B, T)) if tokens.startswith("hub")
         else rng.random((B, T)) ** (1 / 0.3))
    block = np.minimum((V * u).astype(np.int32), V - 1)
    if tokens == "every other":
        block[:, ::2] = 0
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
    if tokens == "hub negatives":
        negs[0].fill_(int(block[0, 0]))
    w = lambda: torch.as_tensor((rng.standard_normal((V, D)) * 0.3)
                                .astype(np.float32)).cuda()
    return w(), w(), torch.as_tensor(block).cuda(), cwin[0], negs[0]


def phase_conv_check(torch, smi) -> tuple[dict, dict]:
    """Phase 14: the conv step's kernels against the plain step in float32
    and in float64 (CONV_SHAPES), two steps on one workspace against two
    plain steps, each kernel's time at the main shape (the accumulate kernel
    by tile), and the grouping of a corpus of the main path's size."""
    from stellar_rw_tpu_torch.ops import sgns_conv as sc

    lr = 0.025
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = k64_err = f32_err = 0.0
    loose = []   # (shape, table, error) where the plain f32 step is off
    plans = {}   # block shape -> (tile, tiles, cols, slices)
    for i, (V, B, T, win, kB, D, tokens) in enumerate(CONV_SHAPES):
        w_in, w_out, block, cwin, negs = conv_block(torch, V, B, T, win, kB,
                                                    D, i, tokens)
        nw = 5 / kB
        a_in, a_out = w_in.double(), w_out.double()
        sc.sgns_conv_step_ref(a_in, a_out, block, cwin, negs, lr, nw, win)
        p_in, p_out = w_in.clone(), w_out.clone()
        sc.sgns_conv_step_ref(p_in, p_out, block, cwin, negs, lr, nw, win)
        plan = sc.launch_plan(B, T, D, win, sms)
        plans[str(CONV_SHAPES[i])] = [plan.tile, plan.tiles, plan.cols,
                                      plan.slices]
        b_in, b_out = w_in.clone(), w_out.clone()
        sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw, win)
        torch.cuda.synchronize()
        at = str(CONV_SHAPES[i])
        for table, got, want, plain, old in (
                ("w_in", b_in, a_in, p_in, w_in),
                ("w_out", b_out, a_out, p_out, w_out)):
            k_err = float((got.double() - want).abs().max())
            p_err = float((plain.double() - want).abs().max())
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6),
                  f"the conv step differs from the float64 step at {at} "
                  f"({table}): max abs err {k_err:.3g}")
            check(k_err <= p_err, f"the conv step is {k_err:.3g} off the "
                  f"float64 step at {at} ({table}), the plain f32 step "
                  f"{p_err:.3g}")
            # the plain f32 step is the reference at that tolerance where it
            # is itself within it of the float64 step: on one token alone
            # its atomics add 2,624 equal per-position shares into one row
            if torch.allclose(plain.double(), want, rtol=1e-5, atol=1e-6):
                check(torch.allclose(got, plain, rtol=1e-5, atol=1e-6),
                      f"the conv step differs from the plain f32 step at "
                      f"{at} ({table}): max abs err "
                      f"{float((got - plain).abs().max()):.3g}")
                err = max(err, float((got - plain).abs().max()))
            else:
                loose.append((CONV_SHAPES[i], table, p_err))
            check(bool((got != old).any()), "the step moved nothing")
            k64_err = max(k64_err, k_err)
            f32_err = max(f32_err, p_err)
    # the main shape: two steps on one workspace with the corpus grouping
    # the trainer makes, then each kernel timed
    V, B, T, win, kB, D, _ = CONV_SHAPES[0]
    nw = 5 / kB
    w_in, w_out, block, cwin, negs = conv_block(torch, V, B, T, win, kB, D,
                                                0, "zipf")
    ws = sc.ConvWorkspace(w_in, w_out, B, T, win, kB)
    g = sc.group_blocks(block[None])
    groups = (g.order[0], g.units[0])
    p_in, p_out = w_in.clone(), w_out.clone()
    b_in, b_out = w_in.clone(), w_out.clone()
    for _ in range(2):
        sc.sgns_conv_step_ref(p_in, p_out, block, cwin, negs, lr, nw, win)
        sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw, win, ws,
                          groups)
    torch.cuda.synchronize()
    check(torch.allclose(b_in, p_in, rtol=1e-5, atol=1e-6)
          and torch.allclose(b_out, p_out, rtol=1e-5, atol=1e-6),
          "two conv steps on one workspace differ from two plain steps")
    acc = lambda: sc.launch_accumulate(ws, b_in, b_out, block, cwin, negs,
                                       win, nw)
    k6 = lambda: sc.launch_negative_half(ws)
    scat = lambda: sc.launch_scatter(ws, b_in, b_out, block, *groups, negs,
                                     nw, lr)
    iters = 20
    a_ms, k_ms, s_ms = cuda_ms_split((acc, k6, scat), iters)
    back = {"accumulate": cuda_ms(acc, iters),
            "sgns_shared_grads": cuda_ms(k6, iters),
            "scatter": cuda_ms(scat, iters)}
    step = lambda: sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw,
                                     win, ws, groups)
    plain = lambda: sc.sgns_conv_step_ref(p_in, p_out, block, cwin, negs,
                                          lr, nw, win)
    runs = [cuda_ms(f, 5) for f in (plain, step, step, plain)]
    # the accumulate kernel under each tile launch_plan could take
    by_tile = {}
    for t in sc.TILES + (4,):
        wt = sc.ConvWorkspace(w_in, w_out, B, T, win, kB, tiles=(t,))
        by_tile[t] = cuda_ms(lambda: sc.launch_accumulate(
            wt, w_in, w_out, block, cwin, negs, win, nw), 20)
    # the grouping, once a run: a corpus of the main path's blocks
    n_blocks = 3125
    rng = np.random.default_rng(1)
    corpus = torch.as_tensor(np.minimum(
        (V * rng.random((n_blocks, B, T)) ** (1 / 0.3)).astype(np.int32),
        V - 1)).cuda()
    group_ms = [cuda_ms_once(lambda: sc.group_blocks(corpus))[1]
                for _ in range(2)]
    del corpus
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
    # read once (the least the function needs; the kernel reads a halo), ein /
    # acc_in / acc_out / mask / counts / wn written; a dot of 2D flops a
    # valid pair, a multiply-add an element on each side
    acc_b = bound(tensor_bytes(block, cwin, negs) + 2 * U * row
                  + kB * row * 2 + 3 * N * row + 3 * N * 4,
                  P * 6 * D, F32_FLOPS)
    # scatter-update: d_in, acc_out, the counts, the grouping and the block
    # read; the touched rows of both tables read and written; the
    # negatives' rows read, added and written
    scat_b = bound(2 * N * row + 5 * N * 4 + (U_in + U_out) * row * 2
                   + kB * row * 3, (2 * N + kB) * D, F32_FLOPS)
    plan = ws.plan
    print(f"phase 14 the conv step: within rtol 1e-5 atol 1e-6 of the "
          f"float64 step and no farther from it than the plain f32 step at "
          f"{CONV_SHAPES} (V, B, T, w, kB, D, tokens): max abs err against "
          f"the float64 step {k64_err:.3g}, the plain f32 step's "
          f"{f32_err:.3g}; within rtol 1e-5 atol 1e-6 of the plain f32 step "
          f"(max abs err {err:.3g}) wherever that step is within it of the "
          f"float64 step, which it is not at {loose}; plans (tile, tiles, "
          f"cols, slices) {plans}; two "
          f"steps on one workspace held; at the main shape "
          f"({P} valid pairs, {U} distinct rows, {U_in} + {U_out} touched; "
          f"plan {plan._asdict()}) accumulate {a_ms:.4f} ms, "
          f"sgns_shared_grads {k_ms:.4f} ms, scatter-update {s_ms:.4f} ms "
          f"(CUDA events around each launch, mean of {iters}); back to back "
          f"{back} (mean of {iters}); accumulate by tile {by_tile} (mean "
          f"of 20 back to back); the step through its "
          f"wrapper {(runs[1] + runs[2]) / 2:.4f} ms, the plain step "
          f"{(runs[0] + runs[3]) / 2:.3f} ms (mean of 2x5); bounds "
          f"{acc_b['bound_ms']:.5f} ms by {acc_b['bound_by']} / "
          f"{scat_b['bound_ms']:.5f} ms by {scat_b['bound_by']}; the "
          f"grouping of {n_blocks} blocks {group_ms[0]:.3f} ms once a run "
          f"(again: {group_ms[1]:.3f} ms) "
          f"[{smi}]")
    common = {"max_abs_err": err, "max_abs_err_f64": k64_err,
              "plain_f32_off_f64": f32_err,
              "plain_ms": (runs[0] + runs[3]) / 2, "library_ms": None,
              "step_ms": (runs[1] + runs[2]) / 2,
              "sgns_shared_grads_ms": k_ms, "valid_pairs": P}
    return ({"ms": a_ms, "ms_back_to_back": back["accumulate"], **acc_b,
             **common, "accumulate_ms_by_tile": by_tile,
             "plan": plan._asdict()},
            {"ms": s_ms, "ms_back_to_back": back["scatter"], **scat_b,
             **common, "includes": "the update (no apply kernel)",
             "grouping_ms_once_a_run": group_ms[0]})


def reset_counts(*kernels) -> None:
    for k in kernels:
        k.launches = 0


def same_path(a: str, b: str) -> bool:
    return filecmp.cmp(os.path.join(a, "path", "part-00000"),
                       os.path.join(b, "path", "part-00000"), shallow=False)


def peak_bytes(torch, fn) -> int:
    """The device bytes fn() holds at its peak above what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def phase_streaming(torch, path_kernels: dict, smi, tmp, main_run) -> dict:
    """Phase 15: `node2vec --streaming true` through the CLI on phase 4's
    graph, conv (kB 128) and exact, one epoch each: /path byte for byte
    phase 4's, every round walked once in the pre-pass and once an epoch,
    the launches of every kernel in path_kernels (name -> wrapper: all nine,
    so the kernels line reads each one's count from these runs), the
    trainer's calls a block, the grouping's ms a round, and the job's peak
    device memory against the stored run's (both without --validate), at
    most a quarter of it for each trainer; then the labeled-synthetic
    micro-F1 gate on a streamed run."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import datasets
    from stellar_rw_tpu_torch.models import eval as ev
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL
    from stellar_rw_tpu_torch.ops.sgns_conv import ConvWorkspace, group_blocks
    from stellar_rw_tpu_torch.ops.sgns_exact import Workspace
    from stellar_rw_tpu_torch.utils.config import parse

    edges = main_run["edges"]
    params = parse(["--input", edges, "--output", tmp] + STREAM_FLAGS)
    graph, _ = cli._load_graph(params)
    V, R, D = graph.num_vertices, params.num_walks, params.w2v_dim
    dg = cli._device_graph(graph, params, torch.device("cuda"))
    # what a run holds whatever its corpus, taken off both runs' peaks: the
    # graph's tables (the stored run frees them before it trains), the two
    # embedding tables, the trainer's step workspace, and the draws of as
    # many blocks as both runs draw at once (_train_epoch's chunk, at most
    # _DRAW_BUDGET elements: 15 exact blocks in either run; 313 conv blocks,
    # a round, streamed, so the stored run's larger chunk stays counted)
    cfg = n2v.sgns_config(params)
    B, T = cfg.row_block, params.walk_length + 2
    w_in = torch.zeros((V, D), device="cuda")
    w_out = torch.zeros_like(w_in)
    fixed = {}
    for name, kB in (("conv", cfg.shared_negatives), ("exact", 0)):
        ws = peak_bytes(torch, lambda: ConvWorkspace(
            w_in, w_out, B, T, cfg.window, kB) if kB else Workspace(
            w_in, w_out, B * T, cfg.window, cfg.negatives))
        per_block = (kB or B * T * 2 * cfg.window * cfg.negatives) + B * T
        chunk = min(max(1, min(n, w2v._DRAW_BUDGET // per_block))
                    for n in (-(-R * V // B), -(-V // B)))
        fixed[name] = (tensor_bytes(*[t for t in dg if t is not None])
                       + 2 * V * D * 4 + ws + 4 * per_block * chunk)
    del w_in, w_out
    # the conv trainer groups each round's blocks when it trains the round
    make_round, _ = n2v._round_maker(graph, params, "cuda", dg)

    def as_blocks(rows):   # the trainer's blocks of 32 rows, -1 padded
        n = -(-rows.shape[0] // 32)
        out = torch.full((n * 32, rows.shape[1]), -1, dtype=torch.int32,
                         device="cuda")
        out[:rows.shape[0]] = rows
        return out.view(n, 32, -1)

    blocks = as_blocks(make_round(0))
    n_blocks = blocks.shape[0]
    group_ms = cuda_ms(lambda: group_blocks(blocks), 20)
    init_key = prng.fold_in(prng.prng_key(0, "cuda"), 0x1A17)
    w2v._init_embeddings(V, D, init_key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):   # host wall: the init is issued a run at a time
        w2v._init_embeddings(V, D, init_key)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3 / 5
    # the two paths' transients, each alone: the grouping of a round and of
    # the whole corpus (3,125 blocks, _GROUP_POSITIONS positions a sort), and
    # the seeded init of the input table (a run of rows at a time)
    corpus = as_blocks(torch.cat([make_round(r) for r in range(R)]))
    transient = {
        "group_round": peak_bytes(torch, lambda: group_blocks(blocks)),
        "group_corpus": peak_bytes(torch, lambda: group_blocks(corpus)),
        "init": peak_bytes(torch, lambda: w2v._init_embeddings(
            V, D, init_key))}
    del dg, make_round, blocks, corpus
    trainer = trainer_kernels()
    runs = {}
    for name, flags in (("conv", STREAM_FLAGS), ("exact", STREAM_EXACT_FLAGS)):
        for mode in ("stored", "streamed"):
            out = os.path.join(tmp, f"out_{mode}_{name}")
            report = {}
            reset_counts(*path_kernels.values())
            rc = cli.main(["--input", edges, "--output", out] + flags
                          + (["--streaming", "true"] if mode == "streamed"
                             else []), report=report)
            torch.cuda.synchronize()
            check(rc == 0, f"{mode} {name} run: cli.main returned {rc}")
            check(same_path(main_run["out"], out),
                  f"{mode} {name} /path differs from phase 4's")
            _, w_in, w_out = n2v.load_model(out)
            check(w_in.shape == (V, D) and np.isfinite(w_in).all()
                  and np.isfinite(w_out).all(),
                  f"{mode} {name} embeddings not finite or misshapen")
            runs[name, mode] = {
                **{k: t.launches for k, t in path_kernels.items()},
                "walk_seconds": report["walk_seconds"],
                "train_seconds": report["train_seconds"],
                "peak_bytes": report["peak_device_bytes"],
                "corpus_bytes": report["peak_device_bytes"] - fixed[name]}
    blocks = R * n_blocks
    for name, most in (("conv", 3.01), ("exact", 1.07)):
        run = runs[name, "streamed"]
        check(run["walk"] == 2 * R and run["trial_keys"] == 2 * R,
              f"streamed {name}: each round walked once in the pre-pass and "
              f"once in the epoch, not {run['walk']} / {run['trial_keys']}")
        check(run["cdf_walk"] == 0 and run["resident_walk"] == 0,
              f"streamed {name}: phase 4's sampler is the alias walk: {run}")
        calls = sum(run[k] for k in trainer)
        run["launches_a_block"] = calls / blocks
        check(calls / blocks <= most, f"streamed {name}: "
              f"{calls / blocks:.4f} kernel calls a block: {run}")
    conv, exact = runs["conv", "streamed"], runs["exact", "streamed"]
    for k in ("trainer_draws", "sgns_conv_accumulate", "sgns_shared_grads",
              "sgns_conv_scatter"):
        check(conv[k] > 0, f"{k} was not launched by the streamed conv "
              f"trainer: {conv}")
    check(conv["sgns_conv_accumulate"] == blocks
          and conv["sgns_exact_step"] == 0, f"streamed conv: {conv}")
    check(exact["sgns_exact_step"] == blocks
          and exact["sgns_conv_accumulate"] == 0, f"streamed exact: {exact}")
    ratio = {name: runs[name, "streamed"]["corpus_bytes"]
             / runs[name, "stored"]["corpus_bytes"]
             for name in ("conv", "exact")}
    mb = lambda b: f"{b / 1e6:.1f} MB"
    for name in ("conv", "exact"):
        check(ratio[name] <= 0.25, f"streamed {name}: corpus-dependent peak "
              f"{ratio[name]:.3f} of the stored run's (peaks "
              f"{mb(runs[name, 'streamed']['peak_bytes'])} and "
              f"{mb(runs[name, 'stored']['peak_bytes'])}, less "
              f"{mb(fixed[name])} each)")
    # the labeled synthetic graph's gate (phase 5's settings), streamed
    sg, labels = datasets.synth_labeled_graph(1500, 15_000, communities=6,
                                              seed=7)
    SGNS_KERNEL.launches = 0
    _, s_in, _, _ = n2v.run_node2vec_streaming(
        sg, parse(["--cmd", "node2vec", "--input", "-", "--output",
                   os.path.join(tmp, "out_streamed_synth")] + SYNTH_FLAGS),
        "cuda")
    check(SGNS_KERNEL.launches > 0, "the streamed synthetic run launched no "
          "sgns_shared_grads")
    f1 = ev.multilabel_micro_f1(s_in, labels, train_frac=0.5, seed=0)
    check(f1 > 0.55, f"labeled synthetic gate, streamed: micro-F1 {f1}")
    print(f"phase 15 node2vec --streaming true ({V} V, {R} rounds of {V} "
          f"walks, {blocks} blocks an epoch): /path byte-equal to phase 4's; "
          + "; ".join(
              f"{name}: pre-pass {runs[name, 'streamed']['walk_seconds']:.3f}"
              f" s, epoch {runs[name, 'streamed']['train_seconds']:.3f} s "
              f"(stored {runs[name, 'stored']['train_seconds']:.3f} s), "
              f"{runs[name, 'streamed']['launches_a_block']:.4f} kernel calls "
              f"a block, launches "
              f"{ {k: runs[name, 'streamed'][k] for k in path_kernels} }"
              f", corpus-dependent peak "
              f"{mb(runs[name, 'streamed']['corpus_bytes'])} against stored "
              f"{mb(runs[name, 'stored']['corpus_bytes'])} "
              f"({ratio[name]:.3f}x)" for name in ("conv", "exact"))
          + f"; grouping {group_ms:.4f} ms a round ({n_blocks} blocks); "
          f"the input table's init {init_ms:.4f} ms (host wall); "
          f"fixed { {k: mb(v) for k, v in fixed.items()} } (graph and "
          f"embedding tables, step workspace, shared draw chunk); transient "
          f"peaks "
          f"{ {k: mb(v) for k, v in transient.items()} }; labeled "
          f"synthetic streamed micro-F1 {f1:.4f} (> 0.55) [{smi}]")
    return {"conv": conv, "exact": exact, "group_ms_a_round": group_ms,
            "init_ms": init_ms,
            "memory_ratio": ratio, "micro_f1": f1,
            "transient_bytes": transient, "fixed_bytes": fixed,
            "stored": {n: runs[n, "stored"] for n in ("conv", "exact")}}


# the CUDA symbols of phase 4's kernels and the counter of each one's
# launches (sgns_shared_grads is two kernels: the tiles and their sum)
def profiled_symbols(walk_kernel, keys_kernel) -> dict:
    t = trainer_kernels()
    return {"walk_kernel": walk_kernel, "trial_keys_kernel": keys_kernel,
            "trainer_draws": t["trainer_draws"],
            "sgns_conv_accumulate": t["sgns_conv_accumulate"],
            "sgns_shared_kernel": t["sgns_shared_grads"],
            "reduce_partials": t["sgns_shared_grads"],
            "sgns_conv_scatter": t["sgns_conv_scatter"]}


EPOCH_SYMBOLS = ("trainer_draws", "sgns_conv_accumulate", "sgns_shared_kernel",
                 "reduce_partials", "sgns_conv_scatter")


def symbol_pattern(sym: str):
    """A demangled kernel name's match for a CUDA symbol (in a namespace or
    not, a template or not)."""
    return re.compile(rf"(?:^|[\s:]){sym}[<(]")


def phase_profile(torch, walk_kernel, keys_kernel, smi, tmp,
                  main_run) -> dict:
    """Phase 16: phase 4's argv with --profile DIR: one torch.profiler trace
    in DIR that names each of the path's kernels by its CUDA symbol as
    often as its wrapper counted launches; /path unchanged. From the trace,
    each kernel's summed duration and the card's idle share in the epoch."""
    from stellar_rw_tpu_torch import cli

    prof = os.path.join(tmp, "profile")
    out = os.path.join(tmp, "out_profile")
    symbols = profiled_symbols(walk_kernel, keys_kernel)
    reset_counts(*symbols.values())
    report = {}
    t0 = time.perf_counter()
    rc = cli.main(["--input", main_run["edges"], "--output", out]
                  + MAIN_FLAGS + ["--profile", prof], report=report)
    wall = time.perf_counter() - t0
    check(rc == 0, f"profiled run: cli.main returned {rc}")
    check(same_path(main_run["out"], out), "profiled /path differs")
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    check(len(traces) == 1, f"trace files in {prof}: {os.listdir(prof)}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(len(kernels) > 0, "no kernel events in the trace")
    found, busy_ms = {}, {}
    for sym, counter in symbols.items():
        pat = symbol_pattern(sym)
        mine = [e for e in kernels if pat.search(e["name"])]
        found[sym] = len(mine)
        busy_ms[sym] = sum(e.get("dur", 0) for e in mine) / 1e3
        check(counter.launches > 0 and len(mine) == counter.launches,
              f"trace: {len(mine)} {sym} events, {counter.launches} "
              f"launches counted")
    # the epoch's window: its first trainer kernel's start to its last
    # one's end. The card is busy where any kernel runs: a union of
    # intervals, since reduce_partials starts early under programmatic
    # dependent launch and waits inside
    pats = [symbol_pattern(sym) for sym in EPOCH_SYMBOLS]
    epoch = [e for e in kernels if any(p.search(e["name"]) for p in pats)]
    lo = min(e["ts"] for e in epoch)
    hi = max(e["ts"] + e.get("dur", 0) for e in epoch)
    busy, end = 0.0, lo
    for e in sorted(kernels, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), min(e["ts"] + e.get("dur", 0), hi)
        if b > a:
            busy += b - a
            end = b
    idle = 1 - busy / (hi - lo)
    print(f"phase 16 --profile on phase 4's argv: {len(traces)} trace "
          f"({os.path.getsize(traces[0]) / 1e6:.1f} MB, {len(events)} "
          f"events, {len(kernels)} kernel events); each symbol's events = "
          f"its launches {found}; summed durations ms "
          f"{ {k: round(v, 3) for k, v in busy_ms.items()} }; the epoch's "
          f"window (its first trainer kernel to its last) "
          f"{(hi - lo) / 1e3:.3f} ms, a kernel running in "
          f"{busy / 1e3:.3f} ms of it: idle share {idle:.4f}; walk "
          f"{report['walk_seconds']:.3f} s, epoch "
          f"{report['train_seconds']:.3f} s under the profiler, CLI wall "
          f"{wall:.1f} s [{smi}]")
    return {"events": found, "busy_ms": busy_ms,
            "epoch_window_ms": (hi - lo) / 1e3, "epoch_idle_share": idle,
            "train_seconds": report["train_seconds"]}


def http(method: str, url: str, payload=None):
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(torch, smi, tmp) -> dict:
    """Phase 17: a JobServer on port 0. A karate node2vec job over REST
    runs in a worker process on the card to FINISHED, its /path byte for
    byte the same argv's through the CLI; a job with an unreadable input
    ends ERROR with its worker's exit code; the server runs the next job
    after it."""
    from stellar_rw_tpu_torch import cli, serve

    karate = os.path.join(ROOT, "tests", "data", "karate.txt")
    job = lambda out, extra="": {serve.CONFIG_KEY: " ".join(
        ["--input", karate, "--output", out] + SERVE_FLAGS) + extra}
    srv = serve.JobServer(port=0, job_timeout=600)
    srv.start()
    base = "http://%s:%d" % srv.address
    try:
        out = os.path.join(tmp, "serve_rest")
        t0 = time.perf_counter()
        code, posted = http("POST", f"{base}/jobs", job(out))
        check(code == 202, f"POST /jobs: {code} {posted}")
        srv.wait(posted["jobId"], timeout=900)
        rest_s = time.perf_counter() - t0
        code, done = http("GET", f"{base}/jobs/{posted['jobId']}")
        check(code == 200 and done["status"] == "FINISHED"
              and done["result"] == out, f"REST job: {done}")
        ref = os.path.join(tmp, "serve_cli")
        check(cli.main(job(ref)[serve.CONFIG_KEY].split()) == 0,
              "the CLI run of the served argv failed")
        check(same_path(ref, out), "the served /path differs from the CLI's")
        code, bad = http("POST", f"{base}/jobs", {
            serve.CONFIG_KEY: f"--cmd randomwalk --input "
                              f"{os.path.join(tmp, 'no_such_graph.txt')} "
                              f"--output {os.path.join(tmp, 'serve_bad')}"})
        check(code == 202, f"POST /jobs (bad input): {code} {bad}")
        srv.wait(bad["jobId"], timeout=900)
        code, bad_done = http("GET", f"{base}/jobs/{bad['jobId']}")
        check(bad_done["status"] == "ERROR" and "rc=" in bad_done["error"],
              f"bad-input job: {bad_done}")
        nxt = os.path.join(tmp, "serve_next")
        code, posted = http("POST", f"{base}/jobs", job(
            nxt, " --cmd randomwalk"))
        srv.wait(posted["jobId"], timeout=900)
        code, next_done = http("GET", f"{base}/jobs/{posted['jobId']}")
        check(next_done["status"] == "FINISHED"
              and os.path.exists(os.path.join(nxt, "path", "part-00000")),
              f"the job after the failed one: {next_done}")
        code, listing = http("GET", f"{base}/jobs")
        check(code == 200 and len(listing["jobs"]) == 3,
              f"GET /jobs: {listing}")
    finally:
        srv.stop()
    print(f"phase 17 job server: karate node2vec over REST FINISHED in "
          f"{rest_s:.1f} s (a worker process on the card), /path byte-equal "
          f"to the CLI's; unreadable input ERROR "
          f"({bad_done['error'].strip().splitlines()[-1][:100]!r}); the next "
          f"job FINISHED [{smi}]")
    return {"rest_seconds": rest_s}


# phase 19: bench.py::hs_ablation's reference protocol (the graph, its
# walks at p = q = 0.25 and the trainer's settings), one epoch
HS_GRAPH = (100_000, 1_000_000, 50, 3)     # V, E, communities, seed
HS_WALKS = {"walk_length": 80, "num_walks": 10, "p": 0.25, "q": 0.25,
            "seed": 1}
HS_TRAIN = {"dim": 128, "window": 10, "lr": 0.025, "iters": 1, "seed": 1,
            "row_block": 256}
# phase 18: (tokens, B, T, window, D). Blocks of phase 19's corpus under
# its Huffman tree (the main shape, D 64, window 1, D 768); Zipf walks
# padded with -1 on a 10,000-token tree (also at D 200); one token alone,
# the deepest (every center on one path: the hub); two tokens (a one-level
# tree)
HS_SHAPES = [("corpus", 256, 82, 10, 128), ("corpus", 256, 82, 10, 64),
             ("corpus", 256, 82, 1, 128), ("padded", 64, 82, 10, 128),
             ("hub", 32, 82, 10, 128), ("two tokens", 32, 82, 10, 128),
             ("padded", 32, 82, 10, 200), ("corpus", 32, 82, 10, 768)]


def hs_kernels() -> dict:
    from stellar_rw_tpu_torch.ops.hsoftmax import HS_STEP

    return {"hs_step": HS_STEP}


def spmm_kernels() -> dict:
    from stellar_rw_tpu_torch.ops.spmm import (SPMM_ROW_SOFTMAX, SPMM_SDDMM,
                                               SPMM_SEGMENT_SUM)

    return {"spmm_segment_sum": SPMM_SEGMENT_SUM, "spmm_sddmm": SPMM_SDDMM,
            "spmm_row_softmax": SPMM_ROW_SOFTMAX}


def hs_corpus(torch) -> dict:
    """Phase 19's corpus: bench.py::hs_ablation's labeled synthetic graph
    walked on the card (the device tensor) and its token counts."""
    from stellar_rw_tpu_torch.graph import datasets
    from stellar_rw_tpu_torch.walk import engine

    V, E, k, seed = HS_GRAPH
    t0 = time.perf_counter()
    graph, _ = datasets.synth_labeled_graph(V, E, communities=k, seed=seed)
    t1 = time.perf_counter()
    walks = engine.random_walks(graph, as_numpy=False, **HS_WALKS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = torch.bincount(walks.reshape(-1) + 1, minlength=V + 1)[1:]
    return {"graph": graph, "walks": walks, "build_s": t1 - t0,
            "walk_s": t2 - t1,
            "counts": counts.cpu().numpy().astype(np.float64)}


def hs_block(torch, tokens, B, T, window, D, seed, corpus):
    """One HS block: rows of phase 19's corpus with its Huffman tree, or
    Zipf walks that end early on a 10,000-token tree ("padded"), the
    deepest token of that tree alone ("hub"), two tokens ("two tokens");
    the trainer's window draws; random tables (syn1 too)."""
    from stellar_rw_tpu_torch.models import hsoftmax as hs
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import trainer_draws as td

    rng = np.random.default_rng(seed)
    if tokens == "corpus":
        block = corpus["walks"][:B, :T].cpu().numpy()
        counts = corpus["counts"]
    else:
        V = 2 if tokens == "two tokens" else 10_000
        block = np.minimum((V * rng.random((B, T)) ** (1 / 0.3))
                           .astype(np.int32), V - 1)
        counts = np.bincount(block.reshape(-1), minlength=V) + 1.0
        if tokens == "hub":
            block[:] = int(np.argmax(hs.build_huffman(counts)[2].sum(1)))
        if tokens == "padded":
            ends = rng.integers(1, T + 1, B)
            block[np.arange(T)[None, :] >= ends[:, None]] = -1
            block[0] = -1
            block[1, 5:9] = -1
    V = len(counts)
    points, labels, pmask = (torch.as_tensor(a).cuda()
                             for a in hs.build_huffman(counts))
    key = prng.fold_in(prng.prng_key(seed), 3).cuda()
    cwin = td.trainer_draws_ref(key, 0, 1, B, T, window, (0,), None,
                                None)[0][0]
    w = lambda n: torch.as_tensor((rng.standard_normal((n, D)) * 0.3)
                                  .astype(np.float32)).cuda()
    return (w(V), w(max(V - 1, 1)), torch.as_tensor(block).cuda(), cwin,
            points, labels, pmask)


def phase_hs_check(torch, smi, corpus) -> dict:
    """Phase 18: the HS step's kernel (one cooperative launch) against the
    plain step in float64 (and in float32 wherever that step is itself
    within rtol 1e-5 atol 1e-6 of float64) at HS_SHAPES, its workspace
    empty after every step, each step timed back to back; at the main
    shape the kernel timed by events around each launch against the plain
    step, with its bound."""
    from stellar_rw_tpu_torch.ops import hsoftmax as ho
    from stellar_rw_tpu_torch.ops.sgns_exact import _valid_from_cwin

    lr = 0.025
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = f32_err = 0.0
    loose, per_shape = [], {}
    for i, shape in enumerate(HS_SHAPES):
        _, B, T, win, D = shape
        syn0, syn1, block, cwin, pts, lbl, pmk = hs_block(torch, *shape, i,
                                                          corpus)
        a0, a1 = syn0.double(), syn1.double()
        ho.hs_step_ref(a0, a1, block, cwin, pts, lbl, pmk, lr, win)
        p0, p1 = syn0.clone(), syn1.clone()
        ho.hs_step_ref(p0, p1, block, cwin, pts, lbl, pmk, lr, win)
        b0, b1 = syn0.clone(), syn1.clone()
        ws = ho.HSWorkspace(b0, b1, B * T, pts.shape[1])
        ho.hs_step(b0, b1, block, cwin, pts, lbl, pmk, lr, win, ws)
        check(workspace_empty(torch, ws),
              f"hs_step left its workspace dirty at {shape}")
        for table, got, want, plain, old in (("syn0", b0, a0, p0, syn0),
                                             ("syn1", b1, a1, p1, syn1)):
            k_err = float((got.double() - want).abs().max())
            p_err = float((plain.double() - want).abs().max())
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6),
                  f"hs_step differs from the float64 step at {shape} "
                  f"({table}): max abs err {k_err:.3g}")
            if torch.allclose(plain.double(), want, rtol=1e-5, atol=1e-6):
                check(torch.allclose(got, plain, rtol=1e-5, atol=1e-6),
                      f"hs_step differs from the plain f32 step at {shape} "
                      f"({table}): max abs err "
                      f"{float((got - plain).abs().max()):.3g}")
            else:
                loose.append((shape, table, p_err))
            if shape[0] != "two tokens" or table == "syn1":
                check(bool((got != old).any()), f"the step moved nothing "
                      f"in {table} at {shape}")
            err = max(err, k_err)
            f32_err = max(f32_err, p_err)
        plan = ho.launch_plan(D, B, T, win, sms, levels=pts.shape[1])
        ms = cuda_ms(lambda: ho.launch_step(ws, b0, b1, block, cwin, pts,
                                            lbl, pmk, win, lr), 10)
        check(workspace_empty(torch, ws),
              f"hs_step left its workspace dirty after timed steps at {shape}")
        per_shape[str(shape)] = {"ms_back_to_back": ms, "L": pts.shape[1],
                                 "plan": plan._asdict()}
        del a0, a1, p0, p1, b0, b1, ws
    # the main shape: the kernel by events around each launch, the plain
    # step in turns with the wrapper
    shape = HS_SHAPES[0]
    _, B, T, win, D = shape
    syn0, syn1, block, cwin, pts, lbl, pmk = hs_block(torch, *shape, 0,
                                                      corpus)
    L = pts.shape[1]
    ws = ho.HSWorkspace(syn0, syn1, B * T, L)
    iters = 20
    (k_ms,) = cuda_ms_split((lambda: ho.launch_step(
        ws, syn0, syn1, block, cwin, pts, lbl, pmk, win, lr),), iters)
    step = lambda: ho.hs_step(syn0, syn1, block, cwin, pts, lbl, pmk, lr,
                              win, ws)
    plain = lambda: ho.hs_step_ref(syn0, syn1, block, cwin, pts, lbl, pmk,
                                   lr, win)
    runs = [cuda_ms(f, 3) for f in (plain, step, step, plain)]
    # the same launch under other plans: tiles
    base = ho.launch_plan(D, B, T, win, sms, levels=L)
    by_plan = {}
    for tile in (8, 16, 32):
        need = ho.smem_bytes(tile, win, D, L)
        bps = next(n for n, budget in ho.SMEM_BUDGETS if need <= budget)
        plan = base._replace(
            tile=tile, tiles=B * -(-T // tile), halo_rows=tile + 2 * win,
            blocks=min(B * -(-T // tile), bps * sms), blocks_per_sm=bps,
            smem_bytes=need)
        by_plan[f"tile {tile}"] = cuda_ms(
            lambda: ho.launch_step(ws, syn0, syn1, block, cwin, pts, lbl,
                                   pmk, win, lr, plan), 10)
    check(workspace_empty(torch, ws), "hs_step left its workspace dirty "
          "under another plan")
    # what this block needs: the distinct syn0 rows that are a context, the
    # distinct path nodes of the centers with a pair, and those centers'
    # path rows; 6 D flops (the dot, d_vo and the context's gradient) a
    # distinct (context token, path node) pair, since all reads are of the
    # tables before the step: every pair of a context token with a center
    # holding the node sums the same sigmoid and rows (pair_levels: the
    # (pair, live level) terms that adds up)
    valid, ctx = _valid_from_cwin(block, cwin, win)
    vcnt = valid.sum(-1)
    tok = block.clamp_min(0).long()
    codelen = pmk.sum(1)
    pair_levels = int((vcnt * codelen[tok]).sum())
    ctx_tok = block[:, ctx].long()
    U0 = int(torch.unique(ctx_tok[valid]).numel())
    centers = torch.unique(tok[vcnt > 0])
    U1 = int(torch.unique(pts[centers][pmk[centers] > 0]).numel())
    V0, V1 = syn0.shape[0], syn1.shape[0]
    cc = torch.unique(ctx_tok[valid] * V0 + tok[..., None].expand_as(
        ctx_tok)[valid])               # distinct (context, center) tokens
    live = pmk[cc % V0] > 0
    ctx_nodes = int(torch.unique(((cc // V0)[:, None] * V1
                                  + pts[cc % V0].long())[live]).numel())
    step_b = bound(tensor_bytes(block, cwin) + centers.numel() * L * 12
                   + (U0 + U1) * D * 4 * 2, ctx_nodes * 6 * D, F32_FLOPS)
    plain_ms = (runs[0] + runs[3]) / 2
    jax_block = B * T * L * D * 4
    print(f"phase 18 hs_step: within rtol 1e-5 atol 1e-6 of the plain step "
          f"in float64 at {HS_SHAPES} (tokens, B, T, w, D): max abs err "
          f"{err:.3g} (the plain f32 step's {f32_err:.3g}); within it of "
          f"the plain f32 step wherever that step is within it of float64, "
          f"which it is not at {loose}; the workspace empty after every "
          f"step; back to back ms by shape {per_shape}; at the main shape "
          f"(phase 19's block: B {B}, T {T}, w {win}, D {D}, L {L}; "
          f"{int(vcnt.sum())} valid pairs, {pair_levels} pair-levels, "
          f"{ctx_nodes} distinct (context token, node) pairs, "
          f"{U0} syn0 + {U1} syn1 rows) the kernel {k_ms:.4f} ms (CUDA "
          f"events around each launch, mean of {iters}), through the "
          f"wrapper {(runs[1] + runs[2]) / 2:.4f} ms, plain step "
          f"{plain_ms:.3f} ms (mean of 2x3); bound {step_b['bound_ms']:.5f} "
          f"ms by {step_b['bound_by']}; back to back under other plans "
          f"(ms, mean of 10) {by_plan}; the JAX body's [B, T, L, D] f32 "
          f"tensor at this block: {jax_block / 1e6:.0f} MB, none on this "
          f"path [{smi}]")
    return {"ms": k_ms, **step_b, "max_abs_err": err,
            "plain_f32_off_f64": f32_err, "plain_ms": plain_ms,
            "library_ms": None, "wrapper_ms": (runs[1] + runs[2]) / 2,
            "pair_levels": pair_levels, "ctx_node_pairs": ctx_nodes,
            "per_shape": per_shape,
            "ms_by_plan": by_plan}


def phase_hs_main(torch, smi, corpus) -> dict:
    """Phase 19: train_skipgram_hs at bench.py::hs_ablation's reference
    protocol on phase 19's corpus, one epoch, with the kernels' launches
    (K9 once a block, K12 once a chunk, no SGNS kernel), the job's peak
    device memory, and the conv trainer's epoch on the same corpus beside
    it (kB 128, the same row_block), the link AUC of both on 20,000 of the
    graph's arcs; then the karate HS gate on the card."""
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import eval as ev
    from stellar_rw_tpu_torch.models import hsoftmax as hs
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.walk import engine

    graph, walks = corpus["graph"], corpus["walks"]
    V = graph.num_vertices
    cfg = w2v.SGNSConfig(**HS_TRAIN)
    path = {**hs_kernels(), **trainer_kernels()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts(*path.values())
    t0 = time.perf_counter()
    syn0 = hs.train_skipgram_hs(walks, V, cfg)
    hs_s = time.perf_counter() - t0
    launches = {k: t.launches for k, t in path.items()}
    peak = torch.cuda.max_memory_allocated() - held
    B, T = cfg.row_block, walks.shape[1]
    n_blocks = -(-walks.shape[0] // B)
    chunks = -(-n_blocks // max(1, w2v._DRAW_BUDGET // (B * T)))
    check(launches["hs_step"] == n_blocks and launches["trainer_draws"]
          == chunks, f"HS epoch launches {launches}: {n_blocks} blocks, "
          f"{chunks} draw chunks")
    check(all(launches[k] == 0 for k in ("sgns_conv_accumulate",
                                         "sgns_shared_grads",
                                         "sgns_conv_scatter",
                                         "sgns_exact_step")),
          f"an SGNS kernel ran in the HS trainer: {launches}")
    check(syn0.shape == (V, cfg.dim) and np.isfinite(syn0).all(),
          "HS embeddings not finite or of the wrong shape")
    # where the epoch's time goes: the Huffman tree on the host, and the
    # step's device time and host time a call over the epoch's first blocks
    t0 = time.perf_counter()
    L = int(hs.build_huffman(corpus["counts"])[0].shape[1])
    tree_s = time.perf_counter() - t0
    step_ms, host_ms = hs_epoch_blocks(torch, corpus, cfg, 200)
    cfg_ns = w2v.SGNSConfig(negatives=5, shared_negatives=128, **HS_TRAIN)
    t0 = time.perf_counter()
    w_ns, _ = w2v.train_skipgram(walks, V, cfg_ns)
    conv_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    ei = rng.choice(graph.num_edges, min(graph.num_edges, 20_000),
                    replace=False)
    src_of = np.repeat(np.arange(V), graph.degrees)
    arcs = np.stack([src_of[ei], graph.cols[ei]], 1)
    auc_hs = ev.link_prediction_auc(syn0, arcs, V, seed=0)
    auc_ns = ev.link_prediction_auc(w_ns, arcs, V, seed=0)
    # the karate gate of tests/test_hsoftmax.py on the card
    kg = gio.load_edge_list(os.path.join(ROOT, "tests", "data",
                                         "karate.txt"),
                            weighted=False, directed=False)
    kwalks = engine.random_walks(kg, walk_length=20, num_walks=10, p=0.25,
                                 q=0.25, seed=2, as_numpy=False)
    ks = hs.train_skipgram_hs(kwalks, kg.num_vertices, w2v.SGNSConfig(
        dim=32, window=5, lr=0.2, iters=20, seed=2))
    k_auc, k_acc = karate_gate(ks, kg)
    check(k_auc > 0.7 and k_acc >= 0.85,
          f"karate HS gate: auc {k_auc} acc {k_acc}")
    print(f"phase 19 train_skipgram_hs at hs_ablation's reference protocol "
          f"(one epoch of 10; synth_labeled_graph{HS_GRAPH[:2]}, "
          f"communities {HS_GRAPH[2]}, seed {HS_GRAPH[3]}: {V} V, "
          f"{graph.num_edges} arcs; {walks.shape[0]} walks x {T} tokens "
          f"walked on the card in {corpus['walk_s']:.2f} s, the graph built "
          f"in {corpus['build_s']:.2f} s; {HS_TRAIN}; tree depth {L}): HS "
          f"epoch {hs_s:.3f} s = {hs_s / n_blocks * 1e3:.4f} ms a block "
          f"over {n_blocks} blocks, of which the Huffman tree on the host "
          f"{tree_s:.3f} s; over the epoch's first 200 blocks K9 "
          f"{step_ms:.4f} ms a block on the card (CUDA events between the "
          f"steps), hs_step's host side {host_ms:.4f} ms a call; "
          f"launches {launches} = "
          f"{launches['hs_step'] / n_blocks:.4f} K9 and "
          f"{launches['trainer_draws'] / n_blocks:.4f} K12 a block; the "
          f"job's peak device memory {peak / 1e6:.1f} MB above the "
          f"{held / 1e6:.1f} MB held before it (the corpus alone "
          f"{tensor_bytes(walks) / 1e6:.1f} MB); the conv trainer's epoch "
          f"(kB 128) on the same corpus {conv_s:.3f} s; link AUC on 20,000 "
          f"arcs HS {auc_hs:.4f}, conv {auc_ns:.4f} (one epoch); karate HS "
          f"gate on the card: AUC {k_auc:.4f} accuracy {k_acc:.4f} [{smi}]")
    return {"launches": launches, "hs_epoch_s": hs_s,
            "conv_epoch_s": conv_s, "blocks": n_blocks, "peak_bytes": peak,
            "held_bytes": held, "auc_hs": auc_hs, "auc_conv": auc_ns,
            "karate_auc": k_auc, "karate_acc": k_acc, "tree_depth": L,
            "walk_s": corpus["walk_s"], "tree_s": tree_s,
            "step_ms_in_epoch": step_ms, "step_host_ms": host_ms}


def hs_epoch_blocks(torch, corpus, cfg, n: int) -> tuple[float, float]:
    """The first n blocks of an HS epoch on phase 19's corpus from the
    trainer's init, one hs_step a block as _hs_epoch makes them: the mean
    device ms a step (CUDA events between the steps) and the mean host ms
    of an hs_step call."""
    from stellar_rw_tpu_torch.models import hsoftmax as hs
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.ops import hsoftmax as ho
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops.trainer_draws import trainer_draws

    walks, V = corpus["walks"], corpus["graph"].num_vertices
    B, T = cfg.row_block, walks.shape[1]
    pts, lbl, pmk = (torch.as_tensor(a).cuda()
                     for a in hs.build_huffman(corpus["counts"]))
    key = prng.prng_key(cfg.seed, "cuda")
    syn0, _ = w2v._init_embeddings(V, cfg.dim, prng.fold_in(key, 0x1A17))
    syn1 = torch.zeros((V - 1, cfg.dim), device="cuda")
    ws = ho.HSWorkspace(syn0, syn1, B * T, pts.shape[1])
    blocks = walks[:n * B].reshape(n, B, T)
    cwin, _ = trainer_draws(prng.fold_in(key, 0), 0, n, B, T, cfg.window,
                            (0,), None, None)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host = 0.0
    torch.cuda.synchronize()
    ev[0].record()
    for i in range(n):
        t0 = time.perf_counter()
        ho.hs_step(syn0, syn1, blocks[i], cwin[i], pts, lbl, pmk, cfg.lr,
                   cfg.window, ws)
        host += time.perf_counter() - t0
        ev[i + 1].record()
    torch.cuda.synchronize()
    return (sum(ev[i].elapsed_time(ev[i + 1]) for i in range(n)) / n,
            host / n * 1e3)


# the split rows of phase 20's extremes: a hub row of 3,000 arcs (24 items
# of 128), an isolate, a row of one arc, short rows, a row of 129 arcs (two
# items), another isolate; columns among SPLIT_COLS vertices
SPLIT_DEGREES = (3000, 0, 1, 5, 129, 0, 40)
SPLIT_COLS = 500


def spmm_split_rows(torch, sp, g) -> dict:
    """Phase 20's split rows against float64 on the card: the SDDMM at D 2,
    32, 33, 64 and 128 (rtol 1e-5 atol 1e-5), the row softmax forward and
    backward (rtol 1e-5 atol 1e-6: the hub row's weights are ~1e-4) with
    scores N(0, 1) x3 and x30, all equal, and the hub row's max in its
    last item; then that last case on measure_spmm's graph `g`, whose
    largest row (39,303 arcs) has its max moved to its last arc. The
    largest error of each."""
    deg = np.asarray(SPLIT_DEGREES)
    rng = np.random.default_rng(13)
    offsets = np.concatenate([[0], np.cumsum(deg), np.full(
        SPLIT_COLS - len(deg), deg.sum())])
    graph = SimpleNamespace(
        num_vertices=SPLIT_COLS, offsets=offsets,
        cols=rng.integers(0, SPLIT_COLS, int(deg.sum())).astype(np.int32),
        weights=np.ones(int(deg.sum()), np.float32))
    err = {"sddmm": 0.0, "softmax": 0.0, "softmax backward": 0.0}
    for name, gr in (("split rows", graph), ("power law", g)):
        es = sp.EdgeStructure.from_csr(gr)
        V, E = gr.num_vertices, es.col.numel()
        f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
            np.float32)).cuda()

        def held(kernel, got, want, atol, what):
            e = float((got.double() - want).abs().max())
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=atol),
                  f"{kernel} differs from float64 on {name}, {what}: max "
                  f"abs err {e:.3g}")
            err[kernel] = max(err[kernel], e)

        for D in ((2, 32, 33, 64, 128) if gr is graph else ()):
            x, y = f(V, D), f(V, D)
            held("sddmm", sp.sddmm_rows(es, x, y),
                 sp.sddmm_ref(es, x.double(), y.double()), 1e-5, f"D {D}")
        hub = int(np.argmax(np.diff(gr.offsets)))
        first, last = int(gr.offsets[hub]), int(gr.offsets[hub + 1]) - 1
        cases = {"hub max last": f(E) * 3}
        cases["hub max last"][last] = cases["hub max last"][
            first:last + 1].max() + 12
        if gr is graph:
            cases.update({"x3": f(E) * 3, "x30": f(E) * 30, "all equal":
                          torch.full((E,), 0.75, device="cuda")})
        for what, s in cases.items():
            a = sp.row_softmax(es, s)
            held("softmax", a, sp.sddmm_softmax_ref(es, s.double()), 1e-6,
                 what)
            da = f(E)
            ad, dad = a.double(), da.double()
            dot = torch.zeros(V, dtype=torch.float64, device="cuda"
                              ).index_add_(0, es.row, ad * dad)
            held("softmax backward", sp.row_softmax(es, a, da),
                 ad * (dad - dot[es.row]), 1e-6, what)
    return err


def phase_spmm(torch, smi) -> tuple[dict, dict]:
    """Phase 20: the GNN-feed ops' kernels against their plain versions in
    float64 (forward rtol 1e-5 atol 1e-5; the gradients of spmm, spmm_mean,
    sddmm and sddmm_softmax against the plain autograd at the same
    tolerance) at bench.py::measure_spmm's graph (D 128 and 64) and the
    directed test graph (an isolate); the split rows' extremes
    (spmm_split_rows); a GAT-style layer and its gradient through the
    public ops, every kernel counted, its gradients against the plain
    layer's in float64; the SDDMM and both softmax modes run twice, bit
    for bit; each kernel timed at D 128 beside its plain version and its
    library call (timed only)."""
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.ops import spmm as sp

    g = synth_power_law_graph(10_000, 334_000, seed=0)
    tg = gio.load_edge_list(os.path.join(ROOT, "tests", "data",
                                         "testgraph.txt"),
                            weighted=False, directed=True)
    # the plain versions under the public ops' names: the reference autograd
    plain_ops = SimpleNamespace(spmm=sp.spmm_ref, spmm_mean=sp.spmm_mean_ref,
                                sddmm=sp.sddmm_ref,
                                sddmm_softmax=sp.sddmm_softmax_ref)
    # each kernel's largest error: its forward ops, and the gradients its
    # backward modes compute (sddmm's gradient is two segment sums; gather
    # rows is an index_select and no kernel's)
    fwd_kernel = {"spmm": "spmm", "spmm unweighted": "spmm",
                  "spmm_mean": "spmm", "sddmm": "sddmm",
                  "sddmm_softmax": "softmax", "scatter_add_rows row": "spmm",
                  "scatter_add_rows col": "spmm"}
    grad_kernel = {"spmm": "spmm", "spmm_mean": "spmm", "sddmm": "spmm",
                   "sddmm_softmax": "softmax"}
    err = {"spmm": 0.0, "sddmm": 0.0, "softmax": 0.0}
    grad_err = {"spmm": 0.0, "sddmm": None, "softmax": 0.0}
    for gi, (name, graph, D) in enumerate((("power law", g, 128),
                                           ("power law", g, 64),
                                           ("testgraph", tg, 2))):
        es = sp.EdgeStructure.from_csr(graph)
        rng = np.random.default_rng(gi)
        V, E = graph.num_vertices, graph.num_edges
        f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
            np.float32)).cuda()
        x, y, s, msgs = f(V, D), f(V, D), f(E) * 3, f(E, D)
        d = lambda t: t.double()
        pairs = {
            "spmm": (sp.spmm(es, x), sp.spmm_ref(es, d(x))),
            "spmm unweighted": (sp.spmm(es, x, weighted=False),
                                sp.spmm_ref(es, d(x), weighted=False)),
            "spmm_mean": (sp.spmm_mean(es, x), sp.spmm_mean_ref(es, d(x))),
            "sddmm": (sp.sddmm(es, x, y), sp.sddmm_ref(es, d(x), d(y))),
            "sddmm_softmax": (sp.sddmm_softmax(es, s),
                              sp.sddmm_softmax_ref(es, d(s))),
            **{f"scatter_add_rows {w}": (
                sp.scatter_add_rows(es, msgs, w),
                sp.scatter_add_rows_ref(es, d(msgs), w))
               for w in ("row", "col")},
            **{f"gather_rows {w}": (sp.gather_rows(es, x, w),
                                    sp.gather_rows_ref(es, d(x), w))
               for w in ("row", "col")}}
        for op, (got, want) in pairs.items():
            check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5),
                  f"{op} differs from its plain version in float64 on "
                  f"{name} D {D}: max abs err "
                  f"{float((got.double() - want).abs().max()):.3g}")
            if op in fwd_kernel:
                k = fwd_kernel[op]
                err[k] = max(err[k], float((got.double() - want).abs().max()))
        r_v, r_e = f(V, D), f(E)
        fwd = {"spmm": (lambda m, a, b: m.spmm(es, a), r_v),
               "spmm_mean": (lambda m, a, b: m.spmm_mean(es, a), r_v),
               "sddmm": (lambda m, a, b: m.sddmm(es, a, b), r_e),
               "sddmm_softmax": (lambda m, a, b: m.sddmm_softmax(es, a),
                                 r_e)}
        for op, (fn, r) in fwd.items():
            a0 = s if op == "sddmm_softmax" else x
            grads = []
            for dt, mod in ((torch.float32, sp), (torch.float64, plain_ops)):
                a = a0.to(dt).clone().requires_grad_()
                b = y.to(dt).clone().requires_grad_()
                (fn(mod, a, b) * r.to(dt)).sum().backward()
                grads.append((a.grad, b.grad))
            for got, want in zip(grads[0], grads[1]):
                if want is None:
                    continue
                check(torch.allclose(got.double(), want, rtol=1e-5,
                                     atol=1e-5),
                      f"the gradient of {op} differs from the plain "
                      f"autograd in float64 on {name} D {D}: max abs err "
                      f"{float((got.double() - want).abs().max()):.3g}")
                k = grad_kernel[op]
                grad_err[k] = max(grad_err[k],
                                  float((got.double() - want).abs().max()))
    split_err = spmm_split_rows(torch, sp, g)
    # the path: a GAT-style layer and its gradient through the public ops
    es = sp.EdgeStructure.from_csr(g)
    V, E, D = g.num_vertices, g.num_edges, 128
    rng = np.random.default_rng(7)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
        np.float32)).cuda()
    x0, y0 = f(V, D), f(V, D)

    def layer(ops, dt):
        x = x0.to(dt).clone().requires_grad_()
        y = y0.to(dt).clone().requires_grad_()
        h = ops.spmm_mean(es, x)
        a = ops.sddmm_softmax(es, ops.sddmm(es, h, y))
        out = ops.scatter_add_rows(es, ops.gather_rows(es, x) * a[:, None])
        (out ** 2).sum().backward()
        return x.grad, y.grad

    kernels = spmm_kernels()
    reset_counts(*kernels.values())
    grads = layer(sp, torch.float32)
    torch.cuda.synchronize()
    launches = {k: t.launches for k, t in kernels.items()}
    check(all(n > 0 for n in launches.values()),
          f"a K8 kernel was not launched by the layer: {launches}")
    check(all(bool(torch.isfinite(gr).all()) for gr in grads),
          "the layer's gradients are not finite")
    # the layer's gradients against the plain layer's in float64, beside
    # the plain layer's own in float32: no more than twice its error
    plain_layer = SimpleNamespace(
        spmm_mean=sp.spmm_mean_ref, sddmm=sp.sddmm_ref,
        sddmm_softmax=sp.sddmm_softmax_ref, gather_rows=sp.gather_rows_ref,
        scatter_add_rows=sp.scatter_add_rows_ref)
    want = layer(plain_layer, torch.float64)
    off = lambda gs: max(float(((a.double() - b).abs() / (b.abs() + 1)).max())
                         for a, b in zip(gs, want))
    layer_err = {"kernels": off(grads),
                 "plain float32": off(layer(plain_layer, torch.float32))}
    check(layer_err["kernels"] <= 2 * layer_err["plain float32"] + 1e-6,
          f"the layer's gradients are further from float64 than the plain "
          f"layer's in float32 (|err| / (|g| + 1)): {layer_err}")
    x, y = x0, y0
    # each kernel at D 128: by events around each launch, back to back,
    # beside its plain version and its library call
    s = f(E)
    a = sp.row_softmax(es, s)
    da = f(E)
    for what, fn in (("sddmm_rows", lambda: sp.sddmm_rows(es, x, y)),
                     ("row_softmax", lambda: sp.row_softmax(es, s)),
                     ("row_softmax backward",
                      lambda: sp.row_softmax(es, a, da))):
        check(torch.equal(fn(), fn()), f"two runs of {what} differ")
    by_row = sp.Order.build(g.offsets, "cuda", chunk=1 << 30)
    fns = {
        "spmm": lambda: sp.segment_sum(es.csr, x, idx=es.col, w=es.weight),
        "spmm transposed": lambda: sp.segment_sum(
            es.trans, x, idx=es.t_row, w=es.weight, widx=es.t_order),
        "spmm a warp a row": lambda: sp.segment_sum(by_row, x, idx=es.col,
                                                    w=es.weight),
        "sddmm": lambda: sp.sddmm_rows(es, x, y),
        "softmax": lambda: sp.row_softmax(es, s),
        "softmax backward": lambda: sp.row_softmax(es, a, da)}
    iters = 20
    ms = dict(zip(fns, cuda_ms_split(list(fns.values()), iters)))
    back = {k: cuda_ms(fn, iters) for k, fn in fns.items()}
    # the same launches under other plans: arcs an item (the SDDMM's own
    # items too)
    by_chunk = {}
    for chunk in (32, 64, 128, 256, 512, 1024):
        ec = sp.EdgeStructure.from_csr(g, chunk=chunk)
        ed = dataclasses.replace(ec, dots=ec.csr)
        by_chunk[chunk] = {
            "spmm": cuda_ms(lambda: sp.segment_sum(ec.csr, x, idx=ec.col,
                                                   w=ec.weight), iters),
            "sddmm": cuda_ms(lambda: sp.sddmm_rows(ed, x, y), iters)}
    def softmax_backward_ref():
        dot = torch.zeros(V, device="cuda").index_add_(0, es.row, a * da)
        return a * (da - dot[es.row])

    plain = {"spmm": cuda_ms(lambda: sp.spmm_ref(es, x), 5),
             "sddmm": cuda_ms(lambda: sp.sddmm_ref(es, x, y), 5),
             "softmax": cuda_ms(lambda: sp.sddmm_softmax_ref(es, s), 5),
             "softmax backward": cuda_ms(softmax_backward_ref, 5)}
    csr = torch.sparse_csr_tensor(es.csr.offsets, es.col, es.weight,
                                  size=(V, V))
    ones = torch.sparse_csr_tensor(es.csr.offsets, es.col,
                                   torch.ones_like(es.weight), size=(V, V))
    coo = torch.sparse_coo_tensor(torch.stack([es.row, es.col]).long(), s,
                                  (V, V)).coalesce()
    yt = y.t().contiguous()
    library = {"spmm": cuda_ms(lambda: torch.sparse.mm(csr, x), iters),
               "sddmm": cuda_ms(lambda: torch.sparse.sampled_addmm(
                   ones, x, yt, beta=0.0), iters),
               "softmax": cuda_ms(lambda: torch.sparse.softmax(coo, 1),
                                  iters)}
    # the backward's library call, on the forward's COO output and a COO
    # gradient of the same pattern, where it runs on the card (coalesce
    # sums the graph's multi-arcs: fewer entries than arcs)
    out_coo = torch.sparse.softmax(coo, 1)
    grad_coo = torch.sparse_coo_tensor(
        coo.indices(), da[:coo.values().numel()], (V, V)).coalesce()
    try:
        library["softmax backward"] = cuda_ms(
            lambda: torch.ops.aten._sparse_softmax_backward_data(
                grad_coo, out_coo, 1, coo), iters)
        library_note = None
    except (RuntimeError, NotImplementedError) as e:
        library["softmax backward"] = None
        library_note = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    items = es.csr.item_seg.numel()
    idx_bytes = (V + 1) * 4 + items * 8
    rows = V * D * 4
    bounds = {"spmm": bound(2 * rows + E * 8 + idx_bytes, 2 * E * D,
                            F32_FLOPS),
              "sddmm": bound(2 * rows + E * 8 + idx_bytes, 2 * E * D,
                             F32_FLOPS),
              # a score read and a weight written an arc; a max, an exp, a
              # sum and a divide
              "softmax": bound(E * 8 + (V + 1) * 4, 4 * E, F32_FLOPS),
              # a and dA read and the result written an arc; a product and
              # its sum, a difference and a product
              "softmax backward": bound(E * 12 + (V + 1) * 4, 4 * E,
                                        F32_FLOPS)}
    rate = {k: {"edges_per_s": E / (ms[k] / 1e3),
                "gathered_gb_per_s": E * D * 4 / (ms[k] / 1e3) / 1e9}
            for k in ("spmm", "spmm transposed", "spmm a warp a row",
                      "sddmm")}
    hubs = int((np.diff(g.offsets) > sp.CHUNK).sum())
    print(f"phase 20 the GNN-feed ops (K8): forward within rtol 1e-5 atol "
          f"1e-5 of the plain versions in float64 (max abs err by kernel "
          f"{err}), the gradients of spmm, spmm_mean, sddmm and "
          f"sddmm_softmax within it of the plain autograd in float64 (max "
          f"abs err by the kernel whose backward mode computes them "
          f"{grad_err}), on measure_spmm's graph ({V} V, {E} arcs, "
          f"{hubs} rows above {sp.CHUNK} arcs split; D 128 and 64) and the "
          f"directed test graph; the split rows' extremes and the hub row's "
          f"max in its last arc within it of float64 (max abs err "
          f"{split_err}); a GAT-style layer and its gradient launched "
          f"{launches}, its gradients' largest |err| / (|g| + 1) against the "
          f"plain layer in float64 {layer_err}; the SDDMM and both softmax "
          f"modes bit for bit in two runs; at D 128 ms by events around "
          f"each launch "
          f"(mean of {iters}) {ms}, back to back {back}, back to back by "
          f"arcs an item {by_chunk}; plain {plain}; "
          f"library calls (timed only: torch.sparse.mm on CSR, "
          f"sampled_addmm, sparse softmax on COO and its backward) "
          f"{library} ({library_note or 'each ran'}); rates {rate}; "
          f"bounds {bounds} [{smi}]")
    row = lambda k, lib: {"ms": ms[k], "ms_back_to_back": back[k],
                          "plain_ms": plain[k], "library_ms": library[lib],
                          **bounds[k], "max_abs_err": err[k],
                          "grad_max_abs_err": grad_err[k],
                          "launches": launches}
    return ({**row("spmm", "spmm"), **rate["spmm"],
             "transposed_ms": ms["spmm transposed"],
             "warp_a_row_ms": ms["spmm a warp a row"],
             "ms_by_chunk": {c: v["spmm"] for c, v in by_chunk.items()}},
            {**row("sddmm", "sddmm"), **rate["sddmm"],
             "split_rows_max_abs_err": split_err["sddmm"],
             "ms_by_chunk": {c: v["sddmm"] for c, v in by_chunk.items()}},
            {**row("softmax", "softmax"),
             "split_rows_max_abs_err": split_err["softmax"],
             "backward_ms": ms["softmax backward"],
             "backward_ms_back_to_back": back["softmax backward"],
             "backward_plain_ms": plain["softmax backward"],
             "backward_library_ms": library["softmax backward"],
             "backward_library_note": library_note,
             "backward_bound_ms": bounds["softmax backward"]["bound_ms"],
             "backward_bound_by": bounds["softmax backward"]["bound_by"],
             "backward_max_abs_err": split_err["softmax backward"],
             "layer_grad_err": layer_err})


# phase 21: (form, D, slot 0's tokens, slot 1's tokens) at two slots of the
# main shape (B 16 a slot at --w2vPartitions 2, T 82, window 10; k 5 or
# kB 128). "own negatives": the block's negatives are its own tokens
DP_CASES = [("exact", 128, "zipf", "zipf"),
            ("exact", 128, "zipf", "own negatives"),
            ("exact", 768, "zipf", "zipf"),
            ("conv", 128, "zipf", "zipf"),
            ("conv", 128, "zipf", "own negatives"),
            ("conv", 128, "hub negatives", "zipf"),
            ("conv", 768, "zipf", "own negatives")]
# K13 alone: (V, D) at the main shape and ragged
DP_APPLY_SHAPES = [(10_000, 128), (1_001, 37), (3, 1)]
DP_FLAGS = ["--w2vPartitions", "2"]
# phase 21 (c): two ranks on the card, each a process of its own
DP_RANK_WORKER = r"""
import json, sys, time
import numpy as np
import torch
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops.dp_apply import DP_APPLY
from stellar_rw_tpu_torch.parallel import dp

rank, port, corpus_path, V, out = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], int(sys.argv[4]), sys.argv[5])
backend = dp.init_group(rank, 2, ["cuda:0", "cuda:0"],
                        f"tcp://localhost:{port}")
blocks, rows = w2v.full_corpus_blocks(np.load(corpus_path), 2, rank, 2)
cfg = w2v.SGNSConfig(**json.loads(sys.argv[6]))
torch.cuda.synchronize()
t0 = time.perf_counter()
w_in, w_out = w2v.train_skipgram_multiproc(blocks, rows, V, cfg,
                                           num_devices=2, device="cuda")
seconds = time.perf_counter() - t0
np.save(f"{out}/rank{rank}.npy", np.stack([w_in, w_out]))
result = {"backend": backend, "all_reduces": dp.ALL_REDUCES,
          "merged_updates": DP_APPLY.launches, "seconds": seconds}
# one merged update of the main shape by hand: this rank's slot of
# chip_smoke.dp_fill's two into the buffer, the all-reduce, K13
from chip_smoke import conv_block
from stellar_rw_tpu_torch.ops import dp_apply as da, sgns_conv as sc
g = torch.Generator(device="cuda").manual_seed(40)
tables = [torch.randn((10_000, 128), generator=g, device="cuda") * 0.3
          for _ in range(2)]
buf = torch.zeros(da.buffer_numel(10_000, 128), device="cuda")
_, _, block, cwin, negs = conv_block(torch, 10_000, 16, 82, 10, 128, 1,
                                     40 + rank, "zipf")
sc.sgns_conv_step(*tables, block, cwin, negs, 0.025, 5 / 128, 10,
                  buffer=buf)
dp.merge(*tables, buf, 0.025, True)
torch.cuda.synchronize()
result["merged_buffer_empty"] = not bool(buf.any())
np.save(f"{out}/merged{rank}.npy", torch.stack(tables).cpu().numpy())
# the exact form across the ranks: each rank's slot in accumulate mode, the
# all-reduce, K13; then one merged update of the main shape by hand, with
# K13's precondition (acc 0 wherever the count is 0) read before it
from chip_smoke import dp_slots
from stellar_rw_tpu_torch.ops import sgns_exact as se
from stellar_rw_tpu_torch.ops.sgns_exact import (SGNS_EXACT_ACCUMULATE,
                                                SGNS_EXACT_MERGED)
for k in (SGNS_EXACT_ACCUMULATE, SGNS_EXACT_MERGED, DP_APPLY):
    k.launches = 0
dp.ALL_REDUCES = 0
cfg = w2v.SGNSConfig(**{**json.loads(sys.argv[6]), "shared_negatives": 0})
torch.cuda.synchronize()
t0 = time.perf_counter()
w_in, w_out = w2v.train_skipgram_multiproc(blocks, rows, V, cfg,
                                           num_devices=2, device="cuda")
result["exact"] = {"seconds": time.perf_counter() - t0,
                   "all_reduces": dp.ALL_REDUCES,
                   "accumulate_launches": SGNS_EXACT_ACCUMULATE.launches,
                   "merged_launches": SGNS_EXACT_MERGED.launches,
                   "merged_updates": DP_APPLY.launches}
np.save(f"{out}/rank{rank}_exact.npy", np.stack([w_in, w_out]))
(tables, slots, (Vm, B, T, win, k, _)) = dp_slots(torch, "exact", 128,
                                                  ("zipf", "zipf"), 0)
buf = torch.zeros(da.buffer_numel(Vm, 128), device="cuda")
se.sgns_exact_step(*tables, *slots[rank], 0.025, win, buffer=buf)
acc_in, acc_out, cnt_in, cnt_out = da.buffer_views(buf, Vm, 128)
result["exact"]["k13_precondition"] = not bool(
    acc_in[cnt_in == 0].any() or acc_out[cnt_out == 0].any())
dp.merge(*tables, buf, 0.025, True)
torch.cuda.synchronize()
result["exact"]["merged_buffer_empty"] = not bool(buf.any())
np.save(f"{out}/merged{rank}_exact.npy", torch.stack(tables).cpu().numpy())
print("RESULT " + json.dumps(result), flush=True)
torch.distributed.destroy_process_group()
"""


def dp_kernels() -> dict:
    """The data-parallel trainer's kernels (and modes), by name."""
    from stellar_rw_tpu_torch.ops.dp_apply import DP_APPLY
    from stellar_rw_tpu_torch.ops.sgns_conv import \
        SGNS_CONV_SCATTER_ACCUMULATE
    from stellar_rw_tpu_torch.ops.sgns_exact import (SGNS_EXACT_ACCUMULATE,
                                                    SGNS_EXACT_MERGED)

    return {"sgns_exact_merged": SGNS_EXACT_MERGED,
            "sgns_exact_accumulate": SGNS_EXACT_ACCUMULATE,
            "sgns_conv_scatter_accumulate": SGNS_CONV_SCATTER_ACCUMULATE,
            "dp_apply": DP_APPLY}


def dp_slots(torch, form, D, tokens, seed):
    """Two slots' blocks of the main shape on shared tables: each slot's
    block, windows and negatives (see DP_CASES)."""
    V, B, T, win, k, kB = 10_000, 16, 82, 10, 5, 128
    slots = []
    for s, tok in enumerate(tokens):
        if form == "exact":
            w_in, w_out, block, cwin, negs = exact_block(
                torch, V, B, T, win, k, D, seed=seed + s,
                tokens="zipf")
            if tok == "own negatives":     # each pair's first: its center
                negs[:, 0] = block.reshape(-1).clamp_min(0).repeat_interleave(
                    2 * win)
        else:
            w_in, w_out, block, cwin, negs = conv_block(
                torch, V, B, T, win, kB, D, seed + s,
                "zipf" if tok == "own negatives" else tok)
            if tok == "own negatives":     # the block's first kB tokens
                negs.copy_(block.reshape(-1)[:kB].clamp_min(0))
        if s == 0:
            tables = (w_in, w_out)
        slots.append((block, cwin, negs))
    return tables, slots, (V, B, T, win, k, kB)


def dp_buffer_empty(torch, buf, ws) -> bool:
    """The reduction buffer all zero, and the step's workspace as a step
    leaves it."""
    torch.cuda.synchronize()
    empty = not bool(buf.any())
    if hasattr(ws, "map"):
        return empty and workspace_empty(torch, ws)
    return empty and not bool(ws.arrive.any())


def dp_row(torch, launch, plain, b: dict, iters: int) -> dict:
    """A kernel's times between CUDA events and back to back, its plain
    version's, beside its bound."""
    (ms,) = cuda_ms_split((launch,), iters)
    return {"ms": ms, "ms_back_to_back": cuda_ms(launch, iters), **b,
            "plain_ms": (cuda_ms(plain, 3) + cuda_ms(plain, 3)) / 2,
            "library_ms": None}


def dp_scatter_row(torch, sc, w_in, w_out, block, cwin, negs, win, nw, buf,
                   iters: int) -> dict:
    """K5's scatter in accumulate mode on one conv block (the accumulate
    kernel and the negative half run first), timed into `buf` beside its
    bound and an index_add_ of its rows."""
    B, T = block.shape
    V, D = w_in.shape
    kB, N, row = negs.shape[0], B * T, D * 4
    ws = sc.ConvWorkspace(w_in, w_out, B, T, win, kB)
    sc.launch_accumulate(ws, w_in, w_out, block, cwin, negs, win, nw)
    sc.launch_negative_half(ws)
    launch = lambda: sc.launch_scatter_accumulate(ws, block, negs, nw, buf)
    plain = lambda: sc.sgns_conv_accumulate_ref(w_in, w_out, block, cwin,
                                                negs, nw, win, buf)
    torch.cuda.synchronize()
    tok = block.reshape(-1)
    adds = [(tok >= 0) & (ws.cnt[t] > 0) for t in (0, 1)]
    n_add = int(adds[0].sum()) + int(adds[1].sum())
    u_in = int(torch.unique(tok[adds[0]]).numel())
    u_out = int(torch.unique(torch.cat([tok[adds[1]], negs])).numel())
    # the block and the counts read, the rows of the positions that add,
    # the negatives' d_wn and the valid counts read; the touched buffer
    # rows and counts read and written
    b = bound(3 * N * 4 + (n_add + kB) * row + ws.valid.numel() * 4
              + (u_in + u_out) * (row + 4) * 2, (n_add + kB) * D, F32_FLOPS)
    out = dp_row(torch, launch, plain, b, iters)
    # the rows' part as one index_add_ into the buffer's [2V, D]
    # accumulators, its index and rows concatenated beforehand (the counts
    # and the negatives' weights aside)
    t = tok.clamp_min(0).long()
    idx = torch.cat([t, V + t, V + negs.long()])
    src = torch.cat([ws.d_in, ws.acc_out, ws.d_wn])
    acc2 = buf[:2 * V * D].view(2 * V, D)
    out.update(library_ms=cuda_ms(lambda: acc2.index_add_(0, idx, src),
                                  iters),
               library_call="index_add_ of the rows into the buffer's "
                            "[2V, D] accumulators, index and rows "
                            "concatenated beforehand (counts and negative "
                            "weights aside)",
               touched_positions=n_add)
    return out


def exact_work(torch, slots, window: int, k: int) -> tuple[int, int]:
    """The valid pairs of the slots' blocks and the distinct rows of both
    tables that they touch (a row counted once over the slots)."""
    from stellar_rw_tpu_torch.ops.sgns_exact import (_pairs_from_valid,
                                                    _valid_from_cwin)

    pairs, rows_in, rows_out = 0, [], []
    for block, cwin, negs in slots:
        valid, ctx = _valid_from_cwin(block, cwin, window)
        c, x, v = _pairs_from_valid(block, valid, ctx)
        pairs += int(v.sum())
        rows_in.append(c[v])
        rows_out += [x[v], negs.reshape(-1, k)[v].reshape(-1)]
    return pairs, (int(torch.unique(torch.cat(rows_in)).numel())
                   + int(torch.unique(torch.cat(rows_out)).numel()))


def dp_fill(torch, V: int, D: int, seed: int, every_row: bool = False):
    """(w_in, w_out, buffer, refill): tables [V, D] drawn from a seed on the
    card and a reduction buffer as two slots' conv accumulate steps fill it
    at the main shape (B 16, T 82, w 10, kB 128, Zipf tokens over V);
    refill() adds the same slots' sums into an empty buffer again by their
    scatter launches alone, as the trainer's last launches before K13 do.
    every_row: instead every count 1 to 5 and every acc row drawn (the
    dense case), refill(buf) a copy of it."""
    from stellar_rw_tpu_torch.ops import dp_apply as da
    from stellar_rw_tpu_torch.ops import sgns_conv as sc

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = lambda: torch.randn((V, D), generator=g, device="cuda") * 0.3
    w_in, w_out = w(), w()
    buf = torch.zeros(da.buffer_numel(V, D), device="cuda")
    if every_row:
        buf[:2 * V * D] = torch.randn(2 * V * D, generator=g, device="cuda")
        buf[2 * V * D:] = torch.randint(1, 6, (2 * V,), generator=g,
                                        device="cuda").float()
        fill = buf.clone()
        return w_in, w_out, buf, lambda into: into.copy_(fill)
    B, T, win, kB = 16, 82, 10, 128
    slots = []
    for s in range(2):      # the blocks' tables of width 1 are not used
        _, _, block, cwin, negs = conv_block(torch, V, B, T, win, kB, 1,
                                             seed + s, "zipf")
        ws = sc.ConvWorkspace(w_in, w_out, B, T, win, kB)
        sc.sgns_conv_step(w_in, w_out, block, cwin, negs, 0.025, 5 / kB,
                          win, ws, buffer=buf)
        slots.append((ws, block, negs))

    def refill(into):
        for ws, block, negs in slots:
            sc.launch_scatter_accumulate(ws, block, negs, 5 / kB, into)
    return w_in, w_out, buf, refill


def dp_apply_row(torch, da, w_in, w_out, fill, refill, lr: float,
                 iters: int) -> dict:
    """K13 on a filled buffer: bit for bit dp_apply_ref and the buffer
    empty after it; then timed between CUDA events with the buffer
    refilled before each launch (refill(buf)), back to back on a copy of
    the fill a launch (each copy cold in the L2), beside its bound, its
    plain version and torch.addcdiv x2."""
    V, D = w_in.shape
    acc_in, acc_out, cnt_in, cnt_out = da.buffer_views(fill, V, D)
    touched = int((cnt_in != 0).sum()) + int((cnt_out != 0).sum())
    r_in, r_out = w_in.clone(), w_out.clone()
    da.dp_apply_ref(r_in, r_out, fill.clone(), lr)
    k_in, k_out, k_buf = w_in.clone(), w_out.clone(), fill.clone()
    da.dp_apply(k_in, k_out, k_buf, lr)
    torch.cuda.synchronize()
    check(torch.equal(k_in, r_in) and torch.equal(k_out, r_out),
          f"dp_apply differs from dp_apply_ref on a fill at V {V}: max abs "
          f"err {float((k_in - r_in).abs().max()):.3g} / "
          f"{float((k_out - r_out).abs().max()):.3g}")
    check(not bool(k_buf.any()),
          f"dp_apply left the buffer of a fill at V {V} not empty")
    del r_in, r_out, k_in, k_out
    (_, ms) = cuda_ms_split((lambda: refill(k_buf),
                             lambda: da.dp_apply(w_in, w_out, k_buf, lr)),
                            iters)
    del k_buf
    bufs = iter([fill.clone() for _ in range(iters + 1)])
    back = cuda_ms(lambda: da.dp_apply(w_in, w_out, next(bufs), lr), iters)
    del bufs
    copy = fill.clone()
    plain_ms = cuda_ms(lambda: da.dp_apply_ref(w_in, w_out, copy, lr), 3)
    del copy
    c_in, c_out = cnt_in.clamp_min(1)[:, None], cnt_out.clamp_min(1)[:, None]

    def library():
        w_in.addcdiv_(acc_in, c_in, value=-lr)
        w_out.addcdiv_(acc_out, c_out, value=-lr)
    lib_ms = cuda_ms(library, iters)
    # the counts read; a touched row's acc and w read, w and acc's zeros
    # written, its count zeroed
    b = bound(8 * V + touched * (16 * D + 4), 3 * touched * D, F32_FLOPS)
    return {"ms": ms, "ms_back_to_back": back, **b, "plain_ms": plain_ms,
            "library_ms": lib_ms, "touched_rows": touched}


def phase_dp_check(torch, smi) -> tuple[dict, dict, dict, dict]:
    """Phase 21 (a): over two slots of the main shape (DP_CASES), the exact
    form's one-launch merged update against the plain merged update in
    float64, with its workspace empty after it; K4 in accumulate mode
    (both slots in one launch, and a launch a slot) and K5's scatter in
    accumulate mode against their plain versions in float64, then K13 on
    the buffer, the tables against the plain merged update in float64; K13
    alone bit for bit against dp_apply_ref (DP_APPLY_SHAPES, acc 0 where
    the count is 0, as the steps leave it); the buffer and the workspaces
    empty after every merged update; each kernel timed at the main shape
    beside its bound: the merged launch beside the parent's form (a slot's
    accumulate launch each, then K13), K4's accumulate mode over a slot and
    over two, the scatter also on the one-token block, K13 on dp_fill's
    buffers a-c, each bit for bit dp_apply_ref and emptied first."""
    from stellar_rw_tpu_torch.ops import dp_apply as da
    from stellar_rw_tpu_torch.ops import sgns_conv as sc
    from stellar_rw_tpu_torch.ops import sgns_exact as se

    lr = 0.025
    err = {"exact": 0.0, "conv": 0.0}
    mode_err = {"exact": 0.0, "conv": 0.0}
    merged_err = 0.0
    for i, (form, D, *tokens) in enumerate(DP_CASES):
        (w_in, w_out), slots, (V, B, T, win, k, kB) = dp_slots(
            torch, form, D, tokens, 10 * i)
        nw = k / kB
        # the plain merged update in float64
        a_in, a_out = w_in.double(), w_out.double()
        buf64 = torch.zeros(da.buffer_numel(V, D), dtype=torch.float64,
                            device="cuda")
        for block, cwin, negs in slots:
            if form == "exact":
                se.sgns_exact_accumulate_ref(a_in, a_out, block, cwin, negs,
                                             win, buf64)
            else:
                sc.sgns_conv_accumulate_ref(a_in, a_out, block, cwin, negs,
                                            nw, win, buf64)
        want_buf = buf64.clone()
        da.dp_apply_ref(a_in, a_out, buf64, lr)
        at = str(DP_CASES[i])
        if form == "exact":
            # the one-card merged update: one launch over both slots, no
            # buffer, no K13
            stacked = [torch.stack(x) for x in zip(*slots)]
            b_in, b_out = w_in.clone(), w_out.clone()
            ws = se.Workspace(b_in, b_out, 2 * B * T, win, k)
            se.sgns_exact_step(b_in, b_out, *stacked, lr, win, ws)
            check(workspace_empty(torch, ws),
                  f"the merged step left its workspace dirty at {at}")
            for table, got, want, old in (("w_in", b_in, a_in, w_in),
                                          ("w_out", b_out, a_out, w_out)):
                e = float((got.double() - want).abs().max())
                check(torch.allclose(got.double(), want, rtol=1e-5,
                                     atol=1e-6),
                      f"the one-launch merged update differs from the plain "
                      f"one in float64 at {at} ({table}): max abs err "
                      f"{e:.3g}")
                check(bool((got != old).any()),
                      "the merged update moved nothing")
                merged_err = max(merged_err, e)
        # the accumulate modes, then K13: the exact step's slots in one
        # launch (a rank's) and a launch a slot (the parent's form); the
        # conv step's a slot at a time
        for one_launch in ((True, False) if form == "exact" else (False,)):
            b_in, b_out = w_in.clone(), w_out.clone()
            buf = torch.zeros(da.buffer_numel(V, D), device="cuda")
            ws = (se.Workspace(b_in, b_out, 2 * B * T, win, k)
                  if form == "exact"
                  else sc.ConvWorkspace(b_in, b_out, B, T, win, kB))
            if one_launch:
                se.sgns_exact_step(b_in, b_out, *stacked, lr, win, ws,
                                   buffer=buf)
            for block, cwin, negs in ([] if one_launch else slots):
                if form == "exact":
                    se.sgns_exact_step(b_in, b_out, block, cwin, negs, lr,
                                       win, ws, buffer=buf)
                else:
                    sc.sgns_conv_step(b_in, b_out, block, cwin, negs, lr, nw,
                                      win, ws, buffer=buf)
            torch.cuda.synchronize()
            check(torch.equal(b_in, w_in) and torch.equal(b_out, w_out),
                  f"an accumulate step wrote the tables at {at}")
            counts = lambda b: torch.cat(da.buffer_views(b, V, D)[2:])
            check(torch.equal(counts(buf).double(), counts(want_buf)),
                  f"the accumulated counts differ from float64 at {at}")
            # the accumulate mode alone: its buffer applied in float64
            m_in, m_out = w_in.double(), w_out.double()
            da.dp_apply_ref(m_in, m_out, buf.double(), lr)
            da.dp_apply(b_in, b_out, buf, lr)
            check(dp_buffer_empty(torch, buf, ws),
                  f"the buffer or the workspace is not empty after the "
                  f"merged update at {at}")
            for table, got, mode, want, old in (
                    ("w_in", b_in, m_in, a_in, w_in),
                    ("w_out", b_out, m_out, a_out, w_out)):
                e_mode = float((mode - want).abs().max())
                check(torch.allclose(mode, want, rtol=1e-5, atol=1e-6),
                      f"{form}'s accumulate mode differs from the plain one "
                      f"in float64 at {at} ({table}): max abs err "
                      f"{e_mode:.3g}")
                e = float((got.double() - want).abs().max())
                check(torch.allclose(got.double(), want, rtol=1e-5,
                                     atol=1e-6),
                      f"the merged update differs from the plain one in "
                      f"float64 at {at} ({table}): max abs err {e:.3g}")
                check(bool((got != old).any()),
                      "the merged update moved nothing")
                err[form] = max(err[form], e)
                mode_err[form] = max(mode_err[form], e_mode)
    # K13 alone, bit for bit, and the buffer zeroed
    rng = np.random.default_rng(21)
    for V, D in DP_APPLY_SHAPES:
        f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
            np.float32)).cuda()
        w_in, w_out = f(V, D), f(V, D)
        cnt = torch.as_tensor(rng.integers(0, 6, 2 * V).astype(
            np.float32)).cuda()
        # acc 0 where the count is 0, as every accumulate step leaves it
        acc = f(2 * V, D) * (cnt != 0)[:, None]
        buf = torch.cat([acc.reshape(-1), cnt])
        r_in, r_out, r_buf = w_in.clone(), w_out.clone(), buf.clone()
        da.dp_apply_ref(r_in, r_out, r_buf, lr)
        da.dp_apply(w_in, w_out, buf, lr)
        torch.cuda.synchronize()
        check(torch.equal(w_in, r_in) and torch.equal(w_out, r_out),
              f"dp_apply differs from dp_apply_ref at V {V} D {D}: max abs "
              f"err {float((w_in - r_in).abs().max()):.3g}")
        check(not bool(buf.any()), f"dp_apply left the buffer at V {V} D {D}")
    # timed at the main shape (D 128, slot 0 of the Zipf case)
    iters = 20
    rows = {}
    for form in ("exact", "conv"):
        (w_in, w_out), slots, (V, B, T, win, k, kB) = dp_slots(
            torch, form, 128, ("zipf", "zipf"), 0)
        block, cwin, negs = slots[0]
        D = 128
        buf = torch.zeros(da.buffer_numel(V, D), device="cuda")
        N, row = B * T, D * 4
        if form == "exact":
            ws = se.Workspace(w_in, w_out, 2 * B * T, win, k)
            stacked = [torch.stack(x) for x in zip(*slots)]
            accumulate = lambda *a: (lambda: se.launch_step(
                ws, w_in, w_out, *a, win, lr, buffer=buf))
            # a slot's accumulate launch (the ranks' case, a slot a rank)
            P, touched = exact_work(torch, slots[:1], win, k)
            # the block's draws and the touched table rows read; the touched
            # rows of the buffer read and written, their counts too
            b = bound(tensor_bytes(block, cwin, negs) + touched * row
                      + touched * (row + 4) * 2,
                      2 * P * (1 + k) * D * 3 + touched * D, F32_FLOPS)
            rows[form] = dp_row(
                torch, accumulate(block, cwin, negs),
                lambda: se.sgns_exact_accumulate_ref(w_in, w_out, block,
                                                     cwin, negs, win, buf),
                b, iters)
            rows[form]["valid_pairs"] = P
            # both slots in one accumulate launch (a rank of two slots)
            P2, touched = exact_work(torch, slots, win, k)
            b = bound(tensor_bytes(*stacked) + touched * row
                      + touched * (row + 4) * 2,
                      2 * P2 * (1 + k) * D * 3 + touched * D, F32_FLOPS)
            two = dp_row(torch, accumulate(*stacked), lambda: None, b, iters)
            rows[form].update({f"two_slots_{key}": two[key] for key in (
                "ms", "ms_back_to_back", "bound_ms", "bound_by")})
            # the parent's merged update: a slot's accumulate launch each,
            # then K13
            parent = cuda_ms_split((accumulate(*slots[0]),
                                    accumulate(*slots[1]),
                                    lambda: da.dp_apply(w_in, w_out, buf,
                                                        lr)), iters)
            # the one-card merged update: one launch over both slots; it
            # reads both slots' draws and the touched rows, and writes those
            # rows (3 flops a touched row's column to update it)
            b = bound(tensor_bytes(*stacked) + touched * row * 2,
                      2 * P2 * (1 + k) * D * 3 + touched * D * 3, F32_FLOPS)
            rows["merged"] = dp_row(
                torch, lambda: se.launch_step(ws, w_in, w_out, *stacked, win,
                                              lr),
                lambda: se.sgns_exact_merged_ref(w_in, w_out, *stacked, lr,
                                                 win), b, iters)
            rows["merged"].update(
                max_abs_err=merged_err, valid_pairs=P2,
                rows_touched=touched, parent_form_ms=sum(parent),
                parent_form_ms_each=parent)
            check(workspace_empty(torch, ws) and not bool(buf.any()),
                  "the timed launches left the workspace or the buffer "
                  "dirty")
        else:
            rows[form] = dp_scatter_row(torch, sc, w_in, w_out, block, cwin,
                                        negs, win, k / kB, buf, iters)
            # the one-token block (a slot of B 16 whose every position is
            # one token), beside the same library call
            hub = conv_block(torch, V, B, T, win, kB, D, 7, "hub")
            one = dp_scatter_row(torch, sc, *hub, win, k / kB, buf, iters)
            rows[form].update({f"one_token_{key}": one[key] for key in (
                "ms", "ms_back_to_back", "library_ms", "bound_ms",
                "bound_by", "touched_positions")})
        rows[form].update(max_abs_err=err[form],
                          accumulate_mode_max_abs_err=mode_err[form])
    # K13 on buffers that two slots' accumulate steps filled at the main
    # shape (fill a: V 10,000; fill b: V 1,000,000, Zipf tokens over it) and
    # on one with every count nonzero (fill c): bit for bit dp_apply_ref,
    # the buffer empty after it, timed beside its bound and torch.addcdiv
    fills = {}
    for name, V in (("a", 10_000), ("b", 1_000_000), ("c", 10_000)):
        D = 128
        w_in, w_out, fill, refill = dp_fill(torch, V, D, 40,
                                            every_row=name == "c")
        fills[name] = dp_apply_row(torch, da, w_in, w_out, fill, refill, lr,
                                   iters if V <= 10_000 else 5)
        fills[name]["V"] = V
        del w_in, w_out, fill, refill
        torch.cuda.empty_cache()
    rows["apply"] = {**fills["a"], "max_abs_err": 0.0,
                     **{f"fill_{name}_{key}": fills[name][key]
                        for name in ("b", "c") for key in (
                            "ms", "ms_back_to_back", "bound_ms", "bound_by",
                            "library_ms", "touched_rows", "V")},
                     "library_call": "torch.addcdiv x2 on a pre-clamped "
                                     "count (not bitwise: one rounding "
                                     "fewer; a dense pass)"}
    conv, ap, mg, ex = rows["conv"], rows["apply"], rows["merged"], \
        rows["exact"]
    print(f"phase 21 (a) the data-parallel step: the exact form's merged "
          f"update of two slots in one launch (sgns_exact merged: no buffer, "
          f"no dp_apply) within rtol 1e-5 atol 1e-6 of the plain merged "
          f"update in float64 (max abs err {merged_err:.3g}); K4 in "
          f"accumulate mode (both slots in one launch, and a launch a slot) "
          f"and K5's scatter in accumulate mode, then dp_apply (K13), within "
          f"the same tolerance "
          f"at {DP_CASES} (form, D, slots' tokens): max abs err exact "
          f"{err['exact']:.3g} / conv {err['conv']:.3g} (the accumulate "
          f"modes' buffers applied in float64: {mode_err['exact']:.3g} / "
          f"{mode_err['conv']:.3g}), the counts equal, the tables untouched "
          f"by the accumulate steps, the buffer and the workspaces empty "
          f"after every merged update; dp_apply bit for bit dp_apply_ref at "
          f"{DP_APPLY_SHAPES} and on fills a-c; at the main shape (B 16 a "
          f"slot, T 82, w 10, D 128): the merged update's one launch "
          f"{mg['ms']:.4f} ms (back to back {mg['ms_back_to_back']:.4f}, "
          f"twin {mg['plain_ms']:.3f}, bound {mg['bound_ms']:.5f} by "
          f"{mg['bound_by']}; the parent's form, two accumulate launches and "
          f"dp_apply, {mg['parent_form_ms']:.4f} = "
          f"{' + '.join(f'{t:.4f}' for t in mg['parent_form_ms_each'])}); "
          f"sgns_exact accumulate over a slot {ex['ms']:.4f} ms (back to "
          f"back {ex['ms_back_to_back']:.4f}, plain {ex['plain_ms']:.3f}, "
          f"bound {ex['bound_ms']:.5f} by {ex['bound_by']}), over two slots "
          f"in one launch {ex['two_slots_ms']:.4f} (bound "
          f"{ex['two_slots_bound_ms']:.5f}); "
          f"conv scatter accumulate {conv['ms']:.4f} ms (back to back "
          f"{conv['ms_back_to_back']:.4f}, plain {conv['plain_ms']:.3f} for "
          f"the whole plain step, index_add_ of its rows "
          f"{conv['library_ms']:.4f}, bound {conv['bound_ms']:.5f} by "
          f"{conv['bound_by']}, {conv['touched_positions']} position-tables "
          f"that add), one token {conv['one_token_ms']:.4f} (back to back "
          f"{conv['one_token_ms_back_to_back']:.4f}, index_add_ "
          f"{conv['one_token_library_ms']:.4f}, bound "
          f"{conv['one_token_bound_ms']:.5f}); dp_apply on fill a (V "
          f"10,000, {ap['touched_rows']:,} of 20,000 rows touched) "
          f"{ap['ms']:.4f} ms (back to back {ap['ms_back_to_back']:.4f}, "
          f"plain {ap['plain_ms']:.4f}, torch.addcdiv x2 "
          f"{ap['library_ms']:.4f}, bound {ap['bound_ms']:.5f} by "
          f"{ap['bound_by']}); fill b (V 1,000,000, "
          f"{ap['fill_b_touched_rows']:,} of 2,000,000 touched) "
          f"{ap['fill_b_ms']:.4f} (back to back "
          f"{ap['fill_b_ms_back_to_back']:.4f}, addcdiv "
          f"{ap['fill_b_library_ms']:.4f}, bound "
          f"{ap['fill_b_bound_ms']:.5f}); fill c (every row) "
          f"{ap['fill_c_ms']:.4f} (back to back "
          f"{ap['fill_c_ms_back_to_back']:.4f}, addcdiv "
          f"{ap['fill_c_library_ms']:.4f}, bound "
          f"{ap['fill_c_bound_ms']:.5f}) [{smi}]")
    return rows["merged"], rows["exact"], rows["conv"], rows["apply"]


def phase_dp_main(torch, smi, tmp, main_run, exact_run) -> dict:
    """Phase 21 (b): `node2vec --w2vPartitions 2` through the CLI on phase
    4's graph, conv (kB 128) and exact, one epoch each: /path byte for
    byte phase 4's, the calls a merged update (conv: dp_apply once a
    merged update after the slots' steps; exact: one sgns_exact merged
    launch and nothing else: no accumulate launch, no dp_apply, no
    all-reduce), the epoch beside phases 4 and 12, the buffer's bytes and
    the job's peak; then the karate gate at num_partitions 4, exact and kB
    128."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.ops.dp_apply import buffer_numel
    from stellar_rw_tpu_torch.parallel import dp
    from stellar_rw_tpu_torch.walk import engine

    P = 2
    kernels = {**trainer_kernels(), **dp_kernels()}
    runs = {}
    for name, flags, beside in (("conv", MAIN_FLAGS, main_run),
                                ("exact", EXACT_FLAGS, exact_run)):
        out = os.path.join(tmp, f"out_dp_{name}")
        report = {}
        reset_counts(*kernels.values())
        dp.ALL_REDUCES = 0
        rc = cli.main(["--input", main_run["edges"], "--output", out]
                      + flags + DP_FLAGS, report=report)
        torch.cuda.synchronize()
        check(rc == 0, f"--w2vPartitions {P} ({name}) returned {rc}")
        counts = {k: t.launches for k, t in kernels.items()}
        check(same_path(out, main_run["out"]),
              f"--w2vPartitions {P} ({name}): /path differs from phase 4's")
        B = -(-32 // P)
        merged = -(-report["paths"] // (B * P))
        calls = sum(v for k, v in counts.items() if k != "trainer_draws")
        per = calls / merged
        if name == "conv":
            check(counts["dp_apply"] == merged,
                  f"{name}: dp_apply launched {counts['dp_apply']} times for "
                  f"{merged} merged updates: {counts}")
            check(counts["sgns_conv_scatter_accumulate"] == P * merged
                  and counts["sgns_conv_accumulate"] == P * merged
                  and counts["sgns_shared_grads"] == P * merged
                  and counts["sgns_conv_scatter"] == 0
                  and counts["sgns_exact_step"] == 0
                  and counts["sgns_exact_merged"] == 0,
                  f"the conv dp trainer's launches: {counts}")
            check(per <= 3 * P + 1.01, f"{per:.4f} calls a merged update")
        else:
            check(counts["sgns_exact_merged"] == merged
                  and counts["sgns_exact_accumulate"] == 0
                  and counts["dp_apply"] == 0
                  and counts["sgns_exact_step"] == 0
                  and counts["sgns_conv_accumulate"] == 0,
                  f"the exact dp trainer's launches: {counts}")
            check(per <= 1.01, f"{per:.4f} calls a merged update")
        check(dp.ALL_REDUCES == 0, "an all-reduce in one process")
        _, w_in, w_out = n2v.load_model(out)
        check(w_in.shape == (report["vertices"], 128)
              and np.isfinite(w_in).all() and np.isfinite(w_out).all(),
              f"{name} dp embeddings not finite or of the wrong shape")
        runs[name] = {"train_seconds": report["train_seconds"],
                      "single_device_seconds": beside["train_seconds"],
                      "merged_updates": merged, "calls_a_merged_update": per,
                      "launches": counts,
                      # the exact form in one process makes no buffer
                      "buffer_bytes": buffer_numel(report["vertices"],
                                                   128) * 4
                      if name == "conv" else 0,
                      "peak_device_bytes": report["peak_device_bytes"]}
    g = gio.load_edge_list(os.path.join(ROOT, "tests", "data", "karate.txt"),
                           weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2,
                                as_numpy=False, device="cuda")
    gate = {}
    for name, kB in (("exact", 0), ("kB 128", 128)):
        cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                             seed=1, shared_negatives=kB)
        w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg,
                                     num_partitions=4, device="cuda")
        gate[name] = karate_gate(w_in, g)
        check(gate[name][0] > 0.7 and gate[name][1] >= 0.85,
              f"karate gate at num_partitions 4 ({name}): {gate[name]}")
    print(f"phase 21 (b) node2vec --w2vPartitions {P} through the CLI on "
          f"phase 4's graph, /path byte-equal to phase 4's: conv (kB 128) "
          f"epoch {runs['conv']['train_seconds']:.3f} s (phase 4's single "
          f"device: {main_run['train_seconds']:.3f} s) over "
          f"{runs['conv']['merged_updates']} merged updates, "
          f"{runs['conv']['calls_a_merged_update']:.4f} calls a merged update "
          f"(<= {3 * P + 1.01}); exact epoch "
          f"{runs['exact']['train_seconds']:.3f} s (phase 12's: "
          f"{exact_run['train_seconds']:.3f} s), "
          f"{runs['exact']['calls_a_merged_update']:.4f} calls a merged "
          f"update (<= 1.01: one sgns_exact merged launch, no accumulate "
          f"launch, no dp_apply, no all-reduce); launches conv "
          f"{runs['conv']['launches']} "
          f"exact {runs['exact']['launches']}; reduction buffer "
          f"{runs['conv']['buffer_bytes']:,} B; the job's peak conv "
          f"{runs['conv']['peak_device_bytes']:,} B / exact "
          f"{runs['exact']['peak_device_bytes']:,} B (one device: "
          f"{main_run['peak_device_bytes']:,} / "
          f"{exact_run['peak_device_bytes']:,} B); karate gate at "
          f"num_partitions 4 (AUC, faction accuracy): {gate} [{smi}]")
    return {**runs, "karate_gate_p4": gate}


def phase_dp_ranks(torch, smi, tmp) -> dict:
    """Phase 21 (c): two gloo ranks on the one card, each a process of its
    own joined through parallel/dp.py::init_group, running
    train_skipgram_multiproc on the labeled synthetic graph's walks (kB
    64), against the single-process two-slot run on the card; the
    all-reduces, the backend, the micro-F1 gate."""
    import socket

    from stellar_rw_tpu_torch.graph import datasets
    from stellar_rw_tpu_torch.models import eval as ev
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.walk import engine

    sg, labels = datasets.synth_labeled_graph(1500, 15_000, communities=6,
                                              seed=7)
    walks = engine.random_walks(sg, walk_length=20, num_walks=3, p=0.25,
                                q=0.25, seed=1, device="cuda")
    corpus = os.path.join(tmp, "dp_corpus.npy")
    np.save(corpus, walks)
    V = sg.num_vertices
    kw = dict(dim=32, window=5, negatives=5, lr=0.1, iters=3, seed=1,
              shared_negatives=64)
    blocks, rows = w2v.full_corpus_blocks(walks, 2)
    t0 = time.perf_counter()
    want = w2v.train_skipgram_multiproc(blocks, rows, V,
                                        w2v.SGNSConfig(**kw), num_devices=2,
                                        device="cuda")
    one_s = time.perf_counter() - t0
    # the exact form in one process: one launch a merged update
    t0 = time.perf_counter()
    want_exact = w2v.train_skipgram_multiproc(
        blocks, rows, V, w2v.SGNSConfig(**{**kw, "shared_negatives": 0}),
        num_devices=2, device="cuda")
    one_exact_s = time.perf_counter() - t0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_RANK_WORKER, str(r), port, corpus, str(V),
         tmp, json.dumps(kw)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            check(p.returncode == 0, f"a rank failed: {stderr[-3000:]}")
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            check(bool(line), f"a rank printed no result: {stdout[-2000:]}")
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = [np.load(os.path.join(tmp, f"rank{r}.npy")) for r in range(2)]
    check(np.array_equal(got[0], got[1]), "the ranks' tables differ")
    err = max(float(np.abs(g - w).max()) for g, w in zip(got[0], want))
    for g, w in zip(got[0], want):
        check(np.allclose(g, w, rtol=2e-4, atol=1e-6),
              f"two ranks differ from the two-slot run: max abs err {err:.3g}")
    for r in results:
        check(r["backend"] == "gloo", f"backend {r['backend']}")
        check(r["all_reduces"] == r["merged_updates"] + 1,
              f"{r['all_reduces']} all-reduces for {r['merged_updates']} "
              f"merged updates")
    # the merged update by hand on both ranks: the buffer empty after it,
    # the ranks' tables equal, and both within rtol 1e-5 atol 1e-6 of the
    # same two slots in one process
    from stellar_rw_tpu_torch.ops import dp_apply as da
    merged = [np.load(os.path.join(tmp, f"merged{r}.npy")) for r in range(2)]
    check(all(r["merged_buffer_empty"] for r in results),
          "a rank's reduction buffer is not empty after its merged update")
    check(np.array_equal(merged[0], merged[1]),
          "the ranks' tables differ after the merged update by hand")
    w_in, w_out, buf, _ = dp_fill(torch, 10_000, 128, 40)
    da.dp_apply(w_in, w_out, buf, 0.025)
    one = np.stack([w_in.cpu().numpy(), w_out.cpu().numpy()])
    merged_err = float(np.abs(merged[0] - one).max())
    check(np.allclose(merged[0], one, rtol=1e-5, atol=1e-6),
          f"two ranks' merged update differs from one process's: max abs "
          f"err {merged_err:.3g}")
    # the exact form: each rank's slot in accumulate mode, the all-reduce
    # and K13, against the one-process run's one launch a merged update
    ex = [np.load(os.path.join(tmp, f"rank{r}_exact.npy")) for r in range(2)]
    check(np.array_equal(ex[0], ex[1]), "the ranks' exact tables differ")
    exact_err = max(float(np.abs(g - w).max())
                    for g, w in zip(ex[0], want_exact))
    check(all(np.allclose(g, w, rtol=2e-4, atol=1e-6)
              for g, w in zip(ex[0], want_exact)),
          f"two ranks' exact run differs from the one-process two-slot run: "
          f"max abs err {exact_err:.3g}")
    for r in results:
        e = r["exact"]
        check(e["accumulate_launches"] == e["merged_updates"] > 0
              and e["merged_launches"] == 0
              and e["all_reduces"] == e["merged_updates"] + 1,
              f"the exact form across ranks: {e}")
        check(e["k13_precondition"] and e["merged_buffer_empty"],
              f"the exact merged update by hand across ranks: {e}")
    merged_ex = [np.load(os.path.join(tmp, f"merged{r}_exact.npy"))
                 for r in range(2)]
    check(np.array_equal(merged_ex[0], merged_ex[1]),
          "the ranks' tables differ after the exact merged update by hand")
    from stellar_rw_tpu_torch.ops import sgns_exact as se
    (w_in, w_out), slots, (_, B, T, win, _, _) = dp_slots(
        torch, "exact", 128, ("zipf", "zipf"), 0)
    se.sgns_exact_step(w_in, w_out, *(torch.stack(x) for x in zip(*slots)),
                       0.025, win)
    one = np.stack([w_in.cpu().numpy(), w_out.cpu().numpy()])
    merged_exact_err = float(np.abs(merged_ex[0] - one).max())
    check(np.allclose(merged_ex[0], one, rtol=1e-5, atol=1e-6),
          f"two ranks' exact merged update differs from one process's one "
          f"launch: max abs err {merged_exact_err:.3g}")
    f1 = ev.multilabel_micro_f1(got[0][0], labels, train_frac=0.5, seed=0)
    check(f1 > 0.55, f"labeled synthetic gate on two ranks: micro-F1 {f1}")
    print(f"phase 21 (c) train_skipgram_multiproc on two ranks sharing the "
          f"card (backend {results[0]['backend']}: a device map of cuda:0 "
          f"twice), labeled synthetic (1,500 V, {rows} rows, kB 64, 3 "
          f"epochs): the ranks' tables equal, within rtol 2e-4 atol 1e-6 "
          f"of the single-process two-slot run (max abs err {err:.3g}); "
          f"one merged update of the main shape by hand on both ranks: "
          f"buffers empty, tables equal, {merged_err:.3g} from one "
          f"process's; "
          f"{results[0]['all_reduces']} all-reduces = "
          f"{results[0]['merged_updates']} merged updates + the token "
          f"counts'; micro-F1 {f1:.4f} (> 0.55); training "
          f"{max(r['seconds'] for r in results):.3f} s on two ranks, "
          f"{one_s:.3f} s in one process (not a target: gloo stages the "
          f"buffer through the host); exact negatives: each rank's slot by "
          f"sgns_exact accumulate, "
          f"{results[0]['exact']['accumulate_launches']} launches = merged "
          f"updates, then the all-reduce and dp_apply, within rtol 2e-4 atol "
          f"1e-6 of the one-process run's one launch a merged update (max "
          f"abs err {exact_err:.3g}), {max(r['exact']['seconds'] for r in results):.3f} s on "
          f"two ranks, {one_exact_s:.3f} s in one process; its merged update "
          f"of the main shape by hand: acc 0 wherever the count is 0 before "
          f"K13, the buffers empty after it, {merged_exact_err:.3g} from one "
          f"process's one launch [{smi}]")
    return {"max_abs_err": err, "micro_f1": f1,
            "merged_max_abs_err": merged_err,
            "two_rank_seconds": max(r["seconds"] for r in results),
            "one_process_seconds": one_s, "backend": results[0]["backend"],
            "exact_max_abs_err": exact_err,
            "exact_merged_max_abs_err": merged_exact_err,
            "exact_two_rank_seconds": max(r["exact"]["seconds"]
                                          for r in results),
            "exact_one_process_seconds": one_exact_s,
            "accumulate_launches": sum(r["exact"]["accumulate_launches"]
                                       for r in results)}


# phase 22: the sharded walk engine (K11) on two gloo ranks sharing the
# card, at phase 4's graph and walk (walk_10k: 10 x 80, p = q = 0.25), in
# three layouts: the hash route over 2 shards, a vertex-cut route over 2
# shards (homes drawn from a seed, routed home % 2), 1 shard x 2 lanes
SHARD_FLAGS = ["--cmd", "randomwalk", "--walkLength", "80", "--numWalks",
               "10", "--p", "0.25", "--q", "0.25"]
SHARD_LAYOUTS = {"hash": ["--shards", "2"],
                 "vcut": ["--shards", "2", "--partitioned", "true"],
                 "lanes": ["--shards", "2", "--lanes", "2"]}
SHARD_STATS = ("num_shards", "lanes", "capacity", "replication_factor",
               "boundary_walkers", "zero_neighbors", "overflow_steps",
               "exchange_rounds_total", "exchange_rounds_with_traffic")
# the superstep whose requests phase 22 holds the kernels to, and the
# capacity of its overflow check
SHARD_STEP = 5
SHARD_SMALL_C = 4096
SHARD_RANK_WORKER = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from chip_smoke import shard_home, plain_shard_walk
from stellar_rw_tpu_torch.graph import io as gio
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.ops import shard_walk, walk_step
from stellar_rw_tpu_torch.parallel import dp
from stellar_rw_tpu_torch.utils.config import parse

rank, port, edges, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          sys.argv[4])
layouts, flags = json.loads(sys.argv[5]), json.loads(sys.argv[6])
backend = dp.init_group(rank, 2, ["cuda:0", "cuda:0"],
                        f"tcp://localhost:{port}")
result = {"backend": backend}
kernels = {"shard_emit": shard_walk.EMIT_KERNEL,
           "shard_serve": shard_walk.SERVE_KERNEL,
           "walk": walk_step.WALK_KERNEL, "trial_keys": walk_step.KEYS_KERNEL}
for name, extra in layouts.items():
    params = parse(["--input", edges, "--output", f"{out}/{name}"] + flags
                   + extra)
    graph = gio.load_edge_list(edges, weighted=params.weighted,
                               directed=params.directed)
    home = shard_home(graph) if params.partitioned else None
    runs = {}
    for mode in ("main", "timed", "plain"):
        for k in kernels.values():
            k.launches = 0
        timing = {} if mode == "timed" else None
        report = {}
        with plain_shard_walk(mode == "plain"):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            walks = n2v.run_walks(graph, params, "cuda", home=home,
                                  report=report, timing=timing)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        report.pop("diag")
        runs[mode] = {"seconds": seconds, "stats": report,
                      "launches": {n: k.launches for n, k in kernels.items()},
                      "timing": timing}
        walks = walks.cpu().numpy()
        if mode == "main":
            corpus = walks
            runs[mode]["steps"] = int((walks[:, 1:] >= 0).sum())
            if rank == 0:
                gio.save_walks(walks, graph, params.output, 1)
        else:
            runs[mode]["same_corpus"] = bool(np.array_equal(walks, corpus))
    result[name] = runs
print("RESULT " + json.dumps(result), flush=True)
dist.destroy_process_group()
"""


def shard_graph():
    """Phase 4's graph as phases 22 and 25 load it: the arcs written to an
    edge list and read back."""
    from stellar_rw_tpu_torch.graph import io as gio

    src, dst = synth_power_law_arcs(10_000, 334_000, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        edges = os.path.join(tmp, "edges.txt")
        np.savetxt(edges, np.stack([src, dst], 1), fmt="%d")
        return gio.load_edge_list(edges)


def shard_home(graph):
    """Phase 22's vertex-cut homes: one of 4 partitions a vertex, from a
    seed (the partitioned loader draws them so for a file without a
    partition column)."""
    return np.random.default_rng(1).integers(
        0, 4, graph.num_vertices).astype(np.int32)


class plain_shard_walk:
    """Within it (when on), the sharded engine runs K11's plain versions
    (and the CDF serve's) on the card in place of its kernels: the plain
    path phases 22 and 25 hold the stats to."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from stellar_rw_tpu_torch.ops import shard_walk as sw

        self.saved = (sw.emit, sw.serve, sw.cdf_serve)
        if self.on:
            def fields(req, valid, gid_base):
                if isinstance(req, tuple):
                    fcur, fprev, _ = req
                    fgid = gid_base + torch_arange_like(fcur)
                else:
                    fcur, fprev, fgid = req[:, 0], req[:, 1], req[:, 2]
                return (fcur, fprev, fgid,
                        None if valid is None else valid != 0)

            def emit(*a):
                return sw.emit_ref(*a[:10])

            def cdf_serve(tab, req, valid, gid_base, *a, work=None,
                          segments=0, out=None, **kw):
                got = sw.cdf_serve_ref(tab, *fields(req, valid, gid_base),
                                       *a, **kw)
                return got if out is None else out.copy_(got)
            sw.emit, sw.serve, sw.cdf_serve = emit, sw.serve_plain, \
                cdf_serve
        return self

    def __exit__(self, *exc):
        from stellar_rw_tpu_torch.ops import shard_walk as sw

        sw.emit, sw.serve, sw.cdf_serve = self.saved
        return False


# K11's kernels with their bodies taken out (the launch of each grid in its
# own form): the emit after its wait and release, the serve after its wait
K11_EMPTY = {
    "shard_emit": [('  asm volatile("griddepcontrol.launch_dependents;");\n',
                    '  asm volatile("griddepcontrol.launch_dependents;");\n'
                    '  if (a.n >= 0) return;\n')],
    "shard_serve": [('  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
                     "  const int k = blockIdx.x",
                     '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
                     "  if (a.m >= 0) return;\n"
                     "  const int k = blockIdx.x")]}


def k11_empty_kernels() -> dict:
    """K11's kernels with their bodies out (K11_EMPTY), as Kernels of the
    package's build machinery, each bound to its wrapper's entry point."""
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import shard_walk as sw

    text = (build.CSRC / "shard_walk.cu").read_text()
    return {name: source_kernel(f"{name}_empty", edited(text, edits),
                                k.symbol, k.argtypes, "k11_empty")
            for (name, edits), k in zip(K11_EMPTY.items(),
                                        (sw.EMIT_KERNEL, sw.SERVE_KERNEL))}


class using_kernel:
    """Within it, ops/shard_walk.py's `name` Kernel is `kernel`."""

    def __init__(self, name: str, kernel):
        self.name, self.kernel = name, kernel

    def __enter__(self):
        from stellar_rw_tpu_torch.ops import shard_walk as sw

        self.saved = getattr(sw, self.name)
        setattr(sw, self.name, self.kernel)

    def __exit__(self, *exc):
        from stellar_rw_tpu_torch.ops import shard_walk as sw

        setattr(sw, self.name, self.saved)
        return False


def torch_arange_like(x):
    import torch

    return torch.arange(x.shape[0], dtype=torch.int32, device=x.device)


def shard_superstep(torch, graph, layout: str, corpus, cdf: bool = False,
                    rank: int = 0):
    """The walkers of a rank (0 or 1; walker i is gid rank * n + i) at
    superstep SHARD_STEP of phase 22's layout for a corpus of R rounds
    [R * V, L + 2]: (the shard tables, shard 0's first (one at one shard),
    cur, prev, alive, the gids' corpus rows, S, L, the auto capacity); cdf:
    the tables with their cdf_rows."""
    from stellar_rw_tpu_torch.graph.partition import plan_shards
    from stellar_rw_tpu_torch.ops import shard_walk
    from stellar_rw_tpu_torch.parallel import distributed

    V = graph.num_vertices
    L = 2 if layout == "lanes" else 1
    S = 2 // L
    route = (shard_home(graph) % S if layout == "vcut" else None)
    plan = plan_shards(graph, S, route)
    tabs = [shard_walk.shard_tables(graph, plan, s, "cuda", cdf=cdf)
            for s in range(S)]
    W_pad = -(-V // 2) * 2
    n = corpus.shape[0] // V * W_pad // 2
    gid = rank * n + torch.arange(n, device="cuda")
    # a lane past V is shard padding: never alive
    lane = gid % W_pad
    rows = (gid // W_pad) * V + lane.clamp_max(V - 1)
    t = SHARD_STEP
    cur = corpus[rows, t].contiguous()
    prev = corpus[rows, t - 1].contiguous()
    alive = ((cur >= 0) & (lane < V)).to(torch.int32)
    C = max(1, min(distributed.auto_capacity(graph, plan.route, 2, n), n))
    return tabs, cur, prev, alive, rows, S, L, C, W_pad


def emit_bytes(n: int, first: bool, routed: int, pending: int, sent: int,
               refilled: int, tiles: int, D: int) -> int:
    """The bytes one emit launch must move: the first round reads cur,
    prev and alive (12 B a walker) and writes the pending and local flags
    (8 B); a later round reads the pending flags (4 B a walker) and the
    pending walkers' cur and prev, and clears a sent walker's flag. Both
    read the route of each walker routed (VCut), write 16 B a request sent
    (its fields and slot) and a fill re-written, a status word a tile and
    column, and the counters."""
    flags = 20 * n if first else 4 * n + 8 * pending + 4 * sent
    return flags + 4 * routed + 16 * (sent + refilled) + 8 * tiles * D + 12


def phase_shard_check(torch, smi, graph, empty) -> tuple[dict, dict]:
    """Phase 22 (a): K11's two halves against their plain versions on the
    card at one superstep of each layout (the walkers of ranks 0 and 1 of
    phase 4's corpus at superstep SHARD_STEP). The emit's buffers, slots,
    counts and flags bit for bit, at the auto capacity and at
    SHARD_SMALL_C, each over three launches into one work (the first
    round, the next, the first again: the buffers re-filled as the counts
    shrink and grow). The serve: one launch of rank 0's walkers with their
    local flags and the buffer it receives (its own bucket and rank 1's
    requests for shard 0) bit for bit serve_plain's, each step the
    corpus's next column; one superstep (emit, serve, the next round's
    emit) under torch.cuda.set_sync_debug_mode("error"). Each kernel timed
    beside its empty launch (`empty`: K11_EMPTY's kernels) and its bound;
    the emit both on its first round again and again (the buffer as the
    last launch left it) and on first and next rounds in turn (each launch
    re-fills the entries the other one sent). Returns the two kernels'
    rows."""
    from stellar_rw_tpu_torch.ops import prng, sampling, shard_walk
    from stellar_rw_tpu_torch.ops import walk_step
    from stellar_rw_tpu_torch.walk import engine

    V, R, Lw = graph.num_vertices, 10, 80
    corpus = engine.random_walks(graph, walk_length=Lw, num_walks=R,
                                 p=0.25, q=0.25, seed=0, as_numpy=False,
                                 device="cuda")
    _, max_rounds = sampling.plan_sampler("rejection", 0.25, 0.25)
    keys = walk_step.trial_keys(prng.prng_key(0), 0, R, Lw, 4 * max_rounds,
                                device="cuda")
    rows_out = {"shard_emit": {}, "shard_serve": {}}
    errs = {"shard_emit": 0, "shard_serve": 0}

    def held(name, a, b, what):
        """a bit for b, and the largest difference into errs[name]"""
        if a.numel():
            errs[name] = max(errs[name],
                             int((a.long() - b.long()).abs().max()))
        check(torch.equal(a, b), f"{name} differs from its plain version "
              f"({what})")
    t = SHARD_STEP
    for layout in SHARD_LAYOUTS:
        ranks = [shard_superstep(torch, graph, layout, corpus, rank=r)
                 for r in range(2)]
        tabs, cur, prev, alive, rows, S, L, C, W_pad = ranks[0]
        D, n = S * L, cur.shape[0]
        i32 = lambda: torch.zeros(n, dtype=torch.int32, device="cuda")
        rounds = {}
        for cap in (C, SHARD_SMALL_C):
            work = shard_walk.emit_work(n, D, cap, "cuda")
            pk, lk, pr, lr = i32(), i32(), i32(), i32()
            rounds[cap] = []
            for first in (True, False, True):
                k = [x.clone() for x in shard_walk.emit(
                    tabs[0], cur, prev, pk, alive if first else None, lk, L,
                    D, 0, cap, work)]
                r = shard_walk.emit_ref(tabs[0], cur, prev, pr,
                                        alive if first else None, lr, L, D,
                                        0, cap)
                torch.cuda.synchronize()
                what = f"{layout}, C {cap}, launch {len(rounds[cap])}"
                for a, b in zip(k, r):
                    held("shard_emit", a, b, what)
                held("shard_emit", pk, pr, f"pending flags, {what}")
                held("shard_emit", lk, lr, f"local flags, {what}")
                rounds[cap].append([int(v) for v in r[2]])
        # rank 0's superstep: its emit, the buffer it receives, one serve
        kw = dict(W_pad=W_pad, W_total=R * W_pad, n_stream=V, p=0.25,
                  q=0.25)
        sends = []
        for rk, (rtabs, rcur, rprev, ralive, *_) in enumerate(ranks):
            lk = i32()
            send, *_ = shard_walk.emit(
                rtabs[rk // L], rcur, rprev, i32(), ralive, lk, L, D, rk * n,
                C, shard_walk.emit_work(n, D, C, "cuda"))
            sends.append(send.clone())
            if rk == 0:
                local_flags = lk
        mine = (cur, prev, local_flags)
        # rank 0 receives bucket 0 of every rank's buffer (ranks 0, 1 are
        # devices 0, 1)
        recv = torch.stack([sends[0][0], sends[1][0]]).contiguous()
        dst_k, reply_k = shard_walk.serve(tabs[0], keys, t, False, local=mine,
                                          recv=recv, **kw)
        counts, rcounts = {}, {}
        lm = local_flags != 0
        count = int(lm.sum())
        (dst_r, reply_r), plain_ms = cuda_ms_once(
            lambda: shard_walk.serve_plain(tabs[0], keys, t, False,
                                           local=mine, recv=recv, **kw))
        shard_walk.serve_ref(tabs[0], cur, prev, torch_arange_like(cur), lm,
                             keys, t, False, counts=counts, **kw)
        flat = recv.reshape(-1, 3)
        shard_walk.serve_ref(tabs[0], flat[:, 0], flat[:, 1], flat[:, 2],
                             None, keys, t, False, counts=rcounts, **kw)
        torch.cuda.synchronize()
        held("shard_serve", dst_k, dst_r, f"local walkers, {layout}")
        held("shard_serve", reply_k, reply_r, f"received buffer, {layout}")
        nxt = corpus[rows, t + 1]
        check(torch.equal(dst_k[lm], nxt[lm])
              and bool((dst_k[~lm] == -1).all()), f"shard_serve's local "
              f"steps differ from the corpus ({layout})")
        ok = flat[:, 2] >= 0
        g = flat[ok, 2].long()
        check(torch.equal(reply_k[ok], corpus[(g // W_pad) * V + g % W_pad,
                                              t + 1])
              and bool((reply_k[~ok] == -1).all()),
              f"shard_serve's received steps differ from the corpus "
              f"({layout})")
        # one superstep on the card alone: the emit, the serve, the next
        # round's emit
        sync_pend, sync_loc = i32(), i32()
        sync_work = shard_walk.emit_work(n, D, C, "cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            shard_walk.emit(tabs[0], cur, prev, sync_pend, alive, sync_loc,
                            L, D, 0, C, sync_work)
            shard_walk.serve(tabs[0], keys, t, False,
                             local=(cur, prev, sync_loc), recv=recv, **kw)
            shard_walk.emit(tabs[0], cur, prev, sync_pend, None, None, L, D,
                            0, C, sync_work)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # times: the emit's first round again and again (no entry to
        # re-fill), the first and next rounds in turn, the serve of the
        # superstep, each beside its grid's empty launch
        pend, loc = i32(), i32()
        i32_empty = (i32(), i32())
        emit_work = shard_walk.emit_work(n, D, C, "cuda")
        emit_fn = lambda: shard_walk.emit(tabs[0], cur, prev, pend, alive,
                                          loc, L, D, 0, C, emit_work)
        turn_work = shard_walk.emit_work(n, D, C, "cuda")
        turn_flags = (i32(), i32())

        def emit_turns():
            shard_walk.emit(tabs[0], cur, prev, turn_flags[0], alive,
                            turn_flags[1], L, D, 0, C, turn_work)
            shard_walk.emit(tabs[0], cur, prev, turn_flags[0], None, None,
                            L, D, 0, C, turn_work)
        serve_fn = lambda: shard_walk.serve(tabs[0], keys, t, False,
                                            local=mine, recv=recv,
                                            dst=dst_k, reply=reply_k, **kw)
        emit_ms = cuda_ms(emit_fn, 20)
        turns_ms = cuda_ms(emit_turns, 20)
        serve_ms = cuda_ms(serve_fn, 20)
        empty_work = shard_walk.emit_work(n, D, C, "cuda")
        with using_kernel("EMIT_KERNEL", empty["shard_emit"]):
            emit_empty_ms = cuda_ms(lambda: shard_walk.emit(
                tabs[0], cur, prev, i32_empty[0], alive, i32_empty[1], L, D,
                0, C, empty_work), 20)
        with using_kernel("SERVE_KERNEL", empty["shard_serve"]):
            serve_empty_ms = cuda_ms(serve_fn, 20)
        _, emit_plain_ms = cuda_ms_once(lambda: shard_walk.emit_ref(
            tabs[0], cur, prev, i32(), alive, i32(), L, D, 0, C))
        # the library yardstick: the emit's function in PyTorch calls,
        # emit_ref's body less its allocations: each pending walker's
        # destination (route, gid % L), torch.sort(stable=True), the ranks
        # in the buckets by bincount and cumsum, and the scatter of the
        # walkers ranked below C; held to the kernel's buffer
        waiting = (alive != 0) & (loc == 0)
        gid = torch.arange(n, device="cuda")
        fields = torch.stack([cur, prev, gid.to(torch.int32)], 1)
        buf = torch.zeros((D, C, 3), dtype=torch.int32, device="cuda")
        buf[..., 2] = -1
        to_shard = shard_walk._dest_shard(tabs[0], cur).long() * L

        def library():
            dest = torch.where(waiting, to_shard + gid % L, D)
            order = torch.sort(dest, stable=True).indices
            sd = dest[order]
            counts = torch.bincount(dest, minlength=D + 1)[:D]
            bstart = torch.cumsum(counts, 0) - counts
            rank = gid - bstart[sd.clamp_max(D - 1)]
            sent = (sd < D) & (rank < C)
            buf[sd[sent], rank[sent]] = fields[order[sent]]
        library_ms = cuda_ms(library, 20)
        check(torch.equal(buf, sends[0]), f"the library yardstick's buffer "
              f"differs from shard_emit's ({layout})")
        # the bounds, from this run's counts: the first round sends
        # `sent` and leaves `left`; in turns, the next round sends the
        # rest and re-fills the first's entries, then the first re-fills
        # the next's
        (before, left), (before2, left2) = rounds[C][:2]
        sent, sent2 = before - left, before2 - left2
        routed = int((alive != 0).sum()) if tabs[0].route is not None else 0
        tiles = max(1, -(-n // shard_walk.EMIT_THREADS))
        first_bytes = emit_bytes(n, True, routed, 0, sent, 0, tiles, D)
        eb = bound(first_bytes, 0, INT_OPS_PER_S)
        tb = bound(first_bytes + emit_bytes(
            n, False, before2 if routed else 0, before2, sent2, sent - sent2,
            tiles, D), 0, INT_OPS_PER_S)
        served = counts["served"] + rcounts["served"]
        draws = sum(2 * c["dense_trials"] + 3 * c["lane_trials"]
                    + c["acc_draws"] for c in (counts, rcounts))
        trials = sum(c["dense_trials"] + c["lane_trials"]
                     for c in (counts, rcounts))
        slots = flat.shape[0]
        received = int(ok.sum())
        # the flags, cur and prev of the local walkers, dst; every slot's
        # gid and the received requests' cur and prev, reply; the rows
        sb = bound(8 * n + 8 * count + 8 * slots + 8 * received
                   + 16 * (2 * served + 2 * trials),
                   draws * OPS_PER_DRAW, INT_OPS_PER_S)
        rows_out["shard_emit"][layout] = {
            "ms": emit_ms, "empty_launch_ms": emit_empty_ms,
            "plain_ms": emit_plain_ms, "library_ms": library_ms, **eb,
            "turns_ms_a_launch": turns_ms / 2,
            "turns_bound_ms_a_launch": tb["bound_ms"] / 2,
            "walkers": n, "capacity": C, "sent": sent,
            "counts": {str(c): v for c, v in rounds.items()}}
        rows_out["shard_serve"][layout] = {
            "ms": serve_ms, "empty_launch_ms": serve_empty_ms,
            "plain_ms": plain_ms, **sb, "library_ms": None,
            "local": count, "received_slots": slots, "received": received,
            "served": served, "trials": trials,
            "max_trials": max(counts["max_trials"], rcounts["max_trials"]),
            "draws": draws}
        print(f"phase 22 (a) {layout}: shard_emit bitwise emit_ref over "
              f"{n} walkers (C {C} and {SHARD_SMALL_C}, three launches "
              f"into one work each; counts {rounds}): the first round "
              f"{emit_ms:.5f} ms (bound {eb['bound_ms']:.5f} by "
              f"{eb['bound_by']}), the first and next rounds in turn "
              f"{turns_ms / 2:.5f} ms a launch (bound "
              f"{tb['bound_ms'] / 2:.5f}), its empty launch "
              f"{emit_empty_ms:.5f}, plain {emit_plain_ms:.2f}, the library "
              f"calls (stable sort, bincount ranks, scatter) "
              f"{library_ms:.4f}; shard_serve bitwise serve_plain and the "
              f"corpus's column {t + 1} in one launch of the {count} local "
              f"walkers of {n} and the {received} requests received in "
              f"{slots} slots ({trials} trials, at most "
              f"{rows_out['shard_serve'][layout]['max_trials']} a "
              f"request): kernel {serve_ms:.4f} ms, its empty launch "
              f"{serve_empty_ms:.4f}, plain {plain_ms:.2f}, bound "
              f"{sb['bound_ms']:.5f} by {sb['bound_by']}; one superstep "
              f"under sync debug 'error' [{smi}]")
    return ({"max_abs_err": errs["shard_emit"],
             **rows_out["shard_emit"]["hash"],
             "layouts": rows_out["shard_emit"]},
            {"max_abs_err": errs["shard_serve"],
             **rows_out["shard_serve"]["hash"],
             "layouts": rows_out["shard_serve"]})


def phase_shard_ranks(torch, smi, tmp, main_run) -> dict:
    """Phase 22 (b): run_walks on two gloo ranks sharing the card (each a
    process of its own, as phase 21 (c)), in each layout: /path byte for
    byte phase 4's (rank 0 writes it), the stats of the kernels' run equal
    to the plain path's on the card, the corpus of a timed run and of the
    plain run equal to the first, K11's launches and no walk kernel launch;
    the walk's seconds, steps/s, supersteps, exchange rounds, the
    kernels' ms and the collectives' host ms a superstep."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RANK_WORKER, str(r), port,
         main_run["edges"], tmp, json.dumps(SHARD_LAYOUTS),
         json.dumps(SHARD_FLAGS)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=420)
            check(p.returncode == 0, f"a rank failed: {stderr[-3000:]}")
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            check(bool(line), f"a rank printed no result: {stdout[-2000:]}")
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = {"backend": results[0]["backend"]}
    for layout in SHARD_LAYOUTS:
        check(same_path(os.path.join(tmp, layout), main_run["out"]),
              f"phase 22 {layout}: /path differs from phase 4's")
        runs = [r[layout] for r in results]
        main = [r["main"] for r in runs]
        for r in runs:
            check(r["timed"]["same_corpus"] and r["plain"]["same_corpus"],
                  f"{layout}: the timed or plain run's corpus differs")
            for k in SHARD_STATS:
                check(r["main"]["stats"][k] == r["plain"]["stats"][k],
                      f"{layout}: stat {k} {r['main']['stats'][k]} against "
                      f"the plain path's {r['plain']['stats'][k]}")
            la = r["main"]["launches"]
            rounds = r["main"]["stats"]["exchange_rounds_total"]
            # one emit and one serve an exchange round
            check(la["shard_emit"] == rounds and la["shard_serve"] == rounds
                  and la["walk"] == 0 and la["trial_keys"] == 1,
                  f"{layout}: launches {la}, {rounds} exchange rounds")
            check(r["plain"]["launches"]["shard_emit"] == 0
                  and r["plain"]["launches"]["shard_serve"] == 0,
                  f"{layout}: the plain run launched K11")
        st = main[0]["stats"]
        tm = [r["timed"]["timing"] for r in runs]
        sec = max(m["seconds"] for m in main)
        steps = main[0]["steps"]
        sup = tm[0]["supersteps"]
        row = {"walk_seconds": sec, "steps_per_s": steps / sec,
               "plain_walk_seconds": max(r["plain"]["seconds"]
                                         for r in runs),
               "stats": {k: st[k] for k in SHARD_STATS},
               "launches": [m["launches"] for m in main],
               "emit_ms_a_superstep": max(t["emit_ms"] for t in tm) / sup,
               "serve_ms_a_superstep": max(t["serve_ms"] for t in tm) / sup,
               "collective_host_ms_a_superstep":
                   max(t["collective_host_ms"] for t in tm) / sup,
               "timed_walk_seconds": max(r["timed"]["seconds"]
                                         for r in runs)}
        out[layout] = row
        print(f"phase 22 (b) {layout}: run_walks on two gloo ranks sharing "
              f"the card ({st['num_shards']} shards x {st['lanes']} lanes), "
              f"/path byte-equal to phase 4's; walk {sec:.3f} s = "
              f"{steps / sec:,.0f} steps/s (the plain path "
              f"{row['plain_walk_seconds']:.2f} s); {sup} supersteps, "
              f"{st['exchange_rounds_total']} exchange rounds "
              f"({st['exchange_rounds_with_traffic']} with traffic, "
              f"{st['overflow_steps']} overflow supersteps), boundary "
              f"walkers {st['boundary_walkers']}, replication factor "
              f"{st['replication_factor']:.4f}, capacity {st['capacity']} "
              f"(stats equal to the plain path's); a superstep: shard_emit "
              f"{row['emit_ms_a_superstep']:.4f} ms, shard_serve "
              f"{row['serve_ms_a_superstep']:.4f} ms (CUDA events), "
              f"collectives {row['collective_host_ms_a_superstep']:.3f} ms "
              f"of host time (the timed run {row['timed_walk_seconds']:.3f} "
              f"s); launches {row['launches']} [{smi}]")
    print(f"  the exchange: all_to_all_single on CUDA tensors under "
          f"{out['backend']}")
    return out


# phase 23: dim-sharded tables on the one card (--w2vModelShards 2) and
# sgns_loss. The CLI at phase 4's graph and width, conv and (with
# --w2vPartitions 2) exact; karate runs on the card against the CPU's plain
# run of the same flags
MP_FLAGS = ["--w2vModelShards", "2"]
KARATE_MP_FLAGS = ["--cmd", "node2vec", "--walkLength", "20", "--numWalks",
                   "10", "--dim", "32", "--window", "5", "--iter", "2",
                   "--seed", "2"] + MP_FLAGS
# sgns_loss's pairs on phase 4's tables: (pairs, negatives a pair)
LOSS_SHAPE = (100_000, 5)
# phase 24: the multi-host CLI, two processes joined by SRW_* on the card.
# The hash route through `python -m stellar_rw_tpu_torch` itself; the
# vertex-cut route, node2vec and embedding through a worker that calls
# cli.main as that module does and reads the kernels' counts after each
MULTIHOST_RUNS = {"vcut": SHARD_FLAGS + ["--partitioned", "true"],
                  "node2vec": MAIN_FLAGS,
                  "embedding": EMBED_FLAGS}
MULTIHOST_WORKER = r"""
import contextlib, io, json, os, sys
import torch
import torch.distributed as dist
from chip_smoke import dp_kernels, trainer_kernels
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.ops import shard_walk
from stellar_rw_tpu_torch.parallel import dp, multihost

kernels = {"shard_emit": shard_walk.EMIT_KERNEL,
           "shard_serve": shard_walk.SERVE_KERNEL,
           "shard_cdf_serve": shard_walk.CDF_SERVE_KERNEL,
           **trainer_kernels(), **dp_kernels()}
joined = {}
initialize = multihost.initialize


def recorded(*args, **kw):
    device = initialize(*args, **kw)
    joined.update(device=str(device), backend=dist.get_backend())
    return device


multihost.initialize = recorded
result = {}
for run in json.loads(sys.argv[1]):
    os.environ["SRW_COORDINATOR"] = f"127.0.0.1:{run['port']}"
    for k in kernels.values():
        k.launches = 0
    dp.ALL_REDUCES = 0
    report, out = {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(run["argv"], report=report)
    result[run["name"]] = {
        "rc": rc, "stdout": out.getvalue(), **joined,
        "report": {k: v for k, v in report.items()
                   if isinstance(v, (int, float))},
        "launches": {n: k.launches for n, k in kernels.items()},
        "all_reduces": dp.ALL_REDUCES}
print("RESULT " + json.dumps(result), flush=True)
"""


def phase_model_shards(torch, smi, tmp, main_run, exact_run) -> dict:
    """Phase 23: `node2vec --w2vModelShards 2` through the CLI on phase 4's
    graph at its width (conv, kB 128): /path byte for byte phase 4's, the
    trainer's kernels a block as in phase 4 and no dp kernel (one slot:
    the one-device update with the slot key, so its tables differ from
    phase 4's), the epoch beside phase 4's; `--w2vPartitions 2
    --w2vModelShards 2` with exact negatives: one K4 launch a merged
    update and nothing else, as phase 21 (b); the karate gate at
    model_shards 2 (exact and kB 32); karate through the CLI on the card
    against the CPU's plain run of the same flags (rtol 1e-4 atol 1e-6);
    sgns_loss on the card against the CPU on phase 4's tables (rtol
    1e-6)."""
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.walk import engine

    kernels = {**trainer_kernels(), **dp_kernels()}
    runs = {}
    for name, flags, beside in (
            ("conv", MAIN_FLAGS + MP_FLAGS, main_run),
            ("exact_p2", EXACT_FLAGS + DP_FLAGS + MP_FLAGS, exact_run)):
        out = os.path.join(tmp, f"out_mp_{name}")
        report = {}
        reset_counts(*kernels.values())
        rc = cli.main(["--input", main_run["edges"], "--output", out]
                      + flags, report=report)
        torch.cuda.synchronize()
        check(rc == 0, f"--w2vModelShards 2 ({name}) returned {rc}")
        check(same_path(out, main_run["out"]),
              f"--w2vModelShards 2 ({name}): /path differs from phase 4's")
        counts = {k: t.launches for k, t in kernels.items()}
        _, w_in, w_out = n2v.load_model(out)
        check(np.isfinite(w_in).all() and np.isfinite(w_out).all(),
              f"--w2vModelShards 2 ({name}): tables not finite")
        if name == "conv":
            _, blocks, per = trainer_launches(report)
            check(all(counts[k] == main_run[k] for k in trainer_kernels())
                  and not any(counts[k] for k in dp_kernels()),
                  f"--w2vModelShards 2: launches {counts}, phase 4's "
                  f"{ {k: main_run[k] for k in trainer_kernels()} }")
            check(per <= 3.01, f"{per:.4f} calls a block")
            moved = float(np.abs(w_in - n2v.load_model(
                main_run["out"])[1]).max())
            check(moved > 1e-4, "--w2vModelShards 2 drew phase 4's stream, "
                  "not the slot key's")
        else:
            merged = -(-report["paths"] // 32)
            per = sum(v for k, v in counts.items()
                      if k != "trainer_draws") / merged
            check(counts["sgns_exact_merged"] == merged
                  and counts["sgns_exact_accumulate"] == 0
                  and counts["dp_apply"] == 0
                  and counts["sgns_exact_step"] == 0, f"launches {counts}")
            check(per <= 1.01, f"{per:.4f} calls a merged update")
        runs[name] = {"train_seconds": report["train_seconds"],
                      "beside_seconds": beside["train_seconds"],
                      "calls": per, "launches": counts}
    karate = os.path.join(ROOT, "tests", "data", "karate.txt")
    g = gio.load_edge_list(karate, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2,
                                as_numpy=False, device="cuda")
    gate = {}
    for name, kB in (("exact", 0), ("kB 32", 32)):
        cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                             seed=1, shared_negatives=kB, model_shards=2)
        w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg,
                                     device="cuda")
        gate[name] = karate_gate(w_in, g)
        check(gate[name][0] > 0.7 and gate[name][1] >= 0.85,
              f"karate gate at model_shards 2 ({name}): {gate[name]}")
    plain = {}
    for name, extra in (("exact", []), ("kB 32", ["--sharedNegatives",
                                                   "32"])):
        tables = []
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"out_mp_karate_{dev}_{len(extra)}")
            check(cli.main(["--input", karate, "--output", out]
                           + KARATE_MP_FLAGS + extra, device=dev) == 0,
                  f"karate --w2vModelShards 2 on {dev} failed")
            tables.append(n2v.load_model(out)[1:])
        check(same_path(os.path.join(tmp, f"out_mp_karate_cuda_{len(extra)}"),
                        os.path.join(tmp, f"out_mp_karate_cpu_{len(extra)}")),
              "karate /path differs between the card and the CPU")
        plain[name] = max(float(np.abs(a - b).max())
                          for a, b in zip(*tables))
        check(all(np.allclose(a, b, rtol=1e-4, atol=1e-6)
                  for a, b in zip(*tables)),
              f"karate at model_shards 2 ({name}): the card against the "
              f"CPU's plain run, max abs err {plain[name]:.3g}")
    # sgns_loss on phase 4's tables
    _, w_in, w_out = n2v.load_model(main_run["out"])
    rng = np.random.default_rng(23)
    P, k = LOSS_SHAPE
    V = w_in.shape[0]
    pairs = (rng.integers(0, V, P), rng.integers(0, V, P),
             rng.integers(0, V, (P, k)))
    losses = {}
    for dev in ("cuda", "cpu"):
        t_in, t_out = (torch.as_tensor(w).to(dev) for w in (w_in, w_out))
        loss = w2v.sgns_loss(t_in, t_out, *(torch.as_tensor(x).to(dev)
                                            for x in pairs))
        check(loss.dim() == 0 and loss.device.type == dev,
              f"sgns_loss on {dev}: {loss}")
        losses[dev] = float(loss)
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    check(np.isfinite(losses["cuda"]) and loss_err <= 1e-6,
          f"sgns_loss on the card {losses['cuda']} against the CPU "
          f"{losses['cpu']}")
    print(f"phase 23 --w2vModelShards 2 through the CLI on phase 4's graph, "
          f"/path byte-equal to phase 4's: conv (kB 128, one slot, the slot "
          f"key) epoch {runs['conv']['train_seconds']:.3f} s (phase 4: "
          f"{main_run['train_seconds']:.3f} s), {runs['conv']['calls']:.4f} "
          f"calls a block (<= 3.01, no dp kernel), launches "
          f"{runs['conv']['launches']}; --w2vPartitions 2 exact epoch "
          f"{runs['exact_p2']['train_seconds']:.3f} s (phase 12, one "
          f"device: {exact_run['train_seconds']:.3f} s), "
          f"{runs['exact_p2']['calls']:.4f} calls a merged update (<= 1.01: "
          f"one sgns_exact merged launch); karate gate at model_shards 2 "
          f"(AUC, faction accuracy): {gate}; karate through the CLI, the "
          f"card against the CPU's plain run: max abs err {plain} (rtol "
          f"1e-4 atol 1e-6), /path equal; sgns_loss at {LOSS_SHAPE} on "
          f"phase 4's tables: {losses['cuda']:.7f} on the card, "
          f"{losses['cpu']:.7f} on the CPU (rel err {loss_err:.2e} <= 1e-6) "
          f"[{smi}]")
    return {"conv_epoch_s": runs["conv"]["train_seconds"],
            "exact_p2_epoch_s": runs["exact_p2"]["train_seconds"],
            "karate_gate": gate, "karate_plain_max_abs_err": plain,
            "loss_rel_err": loss_err,
            "launches": {name: run["launches"] for name, run in runs.items()}}


def spawn_ranks(argv_for, env_for, timeout: int) -> list[str]:
    """Two processes on the card, argv_for(rank) each with env_for(rank)
    added to the environment; returns their stdouts, failing on a non-zero
    exit."""
    procs = [subprocess.Popen(
        argv_for(r), env=dict(os.environ, PYTHONPATH=ROOT, **env_for(r)),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            check(p.returncode == 0, f"a rank failed: {stderr[-3000:]}")
            outs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def merged_parts(out: str) -> bytes:
    path = os.path.join(out, "path")
    return b"".join(open(os.path.join(path, f), "rb").read()
                    for f in sorted(os.listdir(path)))


def phase_multihost(torch, smi, tmp, main_run) -> dict:
    """Phase 24: the multi-host CLI, two processes joined by SRW_* on the
    card (one rank each, gloo: they share cuda:0). randomwalk on phase 4's
    graph and walk by `python -m stellar_rw_tpu_torch` (the hash route
    over both ranks), then through the worker: randomwalk --partitioned
    true (the vertex-cut route), node2vec at phase 4's flags (kB 128, the
    trainer over both ranks) and embedding over phase 4's /path. Each
    walk's two parts merge to phase 4's /path byte for byte, rank 0 prints
    phase 4's corpus stats, each rank validates its rows; the tables
    within rtol 2e-4 atol 1e-6 of train_skipgram_multiproc(num_devices=2)
    in this process on the card, as phase 21 (c); K11 launched, one
    all-reduce a merged update and one for the token counts; each rank's
    walk and train seconds."""
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.utils.config import parse
    from stellar_rw_tpu_torch.utils.stats import walk_stats
    from stellar_rw_tpu_torch.walk import engine

    edges, phase4 = main_run["edges"], os.path.join(main_run["out"], "path")
    io_args = {"hash": ["--input", edges, "--output",
                        os.path.join(tmp, "mh_hash")],
               "vcut": ["--input", edges, "--output",
                        os.path.join(tmp, "mh_vcut")],
               "node2vec": ["--input", edges, "--output",
                            os.path.join(tmp, "mh_node2vec")],
               "embedding": ["--input", phase4, "--output",
                             os.path.join(tmp, "mh_embedding")]}
    group = lambda r: {"SRW_NUM_PROCESSES": "2", "SRW_PROCESS_ID": str(r)}
    port = free_port()
    t0 = time.perf_counter()
    hash_out = spawn_ranks(
        lambda r: [sys.executable, "-m", "stellar_rw_tpu_torch"]
        + io_args["hash"] + SHARD_FLAGS,
        lambda r: {**group(r), "SRW_COORDINATOR": f"127.0.0.1:{port}"}, 300)
    hash_wall = time.perf_counter() - t0
    plan = json.dumps([{"name": n, "port": free_port(),
                        "argv": io_args[n] + flags}
                       for n, flags in MULTIHOST_RUNS.items()])
    t0 = time.perf_counter()
    outs = spawn_ranks(lambda r: [sys.executable, "-c", MULTIHOST_WORKER,
                                  plan], group, 600)
    worker_wall = time.perf_counter() - t0
    ranks = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(bool(line), f"a rank printed no result: {out[-2000:]}")
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    # the corpus stats phase 4's run prints, from its corpus on the card
    graph = gio.load_edge_list(edges)
    walks = engine.random_walks(graph, walk_length=80, num_walks=10, p=0.25,
                                q=0.25, seed=0, device="cuda")
    ws = walk_stats(walks)
    stats_lines = (f"walks: {ws.num_paths} paths, {ws.num_steps} steps in",
                   f"Zero Neighbors: {ws.dead_ends}  (isolated starts: "
                   f"{ws.isolated_starts}, full paths: {ws.full_paths}, "
                   f"mean length: {ws.mean_length:.1f})")
    phase4_bytes = open(os.path.join(phase4, "part-00000"), "rb").read()
    for name, stdout0 in (("hash", hash_out[0]),
                          ("vcut", ranks[0]["vcut"]["stdout"]),
                          ("node2vec", ranks[0]["node2vec"]["stdout"])):
        out = io_args[name][3]
        check(sorted(os.listdir(os.path.join(out, "path")))
              == ["part-00000", "part-00001"], f"{name}: part files")
        check(merged_parts(out) == phase4_bytes,
              f"phase 24 {name}: the merged parts differ from phase 4's "
              f"/path")
        check(all(s in stdout0 for s in stats_lines)
              and "2 processes x 1 devices" in stdout0,
              f"phase 24 {name}: rank 0 did not print phase 4's stats "
              f"{stats_lines}: {stdout0[-1500:]}")
    for r, res in enumerate(ranks):
        for name, run in res.items():
            check(run["rc"] == 0 and run["backend"] == "gloo"
                  and run["device"] == "cuda:0",
                  f"rank {r} {name}: rc {run['rc']}, {run['backend']} on "
                  f"{run['device']}")
        check(f"walk invariants: ok (process {r})"
              in res["node2vec"]["stdout"], f"rank {r} did not validate")
        for name in ("vcut", "node2vec"):
            la = res[name]["launches"]
            check(la["shard_emit"] > 0 and la["shard_serve"] > 0,
                  f"rank {r} {name}: K11 not launched: {la}")
        for name in ("node2vec", "embedding"):
            run = res[name]
            merged = run["launches"]["dp_apply"]
            check(merged > 0 and run["all_reduces"] == merged + 1
                  and run["launches"]["sgns_conv_scatter_accumulate"]
                  == merged, f"rank {r} {name}: {run['all_reduces']} "
                  f"all-reduces, launches {run['launches']}")
    # the tables against the two-slot trainer in this process on the card
    errs = {}
    for name in ("node2vec", "embedding"):
        params = parse(io_args[name] + MULTIHOST_RUNS[name])
        cfg = n2v.sgns_config(params)
        if name == "node2vec":
            W, T = graph.num_vertices, 82
            W_pad = -(-W // 2) * 2
            corpus = np.full((10, W_pad, T), -1, np.int32)
            corpus[:, :W] = walks.reshape(10, W, T)
            corpus, vocab = corpus.reshape(-1, T), None
        else:
            values, offsets = gio.load_walks_ragged(phase4)
            corpus, vocab = w2v.corpus_from_ragged(values, offsets)
        blocks, rows = w2v.full_corpus_blocks(corpus, 2)
        want = w2v.train_skipgram_multiproc(
            blocks, rows, graph.num_vertices if vocab is None else len(vocab),
            cfg, num_devices=2, row_width=corpus.shape[1], device="cuda")
        tokens, *got = n2v.load_model(io_args[name][3])
        if vocab is not None:
            check([int(t) for t in tokens] == vocab,
                  "embedding: the vocabulary differs")
        errs[name] = max(float(np.abs(g - w).max())
                         for g, w in zip(got, want))
        check(all(np.allclose(g, w, rtol=2e-4, atol=1e-6)
                  for g, w in zip(got, want)),
              f"phase 24 {name}: two processes against the two-slot run "
              f"in one process, max abs err {errs[name]:.3g}")
    secs = {name: [res[name]["report"].get(k) for res in ranks
                   for k in ("walk_seconds", "train_seconds")]
            for name in MULTIHOST_RUNS}
    print(f"phase 24 the multi-host CLI, two processes joined by SRW_* on "
          f"the card (gloo, both on cuda:0): randomwalk by `python -m "
          f"stellar_rw_tpu_torch` (hash route, {hash_wall:.1f} s of wall "
          f"with the processes' start), then vcut / node2vec / embedding "
          f"through cli.main in one worker a rank ({worker_wall:.1f} s of "
          f"wall): the parts merge to phase 4's /path byte for byte, rank 0 "
          f"prints phase 4's stats ({stats_lines[0]} ..., "
          f"{stats_lines[1]}), each rank validates its rows; the tables "
          f"within rtol 2e-4 atol 1e-6 of train_skipgram_multiproc("
          f"num_devices=2) in one process (max abs err {errs}); per rank "
          f"[walk s, train s] rank 0 then rank 1: {secs}; K11 launches "
          f"vcut {[res['vcut']['launches']['shard_emit'] for res in ranks]}"
          f" emit / {[res['vcut']['launches']['shard_serve'] for res in ranks]}"
          f" serve, node2vec "
          f"{[res['node2vec']['launches']['shard_emit'] for res in ranks]}"
          f" / {[res['node2vec']['launches']['shard_serve'] for res in ranks]};"
          f" all-reduces node2vec "
          f"{[res['node2vec']['all_reduces'] for res in ranks]}, embedding "
          f"{[res['embedding']['all_reduces'] for res in ranks]} (merged "
          f"updates + the token counts'); node2vec trainer launches rank 0 "
          f"{ranks[0]['node2vec']['launches']} [{smi}]")
    return {"seconds": secs, "max_abs_err": errs,
            "hash_wall_s": hash_wall, "worker_wall_s": worker_wall,
            "launches": {name: [res[name]["launches"] for res in ranks]
                         for name in ("vcut", "node2vec", "embedding")},
            "all_reduces": {name: [res[name]["all_reduces"] for res in ranks]
                            for name in ("node2vec", "embedding")}}


# phase 25: the exact-CDF sampler across ranks (item 12c). The CDF serve
# (shard_walk.cdf_serve, K7's row scan applied to a request) against its
# plain version at one superstep of phase 10's corpus and on phase 9's edge
# graphs; phase 10's walk on two gloo ranks in each layout; the multi-host
# CLI at phase 10's flags, and node2vec at them over 2 rounds
CDF_LAYOUTS = {"hash": ["--shards", "2"],
               "vcut": ["--shards", "2", "--partitioned", "true"]}
# phase 25 (b)'s plain run: the first supersteps only (the plain chunked
# scan is a torch loop over a hub's pieces)
CDF_PLAIN_STEPS = 2
CDF_N2V_FLAGS = (["--cmd", "node2vec", "--walkLength", "80", "--numWalks",
                  "2", "--p", "0.0625", "--q", "4"]
                 + MAIN_FLAGS[MAIN_FLAGS.index("--dim"):])
CDF_RANK_WORKER = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from chip_smoke import shard_home, plain_shard_walk
from stellar_rw_tpu_torch.graph import io as gio
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.ops import cdf_walk, shard_walk, walk_step
from stellar_rw_tpu_torch.parallel import dp
from stellar_rw_tpu_torch.utils.config import parse

rank, port, edges, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          sys.argv[4])
layouts, flags = json.loads(sys.argv[5]), json.loads(sys.argv[6])
plain_steps = int(sys.argv[7])
backend = dp.init_group(rank, 2, ["cuda:0", "cuda:0"],
                        f"tcp://localhost:{port}")
kernels = {"shard_cdf_serve": shard_walk.CDF_SERVE_KERNEL,
           "shard_emit": shard_walk.EMIT_KERNEL,
           "shard_serve": shard_walk.SERVE_KERNEL,
           "walk": walk_step.WALK_KERNEL, "trial_keys": walk_step.KEYS_KERNEL,
           "cdf_walk": cdf_walk.CDF_WALK_KERNEL}


def walk(output, argv, save=True, plain=False, timing=None):
    params = parse(["--input", edges, "--output", output] + argv)
    graph = gio.load_edge_list(edges, weighted=params.weighted,
                               directed=params.directed)
    home = shard_home(graph) if params.partitioned else None
    for k in kernels.values():
        k.launches = 0
    report = {}
    with plain_shard_walk(plain):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        walks = n2v.run_walks(graph, params, "cuda", home=home,
                              report=report, timing=timing)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    walks = walks.cpu().numpy()
    if save and rank == 0:
        gio.save_walks(walks, graph, params.output, 1)
    return (walks, report, seconds,
            {n: k.launches for n, k in kernels.items()})


result = {"backend": backend}
for name, extra in layouts.items():
    corpus, report, seconds, launches = walk(f"{out}/cdf_{name}",
                                             flags + extra)
    diag = report.pop("diag")
    timing = {}
    timed, _, timed_seconds, _ = walk(f"{out}/cdf_{name}_timed",
                                      flags + extra, save=False,
                                      timing=timing)
    cut = list(flags)
    cut[cut.index("--walkLength") + 1] = str(plain_steps)
    plain, preport, plain_seconds, plain_launches = walk(
        f"{out}/cdf_{name}_plain", cut + extra, save=False, plain=True)
    result[name] = {
        "seconds": seconds, "stats": report, "launches": launches,
        "timing": timing, "timed_seconds": timed_seconds,
        "steps": int((corpus[:, 1:] >= 0).sum()),
        "same_timed": bool(np.array_equal(timed, corpus)),
        "plain_seconds": plain_seconds, "plain_launches": plain_launches,
        "same_plain_corpus": bool(np.array_equal(
            plain, corpus[:, :plain_steps + 2])),
        "same_plain_diag": bool(np.array_equal(
            preport["diag"], diag[:plain_steps + 1]))}
# walk-round checkpoints: 2 rounds, then resumed to all of them
ck = flags + ["--shards", "2", "--checkpointEvery", "2"]
cut = list(ck)
cut[cut.index("--numWalks") + 1] = "2"
walk(f"{out}/cdf_ckpt", cut)
walk(f"{out}/cdf_ckpt", ck + ["--resume", "true"])
print("RESULT " + json.dumps(result), flush=True)
dist.destroy_process_group()
"""


def cdf_serve_bound(tab, n: int, served: int, scanned: int,
                    second: bool = True, bitmap_entries: int = 0) -> dict:
    """The CDF serve's bound: the row entries scanned, by cdf_scan_ops
    (bitmap_entries of them read prev's neighbors from the bitmap), at the
    f32 lanes' rate (phase 10's formula), or the bytes if larger, each
    input read once: the n requests read (12 B) and answered (4 B), the
    vmeta rows of the requests served (two 16-byte rows each), their row
    entries (8 B each) and, for a second-order step, prev's bucket rows
    (16 B an entry), each at most its table."""
    g = tab.g
    nbytes = (16 * n + min(32 * served, tensor_bytes(g.vmeta))
              + min(8 * scanned, tensor_bytes(g.cdf_rows)))
    if second:
        nbytes += min(16 * scanned, tensor_bytes(g.hash_buckets))
    return bound(nbytes, cdf_scan_ops(scanned, bitmap_entries),
                 INT_OPS_PER_S)


def phase_cdf_shard_check(torch, smi, edges) -> dict:
    """Phase 25 (a): the CDF serve against cdf_serve_ref on the card, bit
    for bit. At superstep SHARD_STEP of phase 10's corpus (phase 4's graph
    at p = 1/16, q = 4, the chunked form, f32), under the hash route and a
    vertex-cut route over 2 shards: rank 0's local walkers and the requests
    it sends the other shard, each served column the corpus's next one;
    the whole received buffer (D buckets of requests and fills, counted
    over each bucket's filled prefix), and one
    superstep's two serves under torch.cuda.set_sync_debug_mode("error");
    then on phase 9's edge graphs
    in f32 and f64, padded and chunked, every step of a short corpus (t =
    0 first order) on 2 shards, every shard's requests in the request form
    with a fill request (gid -1) and in the local form with the other
    shard's walkers invalid (star50k's hub row of 50,000 entries among the
    requests); then star50k's hub row at one request, at 17 and at 2,048
    (prev a leaf), f32 and f64. Each timed between CUDA events beside its
    bound and the plain version's ms, with the requests that read the
    bitmap. Returns the kernel's row."""
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.graph.partition import plan_shards
    from stellar_rw_tpu_torch.ops import cdf_walk, prng, sampling, shard_walk
    from stellar_rw_tpu_torch.utils.config import parse
    from stellar_rw_tpu_torch.walk import engine

    params = parse(CDF_FLAGS + ["--input", edges, "--output", "-"])
    graph = gio.load_edge_list(edges, weighted=params.weighted,
                               directed=params.directed)
    V, R, Lw = graph.num_vertices, params.num_walks, params.walk_length
    p, q = params.p, params.q
    spec = engine.walk_spec(graph, Lw, R, p, q, "cdf", 16, "float32", V)
    check(spec.cdf_chunk == sampling.CDF_CHUNK, f"phase 10's spec {spec}")
    corpus = engine.random_walks(graph, walk_length=Lw, num_walks=R, p=p,
                                 q=q, seed=params.seed, as_numpy=False,
                                 device="cuda")
    key = prng.prng_key(params.seed)
    deg = torch.as_tensor(graph.offsets[1:] - graph.offsets[:-1],
                          device="cuda")
    cases = 0

    def held(a, b, what):
        check(torch.equal(a, b), f"shard_cdf_serve differs from "
              f"cdf_serve_ref ({what})")

    layouts = {}
    for layout in CDF_LAYOUTS:
        tabs, cur, prev, alive, rows, S, L, C, W_pad = shard_superstep(
            torch, graph, layout, corpus, cdf=True)
        n, t = cur.shape[0], SHARD_STEP
        kw = dict(W_pad=W_pad, W_total=R * W_pad, p=p, q=q,
                  cdf_chunk=spec.cdf_chunk, dtype="float32")
        i32 = lambda: torch.zeros(n, dtype=torch.int32, device="cuda")
        lk = i32()
        send, _, _ = shard_walk.emit(tabs[0], cur, prev, i32(), alive, lk,
                                     L, S * L, 0, C)
        send = send.clone()
        nxt = corpus[rows, t + 1]
        work = torch.zeros(2, dtype=torch.int32, device="cuda")
        local = lambda: shard_walk.cdf_serve(tabs[0], (cur, prev, None), lk,
                                             0, key, 0, t, False, work=work,
                                             **kw)
        got = local()
        want, plain_ms = cuda_ms_once(lambda: shard_walk.cdf_serve_ref(
            tabs[0], cur, prev, torch_arange_like(cur), lk != 0, key, 0, t,
            False, **kw))
        held(got, want, f"phase 10's superstep {t}, {layout}, local")
        lm = lk != 0
        split = cdf_split(tabs[0], cur[lm], prev[lm], spec.cdf_chunk)
        check(torch.equal(got[lm], nxt[lm]), f"shard_cdf_serve's local "
              f"steps differ from phase 10's corpus ({layout})")
        ms = cuda_ms(local, 10)
        served = int(lm.sum())
        scanned = int(deg[cur[lm].long()].sum())
        b = cdf_serve_bound(tabs[0], n, served, scanned,
                            bitmap_entries=split["bitmap_entries"])
        req = send[1].reshape(C, 3)
        remote = lambda: shard_walk.cdf_serve(tabs[1], req, None, 0, key, 0,
                                              t, False, work=work, **kw)
        rk = remote()
        rr, r_plain_ms = cuda_ms_once(lambda: shard_walk.cdf_serve_ref(
            tabs[1], req[:, 0], req[:, 1], req[:, 2], None, key, 0, t, False,
            **kw))
        held(rk, rr, f"phase 10's superstep {t}, {layout}, sent")
        ok = req[:, 2] >= 0
        check(torch.equal(rk[ok], nxt[req[ok, 2].long()]),
              f"shard_cdf_serve's remote steps differ from phase 10's "
              f"corpus ({layout})")
        r_scanned = int(deg[req[ok, 0].long()].sum())
        r_split = cdf_split(tabs[1], req[ok, 0], req[ok, 1], spec.cdf_chunk)
        rb = cdf_serve_bound(tabs[1], C, int(ok.sum()), r_scanned,
                             bitmap_entries=r_split["bitmap_entries"])
        r_ms = cuda_ms(remote, 10)
        # the whole received buffer, as the exchange hands it over: D
        # buckets, each its requests then fills (here rank 0's own buffer:
        # its bucket for itself holds fills only)
        recv = send.reshape(-1, 3)
        whole = lambda: shard_walk.cdf_serve(tabs[1], recv, None, 0, key, 0,
                                             t, False, work=work,
                                             segments=S * L, **kw)
        held(whole(), shard_walk.cdf_serve_ref(
            tabs[1], recv[:, 0], recv[:, 1], recv[:, 2], None, key, 0, t,
            False, **kw), f"phase 10's superstep {t}, {layout}, the "
            f"received buffer")
        w_ms = cuda_ms(whole, 10)
        # one superstep's two serves may not wait on the host
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            local()
            whole()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        cases += 3
        layouts[layout] = {
            "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
            "walkers": n, "served": served, "entries_scanned": scanned,
            **split,
            "remote": {"requests": int(ok.sum()), "ms": r_ms,
                       "plain_ms": r_plain_ms, "bound_ms": rb["bound_ms"],
                       "bound_by": rb["bound_by"],
                       "entries_scanned": r_scanned,
                       "received_buffer_ms": w_ms, "slots": recv.shape[0]}}
        print(f"phase 25 (a) {layout}: shard_cdf_serve bitwise "
              f"cdf_serve_ref and phase 10's column {t + 1} on rank 0's "
              f"{served} local walkers of {n} ({scanned:,} row entries; "
              f"{split['bitmap_requests']} by the bitmap, "
              f"{split['bitmap_entries']:,} entries): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.1f}, bound {b['bound_ms']:.5f} by "
              f"{b['bound_by']} ({ms / b['bound_ms']:.1f}x); on the "
              f"{int(ok.sum())} requests sent the other shard "
              f"({r_scanned:,} entries): kernel {r_ms:.4f} ms, plain "
              f"{r_plain_ms:.1f}, bound {rb['bound_ms']:.5f} "
              f"({r_ms / rb['bound_ms']:.1f}x); the whole received buffer "
              f"({recv.shape[0]} slots, {S * L} buckets) {w_ms:.4f} ms; one "
              f"superstep's serves under sync debug mode \"error\": no host "
              f"sync [{smi}]")
    # phase 9's edge graphs
    pqs = [(0.25, 4.0), (4.0, 0.25), (1.0, 1.0), (0.0625, 4.0), (0.5, 2.0)]
    rng = np.random.default_rng(5)
    edge_ms = {}
    i = 0
    for name, g in cdf_graphs().items():
        Vg = g.num_vertices
        starts = (np.arange(0, Vg, 997, dtype=np.int32) if name == "star50k"
                  else np.arange(Vg, dtype=np.int32))
        W, Rg, Lg, S = len(starts), 2, 4, 2
        dg = sampling.device_put_graph(g, "cuda", cdf=True)
        gdeg = dg.vmeta[:, 1]
        st = torch.as_tensor(starts, device="cuda")
        edge_ms[name] = []
        for chunk in (256,) if name == "star50k" else (0, 256):
            for dtype in ("float32", "float64"):
                gp, gq = pqs[i % len(pqs)]
                route = (None if i % 2 == 0 else
                         rng.integers(0, S, Vg).astype(np.int32))
                i += 1
                plan = plan_shards(g, S, route)
                tabs = [shard_walk.shard_tables(g, plan, s, "cuda", cdf=True)
                        for s in range(S)]
                owner = torch.as_tensor(plan.route, device="cuda").long()
                md = max(g.max_degree, 1)
                corpus_g = cdf_walk.cdf_walk_rounds(dg, st, key, 1, Rg, Lg,
                                                    gp, gq, md, chunk, dtype)
                gid = torch.arange(Rg * W, dtype=torch.int32, device="cuda")
                kw = dict(W_pad=W, W_total=Rg * W, p=gp, q=gq,
                          cdf_chunk=chunk, dtype=dtype)
                timed = None
                for t in range(Lg + 1):
                    cur = corpus_g[:, t] if t else corpus_g[:, 0]
                    prev = corpus_g[:, t - 1] if t > 1 else corpus_g[:, 0]
                    cur, prev = cur.contiguous(), prev.contiguous()
                    live = cur >= 0
                    for s, tab in enumerate(tabs):
                        m = live & (owner[cur.clamp_min(0).long()] == s)
                        what = (f"{name}, {dtype}, chunk {chunk}, step {t}, "
                                f"shard {s}")
                        req = torch.cat([torch.stack(
                            [cur[m], prev[m], gid[m]], 1),
                            torch.tensor([[0, 0, -1]], dtype=torch.int32,
                                         device="cuda")]).contiguous()
                        k = shard_walk.cdf_serve(tab, req, None, 0, key, 1,
                                                 t, t == 0, **kw)
                        ref = shard_walk.cdf_serve_ref(
                            tab, req[:, 0], req[:, 1], req[:, 2], None, key,
                            1, t, t == 0, **kw)
                        held(k, ref, what + ", requests")
                        check(torch.equal(k[:-1], corpus_g[m, t + 1])
                              and int(k[-1]) == -1, f"shard_cdf_serve "
                              f"differs from the corpus's column ({what})")
                        valid = m.to(torch.int32)
                        k = shard_walk.cdf_serve(tab, (cur, prev, None),
                                                 valid, 0, key, 1, t, t == 0,
                                                 **kw)
                        ref = shard_walk.cdf_serve_ref(
                            tab, cur, prev, gid, m, key, 1, t, t == 0, **kw)
                        held(k, ref, what + ", local")
                        check(torch.equal(
                            k, torch.where(m, corpus_g[:, t + 1], -1)),
                            f"shard_cdf_serve's local form ({what})")
                        cases += 2
                        scanned = int(gdeg[cur[m].long()].sum())
                        if t == 1 and (timed is None or scanned > timed[0]):
                            timed = (scanned, req, tab)
                scanned, req, tab = timed
                ms = cuda_ms(lambda: shard_walk.cdf_serve(
                    tab, req, None, 0, key, 1, 1, False, **kw), 5)
                b = cdf_serve_bound(
                    tab, req.shape[0], req.shape[0] - 1, scanned,
                    bitmap_entries=cdf_split(tab, req[:-1, 0], req[:-1, 1],
                                             chunk)["bitmap_entries"])
                edge_ms[name].append({
                    "dtype": dtype, "chunk": chunk, "p": gp, "q": gq,
                    "route": "hash" if route is None else "vcut",
                    "requests": req.shape[0] - 1, "entries_scanned": scanned,
                    "ms": ms, "bound_ms": b["bound_ms"]})
    hub = cdf_star_hub(torch, key, held)
    cases += hub.pop("cases")
    print(f"phase 25 (a) edge graphs: shard_cdf_serve bitwise cdf_serve_ref "
          f"and the single-device corpus's next column in {cases} cases "
          f"({list(edge_ms)}; f32 and f64, padded and chunked, hash and "
          f"vertex-cut over 2 shards, t = 0-4, request form with a gid -1 "
          f"fill and local form with invalid flags; star50k's hub row of "
          f"50,000 entries among the requests); step 1's requests of the "
          f"busiest shard timed (ms / bound ms): "
          + "; ".join(f"{n}: " + ", ".join(
              f"{c['dtype'][-2:]} {'chunked' if c['chunk'] else 'padded'} "
              f"{c['ms']:.4f} / {c['bound_ms']:.5f}" for c in cs)
              for n, cs in edge_ms.items()) + f" [{smi}]")
    print(f"phase 25 (a) star50k's hub row (50,000 entries, chunked; ms "
          f"f32 / f64): " + "; ".join(
              f"{k} requests {v['float32']:.4f} / {v['float64']:.4f}"
              for k, v in hub.items()) + f", bitwise cdf_serve_ref [{smi}]")
    return {"max_abs_err": 0, **layouts["hash"], "layouts": layouts,
            "edge_cases": cases, "edge_graphs": edge_ms, "star_hub": hub,
            "library": "none: a data-dependent scan a request"}


def cdf_split(tab, cur, prev, cdf_chunk: int) -> dict:
    """The CDF serve's second-order requests at (cur, prev) on shard tab
    that read prev's neighbors from the bitmap (shard_walk.bitmap_words: V
    fits; a row of BITMAP_MIN_ENTRIES entries or more; prev with no more
    bucket rows than cur has entries), and the row entries they scan."""
    from stellar_rw_tpu_torch.ops import shard_walk

    cur_row, prev_row = shard_walk._rows(tab, cur, prev)
    d = tab.g.vmeta[cur_row.long(), 1]
    nb = tab.g.vmeta[prev_row.long(), 3] + 1
    on = ((d >= shard_walk.BITMAP_MIN_ENTRIES) & (nb <= d)
          & (shard_walk.bitmap_words(tab.V, cdf_chunk) > 0))
    return {"bitmap_requests": int(on.sum()),
            "bitmap_entries": int(d[on].sum())}


def cdf_star_hub(torch, key, held) -> dict:
    """star50k's hub row (50,000 entries) served at one request, at 17 and
    at 2,048 second-order requests (prev a leaf), against cdf_serve_ref bit
    for bit, f32 and f64, each timed."""
    from stellar_rw_tpu_torch.graph.partition import plan_shards
    from stellar_rw_tpu_torch.ops import shard_walk

    star = star_graph(50_000)
    tabs = [shard_walk.shard_tables(star, plan_shards(star, 2), s, "cuda",
                                    cdf=True) for s in range(2)]
    leaves = torch.arange(1, 2049, dtype=torch.int32, device="cuda")
    many = torch.stack([torch.zeros_like(leaves), leaves, leaves], 1)
    V = star.num_vertices
    out, cases = {}, 0
    for k in (1, 17, 2048):
        req = many[:k].contiguous()
        out[k] = {}
        for dtype in ("float32", "float64"):
            kw = dict(W_pad=V, W_total=V, p=0.0625, q=4.0,
                      cdf_chunk=shard_walk.sampling.CDF_CHUNK, dtype=dtype)
            work = torch.zeros(2, dtype=torch.int32, device="cuda")
            fn = lambda: shard_walk.cdf_serve(tabs[0], req, None, 0, key, 0,
                                              1, False, work=work, **kw)
            held(fn(), shard_walk.cdf_serve_ref(
                tabs[0], req[:, 0], req[:, 1], req[:, 2], None, key, 0, 1,
                False, **kw), f"star50k's hub, {k} requests, {dtype}")
            out[k][dtype] = cuda_ms(fn, 5)
            cases += 1
    out["cases"] = cases
    return out


def phase_cdf_shard_ranks(torch, smi, tmp, main_run) -> dict:
    """Phase 25 (b): phase 10's walk (`--cmd randomwalk --p 0.0625 --q 4`)
    through run_walks on two gloo ranks sharing the card, each a process
    of its own (as phase 22 (b)), with --shards 2 (hash) and with
    --partitioned true (vertex cut): /path byte for byte phase 10's (rank
    0 writes it); the CDF serve launched, and neither K11's serve, the key
    table, the walk kernel nor K7; a timed run's corpus the same, with the
    serve's ms and the collectives' host ms a superstep; the plain path
    (emit_ref, cdf_serve_ref) over the first CDF_PLAIN_STEPS supersteps,
    its corpus the first columns and its counters the first supersteps'
    of the kernels' run; then walk-round checkpoints (--checkpointEvery 2)
    cut after 2 rounds and resumed, /path phase 10's."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CDF_RANK_WORKER, str(r), port,
         main_run["edges"],
         tmp, json.dumps(CDF_LAYOUTS), json.dumps(CDF_FLAGS),
         str(CDF_PLAIN_STEPS)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=420)
            check(p.returncode == 0, f"a rank failed: {stderr[-3000:]}")
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            check(bool(line), f"a rank printed no result: {stdout[-2000:]}")
            results.append((json.loads(line[-1][len("RESULT "):]), stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    phase10 = os.path.join(tmp, CDF_OUT)
    out = {"backend": results[0][0]["backend"]}
    for layout in CDF_LAYOUTS:
        check(same_path(os.path.join(tmp, f"cdf_{layout}"), phase10),
              f"phase 25 {layout}: /path differs from phase 10's")
        runs = [r[layout] for r, _ in results]
        for r in runs:
            check(r["same_timed"], f"{layout}: the timed run's corpus "
                  f"differs")
            check(r["same_plain_corpus"] and r["same_plain_diag"],
                  f"{layout}: the plain path's first {CDF_PLAIN_STEPS} "
                  f"supersteps differ from the kernels' (corpus "
                  f"{r['same_plain_corpus']}, counters "
                  f"{r['same_plain_diag']})")
            la, pl = r["launches"], r["plain_launches"]
            check(la["shard_cdf_serve"] > 0 and la["shard_emit"] > 0
                  and la["shard_serve"] == la["trial_keys"] == la["walk"]
                  == la["cdf_walk"] == 0, f"{layout}: launches {la}")
            check(pl["shard_cdf_serve"] == pl["shard_emit"] == 0,
                  f"{layout}: the plain run launched a kernel: {pl}")
        st = runs[0]["stats"]
        tm = [r["timing"] for r in runs]
        sec = max(r["seconds"] for r in runs)
        sup = tm[0]["supersteps"]
        row = {"walk_seconds": sec, "steps_per_s": runs[0]["steps"] / sec,
               "stats": {k: st[k] for k in SHARD_STATS},
               "launches": [r["launches"] for r in runs],
               "serve_ms_a_superstep": max(t["serve_ms"] for t in tm) / sup,
               "emit_ms_a_superstep": max(t["emit_ms"] for t in tm) / sup,
               "collective_host_ms_a_superstep":
                   max(t["collective_host_ms"] for t in tm) / sup,
               "timed_walk_seconds": max(r["timed_seconds"] for r in runs),
               "plain_seconds_first_supersteps": max(
                   r["plain_seconds"] for r in runs)}
        out[layout] = row
        print(f"phase 25 (b) {layout}: phase 10's walk on two gloo ranks "
              f"sharing the card ({st['num_shards']} shards), /path "
              f"byte-equal to phase 10's; walk {sec:.3f} s = "
              f"{row['steps_per_s']:,.0f} steps/s; {sup} supersteps, "
              f"{st['exchange_rounds_total']} exchange rounds "
              f"({st['overflow_steps']} overflow supersteps), boundary "
              f"walkers {st['boundary_walkers']}, zero neighbors "
              f"{st['zero_neighbors']}, capacity {st['capacity']}; a "
              f"superstep: shard_cdf_serve {row['serve_ms_a_superstep']:.4f}"
              f" ms, shard_emit {row['emit_ms_a_superstep']:.4f} ms (CUDA "
              f"events), collectives "
              f"{row['collective_host_ms_a_superstep']:.3f} ms of host time "
              f"(the timed run {row['timed_walk_seconds']:.3f} s); the plain "
              f"path's first {CDF_PLAIN_STEPS} supersteps "
              f"{row['plain_seconds_first_supersteps']:.2f} s, their corpus "
              f"and counters the kernels'; launches {row['launches']} "
              f"[{smi}]")
    check(same_path(os.path.join(tmp, "cdf_ckpt"), phase10),
          "phase 25: the resumed walk-round checkpoint run's /path differs "
          "from phase 10's")
    check(all("resumed 2 completed walk rounds" in stdout
              for _, stdout in results), "phase 25: the checkpointed run "
          "did not resume after 2 rounds")
    print(f"phase 25 (b) --checkpointEvery 2 on the two ranks, cut after 2 "
          f"rounds and resumed: /path byte-equal to phase 10's; the "
          f"exchange under {out['backend']}")
    return out


def phase_cdf_multihost(torch, smi, tmp, main_run) -> dict:
    """Phase 25 (c): the multi-host CLI at phase 10's flags, two processes
    joined by SRW_* on the card (phase 24's harness): `python -m
    stellar_rw_tpu_torch --cmd randomwalk --p 0.0625 --q 4`, the parts
    merged byte for byte phase 10's /path; then node2vec --sharedNegatives
    128 at the same p and q over 2 rounds (CDF_N2V_FLAGS) through the
    worker: its parts the randomwalk run's first 2 rounds, the CDF serve
    launched, the tables within rtol 2e-4 atol 1e-6 of
    train_skipgram_multiproc(num_devices=2) in this process."""
    from stellar_rw_tpu_torch.graph import io as gio
    from stellar_rw_tpu_torch.models import node2vec as n2v
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.utils.config import parse
    from stellar_rw_tpu_torch.walk import engine

    edges = main_run["edges"]
    rw_out = os.path.join(tmp, "mh_cdf_randomwalk")
    n2v_out = os.path.join(tmp, "mh_cdf_node2vec")
    group = lambda r: {"SRW_NUM_PROCESSES": "2", "SRW_PROCESS_ID": str(r)}
    port = free_port()
    t0 = time.perf_counter()
    rw = spawn_ranks(
        lambda r: [sys.executable, "-m", "stellar_rw_tpu_torch", "--input",
                   edges, "--output", rw_out] + CDF_FLAGS,
        lambda r: {**group(r), "SRW_COORDINATOR": f"127.0.0.1:{port}"}, 300)
    rw_wall = time.perf_counter() - t0
    argv = ["--input", edges, "--output", n2v_out] + CDF_N2V_FLAGS
    plan = json.dumps([{"name": "node2vec", "port": free_port(),
                        "argv": argv}])
    t0 = time.perf_counter()
    outs = spawn_ranks(lambda r: [sys.executable, "-c", MULTIHOST_WORKER,
                                  plan], group, 600)
    n2v_wall = time.perf_counter() - t0
    ranks = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(bool(line), f"a rank printed no result: {out[-2000:]}")
        ranks.append(json.loads(line[-1][len("RESULT "):])["node2vec"])
    phase10 = open(os.path.join(tmp, CDF_OUT, "path", "part-00000"),
                   "rb").read()
    merged = merged_parts(rw_out)
    check(merged == phase10, "phase 25 (c): the randomwalk parts differ "
          "from phase 10's /path")
    for r, stdout in enumerate(rw):
        check(f"walk invariants: ok (process {r})" in stdout,
              f"rank {r} did not validate its rows")
    params = parse(argv)
    graph = gio.load_edge_list(edges, weighted=params.weighted,
                               directed=params.directed)
    V, R = graph.num_vertices, params.num_walks
    part = merged_parts(n2v_out)
    check(part.count(b"\n") == R * V and merged.startswith(part),
          f"phase 25 (c): node2vec's parts are not the randomwalk run's "
          f"first {R} rounds")
    for r, run in enumerate(ranks):
        la = run["launches"]
        check(run["rc"] == 0 and la["shard_cdf_serve"] > 0
              and la["shard_serve"] == 0 and run["all_reduces"]
              == la["dp_apply"] + 1, f"rank {r} node2vec: rc {run['rc']}, "
              f"launches {la}, {run['all_reduces']} all-reduces")
    walks = engine.random_walks(graph, walk_length=params.walk_length,
                                num_walks=R, p=params.p, q=params.q,
                                seed=params.seed, device="cuda")
    T = walks.shape[1]
    W_pad = -(-V // 2) * 2
    corpus = np.full((R, W_pad, T), -1, np.int32)
    corpus[:, :V] = walks.reshape(R, V, T)
    corpus = corpus.reshape(-1, T)
    blocks, rows = w2v.full_corpus_blocks(corpus, 2)
    want = w2v.train_skipgram_multiproc(
        blocks, rows, V, n2v.sgns_config(params), num_devices=2,
        row_width=T, device="cuda")
    _, *got = n2v.load_model(n2v_out)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    check(all(np.allclose(g, w, rtol=2e-4, atol=1e-6)
              for g, w in zip(got, want)),
          f"phase 25 (c): two processes against the two-slot run in one "
          f"process, max abs err {err:.3g}")
    secs = [[run["report"].get(k) for k in ("walk_seconds", "train_seconds")]
            for run in ranks]
    print(f"phase 25 (c) the multi-host CLI at phase 10's flags, two "
          f"processes joined by SRW_* on the card: randomwalk by `python -m "
          f"stellar_rw_tpu_torch` ({rw_wall:.1f} s of wall), the parts "
          f"merged byte-equal to phase 10's /path, each rank validated; "
          f"node2vec --sharedNegatives 128 over {R} rounds through cli.main "
          f"({n2v_wall:.1f} s of wall): its parts the first {R} rounds of "
          f"it, shard_cdf_serve launches "
          f"{[run['launches']['shard_cdf_serve'] for run in ranks]}, the "
          f"tables within rtol 2e-4 atol 1e-6 of train_skipgram_multiproc("
          f"num_devices=2) in one process (max abs err {err:.3g}); per rank "
          f"[walk s, train s] {secs} [{smi}]")
    return {"randomwalk_wall_s": rw_wall, "node2vec_wall_s": n2v_wall,
            "seconds": secs, "max_abs_err": err,
            "launches": [run["launches"] for run in ranks]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops.cdf_walk import CDF_WALK_KERNEL
    from stellar_rw_tpu_torch.ops.resident_walk import RESIDENT_WALK_KERNEL
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL
    from stellar_rw_tpu_torch.ops.shard_walk import (CDF_SERVE_KERNEL,
                                                     EMIT_KERNEL,
                                                     SERVE_KERNEL)
    from stellar_rw_tpu_torch.ops.walk_step import KEYS_KERNEL, WALK_KERNEL

    probe = draws_probe()
    cdf_probe = cdf_row_probe()
    k11_empty = k11_empty_kernels()
    smi = phase_env(torch, (WALK_KERNEL, KEYS_KERNEL, RESIDENT_WALK_KERNEL,
                            CDF_WALK_KERNEL, EMIT_KERNEL, SERVE_KERNEL,
                            CDF_SERVE_KERNEL, *k11_empty.values(),
                            *trainer_kernels().values(),
                            *hs_kernels().values(),
                            *spmm_kernels().values(),
                            *dp_kernels().values(), probe, cdf_probe))
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
                                 main_run["edges"], cdf_probe)
        step_row = phase_exact_check(torch)
        exact_run = phase_exact_main(torch, smi, tmp, main_run["edges"])
        draws_row = phase_draws_check(torch, smi, probe)
        accumulate_row, scatter_row = phase_conv_check(torch, smi)
        stream = phase_streaming(torch, {
            "walk": WALK_KERNEL, "trial_keys": KEYS_KERNEL,
            "resident_walk": RESIDENT_WALK_KERNEL,
            "cdf_walk": CDF_WALK_KERNEL, "shard_emit": EMIT_KERNEL,
            "shard_serve": SERVE_KERNEL, "shard_cdf_serve": CDF_SERVE_KERNEL,
            **trainer_kernels(),
            **hs_kernels(), **spmm_kernels(), **dp_kernels()},
            smi, tmp, main_run)
        profile = phase_profile(torch, WALK_KERNEL, KEYS_KERNEL, smi, tmp,
                                main_run)
        server = phase_server(torch, smi, tmp)
        dp_merged_row, dp_exact_row, dp_conv_row, dp_apply_row = \
            phase_dp_check(torch, smi)
        dp_run = phase_dp_main(torch, smi, tmp, main_run, exact_run)
        dp_ranks = phase_dp_ranks(torch, smi, tmp)
        from stellar_rw_tpu_torch.graph import io as gio

        emit_row, serve_row = phase_shard_check(
            torch, smi, gio.load_edge_list(main_run["edges"]), k11_empty)
        shard_run = phase_shard_ranks(torch, smi, tmp, main_run)
        mp_run = phase_model_shards(torch, smi, tmp, main_run, exact_run)
        multihost_run = phase_multihost(torch, smi, tmp, main_run)
        cdf_serve_row = phase_cdf_shard_check(torch, smi, main_run["edges"])
        cdf_ranks = phase_cdf_shard_ranks(torch, smi, tmp, main_run)
        cdf_multihost = phase_cdf_multihost(torch, smi, tmp, main_run)
    corpus = hs_corpus(torch)
    hs_row = phase_hs_check(torch, smi, corpus)
    hs_run = phase_hs_main(torch, smi, corpus)
    del corpus
    segsum_row, sddmm_row, softmax_row = phase_spmm(torch, smi)
    epochs = {"conv_epoch_s": main_run["train_seconds"],
              "conv_launches_a_block": main_run["launches_a_block"],
              "exact_epoch_s": exact_run["train_seconds"],
              "exact_launches_a_block": exact_run["launches_a_block"],
              "streamed": {name: {k: stream[name][k] for k in (
                  "walk_seconds", "train_seconds", "launches_a_block",
                  "corpus_bytes")} for name in ("conv", "exact")},
              "stored_corpus_bytes": {
                  name: stream["stored"][name]["corpus_bytes"]
                  for name in ("conv", "exact")},
              "group_ms_a_round": stream["group_ms_a_round"],
              "init_ms": stream["init_ms"],
              "profiled_conv_epoch_s": profile["train_seconds"],
              "profiled_epoch_idle_share": profile["epoch_idle_share"],
              "transient_bytes": stream["transient_bytes"],
              "fixed_bytes": stream["fixed_bytes"],
              "served_job_s": server["rest_seconds"],
              "hs_epoch_s": hs_run["hs_epoch_s"],
              "hs_beside_conv_epoch_s": hs_run["conv_epoch_s"],
              "hs_peak_bytes": hs_run["peak_bytes"],
              "dp": {name: {k: dp_run[name][k] for k in (
                  "train_seconds", "merged_updates", "calls_a_merged_update",
                  "buffer_bytes", "peak_device_bytes")}
                  for name in ("conv", "exact")},
              "dp_two_rank_seconds": dp_ranks["two_rank_seconds"],
              "dp_one_process_seconds": dp_ranks["one_process_seconds"],
              "dp_exact_two_rank_seconds": dp_ranks["exact_two_rank_seconds"],
              "dp_exact_one_process_seconds":
                  dp_ranks["exact_one_process_seconds"],
              "sharded_walks": {k: v for k, v in shard_run.items()},
              "model_shards": {k: mp_run[k] for k in (
                  "conv_epoch_s", "exact_p2_epoch_s")},
              "multihost_cli": {k: multihost_run[k] for k in (
                  "seconds", "hash_wall_s", "worker_wall_s",
                  "all_reduces")},
              "sharded_cdf_walks": cdf_ranks,
              "multihost_cdf_cli": {k: cdf_multihost[k] for k in (
                  "randomwalk_wall_s", "node2vec_wall_s", "seconds")}}
    quality["streamed_micro_f1"] = stream["micro_f1"]
    quality.update(hs_karate_auc=hs_run["karate_auc"],
                   hs_karate_acc=hs_run["karate_acc"],
                   hs_link_auc_100k=hs_run["auc_hs"],
                   conv_link_auc_100k=hs_run["auc_conv"],
                   dp_karate_gate_p4=dp_run["karate_gate_p4"],
                   dp_two_rank_micro_f1=dp_ranks["micro_f1"],
                   dp_two_rank_max_abs_err=dp_ranks["max_abs_err"],
                   dp_exact_two_rank_max_abs_err=dp_ranks[
                       "exact_max_abs_err"],
                   model_shards_karate_gate=mp_run["karate_gate"],
                   model_shards_karate_plain_max_abs_err=mp_run[
                       "karate_plain_max_abs_err"],
                   sgns_loss_rel_err=mp_run["loss_rel_err"],
                   multihost_max_abs_err=multihost_run["max_abs_err"],
                   multihost_cdf_max_abs_err=cdf_multihost["max_abs_err"])
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
        {"name": "sgns_exact_step", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_exact.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:154",
         "launches": exact_run["sgns_exact_step"],
         "launches_conv_path": main_run["sgns_exact_step"], **step_row},
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
        {"name": "hs_step", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/hsoftmax.cu",
         "replaces": "stellar_rw_tpu/models/hsoftmax.py:95",
         "launches": hs_run["launches"]["hs_step"], **hs_row},
        {"name": "spmm_segment_sum", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/spmm.cu",
         "replaces": "stellar_rw_tpu/ops/spmm.py:44", **segsum_row,
         "launches": segsum_row["launches"]["spmm_segment_sum"]},
        {"name": "spmm_sddmm", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/spmm.cu",
         "replaces": "stellar_rw_tpu/ops/spmm.py:65", **sddmm_row,
         "launches": sddmm_row["launches"]["spmm_sddmm"]},
        {"name": "spmm_row_softmax", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/spmm.cu",
         "replaces": "stellar_rw_tpu/ops/spmm.py:71", **softmax_row,
         "launches": softmax_row["launches"]["spmm_row_softmax"]},
        {"name": "sgns_exact_merged", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_exact.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:190",
         "launches": dp_run["exact"]["launches"]["sgns_exact_merged"],
         **dp_merged_row},
        # the accumulate mode runs across ranks: its launches are phase 21
        # (c)'s, both ranks' exact runs
        {"name": "sgns_exact_accumulate", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_exact.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:190",
         "launches": dp_ranks["accumulate_launches"],
         "launches_one_card_path": dp_run["exact"]["launches"][
             "sgns_exact_accumulate"], **dp_exact_row},
        {"name": "sgns_conv_scatter_accumulate", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_conv.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:475",
         "launches": dp_run["conv"]["launches"][
             "sgns_conv_scatter_accumulate"], **dp_conv_row},
        {"name": "dp_apply", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/dp_apply.cu",
         "replaces": "stellar_rw_tpu/models/word2vec.py:200",
         "launches": dp_run["conv"]["launches"]["dp_apply"],
         "launches_exact_path": dp_run["exact"]["launches"]["dp_apply"],
         **dp_apply_row},
        # K11 runs on the sharded path: its launches are phase 22 (b)'s,
        # both ranks' hash-route run
        {"name": "shard_emit", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/shard_walk.cu",
         "replaces": "stellar_rw_tpu/parallel/distributed.py:362",
         "launches": sum(la["shard_emit"]
                         for la in shard_run["hash"]["launches"]),
         **emit_row},
        {"name": "shard_serve", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/shard_walk.cu",
         "replaces": "stellar_rw_tpu/parallel/distributed.py:204",
         "launches": sum(la["shard_serve"]
                         for la in shard_run["hash"]["launches"]),
         **serve_row},
        # the CDF serve runs on the sharded exact-CDF path: its launches
        # are phase 25 (b)'s, both ranks' hash-route run
        {"name": "shard_cdf_serve", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/shard_walk.cu",
         "replaces": "stellar_rw_tpu/parallel/distributed.py:262",
         "launches": sum(la["shard_cdf_serve"]
                         for la in cdf_ranks["hash"]["launches"]),
         "launches_multihost_cdf": sum(
             la["shard_cdf_serve"] for la in cdf_multihost["launches"]),
         **cdf_serve_row},
    ]
    for row in kernels:   # the launches of the streamed runs (phase 15)
        for name in ("conv", "exact"):
            row[f"launches_streamed_{name}"] = stream[name][row["name"]]
        # and of phase 23's CLI runs and phase 24's ranks (both ranks)
        row["launches_model_shards"] = sum(
            la.get(row["name"], 0) for la in mp_run["launches"].values())
        row["launches_multihost"] = sum(
            la.get(row["name"], 0)
            for ranks in multihost_run["launches"].values() for la in ranks)
        check(row["launches"] > 0, f"{row['name']} was launched no time on "
              f"its path")
    print(json.dumps({"epochs": epochs, "quality": quality}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
