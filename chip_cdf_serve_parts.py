#!/usr/bin/env python3
"""Where the exact-CDF serve's time goes on one GPU (ops/shard_walk.py::
cdf_serve, csrc/shard_walk.cu over csrc/cdf_pick.cuh), at chip_smoke phase
25 (a)'s superstep: rank 0's local walkers at superstep SHARD_STEP of phase
10's corpus (the walk_10k graph, 10 rounds, p = 1/16, q = 4, chunked,
float32), under the hash route and the vertex cut over 2 shards.

    python3 chip_cdf_serve_parts.py

The serve of the package as it stands is timed

  (i)   on the heavy requests only (deg(cur) >= H, through the valid flags),
        for H in HEAVY, with the rows they stand at and the requests of the
        largest;
  (ii)  on the light requests only (deg(cur) < H);
  (iii) on one request alone at the graph's longest row (39,303 entries),
        served by the shard that owns it;
  (iv)  with the bias weight's bucket read taken out (a text variant of the
        source, csrc/cdf_pick.cuh written in: f from the entry's low bit;
        it picks elsewhere by design);

beside the whole serve, each with the requests served and the row entries
they scan (sum of deg(cur)). Then the serve's forms, each held bit for bit
to the package's serve, on the local walkers and on the whole received
buffer of each layout, and on star50k's hub row at one request and at
2,048, in turns: text variants of the package's source (FORMS: the bitmap
taken out, or read from rows of other lengths, and a warp a request with
no counter), and the three redesigns that lost, kept whole (KEPT: a heavy
row staged in shared memory for a
group of its requests, its weights in a tile or a warp a request; and the
requests compacted on the card, the heavy ones first), launched through
the entry point they had (`kept_serve`: the shard's heavy-row table, a
workspace, the received buffer's buckets). Times are chip_smoke's cuda_ms
(CUDA events around launches queued behind a long product). One JSON
object a line, the card's name and power limit in each. Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_cdf_parts import BUCKET_READ
from chip_smoke import (CDF_FLAGS, SHARD_STEP, check, cuda_ms, edited,
                        shard_superstep, source_kernel, star_graph,
                        synth_power_law_graph)

HEAVY = (256, 1024, 4096)
NO_BUCKET_READ = [(BUCKET_READ, "    f = (e.x & 1) ? T(1) : inv_q;\n")]
# the persistent warps' claims, and the launch of as many warps as slots
CLAIM = """  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(a.next, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n) break;
"""
LOOP_END = """    cdf_serve_one<T, kChunked>(a, i, lane, bm, inv_p, inv_q);
  }
  const int warps"""
FILLS_COUNTED = [("  int n = a.m;\n  const int len = a.segments > 0 ? "
                  "a.m / a.segments : 0;\n  if (a.segments > 0) {",
                  "  int n = a.m;\n  const int len = 0;\n  if (false) {")]
NO_COUNTER = [
    *FILLS_COUNTED,
    (CLAIM, """  for (int k = (blockIdx.x * kCdfServeThreads + threadIdx.x) >> 5;
       k < n; k = n) {
"""),
    ("  const int blocks = static_cast<int>(want < resident ? want : "
     "resident);", "  const int blocks = static_cast<int>(want);")]


def CLAIMS(k: int):
    """The loop with k consecutive requests a claim."""
    return [(CLAIM, f"""  for (;;) {{
    int k0 = 0;
    if (lane == 0) k0 = atomicAdd(a.next, {k});
    k0 = __shfl_sync(kFull, k0, 0);
    if (k0 >= n) break;
    for (int k = k0; k < min(k0 + {k}, n); ++k) {{
"""), (LOOP_END, """    cdf_serve_one<T, kChunked>(a, i, lane, bm, inv_p, inv_q);
    }
  }
  const int warps""")]


# name -> edits of the serve's text (csrc/shard_walk.cu with cdf_pick.cuh
# written in)
FORMS = {
    "package": [],
    "no bitmap (prev's bucket row read for every entry)": [
        ("        if (kChunked && a.words > 0 && cm.y >= kBitmapMinEntries &&",
         "        if (kChunked && a.words < 0 && cm.y >= kBitmapMinEntries &&")],
    "a warp a request, its block's slot held (no counter)": NO_COUNTER,
    "the bitmap to V 32,768 (1,024 words)": [
        ("constexpr int kBitmapWords = 2048;",
         "constexpr int kBitmapWords = 1024;")],
    "four blocks an SM (up to 64 registers)": [
        ("__global__ void __launch_bounds__(kCdfServeThreads)\n"
         "shard_cdf_serve_kernel(",
         "__global__ void __launch_bounds__(kCdfServeThreads, 4)\n"
         "shard_cdf_serve_kernel(")],
    "six blocks an SM (up to 40 registers)": [
        ("__global__ void __launch_bounds__(kCdfServeThreads)\n"
         "shard_cdf_serve_kernel(",
         "__global__ void __launch_bounds__(kCdfServeThreads, 6)\n"
         "shard_cdf_serve_kernel(")],
    "the received buffer's fills counted too": FILLS_COUNTED,
    "blocks of 2 warps, a warp a request (no counter)": [
        *NO_COUNTER, ("constexpr int kCdfServeThreads = 256;",
                       "constexpr int kCdfServeThreads = 64;")],
    "blocks of 1 warp, a warp a request (no counter)": [
        *NO_COUNTER, ("constexpr int kCdfServeThreads = 256;",
                       "constexpr int kCdfServeThreads = 32;")],
    "two requests a claim": CLAIMS(2),
    "four requests a claim": CLAIMS(4),
    "the bitmap from rows of 256 entries": [
        ("constexpr int kBitmapMinEntries = 1024;",
         "constexpr int kBitmapMinEntries = 256;")],
    "the bitmap from rows of 4,096 entries": [
        ("constexpr int kBitmapMinEntries = 1024;",
         "constexpr int kBitmapMinEntries = 4096;")],
}
# the wrapper's constant a form of FORMS needs set while it runs
FORM_WRAPPER = {"the bitmap to V 32,768 (1,024 words)": {"BITMAP_WORDS": 1024}}
# name -> a redesign kept whole in this directory
KEPT = {
    "a group's row staged, its weights in a tile":
        "chip_cdf_serve_tile.cu",
    "a group's row staged, a warp a request": "chip_cdf_serve_staged.cu",
    "the requests compacted, the heavy ones first":
        "chip_cdf_serve_compact.cu",
}
# their entry point: the requests and routing (shard_walk._launch_args),
# vmeta, rows, E, buckets, the heavy-row table and its rows, the bitmap's
# words, the buckets of a received buffer, the workspace and its requests,
# the key, round offset, step, first, W_pad, W_total, 1/p, 1/q, chunked,
# f64, stream
_P, _I = ctypes.c_void_p, ctypes.c_int
KEPT_ARGTYPES = ([_P] * 3 + [_I] + [_P] + [_I] * 2 + [_P] + [_P] + [_I] * 4
                 + [_P] + [_I] + [_P] * 3 + [_I] + [_P] * 2 + [_I] * 3 + [_P]
                 + [_I] + [ctypes.c_uint] * 3 + [_I] * 4
                 + [ctypes.c_double] * 2 + [_I] * 2 + [_P])
KEPT_WORK_HEAD = 3084      # ints before the requests' (the largest of them)
KEPT_WORK_INTS = 19        # a request's ints
KEPT_HEAVY_DEGREE = 1024   # a heavy row's entries
KEPT_MAX_HEAVY = 1024      # rows of a heavy-row table
KEPT_BITMAP_WORDS = 2048   # the compacted form's bitmap words


def serve_text() -> str:
    """csrc/shard_walk.cu with csrc/cdf_pick.cuh written in where it is
    included: the one text the variants edit."""
    from stellar_rw_tpu_torch.ops import _build as build

    source = (build.CSRC / "shard_walk.cu").read_text()
    header = (build.CSRC / "cdf_pick.cuh").read_text()
    include = '#include "cdf_pick.cuh"\n'
    if source.count(include) != 1:
        raise RuntimeError("shard_walk.cu does not include cdf_pick.cuh once")
    return source.replace(include, header.replace("#pragma once\n", ""))


def heavy_rows(deg: np.ndarray,
               min_degree: int = KEPT_HEAVY_DEGREE) -> tuple[np.ndarray, int]:
    """A shard's heavy-row table for the kept redesigns: the rows of at
    least min_degree entries (a halo row is never a request's cur), at most
    KEPT_MAX_HEAVY, numbered by degree, largest first (ties by row); every
    other row -1. Returns (i32 [rows], the count)."""
    deg = np.asarray(deg, dtype=np.int64)
    cand = np.flatnonzero(deg >= max(int(min_degree), 1))
    cand = cand[np.argsort(-deg[cand], kind="stable")][:KEPT_MAX_HEAVY]
    table = np.full(deg.shape[0], -1, dtype=np.int32)
    table[cand] = np.arange(cand.shape[0], dtype=np.int32)
    return table, int(cand.shape[0])


def kept_serve(torch, kernel, tab, req, valid, key, t, first, W_pad,
               W_total, p, q, cdf_chunk, dtype="float32", segments=0):
    """A launch of a kept redesign (its `kernel`) as its wrapper made it:
    the shard's heavy-row table, a workspace of the request count, the
    received buffer's `segments` buckets. Returns a function that launches
    it and returns dst."""
    from stellar_rw_tpu_torch.ops import prng, sampling
    from stellar_rw_tpu_torch.ops import shard_walk as sw
    from stellar_rw_tpu_torch.ops._build import ptr, stream

    g = tab.g
    m = req.shape[0] if torch.is_tensor(req) else req[0].shape[0]
    table, n_heavy = heavy_rows(g.vmeta[:, 1].cpu().numpy())
    table = torch.as_tensor(table).to(g.device)
    work = torch.zeros(KEPT_WORK_HEAD + KEPT_WORK_INTS * m,
                       dtype=torch.int32, device=g.device)
    out, args = sw._launch_args("kept_serve", tab, req, valid, 0,
                                [g.cdf_rows, g.hash_buckets], None)
    inv_p, inv_q = sampling.bias_quotients(p, q, dtype)
    k0, k1 = (int(v) & prng.MASK32 for v in key.tolist())
    words = -(-tab.V // 32)
    words = words if cdf_chunk and words <= KEPT_BITMAP_WORDS else 0

    def run():
        kernel.launch(
            *args, ptr(g.vmeta), ptr(g.cdf_rows), g.cdf_rows.shape[0],
            ptr(g.hash_buckets), ptr(table), n_heavy, words, segments,
            ptr(work), m, k0, k1, 0, t, int(first), W_pad, W_total, inv_p,
            inv_q, int(cdf_chunk > 0), int(dtype == "float64"),
            stream(g.device))
        return out
    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_cdf_serve_parts: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.graph.partition import plan_shards
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import shard_walk as sw
    from stellar_rw_tpu_torch.walk import engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    text = serve_text()
    normal = sw.CDF_SERVE_KERNEL
    here = os.path.dirname(os.path.realpath(__file__))
    no_bucket = source_kernel("serve_no_bucket", edited(text, NO_BUCKET_READ),
                              normal.symbol, normal.argtypes,
                              "cdf_serve_parts")
    forms = {name: source_kernel(f"serve_form_{i}", edited(text, edits),
                                 normal.symbol, normal.argtypes,
                                 "cdf_serve_parts")
             for i, (name, edits) in enumerate(FORMS.items())}
    kept = {name: source_kernel(
        f"serve_kept_{i}", open(os.path.join(here, path)).read(),
        normal.symbol, KEPT_ARGTYPES, "cdf_serve_parts")
        for i, (name, path) in enumerate(KEPT.items())}
    with ThreadPoolExecutor(8) as pool:   # one nvcc a variant, together
        list(pool.map(lambda k: k.fn(),
                      [no_bucket, *forms.values(), *kept.values()]))
    for name, k in {**forms, **kept}.items():
        say(form=name, ptxas=[line.split(":", 1)[-1].strip()
                              for line in k.build_log.splitlines()
                              if "registers" in line or "spill" in line])

    def counters():
        return torch.zeros(2, dtype=torch.int32, device="cuda")

    def using(kernel, fn, consts=None):
        def run():
            saved = {k: getattr(sw, k) for k in consts or {}}
            sw.CDF_SERVE_KERNEL = kernel
            for k, v in (consts or {}).items():
                setattr(sw, k, v)
            try:
                return fn()
            finally:
                sw.CDF_SERVE_KERNEL = normal
                for k, v in saved.items():
                    setattr(sw, k, v)
        return run

    def all_forms(tab, req, valid, t, kw, segments=0):
        """Each form's launch on these requests."""
        fns = {name: using(k, lambda w=counters(): sw.cdf_serve(
            tab, req, valid, 0, key, 0, t, False, work=w, segments=segments,
            **kw), FORM_WRAPPER.get(name)) for name, k in forms.items()}
        fns.update({name: kept_serve(torch, k, tab, req, valid, key, t,
                                     False, segments=segments, **kw)
                    for name, k in kept.items()})
        return fns

    def in_turns(fns, want, what, iters=10):
        for name, fn in fns.items():
            check(torch.equal(fn(), want), f"form {name!r} differs ({what})")
        names = list(fns)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms(fns[name], iters))
        return turns

    graph = synth_power_law_graph(10_000, 334_000, seed=0)
    V, R, L, p, q = graph.num_vertices, 10, 80, 0.0625, 4.0
    check(CDF_FLAGS[CDF_FLAGS.index("--p") + 1] == "0.0625",
          "phase 10's flags changed")
    spec = engine.walk_spec(graph, L, R, p, q, "cdf", 16, "float32", V)
    key = prng.prng_key(0)
    corpus = engine.random_walks(graph, walk_length=L, num_walks=R, p=p, q=q,
                                 seed=0, as_numpy=False, device="cuda")
    deg = torch.as_tensor(graph.offsets[1:] - graph.offsets[:-1],
                          device="cuda")
    t = SHARD_STEP
    for layout in ("hash", "vcut"):
        tabs, cur, prev, alive, rows, S, Ln, C, W_pad = shard_superstep(
            torch, graph, layout, corpus, cdf=True)
        n = cur.shape[0]
        kw = dict(W_pad=W_pad, W_total=R * W_pad, p=p, q=q,
                  cdf_chunk=spec.cdf_chunk, dtype="float32")
        lk = torch.zeros(n, dtype=torch.int32, device="cuda")
        pend = torch.zeros_like(lk)
        send, _, _ = sw.emit(tabs[0], cur, prev, pend, alive, lk, Ln, S * Ln,
                             0, C)
        send = send.clone()
        dcur = deg[cur.clamp_min(0).long()]

        def serve(valid, tab=tabs[0], req=(cur, prev, None)):
            return lambda w=counters(): sw.cdf_serve(
                tab, req, valid, 0, key, 0, t, False, work=w, **kw)
        lm = lk != 0
        whole = serve(lk)
        want = whole()
        subsets = {"all": lk}
        for h in HEAVY:
            subsets[f"deg >= {h}"] = (lm & (dcur >= h)).to(torch.int32)
            subsets[f"deg < {h}"] = (lm & (dcur < h)).to(torch.int32)
        for name, valid in subsets.items():
            got = serve(valid)()
            m = valid != 0
            check(torch.equal(got[m], want[m]), f"{layout} {name}: the "
                  f"subset's steps differ from the whole serve's")
        names = list(subsets)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms(serve(subsets[name]), 10))
        counts = {name: [int((v != 0).sum()), int(dcur[v != 0].sum())]
                  for name, v in subsets.items()}
        # the rows the heavy requests stand at, the largest's requests
        heavy = {}
        for h in HEAVY:
            per_row = torch.bincount(cur[lm & (dcur >= h)].long(),
                                     minlength=V)
            per_row = per_row[per_row > 0]
            heavy[h] = {"rows": int(per_row.numel()),
                        "max_requests_a_row": int(per_row.max())
                        if per_row.numel() else 0}
        nb = using(no_bucket, whole)
        b_turns = [cuda_ms(f, 10) for f in (whole, nb, nb, whole)]
        say(layout=layout, step=t, walkers=n, ms_in_turns=turns,
            requests_and_entries=counts, heavy_rows=heavy,
            bucket_read_out_ms_in_turns={"with": [b_turns[0], b_turns[3]],
                                         "without": b_turns[1:3]})
        # the forms on this superstep: the local walkers, and the whole
        # received buffer (rank 0's send buffer, served on shard 1)
        recv = send.reshape(-1, 3)
        say(layout=layout, requests="local walkers", forms_ms_in_turns=(
            in_turns(all_forms(tabs[0], (cur, prev, None), lk, t, kw), want,
                     f"{layout}, local")))
        say(layout=layout, requests="received buffer", forms_ms_in_turns=(
            in_turns(all_forms(tabs[1], recv, None, t, kw, S * Ln),
                     sw.cdf_serve_ref(tabs[1], recv[:, 0], recv[:, 1],
                                      recv[:, 2], None, key, 0, t, False,
                                      **kw), f"{layout}, received")))

    # (iii) one request at the longest row, alone
    hub = int(deg.argmax())
    col = (corpus[:, 1:] == hub).nonzero()
    r0, c0 = int(col[0, 0]), int(col[0, 1]) + 1
    prev_v = int(corpus[r0, c0 - 1])
    tabs, *_, S, Ln, C, W_pad = shard_superstep(torch, graph, "hash", corpus,
                                                cdf=True)
    one = torch.tensor([[hub, prev_v, r0]], dtype=torch.int32,
                       device="cuda")
    kw = dict(W_pad=W_pad, W_total=R * W_pad, p=p, q=q,
              cdf_chunk=spec.cdf_chunk, dtype="float32")
    alone = lambda w=counters(): sw.cdf_serve(tabs[hub % S], one, None, 0,
                                              key, 0, 1, False, work=w, **kw)
    check(torch.equal(alone(), sw.cdf_serve_ref(
        tabs[hub % S], one[:, 0], one[:, 1], one[:, 2], None, key, 0, 1,
        False, **kw)), "the lone hub request differs")
    say(request="one at the longest row", entries=int(deg[hub]),
        ms=[cuda_ms(alone, 20), cuda_ms(alone, 20)])

    # star50k's hub row: one request and 2,048 (prev a leaf)
    star = star_graph(50_000)
    stabs = [sw.shard_tables(star, plan_shards(star, 2), s, "cuda", cdf=True)
             for s in range(2)]
    sspec = engine.walk_spec(star, 4, 1, p, q, "cdf", 16, "float32",
                             star.num_vertices)
    leaves = torch.arange(1, 2049, dtype=torch.int32, device="cuda")
    many = torch.stack([torch.zeros_like(leaves), leaves, leaves], 1)
    skw = dict(W_pad=star.num_vertices, W_total=star.num_vertices, p=p, q=q,
               cdf_chunk=sspec.cdf_chunk, dtype="float32")
    res = {}
    for label, reqs in (("one", many[:1].contiguous()), ("2048", many)):
        res[label] = in_turns(
            all_forms(stabs[0], reqs, None, 1, skw),
            sw.cdf_serve_ref(stabs[0], reqs[:, 0], reqs[:, 1], reqs[:, 2],
                             None, key, 0, 1, False, **skw),
            f"star50k, {label}", 5)
    say(graph="star50k hub (50,000 entries)", chunk=sspec.cdf_chunk,
        forms_ms_in_turns=res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
