#!/usr/bin/env python3
"""Where K11's time goes on one GPU (ops/shard_walk.py::emit and serve,
csrc/shard_walk.cu), at chip_smoke phase 22 (a)'s superstep: rank 0's
walkers at superstep SHARD_STEP of phase 4's corpus (the walk_10k graph
loaded from its edge list, 10 rounds of 80 steps, p = q = 0.25), in the
three layouts of phase 22 (the hash route and a vertex cut over 2 shards,
1 shard x 2 lanes), at the auto capacity.

    python3 chip_shard_parts.py [PARENT_CHECKOUT]

PARENT_CHECKOUT (build/parent when not given) is the root of a checkout
of the commit before K11's redesign (a `git archive` of it unpacked under
build/, which .gitignore lists). Its csrc/shard_walk.cu is built whole, and
in text variants, beside this checkout's headers, and its kernels are
launched through the entry points they had:

  (i)   the emit (one cooperative launch, two grid barriers) whole; with its
        body taken out (the empty launch of its grid); with its two grid
        barriers taken out (timing only: not a correct emit); without the
        pass that fills the entries past each bucket's count;
  (ii)  the serve (a programmatic dependent, a thread a slot) on rank 0's n
        walkers with the local flags, and on the D * C entries of the
        buffer rank 0 sends the other shard; each with its body taken out;
        each on the real requests only (the local walkers, or the filled
        prefix of each bucket, gathered into a request list beforehand);
  (iii) the serve's longest trial chain (the most trials one request needs
        at the superstep, from serve_ref's counts) and, by clock64, the
        cycles of its slowest warp and the mean over its warps;

then the package's forms against them, in turns, each held bit for bit
to its plain version (and the parent's outputs):

  (iv)  the package's emit (one ordinary launch, a single pass with a
        decoupled look-back) against the parent's; its empty launch
        (chip_smoke.K11_EMPTY); text variants of it (EMIT_FORMS: a walker's
        fields read again after the look-back, as the first form did;
        tiles of 256 or 1,024 walkers);
  (v)   the package's serve of a superstep in one launch (rank 0's walkers
        with their local flags and the buffer it receives: its own bucket
        and rank 1's requests for shard 0) against the parent's two
        launches of the same requests (the walkers by their local flags,
        then every slot of the received buffer); its empty launch; the
        clock64 cycles of its slowest warp; text variants (SERVE_FORMS:
        blocks of 64 or 256 threads).

Times are chip_smoke's cuda_ms
(CUDA events around launches queued behind a long product), each pair in
turns (a, b, b, a). One JSON object a line, the card's name and power limit
in each. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (K11_EMPTY, SHARD_LAYOUTS, SHARD_STEP, check,
                        cuda_ms, edited, shard_graph, shard_superstep,
                        source_kernel, using_kernel)

PARENT = os.path.join("build", "parent")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the parent's entry points: srw_shard_emit_launch, srw_shard_serve_launch
PARENT_EMIT_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P] * 4 + [_P]
PARENT_SERVE_ARGTYPES = ([_P] * 3 + [_I] + [_P] + [_I] * 2 + [_P] + [_P]
                         + [_I] * 4 + [_P] + [_I] + [_P] * 5 + [_I] * 8
                         + [ctypes.c_float] * 3 + [_I] + [_P])
# the parent's emit with its body out (the launch of its grid), with its
# grid barriers out, without its fill pass
EMIT_BODY = ("  cg::grid_group grid = cg::this_grid();\n"
             "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
             "  const int ntiles = (n + kEmitThreads - 1) / kEmitThreads;\n")
PARENT_EMIT_FORMS = {
    "empty": [(EMIT_BODY, "  if (n >= 0) return;\n" + EMIT_BODY)],
    "no grid barriers": [("  }\n  grid.sync();\n\n  // (2)",
                          "  }\n\n  // (2)"),
                         ("  }\n  grid.sync();\n\n  // (3)",
                          "  }\n\n  // (3)")],
    "no fill pass": [("       e < (size_t)D * C; e += stride) {",
                      "       e < 0; e += stride) {")],
}
SERVE_WAIT = ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
              "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
              "  if (i >= m) return;\n")
# a warp's cycles from its wait to its last store: the most over the
# launch's warps and their sum, read and reset by srw_serve_cycles
CLOCKS = [
    (SERVE_WAIT,
     '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     "  const long long c0 = clock64();\n"
     "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (i >= m) return;\n"),
    ("  dst[i] = out;\n}\n",
     "  dst[i] = out;\n"
     "  const unsigned mask = __activemask();\n"
     "  const unsigned dc = __reduce_max_sync(\n"
     "      mask, (unsigned)min(clock64() - c0, (long long)0xffffffff));\n"
     "  if ((threadIdx.x & 31) == __ffs(mask) - 1) {\n"
     "    atomicMax(&g_cycles[0], (unsigned long long)dc);\n"
     "    atomicAdd(&g_cycles[1], (unsigned long long)dc);\n"
     "    atomicAdd(&g_cycles[2], 1ull);\n"
     "  }\n}\n"),
    ("__global__ void __launch_bounds__(kServeThreads)\n",
     "__device__ unsigned long long g_cycles[3];\n\n"
     "__global__ void __launch_bounds__(kServeThreads)\n"),
]
# the package's serve with the same clocks
PACKAGE_CLOCKS = [
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     "  const int k = blockIdx.x",
     '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     "  const long long c0 = clock64();\n"
     "  const int k = blockIdx.x"),
    ("    a.reply[k - a.n] = serve_one(a, f[0], f[1], f[2]);\n  }\n}\n",
     "    a.reply[k - a.n] = serve_one(a, f[0], f[1], f[2]);\n  }\n"
     "  const unsigned mask = __activemask();\n"
     "  const unsigned dc = __reduce_max_sync(\n"
     "      mask, (unsigned)min(clock64() - c0, (long long)0xffffffff));\n"
     "  if ((threadIdx.x & 31) == __ffs(mask) - 1) {\n"
     "    atomicMax(&g_cycles[0], (unsigned long long)dc);\n"
     "    atomicAdd(&g_cycles[1], (unsigned long long)dc);\n"
     "    atomicAdd(&g_cycles[2], 1ull);\n"
     "  }\n}\n"),
    ("__global__ void __launch_bounds__(kServeThreads)\n",
     "__device__ unsigned long long g_cycles[3];\n\n"
     "__global__ void __launch_bounds__(kServeThreads)\n"),
]
# the package's emit and serve with other tiles and blocks, and the
# wrapper's constants each needs while it runs
EMIT_FORMS = {
    "the fields read again at the write": ([
        ("    fcur = a.cur[i];\n    fprev = a.prev[i];\n", ""),
        ("      const int ds = al ? dest_shard(a.rt, fcur) : 0;",
         "      const int ds = al ? dest_shard(a.rt, a.cur[i]) : 0;"),
        ("      c = dest_shard(a.rt, fcur) * a.L",
         "      c = dest_shard(a.rt, a.cur[i]) * a.L"),
        ("      a.send[3 * e] = fcur;\n      a.send[3 * e + 1] = fprev;",
         "      a.send[3 * e] = a.cur[i];\n"
         "      a.send[3 * e + 1] = a.prev[i];")], {}),
    "tiles of 256 walkers": ([("constexpr int kEmitThreads = 512;",
                               "constexpr int kEmitThreads = 256;")],
                             {"EMIT_THREADS": 256}),
    "tiles of 1,024 walkers": ([("constexpr int kEmitThreads = 512;",
                                 "constexpr int kEmitThreads = 1024;")],
                               {"EMIT_THREADS": 1024}),
}
SERVE_FORMS = {
    "blocks of 64 threads": [("constexpr int kServeThreads = 128;",
                              "constexpr int kServeThreads = 64;")],
    "blocks of 256 threads": [("constexpr int kServeThreads = 128;",
                               "constexpr int kServeThreads = 256;")],
}
CLOCK_TAIL = """
// (the most cycles of a warp, their sum, the warps) since the last call
extern "C" void srw_serve_cycles(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles));
  const unsigned long long zero[3] = {0, 0, 0};
  cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero));
}
"""


class Clocked:
    """A serve kernel with the clocks of CLOCKS or PACKAGE_CLOCKS: read()
    gives (the most cycles of a warp, their mean, the warps) since the last
    read."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.lib = None

    def read(self) -> dict:
        if self.lib is None:
            self.lib = ctypes.CDLL(str(self.kernel._build()))
            self.lib.srw_serve_cycles.argtypes = [ctypes.c_void_p]
            self.lib.srw_serve_cycles.restype = None
        buf = (ctypes.c_ulonglong * 3)()
        self.lib.srw_serve_cycles(buf)
        return {"slowest_warp": int(buf[0]),
                "mean_warp": buf[1] / max(int(buf[2]), 1),
                "warps": int(buf[2])}

    def of(self, run) -> dict:
        """The cycles of run()'s launch, warm (after two runs)."""
        run()
        run()
        import torch

        torch.cuda.synchronize()
        self.read()
        run()
        torch.cuda.synchronize()
        return self.read()


class constants:
    """Within it, ops/shard_walk.py's constants are `values`."""

    def __init__(self, values: dict):
        self.values = values

    def __enter__(self):
        from stellar_rw_tpu_torch.ops import shard_walk as sw

        self.saved = {k: getattr(sw, k) for k in self.values}
        for k, v in self.values.items():
            setattr(sw, k, v)

    def __exit__(self, *exc):
        from stellar_rw_tpu_torch.ops import shard_walk as sw

        for k, v in self.saved.items():
            setattr(sw, k, v)
        return False


def swapped(fn, kernels: dict, consts: dict | None = None):
    """fn with ops/shard_walk.py's Kernels `kernels` (name -> Kernel) and
    constants `consts` in place while it runs."""
    def run():
        with constants(consts or {}):
            saved = [using_kernel(k, v) for k, v in kernels.items()]
            for u in saved:
                u.__enter__()
            try:
                return fn()
            finally:
                for u in saved[::-1]:
                    u.__exit__()
    return run


def turns(fns: dict, iters: int = 20) -> dict:
    """Each of fns timed by cuda_ms in turns: a, b, ..., ..., b, a."""
    names = list(fns)
    out = {name: [] for name in names}
    for name in names + names[::-1]:
        out[name].append(cuda_ms(fns[name], iters))
    return out


class Parent:
    """The parent's emit and serve (its csrc/shard_walk.cu) as its wrappers
    launched them: emit into [D, C, 3] / [D, C] buffers with a tile-count
    scratch; serve over (cur, prev, gid) at a stride with valid flags."""

    def __init__(self, torch, emit_kernel, serve_kernel):
        self.torch = torch
        self.emit_kernel = emit_kernel
        self.serve_kernel = serve_kernel

    def emit(self, tab, cur, prev, pending, alive, local, L, D, gid_base,
             C, kernel=None):
        from stellar_rw_tpu_torch.ops._build import ptr, stream

        torch = self.torch
        n = cur.shape[0]
        tiles = -(-n // 512)
        e = lambda *s: torch.empty(s, dtype=torch.int32, device=cur.device)
        send, slot, tc, counters = e(D, C, 3), e(D, C), e((tiles + 1) * D), \
            e(2)
        null = ctypes.c_void_p(0)
        first = alive is not None

        def run():
            (kernel or self.emit_kernel).launch(
                ptr(cur), ptr(prev), ptr(alive) if first else null,
                ptr(pending), ptr(local) if first else null,
                ptr(tab.route) if tab.route is not None else null,
                tab.route_mode, tab.S, tab.rbits, tab.shard, L, D, gid_base,
                n, C, ptr(send), ptr(slot), ptr(tc), ptr(counters),
                stream(cur.device))
            return send, slot, counters
        return run

    def serve(self, tab, req, valid, keys, t, W_pad, W_total, n_stream, p,
              q, kernel=None):
        from stellar_rw_tpu_torch.ops import shard_walk as sw
        from stellar_rw_tpu_torch.ops import walk_step
        from stellar_rw_tpu_torch.ops._build import ptr, stream

        g = tab.g
        out, args = sw._launch_args("serve", tab, req, valid, 0,
                                    [g.alias_packed, g.hash_buckets, keys],
                                    None)
        inv_p, inv_q, max_f, mode = walk_step.bias_constants(p, q)
        L1, T = keys.shape[1], keys.shape[2]

        def run():
            (kernel or self.serve_kernel).launch(
                *args, ptr(g.vmeta), ptr(g.alias_packed),
                ptr(g.hash_buckets), ptr(keys), t, 0, W_pad, W_total,
                walk_step.draw_width(n_stream), L1, T, g.num_edges,
                float(inv_p), float(inv_q), float(max_f), mode,
                stream(g.device))
            return out
        return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_shard_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import prng, sampling, shard_walk as sw
    from stellar_rw_tpu_torch.ops import walk_step
    from stellar_rw_tpu_torch.walk import engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    here = os.path.dirname(os.path.realpath(__file__))
    parent = sys.argv[1] if len(sys.argv) > 1 else os.path.join(here, PARENT)
    with open(os.path.join(parent, "stellar_rw_tpu_torch", "csrc",
                           "shard_walk.cu")) as f:
        text = f.read()
    emit_sym, serve_sym = "srw_shard_emit_launch", "srw_shard_serve_launch"
    build = lambda name, src, sym, types: source_kernel(
        name, src, sym, types, "shard_parts")
    parent_emit = {"parent": build("parent", text, emit_sym,
                                   PARENT_EMIT_ARGTYPES)}
    for i, (name, edits) in enumerate(PARENT_EMIT_FORMS.items()):
        parent_emit[name] = build(f"parent_emit_{i}", edited(text, edits),
                                  emit_sym, PARENT_EMIT_ARGTYPES)
    parent_serve = {
        "parent": build("parent", text, serve_sym, PARENT_SERVE_ARGTYPES),
        "empty": build("parent_serve_empty", edited(text, [(
            SERVE_WAIT, SERVE_WAIT.replace("if (i >= m) return;",
                                           "if (i >= 0) return;"))]),
            serve_sym, PARENT_SERVE_ARGTYPES),
        "clocks": build("parent_serve_clocks", edited(text, CLOCKS)
                        + CLOCK_TAIL, serve_sym, PARENT_SERVE_ARGTYPES)}
    from stellar_rw_tpu_torch.ops import _build

    mine = (_build.CSRC / "shard_walk.cu").read_text()
    E, Sv = sw.EMIT_KERNEL, sw.SERVE_KERNEL
    package = {"emit empty": build("emit_empty", edited(
        mine, K11_EMPTY["shard_emit"]), E.symbol, E.argtypes),
        "serve empty": build("serve_empty", edited(
            mine, K11_EMPTY["shard_serve"]), Sv.symbol, Sv.argtypes),
        "serve clocks": build("serve_clocks", edited(mine, PACKAGE_CLOCKS)
                              + CLOCK_TAIL, Sv.symbol, Sv.argtypes)}
    for i, (name, (edits, _)) in enumerate(EMIT_FORMS.items()):
        package[f"emit {name}"] = build(f"emit_form_{i}", edited(
            mine, edits), E.symbol, E.argtypes)
    for i, (name, edits) in enumerate(SERVE_FORMS.items()):
        package[f"serve {name}"] = build(f"serve_form_{i}", edited(
            mine, edits), Sv.symbol, Sv.argtypes)
    kernels = [*parent_emit.values(), *parent_serve.values(), E, Sv,
               *package.values()]
    with ThreadPoolExecutor(16) as pool:   # one nvcc a variant, together
        list(pool.map(lambda k: k.fn(), kernels))
    for name, k in {**{f"parent emit {n}": k for n, k in parent_emit.items()},
                    **{f"parent serve {n}": k
                       for n, k in parent_serve.items()},
                    "package": E, **package}.items():
        say(kernel=name, ptxas=[line.split(":", 1)[-1].strip()
                                for line in k.build_log.splitlines()
                                if "registers" in line or "spill" in line])
    parent_clocks = Clocked(parent_serve["clocks"])
    package_clocks = Clocked(package["serve clocks"])

    par = Parent(torch, parent_emit["parent"], parent_serve["parent"])
    graph = shard_graph()
    V, R, Lw, p, q = graph.num_vertices, 10, 80, 0.25, 0.25
    corpus = engine.random_walks(graph, walk_length=Lw, num_walks=R, p=p,
                                 q=q, seed=0, as_numpy=False, device="cuda")
    _, max_rounds = sampling.plan_sampler("rejection", p, q)
    keys = walk_step.trial_keys(prng.prng_key(0), 0, R, Lw, 4 * max_rounds,
                                device="cuda")
    t = SHARD_STEP
    for layout in SHARD_LAYOUTS:
        tabs, cur, prev, alive, rows, S, L, C, W_pad = shard_superstep(
            torch, graph, layout, corpus)
        D, n = S * L, cur.shape[0]
        i32 = lambda: torch.zeros(n, dtype=torch.int32, device="cuda")
        kw = dict(W_pad=W_pad, W_total=R * W_pad, n_stream=V, p=p, q=q)
        nxt = corpus[rows, t + 1]

        # (i) the emit
        pend, loc = i32(), i32()
        fns = {name: par.emit(tabs[0], cur, prev, pend, alive, loc, L, D, 0,
                              C, k) for name, k in parent_emit.items()}
        send, slot, counters = (x.clone() for x in fns["parent"]())
        pr, lr = i32(), i32()
        ref = sw.emit_ref(tabs[0], cur, prev, pr, alive, lr, L, D, 0, C)
        for a, b in zip((send, slot, counters[:2], pend, loc),
                        (*ref[:2], ref[2][:2], pr, lr)):
            check(torch.equal(a, b), f"the parent's emit differs from "
                  f"emit_ref ({layout})")
        emit_turns = {name: turns({"parent": fns["parent"], name: fn})
                      for name, fn in fns.items() if name != "parent"}
        # (ii) the serve: rank 0's walkers with the local flags, and the
        # buffer it sends shard 1 (served there)
        lm = loc != 0
        idx = lm.nonzero().squeeze(1)
        local_list = torch.stack(
            [cur[idx], prev[idx], idx.to(torch.int32)], 1).contiguous()
        serves = {"local": (tabs[0], (cur, prev, None), loc, local_list,
                            idx)}
        if S > 1:
            recv = send.reshape(-1, 3)
            real = (recv[:, 2] >= 0).nonzero().squeeze(1)
            serves["received"] = (tabs[1], recv, None,
                                  recv[real].contiguous(), real)
        for part, (tab, req, valid, compact, at) in serves.items():
            whole = par.serve(tab, req, valid, keys, t, **kw)
            want = whole().clone()
            fcur, fprev, fgid = ((req[0], req[1], torch.arange(
                n, dtype=torch.int32, device="cuda")) if part == "local"
                else (req[:, 0], req[:, 1], req[:, 2]))
            counts = {}
            plain = sw.serve_ref(tab, fcur, fprev, fgid,
                                 None if valid is None else valid != 0, keys,
                                 t, False, counts=counts, **kw)
            check(torch.equal(want, plain), f"the parent's serve differs "
                  f"from serve_ref ({layout}, {part})")
            ok = want >= 0
            if part == "local":
                check(torch.equal(want[lm], nxt[lm]), f"the parent's local "
                      f"steps differ from the corpus ({layout})")
            else:
                check(torch.equal(want[ok], nxt[fgid[ok].long()]),
                      f"the parent's remote steps differ ({layout})")
            only = par.serve(tab, compact, None, keys, t, **kw)
            check(torch.equal(only(), want[at]), f"the real requests' "
                  f"steps differ ({layout}, {part})")
            empty = par.serve(tab, req, valid, keys, t,
                              kernel=parent_serve["empty"], **kw)
            clocked = par.serve(tab, req, valid, keys, t,
                                kernel=parent_serve["clocks"], **kw)
            check(torch.equal(clocked(), want), "the clocked serve differs")
            warp_cycles = parent_clocks.of(clocked)
            say(layout=layout, kernel="parent shard_serve", requests=part,
                slots=int(want.shape[0]), served=counts["served"],
                trials=counts["dense_trials"] + counts["lane_trials"],
                max_trials=counts["max_trials"], warp_cycles=warp_cycles,
                ms_in_turns={
                    "whole against empty": turns({"whole": whole,
                                                  "empty": empty}),
                    "whole against the real requests only": turns(
                        {"whole": whole, "real only": only})})
        say(layout=layout, kernel="parent shard_emit", walkers=n,
            capacity=C, counters=[int(v) for v in counters],
            ms_in_turns=emit_turns)

        # (iv) the package's emit against the parent's
        work = sw.emit_work(n, D, C, "cuda")
        pk, lk = i32(), i32()
        mine_emit = lambda: sw.emit(tabs[0], cur, prev, pk, alive, lk, L, D,
                                    0, C, work)
        got = [x.clone() for x in mine_emit()]
        check(torch.equal(got[0], send) and torch.equal(got[1], slot)
              and torch.equal(got[2], counters)
              and torch.equal(pk, pend) and torch.equal(lk, loc),
              f"the package's emit differs from the parent's ({layout})")
        flags = (i32(), i32())
        empty = swapped(lambda w=sw.emit_work(n, D, C, "cuda"): sw.emit(
            tabs[0], cur, prev, flags[0], alive, flags[1], L, D, 0, C, w),
            {"EMIT_KERNEL": package["emit empty"]})
        runs = {"parent": turns({"parent": par.emit(
            tabs[0], cur, prev, pend, alive, loc, L, D, 0, C),
            "package": mine_emit}),
            "empty": turns({"package": mine_emit, "empty": empty})}
        for name, (_, consts) in EMIT_FORMS.items():
            with constants(consts):
                w = sw.emit_work(n, D, C, "cuda")
            fn = swapped(lambda w=w: sw.emit(tabs[0], cur, prev, flags[0],
                                             alive, flags[1], L, D, 0, C, w),
                         {"EMIT_KERNEL": package[f"emit {name}"]}, consts)
            out = fn()
            check(torch.equal(out[0], send) and torch.equal(out[1], slot),
                  f"emit form {name!r} differs ({layout})")
            runs[name] = turns({"package": mine_emit, name: fn})
        say(layout=layout, kernel="package shard_emit", walkers=n,
            capacity=C, ms_in_turns=runs)

        # (v) the package's serve of the superstep against the parent's two
        rank1 = shard_superstep(torch, graph, layout, corpus, rank=1)
        tabs1, cur1, prev1, alive1 = rank1[:4]
        send1, *_ = sw.emit(tabs1[1 // L], cur1, prev1, i32(), alive1, i32(),
                            L, D, n, C, sw.emit_work(n, D, C, "cuda"))
        recv = torch.stack([send[0], send1[0]]).contiguous()
        local = (cur, prev, lk)
        dst = torch.full((n,), -1, dtype=torch.int32, device="cuda")
        one = lambda: sw.serve(tabs[0], keys, t, False, local=local,
                               recv=recv, dst=dst, **kw)
        two_local = par.serve(tabs[0], (cur, prev, None), loc, keys, t, **kw)
        two_recv = par.serve(tabs[0], recv.reshape(-1, 3), None, keys, t,
                             **kw)
        two = lambda: (two_local(), two_recv())
        a, b = one(), two()
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"the package's serve differs from the parent's ({layout})")
        plain = sw.serve_plain(tabs[0], keys, t, False, local=local,
                               recv=recv, **kw)
        check(torch.equal(a[0], plain[0]) and torch.equal(a[1], plain[1]),
              f"the package's serve differs from serve_plain ({layout})")
        flat = recv.reshape(-1, 3)
        counts, rcounts = {}, {}
        sw.serve_ref(tabs[0], cur, prev, torch.arange(
            n, dtype=torch.int32, device="cuda"), lm, keys, t, False,
            counts=counts, **kw)
        sw.serve_ref(tabs[0], flat[:, 0], flat[:, 1], flat[:, 2], None, keys,
                     t, False, counts=rcounts, **kw)
        runs = {"parent's two": turns({"parent's two": two, "package": one}),
                "parent's local alone": turns({"parent's local": two_local,
                                               "package": one}),
                "empty": turns({"package": one, "empty": swapped(
                    one, {"SERVE_KERNEL": package["serve empty"]})})}
        for name in SERVE_FORMS:
            fn = swapped(one, {"SERVE_KERNEL": package[f"serve {name}"]})
            out = fn()
            check(torch.equal(out[1], b[1]) and torch.equal(out[0], b[0]),
                  f"serve form {name!r} differs ({layout})")
            runs[name] = turns({"package": one, name: fn})
        clocked = swapped(one, {"SERVE_KERNEL": package["serve clocks"]})
        check(torch.equal(clocked()[1], b[1]), "the clocked serve differs")
        warp_cycles = package_clocks.of(clocked)
        say(layout=layout, kernel="package shard_serve",
            local=int(lm.sum()), received=int((flat[:, 2] >= 0).sum()),
            slots=flat.shape[0],
            max_trials=[counts["max_trials"], rcounts["max_trials"]],
            warp_cycles=warp_cycles, ms_in_turns=runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
