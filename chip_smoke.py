#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellar_rw_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a), holds each against
its plain PyTorch version on the card, then drives the main path once
through the CLI: `node2vec --sharedNegatives 128` on a BlogCatalog-shaped
graph (10,000 vertices, 334,000 sampled edges; the node2vec paper's
BlogCatalog has 10,312 vertices and 333,983 edges) with walkLength 80,
numWalks 10 and dim 128. It counts the kernels' launches in that run,
checks the outputs, and runs the karate quality gate on the card.

Every failure raises and the script exits non-zero. It needs a CUDA device
and the repository around it; it imports nothing of JAX. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches, error against its plain version and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SGNS_SHAPES = [(2624, 128, 128), (300, 50, 37), (7, 128, 256)]
# every trial mode of csrc/walk.cu: general, p == q == 1, q == 1
WALK_PQ = [(0.25, 0.25), (1.0, 1.0), (1.0, 4.0), (4.0, 0.25), (0.5, 1.0)]
MAIN_FLAGS = ["--cmd", "node2vec", "--walkLength", "80", "--numWalks", "10",
              "--p", "0.25", "--q", "0.25", "--dim", "128", "--window", "10",
              "--negatives", "5", "--sharedNegatives", "128", "--iter", "1",
              "--validate", "true"]


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
    from stellar_rw_tpu.graph.csr import from_edge_arrays

    src, dst = synth_power_law_arcs(num_vertices, num_edges, seed)
    return from_edge_arrays(src, dst, num_vertices=num_vertices,
                            symmetrize=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


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
    builds = {}
    for k in kernels:
        k.fn()
        builds[k.source] = round(k.build_seconds, 2)
    print(f"phase 1 env: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc} | sm_90a build seconds {builds}")
    return smi


def phase_walk(torch) -> None:
    from stellar_rw_tpu.graph import io as gio
    from stellar_rw_tpu_torch.ops import prng, sampling, walk_step

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
            keys = walk_step.trial_keys(prng.prng_key(7), 0, R, L,
                                        4 * max_rounds).cuda()
            got = walk_step.walk_rounds(dg, starts, keys, L, p, q,
                                        g.num_vertices)
            want = walk_step.walk_corpus_ref(dg, starts, keys, L, p, q,
                                             g.num_vertices)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"walk kernel differs from its plain version on {name} "
                  f"at p={p} q={q}")
            n += 1
    print(f"phase 2 walk kernel: bitwise equal to walk_corpus_ref on the "
          f"card in {n} cases (synth 2K power-law + directed testgraph, "
          f"(p, q) in {WALK_PQ})")


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
        want = sgns.sgns_shared_grads_ref(vi, vo, wn, g_pos, mask)
        for a, b in zip(got, want):
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-5),
                  f"sgns_shared_grads differs at {(P, D, kB)}")
            err = max(err, float((a - b).abs().max()))
        if (P, D, kB) == SGNS_SHAPES[0]:
            kern = lambda: sgns.sgns_shared_grads(vi, vo, wn, g_pos, mask)
            plain = lambda: sgns.sgns_shared_grads_ref(vi, vo, wn, g_pos,
                                                       mask)
            runs = [cuda_ms(f, 50) for f in (plain, kern, kern, plain)]
            timing = {"ms": (runs[1] + runs[2]) / 2,
                      "plain_ms": (runs[0] + runs[3]) / 2}
    print(f"phase 3 sgns_shared_grads: within rtol 1e-5 atol 1e-5 of the "
          f"plain f32 version at {SGNS_SHAPES}, max abs err {err:.3g}; at "
          f"{SGNS_SHAPES[0]} kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms (CUDA events, mean of 2x50)")
    return {"max_abs_err": err, **timing}


def phase_walk_main_shape(torch, graph) -> dict:
    """Kernel vs plain version at the main path's walk shape (all rounds in
    one dispatch), bitwise and timed."""
    from stellar_rw_tpu_torch.ops import prng, sampling, walk_step

    dg = sampling.device_put_graph(graph, "cuda")
    V = graph.num_vertices
    starts = torch.arange(V, dtype=torch.int32, device="cuda")
    _, max_rounds = sampling.plan_sampler("rejection", 0.25, 0.25)
    keys = walk_step.trial_keys(prng.prng_key(0), 0, 10, 80,
                                4 * max_rounds).cuda()
    kern = lambda: walk_step.walk_rounds(dg, starts, keys, 80, 0.25, 0.25, V)
    plain = lambda: walk_step.walk_corpus_ref(dg, starts, keys, 80, 0.25,
                                              0.25, V)
    got, want = kern(), plain()
    check(torch.equal(got, want),
          "walk kernel differs from its plain version at the main shape")
    err = float((got - want).abs().max())
    ms = cuda_ms(kern, 5)
    plain_ms = cuda_ms(plain, 1)
    print(f"phase 4a walk kernel at the main shape ({V} starts x 10 rounds, "
          f"L=80, p=q=0.25): bitwise equal; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms (CUDA events)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_main(torch, walk_kernel, sgns_kernel, smi, tmp) -> None:
    from stellar_rw_tpu_torch import cli
    from stellar_rw_tpu_torch.models import node2vec as n2v

    src, dst = synth_power_law_arcs(10_000, 334_000, seed=0)
    edges = os.path.join(tmp, "blogcatalog_shaped.txt")
    np.savetxt(edges, np.stack([src, dst], 1), fmt="%d")
    out = os.path.join(tmp, "out")
    report = {}
    walk_kernel.launches = 0
    sgns_kernel.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["--input", edges, "--output", out] + MAIN_FLAGS,
                  report=report)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc}")
    check(walk_kernel.launches > 0, "the walk kernel was not launched")
    check(sgns_kernel.launches > 0, "sgns_shared_grads was not launched")
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
          f"trainer epoch {report['train_seconds']:.2f} s; CLI wall "
          f"{wall:.1f} s; launches walk={walk_kernel.launches} "
          f"sgns={sgns_kernel.launches}; invariants {report['invariants']} "
          f"[{smi}]")


def phase_quality(torch) -> None:
    from stellar_rw_tpu.graph import io as gio
    from stellar_rw_tpu.models import eval as ev
    from stellar_rw_tpu_torch.models import word2vec as w2v
    from stellar_rw_tpu_torch.walk import engine

    g = gio.load_edge_list(os.path.join(ROOT, "tests", "data", "karate.txt"),
                           weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2,
                                as_numpy=False, device="cuda")
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                         seed=1, shared_negatives=32)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg, device="cuda")
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = ev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices,
                                 seed=0)
    acc = ev.node_classification_accuracy(w_in, ev.karate_labels(g.ids),
                                          seed=0)
    check(auc > 0.7 and acc >= 0.85, f"karate gate: auc {auc} acc {acc}")
    print(f"phase 5 karate quality on the card: link AUC {auc:.4f} (> 0.7), "
          f"faction accuracy {acc:.4f} (>= 0.85)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops.sgns import SGNS_KERNEL
    from stellar_rw_tpu_torch.ops.walk_step import WALK_KERNEL

    smi = phase_env(torch, (WALK_KERNEL, SGNS_KERNEL))
    phase_walk(torch)
    sgns_row = phase_sgns(torch)
    walk_row = phase_walk_main_shape(
        torch, synth_power_law_graph(10_000, 334_000, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        phase_main(torch, WALK_KERNEL, SGNS_KERNEL, smi, tmp)
    launches = {"walk": WALK_KERNEL.launches,
                "sgns_shared_grads": SGNS_KERNEL.launches}
    phase_quality(torch)
    kernels = [
        {"name": "walk", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/walk.cu",
         "replaces": "stellar_rw_tpu/walk/engine.py:176",
         "launches": launches["walk"], **walk_row},
        {"name": "sgns_shared_grads", "route": "cuda",
         "source": "stellar_rw_tpu_torch/csrc/sgns_shared.cu",
         "replaces": "stellar_rw_tpu/ops/pallas/sgns.py:90",
         "launches": launches["sgns_shared_grads"], **sgns_row},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
