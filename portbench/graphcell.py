"""What every entry over a configuration's graph shares.

An entry is the code a cell's window drives: a module entries/<entry>.py,
named by the workload's `entry` and found by that name (spec.entry_module).
Its `make(cell, seed, device)` returns an object with

  setup()               the graph and whatever the entry needs before calls;
  warmup()              one short call over the cell's own shapes;
  call(i)               the i-th call of the window, waited for;
  end_to_end(calls, window_s)
                        the cell's end-to-end metrics, by BENCHMARK.json's
                        names, of `calls` completed in `window_s` seconds
                        (setup_s and peak_mem_gb are the harness's own);
  check(wrong=None)     (numbers compared, facts) after the window; wrong
                        names the plain reference in a lower precision, or
                        a planted fault, put in the program's place;
  bound_per_call(facts) the least seconds a call's work takes on the card;
  kind, host_prep_s     what the per-layer readers look at;

and the module's CONTROL names the wrong program that check() reads for
the control. GraphCell below builds the configuration's graph (the frozen
generator from the configuration's graph seed, then the port's
graph/csr.py and ops/sampling.device_put_graph: the host prep), walks it
with the port's engine, and checks corpora against the plain reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import graphgen
from portbench.reference import graph as refgraph
from portbench.reference import walks as refwalks


def derive(seed: int, *path: int) -> int:
    """A seed below 2**63 drawn from the run's seed and a path of indices."""
    ss = np.random.SeedSequence([seed % 2**64, *path])
    a, b = (int(x) for x in ss.generate_state(2, np.uint32))
    return (a << 31) ^ b


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class GraphCell:
    """The graph, its host prep, the port's walk over it and the corpus
    checks."""

    def __init__(self, cell: dict, seed: int, device):
        self.cfg = cell["config"]
        self.wl = cell["workload"]
        self.seed = seed
        self.device = torch.device(device)
        gcfg = self.cfg["graph"]
        self.V = int(gcfg["num_vertices"])
        self.symmetrize = not gcfg.get("directed", False)
        self.L = int(self.cfg["walk"]["walk_length"])
        self.R = int(self.cfg["walk"]["walks_per_node"])
        self.limits = self.wl["check"]["limits"]

    def build_graph(self, cdf: bool) -> None:
        from stellar_rw_tpu_torch.graph.csr import from_edge_arrays
        from stellar_rw_tpu_torch.ops import sampling

        gcfg = self.cfg["graph"]
        # the graph is the configuration's, one for every seed: the seed
        # draws the walks and the jobs over it, so that every run does the
        # same amount of work
        self.arcs = graphgen.power_law_arcs(self.V, int(gcfg["num_edges"]),
                                            int(gcfg["seed"]))
        t0 = time.perf_counter()
        self.graph = from_edge_arrays(*self.arcs, num_vertices=self.V,
                                      symmetrize=self.symmetrize)
        self.dg = sampling.device_put_graph(self.graph, self.device, cdf=cdf)
        sync(self.device)
        self.host_prep_s = time.perf_counter() - t0
        self.deg = self.graph.degrees.astype(np.int64)
        self.alive = int((self.deg > 0).sum())
        self.hub = int(np.argmax(self.deg))
        self.num_arcs = int(self.graph.num_edges)

    def walk(self, seed: int, p: float, q: float) -> torch.Tensor:
        from stellar_rw_tpu_torch.walk import engine

        return engine.random_walks(self.graph, self.L, self.R, p, q,
                                   seed=seed, device_graph=self.dg,
                                   as_numpy=False, device=self.device)

    def sample_rows(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n rows of a corpus drawn by rng, one of them the hub's walk of a
        drawn round (the longest rows a step scans)."""
        N = self.R * self.V
        rows = rng.choice(N, size=min(n, N), replace=False)
        rows[0] = int(rng.integers(self.R)) * self.V + self.hub
        return np.unique(rows)

    def ref_graph(self):
        return refgraph.build(*self.arcs, self.V, self.symmetrize,
                              self.device)

    def corpus_faults(self, ref, corpus: torch.Tensor,
                      chunk: int = 1 << 18) -> dict:
        """Whole-corpus checks by the reference's rows: rows with a wrong
        start, an id out of range, a -1 followed by an id or a length other
        than a walk from that start has; transitions that are not arcs;
        and the entries of the rows the transitions left (the CDF's
        scans)."""
        V, L = self.V, self.L
        deg = ref.degrees
        bad_rows = bad_trans = entries = steps = 0
        for s in range(0, corpus.shape[0], chunk):
            c = corpus[s:s + chunk].to(torch.int64)
            lane = (torch.arange(s, s + c.shape[0], device=c.device) % V)
            a, b = c[:, :-1], c[:, 1:]
            start_ok = deg[lane] > 0
            want = torch.where(start_ok, L + 2, 1)
            bad = ((c[:, 0] != lane) | ((c < -1) | (c >= V)).any(1)
                   | ((a < 0) & (b >= 0)).any(1) | ((c >= 0).sum(1) != want))
            bad_rows += int(bad.sum())
            valid = (a >= 0) & (b >= 0) & (a < V) & (b < V)
            aa, bb = a[valid], b[valid]
            bad_trans += int((~ref.member(aa, bb)).sum())
            entries += int(deg[aa].sum())
            steps += int(valid.sum())
        return {"bad_rows": bad_rows, "bad_transitions": bad_trans,
                "entries": entries, "steps": steps}

    def replay_rows(self, ref, seeds, rows, p, q, dtype=torch.float32):
        rows = torch.as_tensor(np.asarray(rows, dtype=np.int64))
        sampler = "cdf" if refwalks.uses_cdf(p, q) else "rejection"
        if sampler == "cdf":
            refwalks.check_cdf_exact(ref, p, q, self.R * self.V)
        return refwalks.replay(ref, sampler, seeds, rows // self.V,
                               rows % self.V, self.V, self.L, p, q, dtype)
