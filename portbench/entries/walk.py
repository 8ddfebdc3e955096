"""The walk entry: stellar_rw_tpu_torch.walk.engine.random_walks over the
cell's graph, one whole corpus a call (walks_per_node rounds from every
vertex) under a fresh walk seed, waited for before the next call.

The workload gives `walk` {p, q} and `cdf_rows` (whether set-up uploads the
exact-CDF rows). The check replays `check.rows_per_call` rows of every
corpus, the hub's among them, and checks the last corpus whole. Reports
walk_steps_per_s. The control is the reference's walk in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.graphcell import GraphCell, derive, sync
from portbench.reference import walks as refwalks

CONTROL = "bf16"


class WalkEntry(GraphCell):
    kind = "walk"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.p = float(self.wl["walk"]["p"])
        self.q = float(self.wl["walk"]["q"])
        self.sampler = "cdf" if refwalks.uses_cdf(self.p, self.q) else \
            "rejection"
        self.rows_per_call = int(self.wl["check"]["rows_per_call"])
        self.samples = []
        self.last = None

    def setup(self) -> None:
        self.build_graph(cdf=bool(self.wl.get("cdf_rows", False)))
        # every walker whose start has an arc moves L + 1 times: the graph
        # is undirected, so no walk meets a dead end after its start
        self.steps_per_call = self.R * self.alive * (self.L + 1)

    def warmup(self) -> None:
        out = self.walk(derive(self.seed, 5, 0), self.p, self.q)
        out.index_select(0, torch.zeros(1, dtype=torch.int64,
                                        device=out.device))
        sync(self.device)

    def call(self, i: int) -> None:
        self.last = None    # freed first: one corpus on the card at a time
        s = derive(self.seed, 1, i)
        out = self.walk(s, self.p, self.q)
        rows = self.sample_rows(np.random.default_rng(derive(self.seed, 2, i)),
                                self.rows_per_call)
        self.samples.append((s, rows, out.index_select(
            0, torch.as_tensor(rows, device=out.device))))
        self.last = out
        sync(self.device)

    def end_to_end(self, calls: int, window_s: float) -> dict:
        return {"walk_steps_per_s": self.steps_per_call * calls / window_s}

    def bound_per_call(self, facts: dict) -> float:
        if self.sampler == "cdf":
            return work.cdf_bound(facts["entries_per_call"],
                                  self.steps_per_call, self.R, self.L,
                                  self.V, self.num_arcs)
        return work.rejection_bound(
            self.R * self.alive, self.R, self.L,
            refwalks.rejection_trials(self.p, self.q), self.V, self.num_arcs)

    def sample_arrays(self):
        seeds = np.concatenate([np.full(len(r), s, dtype=np.int64)
                                for s, r, _ in self.samples])
        rows = np.concatenate([r for _, r, _ in self.samples])
        got = torch.cat([t for _, _, t in self.samples]).to(torch.int64)
        return seeds, rows, got

    def check(self, wrong: str | None = None) -> tuple[dict, dict]:
        """(numbers compared, facts for the metrics). wrong "bf16" (the
        control): the rows compared are the reference's own in bfloat16, in
        the program's place."""
        if wrong not in (None, "bf16"):
            raise ValueError(f"no wrong walk {wrong!r}")
        ref = self.ref_graph()
        seeds, rows, got = self.sample_arrays()
        want = self.replay_rows(ref, seeds, rows, self.p, self.q)
        if wrong:
            got = self.replay_rows(ref, seeds, rows, self.p, self.q,
                                   torch.bfloat16)
        faults = self.corpus_faults(ref, self.last)
        numbers = {
            "rows_mismatched": int((got.to(want.device) != want).any(1).sum()),
            "bad_rows": faults["bad_rows"],
            "bad_transitions": faults["bad_transitions"],
            "steps_gap": abs(faults["steps"] - self.steps_per_call),
        }
        facts = {"rows_compared": int(len(rows)),
                 "entries_per_call": faults["entries"]}
        return numbers, facts


def make(cell: dict, seed: int, device) -> WalkEntry:
    return WalkEntry(cell, seed, device)
