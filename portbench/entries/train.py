"""The exact-negative trainer entry:
stellar_rw_tpu_torch.models.word2vec.train_skipgram, one job a call under
a fresh trainer seed, over a corpus the port walked in set-up; a job
returns its tables to the host.

The workload gives `corpus` {p, q} (the set-up walk) and `trainer`
{shared_negatives: 0, iters}. The check replays `check.corpus_rows` rows of
the corpus, checks it whole, and replays the window's last job whole in
float32 (reference/trainer.py). Reports train_tokens_per_s. The control is
the reference with TF32 products; "half" is the planted fault of half of
every block left out. A shared-negative trainer has another step and
another reference, and so an entry of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import work
from portbench.graphcell import GraphCell, derive
from portbench.reference import trainer as reftrainer

CONTROL = "tf32"
WARMUP_BLOCKS = 64


class TrainEntry(GraphCell):
    kind = "train"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        m = self.cfg["model"]
        t = self.wl["trainer"]
        self.dim, self.window = int(m["dim"]), int(m["window"])
        self.negatives, self.row_block = int(m["negatives"]), int(m["row_block"])
        self.lr = float(m["lr"])
        self.iters = int(t["iters"])
        if int(t["shared_negatives"]):
            raise ValueError("entries/train.py replays exact negatives")
        self.p = float(self.wl["corpus"]["p"])
        self.q = float(self.wl["corpus"]["q"])
        self.corpus_rows = int(self.wl["check"]["corpus_rows"])
        self.distinct = None
        self.last = None

    def config(self, seed: int):
        from stellar_rw_tpu_torch.models.word2vec import SGNSConfig

        return SGNSConfig(dim=self.dim, window=self.window,
                          negatives=self.negatives, lr=self.lr,
                          iters=self.iters, row_block=self.row_block,
                          seed=seed, shared_negatives=0)

    def setup(self) -> None:
        self.build_graph(cdf=False)
        self.walk_seed = derive(self.seed, 3)
        self.corpus = self.walk(self.walk_seed, self.p, self.q)
        # the trainer reads no graph: a user drops its tables here
        del self.dg
        # the counts the benchmark needs come from a host copy, so that the
        # card holds only what a user's walk and jobs hold
        self.corpus_host = self.corpus.cpu().numpy()
        lengths = (self.corpus_host >= 0).sum(1)
        self.tokens = int(lengths.sum())
        self.pairs = work.expected_pairs(lengths, self.window)
        N, T = self.corpus_host.shape
        self.B = max(1, min(self.row_block, N))
        self.blocks = -(-N // self.B)
        self.block_positions = self.B * T

    def warmup(self) -> None:
        """A job over the corpus's first WARMUP_BLOCKS blocks: the kernels
        and shapes of a whole job, a fraction of its time."""
        from stellar_rw_tpu_torch.models import word2vec

        word2vec.train_skipgram(
            self.corpus[:WARMUP_BLOCKS * self.row_block], self.V,
            self.config(derive(self.seed, 5, 0)), device=self.device)

    def call(self, i: int) -> None:
        from stellar_rw_tpu_torch.models import word2vec

        s = derive(self.seed, 4, i)
        w_in, w_out = word2vec.train_skipgram(self.corpus, self.V,
                                              self.config(s),
                                              device=self.device)
        self.last = (s, w_in, w_out)

    def work_per_call(self) -> dict:
        return {"tokens": self.tokens * self.iters,
                "flops": self.iters * work.model_flops(
                    self.pairs, self.dim, self.negatives)}

    def end_to_end(self, calls: int, window_s: float) -> dict:
        return {"train_tokens_per_s":
                self.work_per_call()["tokens"] * calls / window_s}

    def bound_per_call(self, facts: dict | None = None) -> float:
        if self.distinct is None:     # read after the window, on the host
            self.distinct = work.distinct_tokens(self.corpus_host, self.B)
        return self.iters * work.exact_step_bound(
            self.pairs, self.dim, self.negatives, self.blocks,
            self.block_positions, self.window, self.distinct)

    def check(self, wrong: str | None = None) -> tuple[dict, dict]:
        """(numbers compared, facts). wrong: the job's tables are those of
        the reference's wrong trainer of that name (reference/trainer.py:
        "tf32", the control, or "half"), in the program's place."""
        ref = self.ref_graph()
        rng = np.random.default_rng(derive(self.seed, 6))
        rows = self.sample_rows(rng, self.corpus_rows)
        want = self.replay_rows(ref, np.full(len(rows), self.walk_seed),
                                rows, self.p, self.q)
        got_rows = self.corpus[torch.as_tensor(rows, device=self.corpus.device)]
        faults = self.corpus_faults(ref, self.corpus)
        del ref
        s, got_in, got_out = self.last
        kw = dict(vocab=self.V, dim=self.dim, window=self.window,
                  k=self.negatives, row_block=self.row_block, seed=s,
                  lr=self.lr, iters=self.iters)
        if getattr(self, "_ref", (None,))[0] != s:
            self._ref = (s, *reftrainer.train(self.corpus, **kw))
        _, r_in, r_out, init = self._ref
        if wrong:
            got_in, got_out, _ = reftrainer.train(self.corpus, wrong=wrong,
                                                  **kw)
        numbers = {
            "corpus_rows_mismatched": int(
                (got_rows.to(torch.int64).to(want.device) != want).any(1).sum()),
            "corpus_bad_rows": faults["bad_rows"],
            "corpus_bad_transitions": faults["bad_transitions"],
            **reftrainer.gaps(got_in, got_out, r_in, r_out, init),
        }
        return numbers, {"rows_compared": int(len(rows))}


def make(cell: dict, seed: int, device) -> TrainEntry:
    return TrainEntry(cell, seed, device)
