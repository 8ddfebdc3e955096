"""Whole runs of each cell at a tiny size on the CPU (the harness's look for
a card skipped), with the timed path broken underneath: `correct` comes out
false for every fault the cell can have, and true without one. The cells
run on one chip, so no fault leaves out an exchange between chips. Also the
control, the reference in a lower precision in the program's place, fails
the cell's limits."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness, spec
from stellar_rw_tpu_torch.models import word2vec

SEED = 2**31 + 4321
BENCH = spec.benchmark()
WALKS = [w["name"] for w in BENCH["workloads"]
         if spec.cell(w["name"], BENCH)["workload"]["entry"] == "walk"]
TRAINS = [w["name"] for w in BENCH["workloads"]
          if spec.cell(w["name"], BENCH)["workload"]["entry"] == "train"]
assert sorted(WALKS + TRAINS) == sorted(w["name"] for w in BENCH["workloads"])


def _run(tiny, name, patch=None):
    bench, base = tiny
    return harness.run_cell(name, SEED, 0.2, False, "cpu", bench, base,
                            patch=patch)


def _corpus_fault(kind):
    """A patch of the entry's walk: its corpora come out broken."""
    def patch(entry):
        walk = entry.walk

        def broken(*a, **kw):
            out = walk(*a, **kw).clone()
            n = out.shape[0]
            if kind == "unchanged":     # every step leaves the walker put
                out[:, 2:] = torch.where(out[:, 2:] >= 0, out[:, 1:2],
                                         out[:, 2:])
            elif kind == "half":        # the second half of each round idle
                lane = torch.arange(n) % entry.V
                out[lane >= entry.V // 2, 1:] = -1
            else:                       # each row's last token altered
                out[:, -1] = torch.where(out[:, -1] >= 0,
                                         (out[:, -1] + 1) % entry.V, -1)
            return out
        entry.walk = broken
    return patch


@pytest.mark.parametrize("name", WALKS + TRAINS)
def test_a_sound_run_is_correct(tiny, name):
    line = _run(tiny, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    # the entry reports every end-to-end metric of its cell, by name
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                    if spec.applies(m, name)}
    assert all(m["value"] > 0 for k, m in line["metrics"].items()
               if k != "peak_mem_gb")


@pytest.mark.parametrize("kind", ["unchanged", "half", "token"])
@pytest.mark.parametrize("name", WALKS)
def test_a_broken_walk_is_not_correct(tiny, name, kind):
    line = _run(tiny, name, _corpus_fault(kind))
    assert not line["correct"], line["checks"]


def _step_fault(kind, monkeypatch):
    real = word2vec.sgns_exact_step

    def broken(w_in, w_out, block, cwin, negs, lr, window, ws=None,
               buffer=None):
        if kind == "unchanged":
            return w_in, w_out
        block = block.clone()
        block[block.shape[0] // 2:] = -1    # the mean over the rest
        return real(w_in, w_out, block, cwin, negs, lr, window, ws, buffer)
    monkeypatch.setattr(word2vec, "sgns_exact_step", broken)


def _answer_fault(monkeypatch):
    real = word2vec.train_skipgram

    def broken(*a, **kw):
        w_in, w_out = real(*a, **kw)
        w_out = w_out.copy()
        r = int(abs(w_out).sum(1).argmax())
        w_out[r] = -w_out[r]                # one row of the answer altered
        return w_in, w_out
    monkeypatch.setattr(word2vec, "train_skipgram", broken)


@pytest.mark.parametrize("kind", ["unchanged", "half", "token", "answer"])
@pytest.mark.parametrize("name", TRAINS)
def test_a_broken_trainer_is_not_correct(tiny, name, kind, monkeypatch):
    patch = None
    if kind in ("unchanged", "half"):
        _step_fault(kind, monkeypatch)
    elif kind == "answer":
        _answer_fault(monkeypatch)
    else:
        def patch(entry):                   # a token of the corpus walked
            entry.corpus[5, 3] = (entry.corpus[5, 3] + 1) % entry.V
    line = _run(tiny, name, patch)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", WALKS + TRAINS)
def test_the_control_fails_the_limits(tiny, name):
    bench, base = tiny
    out = control.control(name, SEED + 1, 0.2, None, "cpu", bench, base)
    wrong = "bf16" if name in WALKS else "tf32"
    limits = spec.cell(name, bench, base)["workload"]["check"]["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out[wrong].items()), out
