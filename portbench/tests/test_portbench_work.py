"""Every work count of the benchmark against a count by hand on inputs of
karate's size (34 vertices, 78 edges): the expected pairs, the model
FLOPs, the exact step's bytes, the CDF's entries, the rejection walk's
draws on its floor, and the bound's arithmetic."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from portbench import graphcell, graphgen, peaks, work
from portbench.reference import graph as refgraph

V, E = 34, 78


@pytest.fixture(scope="module")
def karate_sized():
    src, dst = graphgen.power_law_arcs(V, E, 7)
    return src, dst, refgraph.build(src, dst, V, True, "cpu")


@pytest.mark.parametrize("n,window", [(0, 3), (1, 3), (2, 3), (5, 3),
                                      (82, 10), (7, 10), (4, 1)])
def test_pairs_for_length_is_the_mean_over_every_window(n, window):
    # every center draws b in 1..w alike; count the pairs of each draw
    total = 0
    for b in range(1, window + 1):
        total += sum(1 for c in range(n) for o in range(-b, b + 1)
                     if o and 0 <= c + o < n)
    assert work.pairs_for_length(n, window) == pytest.approx(
        total / window, rel=1e-12)


def test_expected_pairs_sums_the_rows():
    lengths = [82, 82, 1, 0, 40, 82]
    assert work.expected_pairs(lengths, 10) == pytest.approx(
        sum(work.pairs_for_length(n, 10) for n in lengths), rel=1e-12)


def test_model_flops_and_the_exact_step_bytes():
    pairs, D, k = 1000.0, 128, 5
    # a pair: 1 + k dot products (2D each), the center's gradient (2D a
    # target) and the targets' gradients (2D a target)
    assert work.model_flops(pairs, D, k) == pairs * (1 + k) * 3 * 2 * D
    blocks, positions, w, distinct = 3, 32 * 82, 10, 500
    per_block = 4 * positions + 4 * positions + 4 * positions * 2 * w * k
    rows = 2 * 2 * 4 * D * distinct     # two tables, read and written
    assert work.exact_step_bytes(blocks, positions, w, k, D, distinct) == (
        blocks * per_block + rows)


def test_bound_is_the_largest_of_the_three():
    assert peaks.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, flops=67e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, int_ops=33.5e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(3.35e12, 2 * 67e12, 33.5e12) == (
        pytest.approx(2.0))
    assert peaks.OPS_PER_DRAW == 83


def test_rejection_draws_on_the_floor_of_one_trial():
    walkers, rounds, L, T = 34 * 3, 3, 5, 64
    # a walker: the first-order draw (2) and one trial a second-order step
    # (3 uniforms); a (round, step): two chained keys and T trial keys
    hand = walkers * 2 + walkers * L * 3 + rounds * (L + 1) * (2 + T)
    assert work.rejection_draws(walkers, rounds, L, T) == hand


def test_corpus_bytes():
    assert work.corpus_bytes(10, 80, 34, 156) == 4 * 10 * 82 + 4 * 156 + 8 * 35
    assert work.corpus_bytes(10, 80, 34, 156, entry_bytes=8) == (
        4 * 10 * 82 + 8 * 156 + 8 * 35)


def _walk_cell(corpus_graph, L):
    src, dst, g = corpus_graph
    cell = graphcell.GraphCell.__new__(graphcell.GraphCell)
    cell.V, cell.L = V, L
    return cell, g


def test_corpus_entries_are_the_rows_each_step_leaves(karate_sized):
    cell, g = _walk_cell(karate_sized, 4)
    deg = g.degrees.numpy()
    cols = g.cols.numpy()
    offs = g.offsets.numpy()
    rng = np.random.default_rng(3)
    rows = []
    for r, w in itertools.product(range(2), range(V)):
        row = [w]
        if deg[w]:
            for _ in range(cell.L + 1):
                cur = row[-1]
                row.append(int(cols[offs[cur] + rng.integers(deg[cur])]))
        rows.append(row + [-1] * (cell.L + 2 - len(row)))
    corpus = torch.tensor(rows)
    faults = cell.corpus_faults(g, corpus, chunk=7)
    hand_entries = sum(int(deg[a]) for row in rows
                       for a, b in zip(row, row[1:]) if a >= 0 and b >= 0)
    hand_steps = sum(1 for row in rows for a, b in zip(row, row[1:])
                     if a >= 0 and b >= 0)
    assert faults == {"bad_rows": 0, "bad_transitions": 0,
                      "entries": hand_entries, "steps": hand_steps}
    bent = corpus.clone()
    live = int(np.flatnonzero(deg > 0)[0])
    bent[live, 3] = bent[live, 2]      # a walker that stays where it was
    bent[V + live, 4:] = -1            # a walk cut short
    f = cell.corpus_faults(g, bent, chunk=7)
    assert f["bad_rows"] == 1 and f["bad_transitions"] >= 1


def test_cdf_bound_counts_every_entry_at_one_rate():
    entries_, steps = 1e6, 1e4
    ops = work.OPS_PER_ENTRY * entries_ + peaks.OPS_PER_DRAW * 2 * steps
    nbytes = work.corpus_bytes(30, 8, V, 156, entry_bytes=8)
    assert work.cdf_bound(entries_, steps, 3, 8, V, 156) == pytest.approx(
        max(ops / peaks.INT_OPS_PER_S, nbytes / peaks.MEM_BYTES_PER_S))


def test_distinct_tokens_a_block(karate_sized):
    rng = np.random.default_rng(5)
    corpus = rng.integers(-1, V, size=(37, 9)).astype(np.int32)
    B = 4
    hand = sum(len({t for t in corpus[b:b + B].reshape(-1).tolist()
                    if t >= 0}) for b in range(0, 37, B))
    assert work.distinct_tokens(corpus, B) == hand
