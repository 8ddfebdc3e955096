"""Work counts from a cell's inputs and configuration alone.

Every roofline and FLOP count of the benchmark is made here, from the
corpus shape, the graph's rows and the configuration, never from a
kernel's counters or recording form, so that it reads the same work
whatever implements it. `peaks.bound_seconds` turns a count into the least
time the card could take.
"""

from __future__ import annotations

import numpy as np

from . import peaks

OPS_PER_ENTRY = 8   # weighing one CDF row entry: its load, the compare with
#                     prev, the membership probe, the select of the factor,
#                     the product, the sum and the compare with the draw


def pairs_for_length(n: int, window: int) -> float:
    """Expected skip-gram pairs of one row of n tokens: a center draws its
    window b uniformly from 1..w, and offset o on either side is a pair
    where o <= b (probability (w - o + 1) / w) and the neighbour exists."""
    return sum(2 * max(n - o, 0) * (window - o + 1) / window
               for o in range(1, window + 1))


def expected_pairs(row_lengths, window: int) -> float:
    """Expected pairs of a corpus whose rows hold row_lengths tokens."""
    lengths, counts = np.unique(np.asarray(row_lengths, dtype=np.int64),
                                return_counts=True)
    return float(sum(c * pairs_for_length(int(n), window)
                     for n, c in zip(lengths, counts)))


def model_flops(pairs: float, dim: int, negatives: int) -> float:
    """Skip-gram model FLOPs: a pair's 1 + k dots, the center's gradient and
    the targets' gradients, each 2 D a target: 6 D (1 + k)."""
    return 6.0 * dim * (1 + negatives) * pairs


def exact_step_bytes(blocks: int, block_positions: int, window: int,
                     negatives: int, dim: int, distinct_tokens: int) -> float:
    """Bytes an epoch of exact steps needs at least: each block's tokens,
    windows and negatives read once, and the rows of its distinct tokens
    read and written once in each table."""
    per_block = 4 * block_positions * (2 + 2 * window * negatives)
    return float(blocks * per_block + 2 * 2 * 4 * dim * distinct_tokens)


def distinct_tokens(corpus: np.ndarray, rows_per_block: int) -> int:
    """Distinct tokens (ids >= 0) summed over the corpus's blocks of
    rows_per_block rows, the last block padded."""
    N, T = corpus.shape
    B = rows_per_block
    blocks = -(-N // B)
    padded = np.full((blocks * B, T), -1, dtype=np.int64)
    padded[:N] = corpus
    total = 0
    per = max(1, (1 << 22) // (B * T))
    for b0 in range(0, blocks, per):
        s = np.sort(padded[b0 * B:(b0 + per) * B].reshape(-1, B * T), axis=1)
        new = np.ones(s.shape, dtype=bool)
        new[:, 1:] = s[:, 1:] != s[:, :-1]
        total += int((new & (s >= 0)).sum())
    return total


def exact_step_bound(pairs: float, dim: int, negatives: int, blocks: int,
                     block_positions: int, window: int,
                     distinct_tokens: int) -> float:
    """Seconds an epoch of exact steps takes at least."""
    return peaks.bound_seconds(
        exact_step_bytes(blocks, block_positions, window, negatives, dim,
                         distinct_tokens),
        flops=model_flops(pairs, dim, negatives))


def corpus_bytes(rows: int, walk_length: int, num_vertices: int,
                 num_arcs: int, entry_bytes: int = 4) -> float:
    """A corpus written once and the graph's rows read once."""
    return float(4 * rows * (walk_length + 2) + entry_bytes * num_arcs
                 + 8 * (num_vertices + 1))


def rejection_draws(walkers: int, rounds: int, walk_length: int,
                    trials: int) -> float:
    """Threefry draws of a rejection-sampled corpus on the floor of one
    trial a step: two for the first-order draw and three for a trial, for
    each walker that moves; the trial keys of every (round, step) and
    trial, two chained draws a (round, step) above its T keys."""
    return float(walkers * (2 + 3 * walk_length)
                 + rounds * (walk_length + 1) * (2 + trials))


def rejection_bound(walkers: int, rounds: int, walk_length: int, trials: int,
                    num_vertices: int, num_arcs: int) -> float:
    """Seconds a rejection-sampled corpus takes at least."""
    return peaks.bound_seconds(
        corpus_bytes(rounds * num_vertices, walk_length, num_vertices,
                     num_arcs),
        int_ops=peaks.OPS_PER_DRAW * rejection_draws(
            walkers, rounds, walk_length, trials))


def cdf_bound(entries: float, steps: float, rounds: int, walk_length: int,
              num_vertices: int, num_arcs: int) -> float:
    """Seconds an exact-CDF corpus takes at least: every entry of each row
    a step scans weighed once, and two draws a step (the step's key and
    the walker's uniform)."""
    return peaks.bound_seconds(
        corpus_bytes(rounds * num_vertices, walk_length, num_vertices,
                     num_arcs, entry_bytes=8),
        int_ops=OPS_PER_ENTRY * entries + peaks.OPS_PER_DRAW * 2 * steps)
