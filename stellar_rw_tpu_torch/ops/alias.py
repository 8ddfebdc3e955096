"""Host-side Vose alias-table construction for a single discrete distribution.

Used for the word2vec negative-sampling unigram table (counts^0.75) — the
replacement for hierarchical softmax in the reference's MLlib Word2Vec dependency
(reference Main.scala:89-97; BASELINE.json swaps HS for negative sampling). Per-row
CSR alias tables live in graph/csr.py.
"""

from __future__ import annotations

import numpy as np


def build_alias(probs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose alias table: returns (keep_prob f32[n], alias i32[n]). Drawing: pick cell
    j uniformly, keep j with prob keep_prob[j], else take alias[j].

    Uses the native C++ row builder when available (a million-word vocab table
    builds in ms instead of a per-index Python worklist); identical algorithm
    either way, modulo f32-vs-f64 normalization rounding in the inputs."""
    n = len(probs)
    try:
        from .. import native
        if n > 4096 and native.available():
            offsets = np.array([0, n], dtype=np.int64)
            keep, alias = native.build_alias_rows(
                offsets, np.asarray(probs, dtype=np.float32))
            return keep, alias
    except Exception:
        pass
    p = np.asarray(probs, dtype=np.float64)
    p = p / p.sum() * n
    keep = np.ones(n, dtype=np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large[-1]
        keep[s] = p[s]
        alias[s] = l
        p[l] -= 1.0 - p[s]
        if p[l] < 1.0:
            large.pop()
            small.append(l)
    return keep, alias
