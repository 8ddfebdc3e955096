"""Embedding quality harness: link prediction and node classification.

The reference has no in-repo eval; BASELINE.json makes quality parity (link-prediction /
node-classification vs the Scala+MLlib embeddings) part of the spec, so this harness is
a first-class component (SURVEY.md §7 milestone 3, hard-part #5).
"""

from __future__ import annotations

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.where(n > 0, n, 1.0)


def sample_non_edges(edges: np.ndarray, num_vertices: int, m: int,
                     rng: np.random.Generator) -> np.ndarray:
    """m random (a, b) pairs with a != b and neither (a, b) nor (b, a) an edge.

    Vectorized (the one-at-a-time Python loop with
    a Python edge set made the EVALUATION the bottleneck at large V): draw
    candidate batches, reject against the sorted packed-key edge index
    (the same searchsorted trick as utils/stats.validate_walks), repeat on the
    survivors' shortfall. Batches are oversized by the measured rejection rate
    so the expected number of rounds is ~2 even on dense graphs."""
    V = int(num_vertices)
    e = edges.astype(np.int64)
    keys = np.unique(
        np.concatenate([e[:, 0] * V + e[:, 1], e[:, 1] * V + e[:, 0]]))

    def ok(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        cand = a * V + b
        if len(keys):
            pos = np.minimum(np.searchsorted(keys, cand), len(keys) - 1)
            is_edge = keys[pos] == cand
        else:
            is_edge = np.zeros(len(cand), dtype=bool)
        return (a != b) & ~is_edge

    out = np.empty((m, 2), dtype=np.int64)
    got = 0
    accept = 1.0
    while got < m:
        want = m - got
        batch = int(min(max(want / max(accept, 0.05) * 1.2, want), 4 * m + 64))
        a = rng.integers(V, size=batch)
        b = rng.integers(V, size=batch)
        keep = ok(a, b)
        k = int(keep.sum())
        accept = max(k / max(batch, 1), 0.01)
        take = min(k, want)
        out[got:got + take, 0] = a[keep][:take]
        out[got:got + take, 1] = b[keep][:take]
        got += take
    return out


def link_prediction_auc(
    vectors: np.ndarray, edges: np.ndarray, num_vertices: int,
    seed: int = 0, num_neg: int | None = None,
) -> float:
    """AUC of cosine-similarity scores: true edges vs random non-edges."""
    rng = np.random.default_rng(seed)
    vn = _normalize(vectors)
    pos = np.einsum("ij,ij->i", vn[edges[:, 0]], vn[edges[:, 1]])
    m = num_neg or len(edges)
    negs = sample_non_edges(edges, num_vertices, m, rng)
    neg = np.einsum("ij,ij->i", vn[negs[:, 0]], vn[negs[:, 1]])
    # exact AUC by rank statistic
    scores = np.concatenate([pos, neg])
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos, n_neg = len(pos), len(neg)
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def node_classification_accuracy(
    vectors: np.ndarray, labels: np.ndarray,
    train_frac: float = 0.5, seed: int = 0, epochs: int = 300, lr: float = 0.5,
) -> float:
    """Accuracy of a multinomial logistic probe on a random train/test split
    (the standard node2vec downstream evaluation protocol)."""
    rng = np.random.default_rng(seed)
    V = len(labels)
    perm = rng.permutation(V)
    n_train = max(2, int(V * train_frac))
    tr, te = perm[:n_train], perm[n_train:]
    X = _normalize(vectors)
    C = int(labels.max()) + 1
    Wm = np.zeros((X.shape[1], C))
    b = np.zeros(C)
    Y = np.eye(C)[labels]
    for _ in range(epochs):
        z = X[tr] @ Wm + b
        z -= z.max(axis=1, keepdims=True)
        sm = np.exp(z)
        sm /= sm.sum(axis=1, keepdims=True)
        g = (sm - Y[tr]) / len(tr)
        Wm -= lr * X[tr].T @ g
        b -= lr * g.sum(axis=0)
    pred = (X[te] @ Wm + b).argmax(axis=1)
    return float((pred == labels[te]).mean())


def multilabel_micro_f1(
    vectors: np.ndarray, labels_multihot: np.ndarray,
    train_frac: float = 0.5, seed: int = 0, epochs: int = 300, lr: float = 0.5,
) -> float:
    """Micro-F1 of one-vs-rest logistic probes, node2vec-paper protocol.

    labels_multihot: [V, K] {0,1}. For each test node the top-k_i scoring
    labels are predicted, where k_i is the node's true label count — the
    evaluation used for BlogCatalog/PPI/Wikipedia in Grover & Leskovec (2016),
    which the BASELINE quality configs mirror. All K probes train jointly as
    one [D, K] sigmoid layer (full-batch GD — one matmul per step)."""
    rng = np.random.default_rng(seed)
    V, K = labels_multihot.shape
    perm = rng.permutation(V)
    n_train = max(2, int(V * train_frac))
    tr, te = perm[:n_train], perm[n_train:]
    X = _normalize(vectors)
    Y = labels_multihot.astype(np.float64)
    Wm = np.zeros((X.shape[1], K))
    b = np.zeros(K)
    for _ in range(epochs):
        z = X[tr] @ Wm + b
        p = 1.0 / (1.0 + np.exp(-z))
        g = (p - Y[tr]) / len(tr)
        Wm -= lr * X[tr].T @ g
        b -= lr * g.sum(axis=0)
    scores = X[te] @ Wm + b
    k_i = Y[te].sum(axis=1).astype(np.int64)
    order = np.argsort(-scores, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(K), order.shape),
                      axis=1)
    pred = rank < k_i[:, None]
    true = Y[te] > 0
    tp = float((pred & true).sum())
    fp = float((pred & ~true).sum())
    fn = float((~pred & true).sum())
    return 2 * tp / max(2 * tp + fp + fn, 1.0)


# Zachary karate-club faction labels (original ids 1..34): 1 = Mr. Hi's faction.
# Public ground truth from Zachary (1977), as distributed with networkx.
KARATE_MR_HI = {1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 17, 18, 20, 22}


def karate_labels(original_ids: np.ndarray) -> np.ndarray:
    return np.asarray([1 if int(i) in KARATE_MR_HI else 0 for i in original_ids])
