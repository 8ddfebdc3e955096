"""Hierarchical-softmax skip-gram (port of stellar_rw_tpu/models/hsoftmax.py).

The reference's own objective: MLlib's Word2Vec is skip-gram with
hierarchical softmax over a Huffman tree and has no negative-sampling mode.
The product trainer (models/word2vec.py) uses negative sampling; this one
is the yardstick run beside it on the same corpus, with the same pair
enumeration, windows and batching, so that the two differ only in their
objective.

Single device. The JAX package's streams are reproduced exactly: syn0's
init fold_in(key, 0x1A17), each block's dynamic windows
randint(fold_in(fold_in(key, epoch), block), (B, T), 1, w + 1), drawn a
chunk of blocks at a time by ops/trainer_draws.py with no negatives; so a
run differs from the JAX run only by floating-point summation order. Each
block's step is ops/hsoftmax.py::hs_step: one launch of csrc/hsoftmax.cu
on the card, hs_step_ref (the JAX body in torch) on the CPU. The tables are
updated in place.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..errors import resolve_device
from ..ops import prng
from ..ops.hsoftmax import HSWorkspace, hs_step
from ..ops.trainer_draws import trainer_draws
from .word2vec import _DRAW_BUDGET, SGNSConfig, _block_lr, _init_embeddings


def build_huffman(counts: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Huffman-code a vocabulary by frequency.

    Returns (points i32[V, L], labels f32[V, L], mask f32[V, L]): points[v]
    are the inner-node ids (0..V-2) on the root->leaf path of token v,
    labels[v, j] = 1 - code_bit (word2vec's target convention), mask marks
    the live prefix (paths are ragged; L = max code length)."""
    V = len(counts)
    if V <= 1:
        return (np.zeros((V, 1), np.int32), np.ones((V, 1), np.float32),
                np.zeros((V, 1), np.float32))
    heap = [(float(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.zeros(2 * V - 1, dtype=np.int64)
    code = np.zeros(2 * V - 1, dtype=np.int8)
    nxt = V
    while len(heap) > 1:
        c1, i1 = heapq.heappop(heap)
        c2, i2 = heapq.heappop(heap)
        parent[i1] = nxt
        parent[i2] = nxt
        code[i2] = 1
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = nxt - 1
    paths: list[list[int]] = []
    codes: list[list[int]] = []
    for v in range(V):
        p: list[int] = []
        c: list[int] = []
        node = v
        while node != root:
            c.append(int(code[node]))
            p.append(int(parent[node]) - V)   # inner-node id in [0, V-1)
            node = int(parent[node])
        p.reverse()
        c.reverse()
        paths.append(p)
        codes.append(c)
    L = max(len(p) for p in paths)
    points = np.zeros((V, L), dtype=np.int32)
    labels = np.zeros((V, L), dtype=np.float32)
    mask = np.zeros((V, L), dtype=np.float32)
    for v in range(V):
        n = len(paths[v])
        points[v, :n] = paths[v]
        labels[v, :n] = 1.0 - np.asarray(codes[v], dtype=np.float32)
        mask[v, :n] = 1.0
    return points, labels, mask


def _hs_epoch(syn0, syn1, corpus, points, labels, pmask, key, lr_start,
              lr_end, window: int, ws: HSWorkspace | None = None) -> None:
    """One epoch over corpus [n_blocks, B, T] (-1 padded), block by block,
    in place: each chunk of blocks' windows drawn by one trainer_draws
    call (no negatives), then one hs_step a block with the JAX epoch's
    linear learning rate."""
    n_blocks, B, T = corpus.shape
    chunk = max(1, min(n_blocks, _DRAW_BUDGET // max(B * T, 1)))
    for c0 in range(0, n_blocks, chunk):
        n = min(chunk, n_blocks - c0)
        cwin, _ = trainer_draws(key, c0, n, B, T, window, (0,), None, None)
        for j in range(n):
            i = c0 + j
            hs_step(syn0, syn1, corpus[i], cwin[j], points, labels, pmask,
                    _block_lr(i, n_blocks, lr_start, lr_end), window, ws)
        del cwin


def train_skipgram_hs(corpus: np.ndarray | torch.Tensor, vocab_size: int,
                      cfg: SGNSConfig, counts: np.ndarray | None = None,
                      on_epoch=None, *, device="cuda") -> np.ndarray:
    """Train HS skip-gram on a dense [N, T] i32 corpus (-1 padding) on
    `device` (the card unless device="cpu" is asked for; no GPU raises
    CudaUnavailable). Returns the input-side embeddings syn0 as numpy f32
    [vocab, dim] (what MLlib's getVectors exposes).

    cfg.negatives and shared_negatives are ignored (HS draws none);
    dim/window/lr/iters/seed/row_block are the SGNS trainer's, so a run
    beside it differs only in the objective. counts: the tokens'
    frequencies for the Huffman code (by default the corpus's, counted in
    integers). on_epoch(ep, syn0) receives a numpy copy after each
    epoch."""
    device = resolve_device("train_skipgram_hs", device)
    corpus = torch.as_tensor(corpus).to(device=device, dtype=torch.int32)
    N, T = corpus.shape
    if counts is None:
        # the -1 pads shifted into bin 0, in int32
        counts = torch.bincount(corpus.reshape(-1) + 1,
                                minlength=vocab_size + 1)[1:]
        counts = counts.cpu().numpy().astype(np.float64)
    points, labels, pmask = (torch.as_tensor(a).to(device)
                             for a in build_huffman(counts))
    B = max(1, min(cfg.row_block, max(N, 1)))
    n_blocks = -(-N // B)
    padded = torch.full((n_blocks * B, T), -1, dtype=torch.int32,
                        device=device)
    padded[:N] = corpus
    blocks = padded.reshape(n_blocks, B, T)
    key = prng.prng_key(cfg.seed, device)
    syn0, _ = _init_embeddings(vocab_size, cfg.dim,
                               prng.fold_in(key, 0x1A17))
    syn1 = torch.zeros((max(vocab_size - 1, 1), cfg.dim),
                       dtype=torch.float32, device=device)
    ws = (HSWorkspace(syn0, syn1, B * T, points.shape[1])
          if device.type == "cuda" else None)
    lr_lo = cfg.lr * cfg.min_lr_frac
    for ep in range(cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        _hs_epoch(syn0, syn1, blocks, points, labels, pmask,
                  prng.fold_in(key, ep), np.float32(lr_s), np.float32(lr_e),
                  cfg.window, ws)
        if on_epoch is not None:
            on_epoch(ep, syn0.cpu().numpy())
    return syn0.cpu().numpy()
