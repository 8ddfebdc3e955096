"""Skip-gram with negative sampling (port of stellar_rw_tpu/models/word2vec.py).

Single device. The JAX package's streams are reproduced exactly
(ops/prng.py): the embedding init, each block's dynamic window
(jax.random.randint) and its negatives come from the same key chain
PRNGKey(seed) -> fold_in(., epoch) -> fold_in(., block), so a run from the
same init differs from the JAX run only by floating-point summation order.

Each block runs on the card as the JAX package's epoch scan runs it on its
device: a chunk of blocks' windows and negatives is drawn by one kernel
(ops/trainer_draws.py, csrc/trainer_draws.cu), then each block takes one of
two update forms, as in the JAX package:
  * exact per-pair negatives (shared_negatives = 0, the CLI's default):
    ops/sgns_exact.py::sgns_exact_step, the two kernels of
    csrc/sgns_exact.cu;
  * block-shared negatives in the dense shifted-window form
    (shared_negatives = kB > 0): ops/sgns_conv.py::sgns_conv_step, three
    calls a block: its positive half and its scatter-mean with the update
    are csrc/sgns_conv.cu, its negative half is sgns_shared_grads
    (csrc/sgns_shared.cu); the corpus blocks' positions are grouped by token
    once a run (ops/sgns_conv.py::group_blocks) for the scatter.
On the CPU (device="cpu") the same steps run their plain versions:
trainer_draws_ref, `_sgns_apply` over the block's pairs and
`_sgns_apply_shared_conv`.

The tables are updated in place (JAX returns new arrays); each row moves by
lr times the mean of its gradients in the block (scatter-mean).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import NotPorted, resolve_device
from ..ops import prng
from ..ops.alias import build_alias
# the steps' and the draws' plain pieces live beside their kernels;
# _sgns_apply, _sgns_apply_shared_conv, _shift and _draw_negatives stay
# importable here, the trainer's names for them
from ..ops.sgns_conv import (ConvWorkspace, _sgns_apply_shared_conv,  # noqa: F401
                             _shift, group_blocks, sgns_conv_step)
from ..ops.sgns_exact import (_pairs_from_valid, _sgns_apply,  # noqa: F401
                              _valid_from_cwin, Workspace, sgns_exact_step)
from ..ops.trainer_draws import _draw_negatives, trainer_draws  # noqa: F401

# elements of per-block random draws generated in one batch
_DRAW_BUDGET = 1 << 22


@dataclass(frozen=True)
class SGNSConfig:
    dim: int = 128
    window: int = 10
    negatives: int = 5
    lr: float = 0.025
    min_lr_frac: float = 1e-4
    iters: int = 10
    row_block: int = 32      # walks per update step (one scatter-mean each)
    seed: int = 0
    power: float = 0.75      # unigram smoothing for the negative table
    shared_negatives: int = 0  # >0: kB block-shared negatives
    shared_impl: str = "conv"  # "conv" is ported; "band" / "pos" are not
    model_shards: int = 1    # >1: dim-sharded tables (not ported)

    def __post_init__(self):
        if self.shared_impl not in ("band", "conv", "pos"):
            raise ValueError(f"shared_impl must be 'band', 'conv' or 'pos', "
                             f"got {self.shared_impl!r}")


def params_from_numpy(w_in: np.ndarray, w_out: np.ndarray, device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's tables (numpy f32 [V, D]) as the port's."""
    as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32)
                                     ).to(device).clone()
    return as_t(w_in), as_t(w_out)


def _init_embeddings(vocab: int, dim: int, key: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """word2vec init: input uniform in [-0.5/dim, 0.5/dim), output zeros."""
    w_in = (prng.uniform(key, (vocab, dim)) - 0.5) / dim
    return w_in, torch.zeros_like(w_in)


def _valid_for_block(block: torch.Tensor, key: torch.Tensor, window: int):
    """[B, T, 2w] pair-validity mask and clamped context positions; cell
    (b, t, o) is the pair (center (b, t), context (b, t + offs[o]))."""
    cwin = prng.randint(key, block.shape, 1, window + 1)
    return _valid_from_cwin(block, cwin, window)


def _pairs_for_block(block: torch.Tensor, key: torch.Tensor, window: int):
    """(centers, contexts, valid) flattened to [B*T*2w]."""
    valid, ctx_pos_c = _valid_for_block(block, key, window)
    return _pairs_from_valid(block, valid, ctx_pos_c)


def _block_lr(i: int, n_blocks: int, lr_start: np.float32,
              lr_end: np.float32) -> float:
    """The JAX epoch's f32 linear decay within an epoch."""
    frac = np.float32(i) / np.float32(n_blocks)
    return float(lr_start * (np.float32(1.0) - frac) + lr_end * frac)


def _train_epoch(w_in, w_out, corpus, neg_keep, neg_alias, key, lr_start,
                 lr_end, window: int, negatives: int,
                 shared_negatives: int = 0, groups=None):
    """One epoch over corpus [n_blocks, B, T] (-1 padded), block by block.
    Each block's random draws are made a chunk of blocks at a time (one
    kernel launch on the card). groups: group_blocks(corpus) for the conv
    step on the card (made here if none is given)."""
    n_blocks, B, T = corpus.shape
    per_block = (shared_negatives if shared_negatives
                 else B * T * 2 * window * negatives) + B * T
    chunk = max(1, min(n_blocks, _DRAW_BUDGET // per_block))
    nshape = ((shared_negatives,) if shared_negatives
              else (B * T * 2 * window, negatives))
    # the steps' scratch, empty again after every step
    ws = None
    if w_in.device.type == "cuda":
        ws = (ConvWorkspace(w_in, w_out, B, T, window, shared_negatives)
              if shared_negatives
              else Workspace(w_in, w_out, B * T, window, negatives))
        if shared_negatives and groups is None:
            groups = group_blocks(corpus)
    for c0 in range(0, n_blocks, chunk):
        n = min(chunk, n_blocks - c0)
        cwin, negs = trainer_draws(key, c0, n, B, T, window, nshape,
                                   neg_keep, neg_alias)
        for j in range(n):
            i = c0 + j
            lr = _block_lr(i, n_blocks, lr_start, lr_end)
            if shared_negatives:
                sgns_conv_step(w_in, w_out, corpus[i], cwin[j], negs[j], lr,
                               negatives / shared_negatives, window, ws,
                               None if groups is None
                               else (groups.order[i], groups.units[i]))
            else:
                sgns_exact_step(w_in, w_out, corpus[i], cwin[j], negs[j], lr,
                                window, ws)
    return w_in, w_out


def train_skipgram(
    corpus: np.ndarray | torch.Tensor,
    vocab_size: int,
    cfg: SGNSConfig,
    counts: np.ndarray | None = None,
    num_partitions: int = 1,
    init: tuple[np.ndarray, np.ndarray] | None = None,
    start_epoch: int = 0,
    on_epoch=None,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Train SGNS on a dense [N, T] i32 corpus (-1 padding) on `device` (the
    card unless device="cpu" is asked for; no GPU raises CudaUnavailable).
    Returns (w_in, w_out) as numpy f32 [vocab, dim].

    corpus may be a device tensor (the walk engine's handoff). init resumes
    from given tables (numpy, e.g. the JAX package's) at start_epoch;
    on_epoch(ep, w_in, w_out) receives numpy copies after each epoch."""
    if num_partitions != 1:
        raise NotPorted("num_partitions > 1 (--w2vPartitions): data-parallel "
                        "training is ROADMAP Queue 1 item 11")
    if cfg.model_shards != 1:
        raise NotPorted("model_shards > 1 (--w2vModelShards): dim-sharded "
                        "tables are ROADMAP Queue 1 item 11")
    if cfg.shared_negatives and cfg.shared_impl != "conv":
        raise NotPorted(f"shared_impl {cfg.shared_impl!r}: only 'conv' is "
                        "ported (ROADMAP Queue 1, not to port)")
    device = resolve_device("train_skipgram", device)
    corpus = torch.as_tensor(corpus).to(device=device, dtype=torch.int32)
    N, T = corpus.shape
    if counts is None:
        flat = corpus.reshape(-1)
        counts = torch.bincount(flat[flat >= 0].long(), minlength=vocab_size
                                ).cpu().numpy().astype(np.float64)
    keep, alias = build_alias(np.maximum(counts, 1e-12) ** cfg.power)
    neg_keep = torch.as_tensor(keep, dtype=torch.float32).to(device)
    neg_alias = torch.as_tensor(alias, dtype=torch.int32).to(device)

    B = max(1, min(cfg.row_block, max(N, 1)))
    n_blocks = -(-N // B)
    padded = torch.full((n_blocks * B, T), -1, dtype=torch.int32,
                        device=device)
    padded[:N] = corpus
    blocks = padded.reshape(n_blocks, B, T)

    # the conv step's token groups: one sort of the blocks a run, the same
    # blocks for every epoch and a resumed start_epoch
    groups = (group_blocks(blocks)
              if cfg.shared_negatives and device.type == "cuda" else None)
    key = prng.prng_key(cfg.seed, device)
    if init is not None:
        w_in, w_out = params_from_numpy(init[0], init[1], device)
    else:
        w_in, w_out = _init_embeddings(vocab_size, cfg.dim,
                                       prng.fold_in(key, 0x1A17))
    lr_lo = cfg.lr * cfg.min_lr_frac
    for ep in range(start_epoch, cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        _train_epoch(w_in, w_out, blocks, neg_keep, neg_alias,
                     prng.fold_in(key, ep), np.float32(lr_s),
                     np.float32(lr_e), cfg.window, cfg.negatives,
                     shared_negatives=cfg.shared_negatives, groups=groups)
        if on_epoch is not None:
            on_epoch(ep, w_in.cpu().numpy(), w_out.cpu().numpy())
    return w_in.cpu().numpy(), w_out.cpu().numpy()


def corpus_from_token_lists(token_lists) -> tuple[np.ndarray, list]:
    """(dense corpus, vocab tokens by descending frequency) from arbitrary
    token sequences; every token kept, ties broken by str(token)."""
    from collections import Counter
    cnt = Counter(t for row in token_lists for t in row)
    vocab = [t for t, _ in sorted(cnt.items(),
                                  key=lambda kv: (-kv[1], str(kv[0])))]
    index = {t: i for i, t in enumerate(vocab)}
    T = max((len(r) for r in token_lists), default=0)
    corpus = np.full((len(token_lists), T), -1, dtype=np.int32)
    for i, row in enumerate(token_lists):
        for j, t in enumerate(row):
            corpus[i, j] = index[t]
    return corpus, vocab


def corpus_from_ragged(values: np.ndarray,
                       offsets: np.ndarray) -> tuple[np.ndarray, list]:
    """Vectorized corpus_from_token_lists for integer tokens in ragged form
    (values i64[NT], offsets i64[NW+1], graph/io.load_walks_ragged): the
    same vocab order and the same dense [N, T] i32 corpus (-1 padded), by
    np.unique and one masked assignment."""
    lengths = np.diff(offsets).astype(np.int64)
    N = len(lengths)
    T = int(lengths.max()) if N else 0
    uniq, inv, counts = np.unique(values, return_inverse=True,
                                  return_counts=True)
    order = sorted(range(len(uniq)),
                   key=lambda i: (-int(counts[i]), str(int(uniq[i]))))
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[np.asarray(order, dtype=np.int64)] = np.arange(len(uniq),
                                                        dtype=np.int32)
    corpus = np.full((N, T), -1, dtype=np.int32)
    if len(values):
        mask = np.arange(T, dtype=np.int64)[None, :] < lengths[:, None]
        corpus[mask] = rank[inv]
    vocab = [int(uniq[i]) for i in order]
    return corpus, vocab
