"""One skip-gram job with exact negatives, replayed block by block.

The semantics are the program's trainer as its docstrings and the JAX
package state them (stellar_rw_tpu_torch/models/word2vec.py,
ops/trainer_draws.py, ops/sgns_exact.py), written again in plain torch:

  * the corpus [N, T] (-1 padded) is cut into blocks of B = min(row_block,
    N) rows, the last padded with -1 rows;
  * key = PRNGKey(seed); the input table is (uniform(fold_in(key, 0x1A17),
    (V, D)) - 0.5) / D, the output table zeros;
  * the negatives' table: Vose's alias table of counts ** 0.75 over the
    corpus's token counts;
  * epoch e's key is fold_in(key, e); block i's kb = fold_in(epoch key, i),
    its windows randint(kb, (B, T), 1, w + 1), its negatives drawn from
    fold_in(kb, 2): u1, u2 = uniform(that key, (B*T*2w, k)),
    uniform(fold_in(that key, 1), ...); j = min(int(u1 * V), V - 1), kept
    where u2 < keep[j], else alias[j];
  * pair (center b,t; context b,t+o) for o in -w..-1, 1..w is valid where
    both tokens exist and |o| <= the center's window; each valid pair has
    its context and its k negatives as targets, label 1 then 0;
  * the step: every row of each table moves by -lr times the mean of its
    gradients in the block, all from the tables as they were before the
    step; lr falls linearly in float32 over the blocks of the epoch.

It computes in float32 with TF32 off (the configuration's precision). In
the program's place it stands for two wrong trainers: "tf32", the control,
rounds both operands of its two products to TF32 first, as a tensor-core
product with TF32 on does; "half" leaves the second half of every block's
rows out of its step, the mean taken over the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng

INIT_FOLD = 0x1A17
NATIVE_ALIAS_MIN = 4097   # vocabularies from which the row builder's
#                           arithmetic makes the negatives' table


def alias_table(counts: np.ndarray, power: float):
    """(keep f32 [V], alias i64 [V]) of counts ** power. From NATIVE_ALIAS_MIN
    words the weights are rounded to float32 and normalized by their
    sequential float64 sum, below it they stay float64 and are normalized by
    numpy's sum; both then run Vose's two stacks."""
    probs = np.maximum(np.asarray(counts, dtype=np.float64), 1e-12) ** power
    n = len(probs)
    if n >= NATIVE_ALIAS_MIN:
        w = probs.astype(np.float32).astype(np.float64)
        scaled = (w / np.cumsum(w)[-1] * n).tolist()
    else:
        scaled = (probs / probs.sum() * n).tolist()
    keep = np.ones(n, dtype=np.float32)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large[-1]
        keep[s] = scaled[s]
        alias[s] = big
        scaled[big] -= 1.0 - scaled[s]
        if scaled[big] < 1.0:
            large.pop()
            small.append(big)
    return keep, alias


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -8192).view(torch.float32)


def init_tables(seed: int, vocab: int, dim: int, device):
    k = prng.fold_in(prng.key(seed, device), INIT_FOLD)
    w_in = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    rows = max(1, (1 << 20) // max(dim, 1))
    for r0 in range(0, vocab, rows):
        r1 = min(vocab, r0 + rows)
        idx = torch.arange(r0 * dim, r1 * dim, device=device)
        w_in[r0:r1] = ((prng.uniform_at(k, idx) - 0.5) / dim).view(
            r1 - r0, dim)
    return w_in, torch.zeros_like(w_in)


def draws(kep, c0: int, n: int, B: int, T: int, window: int, k: int,
          keep: torch.Tensor, alias: torch.Tensor):
    """Windows [n, B, T] and negatives [n, B*T*2w, k] of blocks c0..c0+n-1."""
    kb = prng.fold_in(kep, torch.arange(c0, c0 + n, device=kep.device))
    cwin = prng.randint(kb, (B, T), 1, window + 1)
    nk = prng.fold_in(kb, 2)
    shape = (B * T * 2 * window, k)
    u1 = prng.uniform(nk, shape)
    u2 = prng.uniform(prng.fold_in(nk, 1), shape)
    V = keep.shape[0]
    j = torch.clamp_max((u1 * V).to(torch.int32), V - 1).long()
    return cwin, torch.where(u2 < keep[j], j, alias[j])


def step(w_in, w_out, block, cwin, negs, lr: float, window: int,
         control: bool = False) -> None:
    """One block's update of both tables, in place. Every (center, offset)
    slot of the block is computed, an invalid pair's gradient zeroed by its
    mask, so that nothing waits for the device."""
    B, T = block.shape
    dev = block.device
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]
                     ).to(dev)
    pos = torch.arange(T, device=dev)[:, None] + offs[None, :]
    ctx = block[:, pos.clamp(0, T - 1)]
    valid = (((pos >= 0) & (pos < T))[None]
             & (offs.abs()[None, None, :] <= cwin[..., None])
             & (block[..., None] >= 0) & (ctx >= 0))
    mask = valid.reshape(-1).to(torch.float32)
    centers = block[:, :, None].expand_as(ctx).reshape(-1).long().clamp_min(0)
    targets = torch.cat([ctx.reshape(-1).long().clamp_min(0)[:, None],
                         negs.long()], dim=1)
    vi, vo = w_in[centers], w_out[targets]
    rnd = tf32 if control else (lambda x: x)
    logits = torch.bmm(rnd(vo), rnd(vi)[:, :, None])[..., 0]
    g = torch.sigmoid(logits)
    g[:, 0] -= 1.0
    g *= mask[:, None]
    d_vi = torch.bmm(rnd(g)[:, None, :], rnd(vo))[:, 0]
    d_vo = (g[:, :, None] * vi[:, None, :]).reshape(-1, vi.shape[1])
    tflat = targets.reshape(-1)
    V = w_in.shape[0]
    cnt_in = torch.zeros(V, device=dev).index_add_(0, centers, mask)
    cnt_out = torch.zeros(V, device=dev).index_add_(
        0, tflat, mask.repeat_interleave(targets.shape[1]))
    w_in.index_add_(0, centers,
                    d_vi * (-lr / cnt_in[centers].clamp_min(1))[:, None])
    w_out.index_add_(0, tflat,
                     d_vo * (-lr / cnt_out[tflat].clamp_min(1))[:, None])


def block_lr(i: int, n_blocks: int, lr_start: np.float32,
             lr_end: np.float32) -> float:
    frac = np.float32(i) / np.float32(n_blocks)
    return float(lr_start * (np.float32(1.0) - frac) + lr_end * frac)


def train(corpus: torch.Tensor, vocab: int, dim: int, window: int, k: int,
          row_block: int, seed: int, lr: float = 0.025,
          min_lr_frac: float = 1e-4, iters: int = 1, power: float = 0.75,
          wrong: str | None = None, chunk_elems: int = 1 << 24):
    """The job's tables (w_in, w_out) and the input table it started from,
    on the corpus's device; `wrong` ("tf32" or "half") computes one of the
    wrong trainers of the module's docstring instead."""
    if wrong not in (None, "tf32", "half"):
        raise ValueError(f"no wrong trainer {wrong!r}")
    dev = corpus.device
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        counts = torch.bincount(corpus.reshape(-1).long() + 1,
                                minlength=vocab + 1)[1:]
        keep, alias = alias_table(counts.cpu().numpy(), power)
        keep = torch.as_tensor(keep).to(dev)
        alias = torch.as_tensor(alias).to(dev)
        N, T = corpus.shape
        B = max(1, min(row_block, N))
        n_blocks = -(-N // B)
        padded = torch.full((n_blocks * B, T), -1, dtype=torch.int64,
                            device=dev)
        padded[:N] = corpus
        blocks = padded.view(n_blocks, B, T)
        w_in, w_out = init_tables(seed, vocab, dim, dev)
        w0 = w_in.clone()
        key = prng.key(seed, dev)
        lr_lo = lr * min_lr_frac
        per = max(1, chunk_elems // (B * T * 2 * window * k))
        for ep in range(iters):
            lr_s = np.float32(lr + (lr_lo - lr) * ep / max(iters, 1))
            lr_e = np.float32(lr + (lr_lo - lr) * (ep + 1) / max(iters, 1))
            kep = prng.fold_in(key, ep)
            for c0 in range(0, n_blocks, per):
                n = min(per, n_blocks - c0)
                cwin, negs = draws(kep, c0, n, B, T, window, k, keep, alias)
                for j in range(n):
                    i = c0 + j
                    block = blocks[i]
                    if wrong == "half":
                        block = block.clone()
                        block[B // 2:] = -1
                    step(w_in, w_out, block, cwin[j], negs[j],
                         block_lr(i, n_blocks, lr_s, lr_e), window,
                         wrong == "tf32")
        return w_in, w_out, w0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gaps(got_in, got_out, ref_in, ref_out, init_in) -> dict:
    """The numbers the comparison holds: each table's distance from the
    reference over the reference's change (Frobenius), and the worst row's
    distance over the larger of its own change and the median row's."""
    out = {}
    worst = 0.0
    for name, got, ref, start in (("in", got_in, ref_in, init_in),
                                  ("out", got_out, ref_out, None)):
        got = torch.as_tensor(got).to(ref.device, torch.float64)
        ref = ref.to(torch.float64)
        change = ref - (start.to(torch.float64) if start is not None else 0)
        diff = got - ref
        out[f"table_gap_{name}"] = float(diff.norm() / change.norm())
        rows = change.norm(dim=1)
        scale = torch.maximum(rows, rows.median())
        worst = max(worst, float((diff.norm(dim=1) / scale).max()))
    out["row_gap"] = worst
    return out
