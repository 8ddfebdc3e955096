"""Skip-gram with negative sampling (port of stellar_rw_tpu/models/word2vec.py).

The JAX package's streams are reproduced exactly
(ops/prng.py): the embedding init, each block's dynamic window
(jax.random.randint) and its negatives come from the same key chain
PRNGKey(seed) -> fold_in(., epoch) -> fold_in(., block), so a run from the
same init differs from the JAX run only by floating-point summation order.

Each block runs on the card as the JAX package's epoch scan runs it on its
device: a chunk of blocks' windows and negatives is drawn by one kernel
(ops/trainer_draws.py, csrc/trainer_draws.cu), then each block takes one of
two update forms, as in the JAX package:
  * exact per-pair negatives (shared_negatives = 0, the CLI's default):
    ops/sgns_exact.py::sgns_exact_step, one launch of csrc/sgns_exact.cu;
  * block-shared negatives in the dense shifted-window form
    (shared_negatives = kB > 0): ops/sgns_conv.py::sgns_conv_step, three
    calls a block: its positive half and its scatter-mean with the update
    are csrc/sgns_conv.cu, its negative half is sgns_shared_grads
    (csrc/sgns_shared.cu); the corpus blocks' positions are grouped by token
    once a run (ops/sgns_conv.py::group_blocks) for the scatter (one device;
    the data-parallel slots' accumulate mode needs no groups), once a
    round in every epoch when the corpus is streamed
    (train_skipgram_streaming: one walk round on the device at a time).
On the CPU (device="cpu") the same steps run their plain versions:
trainer_draws_ref, `_sgns_apply` over the block's pairs and
`_sgns_apply_shared_conv`.

The tables are updated in place (JAX returns new arrays); each row moves by
lr times the mean of its gradients in the block (scatter-mean).

Data parallelism (train_skipgram with num_partitions = P > 1, and
train_skipgram_multiproc over torch.distributed ranks) runs the JAX
package's psum-merged form: P slots (parallel/dp.py), each over its own
contiguous range of corpus rows with its own key, take a block each; their
steps run in accumulate mode into one reduction buffer a process (summed
across ranks by one all-reduce), and one merged update moves the tables
(ops/dp_apply.py, csrc/dp_apply.cu). Every slot reads the tables as they
were before the update. In the conv form the negatives' counts merge with
the context rows' there, as in the JAX package, where one device divides
them on their own: P = 1 is the single-device path, not a merged update.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import NotPorted, resolve_device
from ..ops import prng
from ..ops.alias import build_alias
from ..ops.dp_apply import buffer_numel
from ..parallel import dp
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
# elements of the input table's init drawn in one batch (its least run)
_INIT_CHUNK = 1 << 18


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
    model_shards: int = 1    # >1: dim-sharded tables (not ported; ignored
    #                          by the streamed trainer, as in the JAX package)

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


def _init_embeddings(vocab: int, dim: int, key: torch.Tensor,
                     chunk: int = _INIT_CHUNK
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """word2vec init: input uniform in [-0.5/dim, 0.5/dim), output zeros.

    jax.random.uniform(key, (vocab, dim)) drawn a run of whole rows at a
    time: element i is a function of (key, i) alone, so the table is the
    same bit for bit, and the int64 threefry temporaries (about 56 bytes an
    element) stay those of one run of at least `chunk` elements and at
    most 256 runs, not of the table."""
    w_in = torch.empty((vocab, dim), dtype=torch.float32, device=key.device)
    rows = max(1, max(chunk, -(-vocab * dim // 256)) // max(dim, 1))
    for r0 in range(0, vocab, rows):
        r1 = min(vocab, r0 + rows)
        idx = torch.arange(r0 * dim, r1 * dim, device=key.device)
        w_in[r0:r1] = ((prng.uniform_at(key, idx) - 0.5) / dim
                       ).view(r1 - r0, dim)
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


def _train_epoch(w_in, w_out, slots, neg_keep, neg_alias, keys, lr_start,
                 lr_end, window: int, negatives: int,
                 shared_negatives: int = 0, groups=None, buf=None,
                 reduce: bool = False):
    """One epoch over slots [S, n_blocks, B, T] (-1 padded), keys [S] the
    slots' epoch keys, block index by block index. Without a reduction
    buffer (S = 1: one device) each block's step moves the tables. With
    one (data parallel, parallel/dp.py) every slot's step on its block i
    adds into `buf` in accumulate mode, then one merged update (dp.merge,
    summed over the ranks when `reduce`) moves them. Each slot's draws are
    made a chunk of blocks at a time (one kernel launch on the card), all
    slots' chunks together within _DRAW_BUDGET. groups: group_blocks of
    the slots' blocks as [S * n_blocks, B, T] for the one-device conv step
    on the card (made here if none is given; the accumulate mode reads
    none)."""
    S, n_blocks, B, T = slots.shape
    per_block = (shared_negatives if shared_negatives
                 else B * T * 2 * window * negatives) + B * T
    chunk = max(1, min(n_blocks, _DRAW_BUDGET // (per_block * S)))
    nshape = ((shared_negatives,) if shared_negatives
              else (B * T * 2 * window, negatives))
    # the steps' scratch, empty again after every step
    ws = None
    if w_in.device.type == "cuda":
        ws = (ConvWorkspace(w_in, w_out, B, T, window, shared_negatives)
              if shared_negatives
              else Workspace(w_in, w_out, B * T, window, negatives))
        if shared_negatives and groups is None and buf is None:
            groups = group_blocks(slots.reshape(S * n_blocks, B, T))
    for c0 in range(0, n_blocks, chunk):
        n = min(chunk, n_blocks - c0)
        draws = [trainer_draws(k, c0, n, B, T, window, nshape, neg_keep,
                               neg_alias) for k in keys]
        for j in range(n):
            i = c0 + j
            lr = _block_lr(i, n_blocks, lr_start, lr_end)
            for s, (cwin, negs) in enumerate(draws):
                if shared_negatives:
                    g = s * n_blocks + i
                    sgns_conv_step(w_in, w_out, slots[s, i], cwin[j],
                                   negs[j], lr, negatives / shared_negatives,
                                   window, ws,
                                   None if groups is None
                                   else (groups.order[g], groups.units[g]),
                                   buffer=buf)
                else:
                    sgns_exact_step(w_in, w_out, slots[s, i], cwin[j],
                                    negs[j], lr, window, ws, buffer=buf)
            if buf is not None:
                dp.merge(w_in, w_out, buf, lr, reduce)
        # freed before the next chunk is drawn: one chunk's draws are held
        del draws, cwin, negs
    return w_in, w_out


def _train(slots, vocab_size: int, cfg: SGNSConfig, neg_keep, neg_alias,
           init, start_epoch: int, on_epoch, first_slot: int | None = None,
           reduce: bool = False):
    """The epochs over this process's slots [S, n_blocks, B, T] on their
    device. first_slot None: the one-device path (S = 1, the epoch key
    fold_in(key, ep)); else data parallel over global slots first_slot ..
    first_slot + S - 1 (slot s's key fold_in(fold_in(key, ep), s)), one
    merged update a block index, all-reduced when `reduce`. Returns
    (w_in, w_out) as numpy."""
    device = slots.device
    S, n_blocks, B, T = slots.shape
    # the one-device conv step's token groups: one sort of the blocks a
    # run, the same blocks for every epoch and a resumed start_epoch (the
    # data-parallel slots' accumulate mode reads none)
    groups = (group_blocks(slots.reshape(S * n_blocks, B, T))
              if cfg.shared_negatives and device.type == "cuda"
              and first_slot is None else None)
    key = prng.prng_key(cfg.seed, device)
    if init is not None:
        w_in, w_out = params_from_numpy(init[0], init[1], device)
    else:
        w_in, w_out = _init_embeddings(vocab_size, cfg.dim,
                                       prng.fold_in(key, 0x1A17))
    buf = (None if first_slot is None else torch.zeros(
        buffer_numel(vocab_size, cfg.dim), dtype=torch.float32,
        device=device))
    lr_lo = cfg.lr * cfg.min_lr_frac
    for ep in range(start_epoch, cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        kep = prng.fold_in(key, ep)
        keys = ([kep] if first_slot is None else
                [dp.slot_key(kep, first_slot + s) for s in range(S)])
        _train_epoch(w_in, w_out, slots, neg_keep, neg_alias, keys,
                     np.float32(lr_s), np.float32(lr_e), cfg.window,
                     cfg.negatives, cfg.shared_negatives, groups, buf, reduce)
        if on_epoch is not None:
            on_epoch(ep, w_in.cpu().numpy(), w_out.cpu().numpy())
    return w_in.cpu().numpy(), w_out.cpu().numpy()


def _refuse_unported(cfg: SGNSConfig, streamed: bool = False) -> None:
    """NotPorted for the trainer forms the port does not serve. The
    streamed trainer reads no model_shards, as in the JAX package."""
    if cfg.model_shards != 1 and not streamed:
        raise NotPorted("model_shards > 1 (--w2vModelShards): dim-sharded "
                        "tables are ROADMAP Queue 1 item 15")
    if cfg.shared_negatives and cfg.shared_impl != "conv":
        raise NotPorted(f"shared_impl {cfg.shared_impl!r}: only 'conv' is "
                        "ported (ROADMAP Queue 1, not to port)")


def _negative_tables(counts: np.ndarray, power: float, device):
    """The unigram^power alias table of the negatives, on the device."""
    keep, alias = build_alias(np.maximum(counts, 1e-12) ** power)
    return (torch.as_tensor(keep, dtype=torch.float32).to(device),
            torch.as_tensor(alias, dtype=torch.int32).to(device))


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
    on_epoch(ep, w_in, w_out) receives numpy copies after each epoch.

    num_partitions = P > 1 trains data-parallel, as the JAX package's
    num_partitions does on P devices: P slots on this device, each over a
    contiguous range of the padded corpus (reshape(P, n_blocks, B, T))
    with B = ceil(row_block / P) (at most ceil(N / P)), one merged update
    a block index (see the module)."""
    _refuse_unported(cfg)
    device = resolve_device("train_skipgram", device)
    corpus = torch.as_tensor(corpus).to(device=device, dtype=torch.int32)
    N, T = corpus.shape
    if counts is None:
        # the -1 pads shifted into bin 0, in int32: no masked or int64 copy
        # of the corpus
        counts = torch.bincount(corpus.reshape(-1) + 1,
                                minlength=vocab_size + 1)[1:]
        counts = counts.cpu().numpy().astype(np.float64)
    neg_keep, neg_alias = _negative_tables(counts, cfg.power, device)
    P = max(1, num_partitions)
    # P > 1: the block shrinks with P, so a merged update takes about
    # row_block rows, as the JAX package's does
    B = max(1, min(-(-cfg.row_block // P), max(-(-N // P), 1)))
    n_blocks = -(-N // (B * P))
    padded = torch.full((P * n_blocks * B, T), -1, dtype=torch.int32,
                        device=device)
    padded[:N] = corpus
    return _train(padded.reshape(P, n_blocks, B, T), vocab_size, cfg,
                  neg_keep, neg_alias, init, start_epoch, on_epoch,
                  first_slot=0 if P > 1 else None)


def train_skipgram_streaming(
    make_round,
    num_rounds: int,
    round_shape: tuple[int, int],
    vocab_size: int,
    cfg: SGNSConfig,
    counts: np.ndarray,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """SGNS over a corpus that is never whole on the device: one walk round
    at a time (port of the JAX package's train_skipgram_streaming).

    make_round(r) -> the round's [W, T] i32 corpus on `device` (-1 padded),
    the same for the same r in every epoch; it is called num_rounds times an
    epoch. counts: the whole corpus's token counts (the pipeline's
    pre-pass).

    Each round is one `_train_epoch` slice: its blocks padded with -1 rows
    to n_blocks * B, its key fold_in(fold_in(key, epoch), r), its learning
    rate falling linearly over the iters * num_rounds slices. The conv
    step's token groups are made for each round in each epoch and dropped
    with it (`_train_epoch` groups the round it is given): keeping them for
    every round would hold two int32 a corpus position. Device memory for
    the corpus is one round, its padded copy and that round's groups and
    draws. As in the JAX package, cfg.model_shards is not read, and there
    is no data parallelism. Returns (w_in, w_out) as numpy f32 [vocab,
    dim]."""
    _refuse_unported(cfg, streamed=True)
    device = resolve_device("train_skipgram_streaming", device)
    W, T = round_shape
    neg_keep, neg_alias = _negative_tables(counts, cfg.power, device)
    key = prng.prng_key(cfg.seed, device)
    w_in, w_out = _init_embeddings(vocab_size, cfg.dim,
                                   prng.fold_in(key, 0x1A17))
    B = max(1, min(cfg.row_block, W))
    n_blocks = -(-W // B)
    # one padded buffer for every round; its pad rows stay -1
    padded = torch.full((n_blocks * B, T), -1, dtype=torch.int32,
                        device=device)
    blocks = padded.view(n_blocks, B, T)
    lr_lo = cfg.lr * cfg.min_lr_frac
    total_slices = max(cfg.iters * num_rounds, 1)

    def lr_at(slice_idx: int) -> float:
        frac = slice_idx / total_slices
        return cfg.lr + (lr_lo - cfg.lr) * frac

    for ep in range(cfg.iters):
        kep = prng.fold_in(key, ep)
        for r in range(num_rounds):
            padded[:W] = make_round(r)
            s = ep * num_rounds + r
            _train_epoch(w_in, w_out, blocks[None], neg_keep, neg_alias,
                         [prng.fold_in(kep, r)], np.float32(lr_at(s)),
                         np.float32(lr_at(s + 1)), cfg.window, cfg.negatives,
                         shared_negatives=cfg.shared_negatives)
    return w_in.cpu().numpy(), w_out.cpu().numpy()


def _divisor_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (>= 1)."""
    B = max(1, min(target, n))
    while n % B:
        B -= 1
    return B


def full_corpus_blocks(corpus: np.ndarray, num_devices: int | None = None,
                       rank: int = 0, world: int = 1
                       ) -> tuple[list[tuple[int, np.ndarray]], int]:
    """A corpus that every process holds in full (the `embedding` command's
    walks file, read by each) as this process's (start, rows) blocks: the
    corpus padded with -1 rows to a multiple of num_devices slots (default:
    one a rank), n rows a slot, the slots of rank `rank` of `world`
    (num_devices / world each). Returns (local blocks, padded rows)."""
    D = num_devices or world
    if D % world:
        raise ValueError(f"{D} slots do not split over {world} ranks")
    N, T = corpus.shape
    N_pad = -(-max(N, 1) // D) * D
    padded = corpus
    if N_pad != N:
        padded = np.concatenate(
            [corpus, np.full((N_pad - N, T), -1, dtype=corpus.dtype)])
    n = N_pad // D
    local = D // world
    blocks = [(d * n, padded[d * n:(d + 1) * n])
              for d in dp.slot_range(rank, local)]
    return blocks, N_pad


def _rows_from_blocks(blocks, lo: int, hi: int, T: int) -> np.ndarray:
    """Global corpus rows [lo, hi) from this process's (start, rows)
    blocks; uncovered rows are -1."""
    out = np.full((hi - lo, T), -1, dtype=np.int32)
    for start, rows in blocks:
        s, e = max(lo, start), min(hi, start + len(rows))
        if e > s:
            out[s - lo:e - lo] = rows[s - start:e - start]
    return out


def train_skipgram_multiproc(
    blocks: list[tuple[int, np.ndarray]],
    num_rows: int,
    vocab_size: int,
    cfg: SGNSConfig,
    counts: np.ndarray | None = None,
    init: tuple[np.ndarray, np.ndarray] | None = None,
    start_epoch: int = 0,
    on_epoch=None,
    num_devices: int | None = None,
    row_width: int | None = None,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """SGNS over a corpus that no process holds in full, data-parallel over
    the ranks of the default torch.distributed process group (one process
    and no group: a world of one). Port of the JAX package's
    train_skipgram_multiproc.

    Every rank calls with identical (num_rows, cfg). `blocks` are this
    rank's (global row start, rows [n, T]); across the ranks they tile the
    padded global corpus [num_rows, T] (all -1 rows are inert). There are
    num_devices slots in all (default: one a rank), num_devices / world on
    each rank, slot p over rows [p * n, (p + 1) * n), n = num_rows /
    num_devices, in blocks of B = the largest divisor of n that is at most
    ceil(row_block / num_devices). The token counts for the negatives'
    table are one all-reduced integer bincount of the slots' rows. Every
    merged update is the sum over all slots (one all-reduce of the
    buffer), so the tables stay equal on every rank. row_width (T) is
    needed where this rank holds no blocks. Returns (w_in, w_out) as
    numpy."""
    _refuse_unported(cfg)
    device = resolve_device("train_skipgram_multiproc", device)
    rank, world = dp.rank_world()
    D = num_devices or world
    if D % world or num_rows % D:
        raise ValueError(f"{num_rows} rows and {D} slots over {world} ranks")
    n = num_rows // D
    T = row_width if row_width is not None else (
        blocks[0][1].shape[1] if blocks else 0)
    if T <= 0:
        raise ValueError("row_width is needed where a rank holds no blocks")
    B = _divisor_block(n, max(1, -(-cfg.row_block // D)))
    n_blocks = n // B
    local = D // world
    slots = torch.as_tensor(np.stack(
        [_rows_from_blocks(blocks, p * n, (p + 1) * n, T)
         for p in dp.slot_range(rank, local)])).to(device)
    slots = slots.reshape(local, n_blocks, B, T)
    if counts is None:
        c = torch.bincount(slots.reshape(-1) + 1,
                           minlength=vocab_size + 1)[1:]
        if world > 1:
            dp.all_reduce_sum(c)
        counts = c.cpu().numpy().astype(np.float64)
    neg_keep, neg_alias = _negative_tables(counts, cfg.power, device)
    return _train(slots, vocab_size, cfg, neg_keep, neg_alias, init,
                  start_epoch, on_epoch, first_slot=rank * local,
                  reduce=world > 1)


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
