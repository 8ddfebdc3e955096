"""The node2vec pipeline: walks -> skip-gram embeddings.

Port of stellar_rw_tpu/models/node2vec.py: the single-device path, the
sharded walks (parallel/distributed.py over the ranks of the default
torch.distributed process group, one walk device a rank: run_walks,
checkpointed_random_walks and run_node2vec_streaming are called on every
rank), the multi-host CLI's walks and trainer (run_walks_multihost, each
rank keeping its own rows, and embed_walk_blocks), and the multi-process
trainer with checkpoints (train_multiproc_with_ckpt, over the same
group's ranks). Model
artifacts go to <output>/bin in the JAX package's format (model.npz +
metadata.json), and walk-round checkpoints to <output>/bin/walk_rounds in
its layout (round files, marker JSON and fingerprint), so a model or a
partial walk checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..errors import NotPorted, resolve_device
from ..graph import io as gio
from ..graph.csr import CSRGraph
from ..ops import prng, sampling
from ..ops.sampling import DeviceGraph
from ..utils.config import MODEL_SUFFIX, Params
from ..utils.stats import WalkStats
from ..walk import engine
from . import word2vec as w2v

logger = logging.getLogger("stellar_rw_tpu_torch.node2vec")


def walk_devices() -> int:
    """The devices the walks run on: the default process group's ranks (one
    device a rank), 1 without a group."""
    from ..parallel.distributed import rank_world

    return rank_world()[1]


def num_walk_shards(params: Params, devices: int | None = None) -> int:
    """Resolve --shards as the JAX package does: 0 = auto (one shard, unless
    --partitioned true, which takes min(devices, rddPartitions)), always
    capped at the devices the walks run on (walk_devices() by default)."""
    devices = walk_devices() if devices is None else devices
    if params.shards > 0:
        return max(1, min(params.shards, devices))
    if params.partitioned:
        return max(1, min(devices, params.rdd_partitions))
    return 1


def resolve_lanes(S: int, lanes: int) -> int:
    """Clamp --lanes to a divisor of the device count S.

    lanes must divide S (each graph shard is replicated across exactly `lanes`
    devices); a non-divisor falls back to the largest divisor <= lanes with a
    warning, so `--shards 6 --lanes 4` degrades gracefully (lanes=3) instead
    of crashing — and identically in every pipeline (run_walks, streaming,
    checkpointed)."""
    L = max(1, min(lanes, S))
    while S % L:
        L -= 1
    if L != lanes and lanes > 1:
        logger.warning("lanes=%d does not divide device count %d; using "
                       "lanes=%d", lanes, S, L)
    return L


def _sharded(params: Params, home: np.ndarray | None):
    """(devices S, lanes L, route or None) of a sharded walk: the route
    targets GRAPH shards, home % (S / L) under --partitioned true with a
    home array, else the hash policy."""
    S = num_walk_shards(params)
    L = resolve_lanes(S, params.lanes)
    route = None
    if params.partitioned and home is not None:
        route = (home.astype(np.int64) % max(S // L, 1)).astype(np.int32)
    return S, L, route


def run_walks(graph: CSRGraph, params: Params, device="cuda",
              device_graph: DeviceGraph | None = None,
              home: np.ndarray | None = None,
              report: dict | None = None,
              timing: dict | None = None) -> torch.Tensor:
    """The corpus as a device tensor [num_walks * V, L+2] (the trainer's
    handoff: no host round trip). With --checkpointEvery and an output the
    rounds run one at a time through checkpointed_random_walks. More than
    one walk shard (the default group's ranks, called on each) runs the
    sharded engine, routed by home % shards under --partitioned true (the
    reference's VCutRandomWalk) or by hash; the corpus is the same.
    report, when given, receives the sharded engine's stats, and timing
    its timing (parallel/distributed.py::distributed_walk_corpus)."""
    if params.checkpoint_every and params.output:
        walks, resumed = checkpointed_random_walks(graph, params, device,
                                                   device_graph, home)
        if resumed:
            print(f"resumed {resumed} completed walk rounds from checkpoint")
        return torch.as_tensor(walks).to(resolve_device("run_walks", device))
    kw = dict(walk_length=params.walk_length, num_walks=params.num_walks,
              p=params.p, q=params.q, seed=params.seed,
              sampler=params.sampler, rng_impl=params.rng_impl)
    if num_walk_shards(params) <= 1:
        return engine.random_walks(graph, device_graph=device_graph,
                                   as_numpy=False, device=device, **kw)
    from ..parallel import distributed

    S, lanes, route = _sharded(params, home)
    walks, stats = distributed.distributed_random_walks(
        graph, num_shards=S, route=route, verbose=True, return_stats=True,
        lanes=lanes, device=device, as_numpy=False, timing=timing, **kw)
    print(f"shards: {stats['num_shards']} x {stats['lanes']} lanes "
          f"({'vcut' if route is not None else 'hash'} routing), "
          f"replication factor: {stats['replication_factor']:.3f}, "
          f"boundary walkers: {stats['boundary_walkers']}, "
          f"a2a capacity: {stats['capacity']}, "
          f"overflow supersteps: {stats['overflow_steps']}")
    logger.info("shard stats: %s",
                {k: v for k, v in stats.items() if k != "diag"})
    if report is not None:
        report.update(stats)
    return walks


def run_walks_multihost(graph: CSRGraph, params: Params,
                        home: np.ndarray | None = None, device="cuda",
                        timing: dict | None = None):
    """The multi-host CLI's walks (port of the JAX package's
    run_walks_multihost), called on every rank of the default group with
    the same params: the sharded engine over every rank, each keeping and
    writing only its own rows (parallel/multihost.py). The devices are the
    ranks, so --shards other than their count is ignored with the JAX
    package's warning; --lanes divides them into graph shards, routed by
    home % shards under --partitioned true.

    Returns (local blocks [(global row start, rows)], diag, padded rows
    num_walks * W_pad, devices D): the blocks tile the padded corpus
    [num_walks * W_pad, L+2] across the ranks; rows whose start slot was
    padding are all -1. timing: see distributed_walk_corpus."""
    from ..parallel import multihost

    D = walk_devices()
    if params.shards > 0 and params.shards != D:
        logger.warning(
            "multi-host runs use all %d global devices; --shards %d is "
            "ignored (use --lanes to reduce the graph-shard count)",
            D, params.shards)
    lanes = resolve_lanes(D, params.lanes)
    route = None
    if params.partitioned and home is not None:
        route = (home.astype(np.int64) % max(D // lanes, 1)).astype(np.int32)
    blocks, diag = multihost.multihost_random_walks(
        graph, walk_length=params.walk_length, num_walks=params.num_walks,
        p=params.p, q=params.q, seed=params.seed, sampler=params.sampler,
        num_shards=D, route=route, rng_impl=params.rng_impl, lanes=lanes,
        device=device, timing=timing)
    W_pad = -(-graph.num_vertices // D) * D
    return blocks, diag, params.num_walks * W_pad, D


def _round_maker(graph: CSRGraph, params: Params, device="cuda",
                 device_graph: DeviceGraph | None = None,
                 home: np.ndarray | None = None):
    """make_round(r) -> round r of the full corpus [V, L+2] on the device,
    bitwise the rows of the all-rounds corpus (the streams are addressed by
    round). Single device or sharded per --shards/--partitioned (the routing
    rules of run_walks); sharded, every walking rank builds its own shard
    once, and every rank of the default group gets every round whole."""
    device = resolve_device("checkpointed_random_walks", device)
    sampler, max_rounds = sampling.plan_sampler(params.sampler, params.p,
                                                params.q)
    if params.rng_impl not in ("threefry", "threefry2x32"):
        raise NotPorted(f"rng_impl {params.rng_impl!r}: XLA RngBitGenerator "
                        "streams have no port (ROADMAP Queue 1, not to port)")
    V = graph.num_vertices
    spec = engine.walk_spec(graph, params.walk_length, params.num_walks,
                            params.p, params.q, sampler, max_rounds,
                            "float32", V)
    base = prng.prng_key(params.seed)
    if num_walk_shards(params) > 1:
        from ..graph.partition import plan_shards
        from ..ops import shard_walk
        from ..parallel import distributed

        S, L, route = _sharded(params, home)
        SH = S // L     # graph shards (each replicated across its L lanes)
        group, member = distributed.walk_group(S)
        plan = plan_shards(graph, SH, route)
        distributed.log_shard_stats(graph, plan)
        tables = (shard_walk.shard_tables(
            graph, plan, distributed.rank_world()[0] // L, device,
            cdf=sampler == "cdf") if member else None)
        W_pad = -(-V // S) * S
        starts_pad = torch.full((W_pad,), -1, dtype=torch.int32)
        starts_pad[:V] = torch.arange(V, dtype=torch.int32)
        C = distributed.auto_capacity(graph, plan.route, S, W_pad // S)
        C = max(1, min(C, W_pad // S))

        def make_round(r: int) -> torch.Tensor:
            paths = None
            if member:
                paths, _ = distributed.distributed_walk_corpus(
                    tables, starts_pad, base, r, spec, 1, SH, C, L,
                    group=group)
            return distributed.gather_corpus(
                paths, group, (W_pad, params.walk_length + 2), device)[:V]

        return make_round, V
    g = (device_graph if device_graph is not None
         else sampling.device_put_graph(graph, device))
    if sampler == "cdf":
        g = sampling.with_cdf_rows(g, graph)
    starts = torch.arange(V, dtype=torch.int32, device=g.device)

    def make_round(r: int) -> torch.Tensor:
        return engine.walk_corpus(g, starts, base, spec, 1, r)

    return make_round, V


WALK_CKPT_DIR = "walk_rounds"
WALK_CKPT_MARKER = "marker.json"


def _round_file(ckpt_dir: str, r: int) -> str:
    return os.path.join(ckpt_dir, f"round-{r:05d}.npy")


def _save_round_atomic(ckpt_dir: str, r: int, block: np.ndarray) -> None:
    tmp = _round_file(ckpt_dir, r) + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, block)
    os.replace(tmp, _round_file(ckpt_dir, r))


def checkpointed_random_walks(graph: CSRGraph, params: Params,
                              device="cuda",
                              device_graph: DeviceGraph | None = None,
                              home: np.ndarray | None = None
                              ) -> tuple[np.ndarray, int]:
    """Round-granular walk checkpoints. Each finished round goes to its own
    atomic file <output>/bin/walk_rounds/round-NNNNN.npy; every
    --checkpointEvery rounds (and at the end) the marker (rounds completed,
    config fingerprint, shape) is replaced atomically. With --resume the
    completed rounds load from their files and only the rest is walked: the
    corpus is bitwise the uninterrupted one. A marker whose fingerprint or
    shape differs, or whose round files are missing, restarts from round 0.
    Sharded (called on every rank of the group), rank 0 decides where to
    resume and writes the files; the ranks read the completed rounds from
    them (one filesystem).

    Returns (walks [num_walks*V, L+2] on the host, rounds resumed)."""
    from ..parallel.distributed import for_backend, rank_world

    make_round, V = _round_maker(graph, params, device, device_graph, home)
    rank, world = rank_world()
    writer = rank == 0
    R = params.num_walks
    T = params.walk_length + 2
    ckpt_dir = os.path.join(params.output, MODEL_SUFFIX, WALK_CKPT_DIR)
    marker = os.path.join(ckpt_dir, WALK_CKPT_MARKER)
    # whatever changes the rounds' contents; the JAX package's fingerprint
    fp = json.dumps([params.seed, params.p, params.q, params.sampler,
                     params.rng_impl, params.shards, params.lanes,
                     params.partitioned, params.walk_length])
    start = 0
    if writer and params.resume and os.path.exists(marker):
        try:
            with open(marker) as f:
                m = json.load(f)
        except (json.JSONDecodeError, OSError):
            m = {}
        done = int(m.get("completed", 0))
        if m.get("fingerprint") != fp:
            logger.warning("walk checkpoint fingerprint %s does not match "
                           "current params %s: regenerating from scratch",
                           m.get("fingerprint"), fp)
        elif m.get("rows") != V or m.get("cols") != T or done > R:
            logger.warning("walk checkpoint shape %s does not match params "
                           "(rows=%d cols=%d, completed<=%d): regenerating "
                           "from scratch",
                           (m.get("rows"), m.get("cols"), done), V, T, R)
        elif not all(os.path.exists(_round_file(ckpt_dir, r))
                     for r in range(done)):
            logger.warning("walk checkpoint round files missing: "
                           "regenerating from scratch")
        else:
            start = done
            logger.info("walk checkpoint: resuming after %d completed rounds",
                        done)
    if world > 1:
        found = for_backend(torch.tensor([start]), device)
        torch.distributed.broadcast(found, src=0)
        start = int(found)
    every = max(1, params.checkpoint_every)
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    out = np.empty((R * V, T), dtype=np.int32)
    for r in range(start):
        out[r * V:(r + 1) * V] = np.load(_round_file(ckpt_dir, r))

    def write_marker(done: int) -> None:
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"completed": done, "fingerprint": fp,
                       "rows": V, "cols": T}, f)
        os.replace(tmp, marker)   # a kill never leaves half a marker

    if start == 0 and writer:
        write_marker(0)   # void a stale marker before its files are replaced
    for r in range(start, R):
        block = make_round(r).cpu().numpy()
        out[r * V:(r + 1) * V] = block
        if not writer:
            continue
        _save_round_atomic(ckpt_dir, r, block)
        done = r + 1
        if done % every == 0 or done == R:
            write_marker(done)
    return out, start


def run_node2vec_streaming(graph: CSRGraph, params: Params, device="cuda",
                           device_graph: DeviceGraph | None = None,
                           report: dict | None = None,
                           home: np.ndarray | None = None):
    """Node2vec with one walk round on the device at a time (port of the
    JAX package's run_node2vec_streaming).

    The stored path holds the whole corpus on the device before training.
    Here the counter-based streams make every round exactly regenerable:
      pre-pass (once): walk each round on the device, write it to /path
        (graph/io.py::save_walks_stream), count its tokens and row lengths;
      training: in every epoch walk each round again and train on it
        (word2vec.py::train_skipgram_streaming); the realized corpus is
        bitwise the stored path's.
    Each walk dispatch walks only its own round. The graph is uploaded once
    (device_graph, when given, is used as it is). As in the JAX package
    there are no walk-round or trainer checkpoints and no --validate.
    Sharded (called on every rank of the group), every rank walks and
    trains the same rounds; rank 0 alone writes /path.

    Returns (tokens, w_in, w_out, stats); report, when given, receives
    walk_seconds (the pre-pass) and train_seconds (the epochs)."""
    t0 = time.perf_counter()
    V = graph.num_vertices
    R = params.num_walks
    from ..parallel.distributed import rank_world

    make_round, _ = _round_maker(graph, params, device, device_graph, home)
    counts = None
    lengths = []

    def rounds_for_save():
        nonlocal counts
        for r in range(R):
            block = make_round(r)
            # -1 pads land in bin 0. The JAX package sums the counts in f32,
            # which is exact while every count is below 2**24; the integer
            # counts equal it there and stay exact beyond
            c = torch.bincount(block.reshape(-1) + 1, minlength=V + 1)[1:]
            counts = c if counts is None else counts + c
            block_np = block.cpu().numpy()
            lengths.append((block_np >= 0).sum(axis=1))
            yield block_np

    if rank_world()[0] == 0:
        gio.save_walks_stream(rounds_for_save(), R * V, graph, params.output,
                              output_partitions(params))
    else:
        for _ in rounds_for_save():
            pass
    counts = (counts.cpu().numpy().astype(np.float64) if counts is not None
              else np.zeros(V))
    lengths = np.concatenate(lengths) if lengths else np.zeros(0, np.int64)
    full = params.walk_length + 2
    stats = WalkStats(
        num_paths=int(len(lengths)),
        num_steps=int(lengths.sum() - len(lengths)),
        full_paths=int((lengths == full).sum()),
        dead_ends=int(((lengths < full) & (lengths > 1)).sum()),
        isolated_starts=int((lengths == 1).sum()),
        mean_length=float(lengths.mean()) if len(lengths) else 0.0,
    )
    t1 = time.perf_counter()
    w_in, w_out = w2v.train_skipgram_streaming(
        make_round, R, (V, full), V, sgns_config(params), counts,
        device=device)
    if report is not None:
        report.update(walk_seconds=t1 - t0,
                      train_seconds=time.perf_counter() - t1)
    return [int(i) for i in graph.ids], w_in, w_out, stats


def sgns_config(params: Params) -> w2v.SGNSConfig:
    return w2v.SGNSConfig(
        dim=params.w2v_dim,
        window=params.w2v_window,
        negatives=params.w2v_negatives,
        lr=params.w2v_lr,
        iters=params.w2v_iter,
        seed=params.seed,
        shared_negatives=params.shared_negatives,
        model_shards=params.w2v_model_shards,
    )


def save_model(output: str, tokens: list, w_in: np.ndarray, w_out: np.ndarray,
               params: Params) -> str:
    """Persist the tables + metadata to <output>/bin."""
    out_dir = os.path.join(output, MODEL_SUFFIX)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "model.npz"),
             w_in=w_in, w_out=w_out, tokens=np.asarray(tokens))
    meta = {
        "dim": params.w2v_dim, "window": params.w2v_window,
        "negatives": params.w2v_negatives, "lr": params.w2v_lr,
        "iters": params.w2v_iter, "vocab_size": len(tokens),
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_model(output_or_bin: str):
    """(tokens, w_in, w_out) from <output> or <output>/bin."""
    d = output_or_bin
    if os.path.isdir(os.path.join(d, MODEL_SUFFIX)):
        d = os.path.join(d, MODEL_SUFFIX)
    z = np.load(os.path.join(d, "model.npz"), allow_pickle=False)
    return z["tokens"], z["w_in"], z["w_out"]


def _checkpoint_path(output: str) -> str:
    return os.path.join(output, MODEL_SUFFIX, "checkpoint.npz")


def _train(corpus, vocab_size: int, params: Params, device="cuda"):
    """Trainer with epoch checkpoints: --checkpointEvery N saves the tables
    after every N-th epoch to <output>/bin/checkpoint.npz (the JAX package's
    file), --resume true starts after the saved epoch. The keys are counter
    based, so a resumed run replays the uninterrupted one exactly."""
    init = None
    start_epoch = 0
    ckpt = _checkpoint_path(params.output) if params.output else None
    if params.resume and ckpt and os.path.exists(ckpt):
        z = np.load(ckpt)
        init = (z["w_in"], z["w_out"])
        start_epoch = int(z["epoch"]) + 1

    on_epoch = None
    if params.checkpoint_every and ckpt:
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)

        def on_epoch(ep, w_in, w_out):
            if (ep + 1) % params.checkpoint_every == 0:
                np.savez(ckpt, w_in=w_in, w_out=w_out, epoch=ep)

    return w2v.train_skipgram(
        corpus, vocab_size, sgns_config(params),
        num_partitions=params.w2v_partitions, init=init,
        start_epoch=start_epoch, on_epoch=on_epoch, device=device)


def train_multiproc_with_ckpt(blocks, num_rows: int, vocab_size: int,
                              params: Params,
                              num_devices: int | None = None,
                              row_width: int | None = None, *,
                              device="cuda"):
    """w2v.train_skipgram_multiproc with epoch checkpoints, over the ranks
    of the default process group (a world of one without one). Rank 0
    writes <output>/bin/checkpoint.npz (the JAX package's file); on
    --resume rank 0 reads it and broadcasts (found, epoch, w_in, w_out) to
    every rank, whose filesystems need not share <output>, so every rank
    restarts from the same tables. Returns (w_in, w_out)."""
    from ..parallel import dp

    device = resolve_device("train_multiproc_with_ckpt", device)
    cfg = sgns_config(params)
    rank, world = dp.rank_world()
    init = None
    start_epoch = 0
    ckpt = _checkpoint_path(params.output) if params.output else None
    if params.resume and ckpt:
        V, dim = vocab_size, params.w2v_dim
        # found, epoch + 1, w_in, w_out in one float32 tensor (the JAX
        # package broadcasts the same payload)
        payload = torch.zeros(2 + 2 * V * dim, dtype=torch.float32,
                              device=device)
        if rank == 0 and os.path.exists(ckpt):
            z = np.load(ckpt)
            payload[0] = 1
            payload[1] = int(z["epoch"]) + 1
            payload[2:] = torch.as_tensor(np.concatenate(
                [z["w_in"].astype(np.float32).ravel(),
                 z["w_out"].astype(np.float32).ravel()]))
        if world > 1:
            torch.distributed.broadcast(payload, src=0)
        if float(payload[0]):
            tables = payload[2:].cpu().numpy().reshape(2, V, dim)
            init = (tables[0], tables[1])
            start_epoch = int(payload[1])

    on_epoch = None
    if params.checkpoint_every and ckpt and rank == 0:
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)

        def on_epoch(ep, w_in, w_out):
            if (ep + 1) % params.checkpoint_every == 0:
                np.savez(ckpt, w_in=w_in, w_out=w_out, epoch=ep)

    return w2v.train_skipgram_multiproc(
        blocks, num_rows, vocab_size, cfg, init=init,
        start_epoch=start_epoch, on_epoch=on_epoch,
        num_devices=num_devices, row_width=row_width, device=device)


def embed_walk_blocks(blocks, num_rows: int, graph: CSRGraph,
                      params: Params, num_devices: int | None = None,
                      row_width: int | None = None, *, device="cuda"):
    """The multi-host node2vec trainer: SGNS over the ranks' own corpus
    blocks (train_multiproc_with_ckpt). Returns (tokens, w_in, w_out)."""
    w_in, w_out = train_multiproc_with_ckpt(
        blocks, num_rows, graph.num_vertices, params,
        num_devices=num_devices, row_width=row_width, device=device)
    return [int(i) for i in graph.ids], w_in, w_out


def embed_walks(walks, graph: CSRGraph, params: Params, device="cuda"):
    """Train SGNS on the dense walk corpus (vocab = graph vertices).
    Returns (tokens = original ids, w_in, w_out)."""
    w_in, w_out = _train(walks, graph.num_vertices, params, device)
    return [int(i) for i in graph.ids], w_in, w_out


def embed_token_corpus(token_lists, params: Params, device="cuda"):
    """Train SGNS from arbitrary token sequences. Returns (vocab, w_in,
    w_out), vocab by descending frequency."""
    corpus, vocab = w2v.corpus_from_token_lists(token_lists)
    w_in, w_out = _train(corpus, len(vocab), params, device)
    return vocab, w_in, w_out


def embed_ragged_corpus(values: np.ndarray, offsets: np.ndarray,
                        params: Params, device="cuda"):
    """embed_token_corpus on the ragged walks representation
    (graph/io.load_walks_ragged): the `embedding` command's path."""
    corpus, vocab = w2v.corpus_from_ragged(values, offsets)
    w_in, w_out = _train(corpus, len(vocab), params, device)
    return vocab, w_in, w_out


def output_partitions(params: Params) -> int:
    """singleOutput -> 1 file else rddPartitions files."""
    return 1 if params.single_output else params.rdd_partitions
