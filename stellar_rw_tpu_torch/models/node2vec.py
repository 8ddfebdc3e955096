"""The node2vec pipeline on one device: walks -> skip-gram embeddings.

Port of the single-device path of stellar_rw_tpu/models/node2vec.py. Model
artifacts go to <output>/bin in the JAX package's format (model.npz +
metadata.json), and walk-round checkpoints to <output>/bin/walk_rounds in
its layout (round files, marker JSON and fingerprint), so a model or a
partial walk checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from ..errors import NotPorted, resolve_device
from ..graph.csr import CSRGraph
from ..ops import prng, sampling
from ..ops.sampling import DeviceGraph
from ..utils.config import MODEL_SUFFIX, Params
from ..walk import engine
from . import word2vec as w2v

logger = logging.getLogger("stellar_rw_tpu_torch.node2vec")


WALK_DEVICES = 1   # the port's walk engine runs on one device


def num_walk_shards(params: Params, devices: int = WALK_DEVICES) -> int:
    """Resolve --shards as the JAX package does: 0 = auto (one shard, unless
    --partitioned true, which takes min(devices, rddPartitions)), always
    capped at the devices the walks run on."""
    if params.shards > 0:
        return max(1, min(params.shards, devices))
    if params.partitioned:
        return max(1, min(devices, params.rdd_partitions))
    return 1


def _refuse_sharded(params: Params) -> None:
    """One shard takes the single-device engine; --partitioned then changes
    only the loader (the walks do not depend on the routing)."""
    if num_walk_shards(params) > 1:
        raise NotPorted("more than one walk shard: the sharded walk engine "
                        "is ROADMAP Queue 1 item 12 (K11)")


def run_walks(graph: CSRGraph, params: Params, device="cuda",
              device_graph: DeviceGraph | None = None) -> torch.Tensor:
    """The corpus as a device tensor [num_walks * V, L+2] (the trainer's
    handoff: no host round trip). With --checkpointEvery and an output the
    rounds run one at a time through checkpointed_random_walks."""
    _refuse_sharded(params)
    if params.checkpoint_every and params.output:
        walks, resumed = checkpointed_random_walks(graph, params, device,
                                                   device_graph)
        if resumed:
            print(f"resumed {resumed} completed walk rounds from checkpoint")
        return torch.as_tensor(walks).to(resolve_device("run_walks", device))
    return engine.random_walks(
        graph, walk_length=params.walk_length, num_walks=params.num_walks,
        p=params.p, q=params.q, seed=params.seed, sampler=params.sampler,
        rng_impl=params.rng_impl, device_graph=device_graph, as_numpy=False,
        device=device)


def _round_maker(graph: CSRGraph, params: Params, device="cuda",
                 device_graph: DeviceGraph | None = None):
    """make_round(r) -> round r of the full corpus [V, L+2] on the device,
    bitwise the rows of the all-rounds corpus (the streams are addressed by
    round). Single device only: the sharded rounds are ROADMAP item 12."""
    _refuse_sharded(params)
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
    g = (device_graph if device_graph is not None
         else sampling.device_put_graph(graph, device))
    if sampler == "cdf":
        g = sampling.with_cdf_rows(g, graph)
    base = prng.prng_key(params.seed)
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
                              device_graph: DeviceGraph | None = None
                              ) -> tuple[np.ndarray, int]:
    """Round-granular walk checkpoints. Each finished round goes to its own
    atomic file <output>/bin/walk_rounds/round-NNNNN.npy; every
    --checkpointEvery rounds (and at the end) the marker (rounds completed,
    config fingerprint, shape) is replaced atomically. With --resume the
    completed rounds load from their files and only the rest is walked: the
    corpus is bitwise the uninterrupted one. A marker whose fingerprint or
    shape differs, or whose round files are missing, restarts from round 0.

    Returns (walks [num_walks*V, L+2] on the host, rounds resumed)."""
    make_round, V = _round_maker(graph, params, device, device_graph)
    R = params.num_walks
    T = params.walk_length + 2
    ckpt_dir = os.path.join(params.output, MODEL_SUFFIX, WALK_CKPT_DIR)
    marker = os.path.join(ckpt_dir, WALK_CKPT_MARKER)
    # whatever changes the rounds' contents; the JAX package's fingerprint
    fp = json.dumps([params.seed, params.p, params.q, params.sampler,
                     params.rng_impl, params.shards, params.lanes,
                     params.partitioned, params.walk_length])
    start = 0
    if params.resume and os.path.exists(marker):
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
    every = max(1, params.checkpoint_every)
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

    if start == 0:
        write_marker(0)   # void a stale marker before its files are replaced
    for r in range(start, R):
        block = make_round(r).cpu().numpy()
        out[r * V:(r + 1) * V] = block
        _save_round_atomic(ckpt_dir, r, block)
        done = r + 1
        if done % every == 0 or done == R:
            write_marker(done)
    return out, start


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
