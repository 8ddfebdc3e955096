"""The node2vec pipeline on one device: walks -> skip-gram embeddings.

Port of the single-device path of stellar_rw_tpu/models/node2vec.py. Model
artifacts go to <output>/bin in the JAX package's format (model.npz +
metadata.json), so a model written by either package loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..errors import NotPorted
from ..graph.csr import CSRGraph
from ..ops.sampling import DeviceGraph
from ..utils.config import MODEL_SUFFIX, Params
from ..walk import engine
from . import word2vec as w2v


def run_walks(graph: CSRGraph, params: Params, device="cuda",
              device_graph: DeviceGraph | None = None) -> torch.Tensor:
    """The corpus as a device tensor [num_walks * V, L+2] (the trainer's
    handoff: no host round trip)."""
    if params.shards > 1 or params.partitioned:
        raise NotPorted("--shards > 1 / --partitioned true: the sharded walk "
                        "engine is ROADMAP Queue 1 item 12 (K11)")
    if params.checkpoint_every and params.output:
        raise NotPorted("--checkpointEvery with walks: the walk rounds' "
                        "checkpoint files are ROADMAP Queue 1 item 5")
    return engine.random_walks(
        graph, walk_length=params.walk_length, num_walks=params.num_walks,
        p=params.p, q=params.q, seed=params.seed, sampler=params.sampler,
        rng_impl=params.rng_impl, device_graph=device_graph, as_numpy=False,
        device=device)


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
