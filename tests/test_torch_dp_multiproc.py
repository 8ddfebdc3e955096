"""The port's multi-process trainer on two gloo ranks: two subprocesses on
the CPU (CUDA_VISIBLE_DEVICES empty), joined through
stellar_rw_tpu_torch/parallel/dp.py::init_group, run
train_skipgram_multiproc over a karate corpus held in full by each (the
`embedding` command's case: full_corpus_blocks), and
models/node2vec.py::train_multiproc_with_ckpt uninterrupted, cut after its
first epoch, and resumed (rank 0 reads the checkpoint and broadcasts it).

Held against the JAX package's train_skipgram_multiproc(num_devices=2) on
two CPU devices of one process, at its own two-process test's tolerance
(rtol 2e-4 / atol 1e-6, tests/test_multihost.py:218); the resumed run
equal to the uninterrupted one; both ranks' tables equal; one all-reduce
a merged update and one for the token counts. train_skipgram's
num_partitions, called on each rank of that group, does no all-reduce.
JAX runs with x64 off."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.models import word2vec as w2v

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# train_skipgram(num_partitions=2)'s settings, run inside the group
PARTITIONS = dict(dim=8, window=3, negatives=2, iters=1, seed=3, lr=0.05,
                  shared_negatives=8)

WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.parallel import dp
from stellar_rw_tpu_torch.utils.config import parse

rank, world, port, corpus_path, out = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
PARTITIONS = json.loads(sys.argv[6])
backend = dp.init_group(rank, world, "cpu", f"tcp://localhost:{port}")
corpus = np.load(corpus_path)
blocks, rows = w2v.full_corpus_blocks(corpus, 2, rank, world)
result = {"backend": backend}
for kB in (0, 8):
    cfg = w2v.SGNSConfig(dim=8, window=3, negatives=2, iters=2, seed=3,
                         lr=0.05, shared_negatives=kB)
    before = dp.ALL_REDUCES
    w_in, w_out = w2v.train_skipgram_multiproc(blocks, rows, 34, cfg,
                                               num_devices=2, device="cpu")
    result[f"all_reduces_{kB}"] = dp.ALL_REDUCES - before
    np.save(f"{out}/kB{kB}_rank{rank}.npy", np.stack([w_in, w_out]))
# the single-process trainer inside the group: its slots are its own
before = dp.ALL_REDUCES
w_in, w_out = w2v.train_skipgram(corpus, 34, w2v.SGNSConfig(**PARTITIONS),
                                 num_partitions=2, device="cpu")
result["all_reduces_partitions"] = dp.ALL_REDUCES - before
np.save(f"{out}/partitions_rank{rank}.npy", np.stack([w_in, w_out]))


class Cut(Exception):
    pass


def params(output, resume):
    return parse(["--cmd", "embedding", "--input", corpus_path, "--output",
                  output, "--dim", "8", "--window", "3", "--iter", "2",
                  "--seed", "5", "--checkpointEvery", "1", "--resume",
                  "true" if resume else "false"])


train = w2v.train_skipgram_multiproc


def cut_after_one_epoch(*args, on_epoch=None, **kw):
    def first(ep, w_in, w_out):
        if on_epoch is not None:
            on_epoch(ep, w_in, w_out)
        raise Cut
    return train(*args, on_epoch=first, **kw)


whole = n2v.train_multiproc_with_ckpt(blocks, rows, 34,
                                      params(f"{out}/whole", False),
                                      num_devices=2, device="cpu")
w2v.train_skipgram_multiproc = cut_after_one_epoch
try:
    n2v.train_multiproc_with_ckpt(blocks, rows, 34, params(f"{out}/cut", False),
                                  num_devices=2, device="cpu")
except Cut:
    result["cut"] = True
w2v.train_skipgram_multiproc = train
resumed = n2v.train_multiproc_with_ckpt(blocks, rows, 34,
                                        params(f"{out}/cut", True),
                                        num_devices=2, device="cpu")
np.save(f"{out}/ckpt_rank{rank}.npy", np.stack([*whole, *resumed]))
print("RESULT " + json.dumps(result), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def walks(karate_path):
    g = jio.load_edge_list(karate_path, weighted=False, directed=False)
    with jax.enable_x64(False):
        return np.asarray(jengine.random_walks(g, walk_length=8,
                                               num_walks=3, seed=2))[:97]


@pytest.fixture(scope="module")
def two_ranks(walks, tmp_path_factory):
    """Both ranks' results and output directory."""
    out = tmp_path_factory.mktemp("dp_ranks")
    corpus = out / "corpus.npy"
    np.save(corpus, walks)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", port, str(corpus),
         str(out), json.dumps(PARTITIONS)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results, out


@pytest.mark.parametrize("kB", [0, 8])
def test_two_gloo_ranks_match_jax(walks, two_ranks, kB):
    """Two gloo ranks against the JAX package's multiproc trainer on two
    devices: the same tables on both ranks, within rtol 2e-4 atol 1e-6 of
    JAX's; one all-reduce a merged update plus the token counts'."""
    results, out = two_ranks
    assert [r["backend"] for r in results] == ["gloo", "gloo"]
    got = [np.load(out / f"kB{kB}_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])
    jblocks, rows = jw2v.full_corpus_blocks(walks, 2)
    cfg = jw2v.SGNSConfig(dim=8, window=3, negatives=2, iters=2, seed=3,
                          lr=0.05, shared_negatives=kB)
    with jax.enable_x64(False):
        want = jw2v.train_skipgram_multiproc(jblocks, rows, 34, cfg,
                                             num_devices=2)
    for g, w in zip(got[0], want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6)
    B = jw2v._divisor_block(rows // 2, 16)
    merged = cfg.iters * (rows // 2 // B)
    assert all(r[f"all_reduces_{kB}"] == merged + 1 for r in results)


def test_partitions_inside_a_group_do_no_all_reduce(walks, two_ranks):
    """train_skipgram(num_partitions=2) called on each rank of an
    initialized world-2 group keeps its slots to itself: no all-reduce, and
    the tables of the same call made outside any group."""
    results, out = two_ranks
    assert all(r["all_reduces_partitions"] == 0 for r in results)
    want = np.stack(w2v.train_skipgram(walks, 34,
                                       w2v.SGNSConfig(**PARTITIONS),
                                       num_partitions=2, device="cpu"))
    for r in range(2):
        np.testing.assert_array_equal(
            np.load(out / f"partitions_rank{r}.npy"), want)


def test_checkpoint_cut_and_resumed_equals_uninterrupted(two_ranks):
    """train_multiproc_with_ckpt cut after its first epoch (rank 0 wrote the
    checkpoint) and resumed (rank 0 read it and broadcast it) equals the
    uninterrupted run, on both ranks."""
    results, out = two_ranks
    assert all(r.get("cut") for r in results)
    assert (out / "cut" / "bin" / "checkpoint.npz").exists()
    for r in range(2):
        whole_in, whole_out, res_in, res_out = np.load(
            out / f"ckpt_rank{r}.npy")
        np.testing.assert_array_equal(res_in, whole_in)
        np.testing.assert_array_equal(res_out, whole_out)
    np.testing.assert_array_equal(np.load(out / "ckpt_rank0.npy"),
                                  np.load(out / "ckpt_rank1.npy"))
