"""The port's multi-host CLI: `python -m stellar_rw_tpu_torch` processes
joined through the SRW_* variables (parallel/multihost.py), one gloo rank
each on the CPU (CUDA_VISIBLE_DEVICES empty), against the JAX package.

The patterns of tests/test_multihost.py, with two ranks where the JAX test
has two processes of four devices each (a rank is one device here, so D is
2, and there are two part files): randomwalk (each rank validates and
writes its own part; the parts' concatenation byte-equal to the JAX CLI's
single-process /path; rank 0's global path count), node2vec end to end
with --checkpointEvery 1 (rank 0 writes the trainer checkpoint; the tables
within rtol 2e-4 atol 1e-6 of the JAX package's train_skipgram_multiproc
at num_devices=2 on the same padded corpus), embedding, and
--partitioned true --shards 8 (the vertex-cut route; --shards other than
the ranks is ignored with the JAX package's warning). Beside them: a
trainer cut after its first epoch and resumed with --resume true (rank 0
reads the checkpoint and broadcasts it) equal to the uninterrupted run,
randomwalk --sampler cdf (the exact-CDF sampler across the ranks) whose
parts merge to the JAX CLI's /path, the refusals (--streaming, model
shards across processes) raised on every rank, and --lanes 2 on four
ranks. Each spawn runs its CLI runs one after the other, a coordinator
port each; the JAX references are computed while the ranks run. JAX runs
with x64 off."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.utils import config as jconfig
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.models import node2vec as n2v

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RW = ["--cmd", "randomwalk", "--walkLength", "8", "--numWalks", "2",
      "--weighted", "false", "--p", "0.5", "--q", "2.0", "--seed", "13",
      "--validate", "true"]
N2V = ["--cmd", "node2vec", "--walkLength", "8", "--numWalks", "2",
       "--weighted", "false", "--dim", "8", "--iter", "2", "--window", "3",
       "--seed", "13", "--checkpointEvery", "1"]
EMB = ["--cmd", "embedding", "--dim", "8", "--iter", "2", "--window", "3",
       "--seed", "5"]
VCUT = ["--cmd", "randomwalk", "--walkLength", "6", "--numWalks", "2",
        "--weighted", "false", "--seed", "4", "--partitioned", "true"]
LANES = ["--cmd", "randomwalk", "--walkLength", "6", "--numWalks", "3",
         "--weighted", "false", "--p", "0.5", "--q", "2.0", "--seed", "7"]

WORKER = r"""
import contextlib, io, json, logging, os, sys
import torch
torch.set_num_threads(1)
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.models import word2vec as w2v

rank, world, runs = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
os.environ.update(SRW_NUM_PROCESSES=str(world), SRW_PROCESS_ID=str(rank))


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.seen = []

    def emit(self, record):
        self.seen.append(record.getMessage())


class Cut(Exception):
    pass


train = w2v.train_skipgram_multiproc
started = []


def recorded(*args, **kw):
    started.append(kw.get("start_epoch", 0))
    return train(*args, **kw)


def cut_after_one_epoch(*args, on_epoch=None, **kw):
    def first(ep, w_in, w_out):
        if on_epoch is not None:
            on_epoch(ep, w_in, w_out)
        raise Cut
    return recorded(*args, on_epoch=first, **kw)


warnings = Warnings()
logging.getLogger().addHandler(warnings)
result = {}
for run in runs:
    os.environ["SRW_COORDINATOR"] = f"127.0.0.1:{run['port']}"
    w2v.train_skipgram_multiproc = (cut_after_one_epoch if run.get("cut")
                                    else recorded)
    warnings.seen = []
    started.clear()
    out, report, error = io.StringIO(), {}, None
    try:
        with contextlib.redirect_stdout(out):
            cli.main(run["argv"], device="cpu", report=report)
    except Exception as e:
        error = [type(e).__name__, str(e)]
    w2v.train_skipgram_multiproc = train
    result[run["name"]] = {"stdout": out.getvalue(), "error": error,
                           "warnings": warnings.seen,
                           "start_epochs": list(started),
                           "report": {k: v for k, v in report.items()
                                      if isinstance(v, (int, float))}}
print("RESULT " + json.dumps(result), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(world, runs, meanwhile, timeout=240):
    """The worker on `world` ranks, each running `runs` (name -> argv)
    through cli.main in order; `meanwhile` runs here while they do.
    Returns each rank's results by run name."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    for name in ("SRW_COORDINATOR", "SRW_NUM_PROCESSES", "SRW_PROCESS_ID"):
        env.pop(name, None)
    plan = json.dumps([{"name": name, "port": _free_port(), **run}
                       for name, run in runs.items()])
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), plan], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results = []
    try:
        meanwhile()
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _merged_path(out_dir) -> str:
    parts = sorted(os.listdir(os.path.join(out_dir, "path")))
    return "".join(open(os.path.join(out_dir, "path", f)).read()
                   for f in parts)


def _vcut_file(karate_path, out):
    """Karate with a partition column, pid = src % 3 (as
    tests/test_multihost.py builds it)."""
    path = out / "karate_part.txt"
    with open(karate_path) as f, open(path, "w") as g:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                g.write(f"{toks[0]} {toks[1]} {int(toks[0]) % 3}\n")
    return str(path)


def _jax_cli_path(args, out) -> str:
    """The JAX CLI's single-process /path for `args`."""
    with jax.enable_x64(False):
        jcli.run_job(jconfig.parse(args + ["--output", str(out)]))
    return open(out / "path" / "part-00000").read()


def _jax_multiproc(corpus, vocab, kw):
    """The JAX package's train_skipgram_multiproc on two of conftest's CPU
    devices in this process."""
    blocks, rows = jw2v.full_corpus_blocks(corpus, 2)
    with jax.enable_x64(False):
        return jw2v.train_skipgram_multiproc(blocks, rows, vocab,
                                             jw2v.SGNSConfig(**kw),
                                             num_devices=2)


@pytest.fixture(scope="module")
def two_ranks(karate_path, tmp_path_factory):
    """Both ranks' results, the output root and the JAX references."""
    out = tmp_path_factory.mktemp("multihost")
    vcut = _vcut_file(karate_path, out)
    # the embedding command's walks file, written before the ranks start
    walks_file = out / "stage1"
    with jax.enable_x64(False):
        jcli.run_job(jconfig.parse(
            ["--cmd", "randomwalk", "--input", karate_path, "--output",
             str(walks_file), "--walkLength", "6", "--numWalks", "2",
             "--weighted", "false"]))
    k = ["--input", karate_path]
    runs = {
        "rw": {"argv": RW + k + ["--output", str(out / "rw")]},
        "n2v": {"argv": N2V + k + ["--output", str(out / "n2v")]},
        "emb": {"argv": EMB + ["--input", str(walks_file / "path"),
                               "--output", str(out / "emb")]},
        "vcut": {"argv": VCUT + ["--input", vcut, "--shards", "8",
                                 "--output", str(out / "vcut")]},
        "cut": {"argv": N2V + k + ["--output", str(out / "resumed")],
                "cut": True},
        "resumed": {"argv": N2V + k + ["--output", str(out / "resumed"),
                                       "--resume", "true"]},
        "streaming": {"argv": N2V + k + ["--output", str(out / "no1"),
                                         "--streaming", "true"]},
        "cdf": {"argv": RW + k + ["--output", str(out / "cdf"),
                                  "--sampler", "cdf"]},
        "model_shards": {"argv": N2V + k + ["--output", str(out / "no3"),
                                            "--w2vModelShards", "2"]},
    }
    refs = {}

    def meanwhile():
        refs["rw"] = _jax_cli_path(RW + k, out / "jax_rw")
        refs["cdf"] = _jax_cli_path(RW + k + ["--sampler", "cdf"],
                                    out / "jax_cdf")
        refs["vcut"] = _jax_cli_path(VCUT + ["--input", vcut, "--shards",
                                             "1"], out / "jax_vcut")
        g = jio.load_edge_list(karate_path, weighted=False, directed=False)
        with jax.enable_x64(False):
            walks = np.asarray(jengine.random_walks(
                g, walk_length=8, num_walks=2, seed=13,
                schedule="dynamic")).astype(np.int32)
        W, D = g.num_vertices, 2
        W_pad = -(-W // D) * D
        padded = np.full((2, W_pad, walks.shape[1]), -1, np.int32)
        padded[:, :W] = walks.reshape(2, W, -1)
        refs["n2v"] = _jax_multiproc(padded.reshape(2 * W_pad, -1), W,
                                     dict(dim=8, window=3, negatives=5,
                                          lr=0.025, iters=2, seed=13))
        values, offsets = jio.load_walks_ragged(str(walks_file / "path"))
        corpus, vocab = jw2v.corpus_from_ragged(values, offsets)
        refs["emb"] = (_jax_multiproc(corpus, len(vocab),
                                      dict(dim=8, window=3, negatives=5,
                                           lr=0.025, iters=2, seed=5)),
                       vocab)

    return _spawn(2, runs, meanwhile), out, refs


def test_randomwalk_parts_match_jax_cli(two_ranks, karate_path):
    """Each rank validates and writes its own part; the two parts in name
    order are the JAX CLI's single-process /path byte for byte; rank 0
    prints the global path count."""
    results, out, refs = two_ranks
    for r in range(2):
        run = results[r]["rw"]
        assert run["error"] is None, run
        assert f"walk invariants: ok (process {r})" in run["stdout"]
        assert run["report"]["paths"] == 68
    assert sorted(os.listdir(out / "rw" / "path")) == ["part-00000",
                                                      "part-00001"]
    assert _merged_path(out / "rw") == refs["rw"]
    assert "walks: 68 paths" in results[0]["rw"]["stdout"]
    assert "2 processes x 1 devices" in results[0]["rw"]["stdout"]
    assert "walks:" not in results[1]["rw"]["stdout"]


def test_node2vec_matches_jax_multiproc(two_ranks):
    """node2vec end to end: rank 0 writes the trainer checkpoint and the
    model; the tables within rtol 2e-4 atol 1e-6 of JAX's multiproc trainer
    at num_devices=2 on the same padded corpus; walk-round checkpoints
    skipped with the JAX package's warning."""
    results, out, refs = two_ranks
    for r in range(2):
        assert results[r]["n2v"]["error"] is None, results[r]["n2v"]
        assert any("walk-round checkpoints are single-host only" in w
                   for w in results[r]["n2v"]["warnings"])
    assert (out / "n2v" / "bin" / "checkpoint.npz").exists()
    assert not (out / "n2v" / "bin" / "walk_rounds").exists()
    tokens, w_in, w_out = n2v.load_model(str(out / "n2v"))
    assert len(open(out / "n2v" / "vec" / "part-00000").read()
               .splitlines()) == 34
    for got, want in zip((w_in, w_out), refs["n2v"]):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_embedding_matches_jax_multiproc(two_ranks):
    """embedding: every rank reads the walks file, the trainer splits it;
    the vocabulary and the tables are JAX's multiproc trainer's."""
    results, out, refs = two_ranks
    assert all(results[r]["emb"]["error"] is None for r in range(2))
    (want, vocab) = refs["emb"]
    tokens, w_in, w_out = n2v.load_model(str(out / "emb"))
    assert [int(t) for t in tokens] == vocab
    for got, w in zip((w_in, w_out), want):
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=1e-6)


def test_partitioned_vcut_matches_jax_cli(two_ranks):
    """--partitioned true --shards 8 on two ranks: the vertex-cut route
    over both, --shards 8 ignored with the JAX package's warning, the
    parts merging to the single-process corpus byte for byte."""
    results, out, refs = two_ranks
    for r in range(2):
        run = results[r]["vcut"]
        assert run["error"] is None, run
        assert any("--shards 8 is ignored" in w for w in run["warnings"])
    assert _merged_path(out / "vcut") == refs["vcut"]


def test_resume_broadcasts_the_checkpoint(two_ranks):
    """The trainer cut after its first epoch (rank 0 wrote the
    checkpoint) and resumed by --resume true (rank 0 read it and broadcast
    it) gives the uninterrupted run's tables bit for bit, on every rank
    from epoch 1."""
    results, out, _ = two_ranks
    for r in range(2):
        assert results[r]["cut"]["error"][0] == "Cut"
        assert results[r]["resumed"]["error"] is None
        assert results[r]["n2v"]["start_epochs"] == [0]
        assert results[r]["resumed"]["start_epochs"] == [1]
    for a, b in zip(n2v.load_model(str(out / "resumed")),
                    n2v.load_model(str(out / "n2v"))):
        np.testing.assert_array_equal(a, b)


def test_cdf_sampler_parts_match_jax_cli(two_ranks):
    """randomwalk --sampler cdf over the two ranks (the sharded engine's
    exact-CDF serve): each rank validates and writes its own part, and the
    two parts in name order are the JAX CLI's single-process /path byte
    for byte."""
    results, out, refs = two_ranks
    for r in range(2):
        run = results[r]["cdf"]
        assert run["error"] is None, run
        assert f"walk invariants: ok (process {r})" in run["stdout"]
    assert sorted(os.listdir(out / "cdf" / "path")) == ["part-00000",
                                                       "part-00001"]
    assert _merged_path(out / "cdf") == refs["cdf"]
    assert "walks: 68 paths" in results[0]["cdf"]["stdout"]


@pytest.mark.parametrize("name,error,match", [
    ("streaming", "ValueError", "--streaming is not supported in multi-host"),
    ("model_shards", "ValueError", "model_shards > 1 is single-process")])
def test_refusals_on_every_rank(two_ranks, name, error, match):
    """--streaming (as the JAX CLI) and model shards across processes (as
    the JAX trainer) are refused on every rank before the graph is read or
    an output made."""
    results, out, _ = two_ranks
    for r in range(2):
        got = results[r][name]["error"]
        assert got[0] == error and match in got[1], got
    assert not any((out / d).exists() for d in ("no1", "no3"))


def test_lanes_on_four_ranks(karate_path, tmp_path):
    """--lanes 2 on four ranks: 2 graph shards x 2 lanes, four parts
    merging to the JAX CLI's single-process /path."""
    refs = {}
    args = LANES + ["--input", karate_path]
    results = _spawn(4, {"lanes": {"argv": args + [
        "--lanes", "2", "--validate", "true", "--output",
        str(tmp_path / "mh")]}},
        lambda: refs.update(path=_jax_cli_path(args, tmp_path / "jax")))
    for r, res in enumerate(results):
        assert res["lanes"]["error"] is None, res["lanes"]
        assert f"walk invariants: ok (process {r})" in res["lanes"]["stdout"]
    assert sorted(os.listdir(tmp_path / "mh" / "path")) == [
        f"part-{i:05d}" for i in range(4)]
    assert _merged_path(tmp_path / "mh") == refs["path"]
