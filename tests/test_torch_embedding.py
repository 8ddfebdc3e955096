"""`--cmd embedding` of the port and its trainer checkpoints, on a karate
/path corpus written by the JAX package's CLI: the vocabulary in
corpus_from_ragged's order, one epoch's tables against the JAX package from
the same initial tables (rtol 1e-4 / atol 1e-6: the draws are equal bit for
bit, so only the fp summation order of the scatter-adds differs, as
tests/test_torch_pipeline.py states for node2vec), and --checkpointEvery /
--resume replaying an uninterrupted run exactly on the CPU. JAX runs with
x64 off."""

import os

import jax
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.graph import io
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.utils.config import parse

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def karate_corpus(karate_path, tmp_path_factory):
    """<out>/path of `--cmd randomwalk` by the JAX package's CLI."""
    out = str(tmp_path_factory.mktemp("walks"))
    with jax.enable_x64(False):
        assert jcli.main(["--cmd", "randomwalk", "--input", karate_path,
                          "--output", out, "--walkLength", "10", "--numWalks",
                          "3", "--p", "0.5", "--q", "2", "--seed", "4"]) == 0
    return os.path.join(out, "path")


class _Stopped(Exception):
    """Ends a training run from its epoch callback."""


def _flags(corpus, out, *extra):
    return ["--cmd", "embedding", "--input", corpus, "--output", out, "--dim",
            "16", "--window", "3", "--seed", "5", *extra]


@pytest.mark.parametrize("shared", ["0", "32"])
def test_embedding_cli_matches_jax_cli(karate_corpus, tmp_path, shared):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    extra = ["--iter", "2", "--sharedNegatives", shared]
    with jax.enable_x64(False):
        assert jcli.main(_flags(karate_corpus, jout, *extra)) == 0
    report = {}
    assert cli.main(_flags(karate_corpus, tout, *extra), device="cpu",
                    report=report) == 0
    assert report["paths"] == 3 * 34 and report["tokens"] == 3 * 34 * 12
    tokens, w_in, w_out = jn2v.load_model(tout)          # the JAX loader
    jt, jw_in, jw_out = jn2v.load_model(jout)
    np.testing.assert_array_equal(tokens, jt)            # same vocabulary
    assert w_in.shape == (34, 16) and np.isfinite(w_in).all()
    np.testing.assert_allclose(w_in, jw_in, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w_out, jw_out, rtol=1e-4, atol=1e-6)
    vec = os.path.join(tout, "vec", "part-00000")
    with open(vec) as f, open(os.path.join(jout, "vec", "part-00000")) as jf:
        ids = [ln.split("\t")[0] for ln in f]
        assert ids == [ln.split("\t")[0] for ln in jf]
        assert ids == [str(t) for t in tokens]
    assert not os.path.exists(os.path.join(tout, "path"))


def test_vocabulary_order_and_one_epoch_from_the_same_init(karate_corpus):
    """embed_ragged_corpus: the vocabulary is corpus_from_ragged's
    (descending frequency, str tie-break), and one epoch from the JAX
    package's own initial tables lands within rtol 1e-4 / atol 1e-6."""
    values, offsets = io.load_walks_ragged(karate_corpus)
    jvalues, joffsets = jio.load_walks_ragged(karate_corpus)
    np.testing.assert_array_equal(values, jvalues)
    np.testing.assert_array_equal(offsets, joffsets)
    corpus, vocab = w2v.corpus_from_ragged(values, offsets)
    jcorpus, jvocab = jw2v.corpus_from_ragged(jvalues, joffsets)
    assert vocab == jvocab
    np.testing.assert_array_equal(corpus, jcorpus)
    counts = np.bincount(corpus[corpus >= 0], minlength=len(vocab))
    assert (np.diff(counts) <= 0).all()                  # by frequency

    rng = np.random.default_rng(0)
    init = ((rng.standard_normal((34, 16)) * 0.1).astype(np.float32),
            (rng.standard_normal((34, 16)) * 0.1).astype(np.float32))
    kw = dict(dim=16, window=3, negatives=5, lr=0.05, iters=1, seed=5,
              shared_negatives=32)
    with jax.enable_x64(False):
        a_in, a_out = jw2v.train_skipgram(jcorpus, 34, jw2v.SGNSConfig(**kw),
                                          init=init)
    b_in, b_out = w2v.train_skipgram(corpus, 34, w2v.SGNSConfig(**kw),
                                     init=init, device="cpu")
    np.testing.assert_allclose(b_in, a_in, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b_out, a_out, rtol=1e-4, atol=1e-6)
    assert np.abs(b_in - init[0]).max() > 1e-3

    params = parse(_flags(karate_corpus, "unused", "--iter", "1",
                          "--sharedNegatives", "32", "--lr", "0.05"))
    params.output = None                                 # no checkpoint file
    tokens, w_in, _ = n2v.embed_ragged_corpus(values, offsets, params, "cpu")
    assert tokens == vocab and w_in.shape == (34, 16)
    lists = io.load_walks(karate_corpus)
    t2, w2, _ = n2v.embed_token_corpus(lists, params, "cpu")
    assert t2 == vocab
    np.testing.assert_array_equal(w2, w_in)


@pytest.mark.parametrize("shared", ["0", "32"])
def test_checkpoint_then_resume_replays_the_run(karate_corpus, tmp_path,
                                                shared):
    """--checkpointEvery 1 for two of four epochs, then --resume true to the
    end: exactly the uninterrupted run's tables (CPU, same order of sums)."""
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    sn = ["--sharedNegatives", shared]
    assert cli.main(_flags(karate_corpus, whole, "--iter", "4", *sn),
                    device="cpu") == 0
    assert not os.path.exists(n2v._checkpoint_path(whole))

    # the first two epochs of a four-epoch schedule, checkpointed
    values, offsets = io.load_walks_ragged(karate_corpus)
    corpus, vocab = w2v.corpus_from_ragged(values, offsets)
    params = parse(_flags(karate_corpus, parts, "--iter", "4",
                          "--checkpointEvery", "1", *sn))
    saved = []
    ckpt = n2v._checkpoint_path(parts)
    os.makedirs(os.path.dirname(ckpt))

    def stop_after_two(ep, w_in, w_out):
        np.savez(ckpt, w_in=w_in, w_out=w_out, epoch=ep)
        saved.append(ep)
        if ep == 1:
            raise _Stopped

    with pytest.raises(_Stopped):
        w2v.train_skipgram(corpus, len(vocab), n2v.sgns_config(params),
                           on_epoch=stop_after_two, device="cpu")
    assert saved == [0, 1] and int(np.load(ckpt)["epoch"]) == 1

    assert cli.main(_flags(karate_corpus, parts, "--iter", "4", "--resume",
                           "true", "--checkpointEvery", "1", *sn),
                    device="cpu") == 0
    assert int(np.load(ckpt)["epoch"]) == 3              # kept checkpointing
    for a, b in zip(n2v.load_model(whole), n2v.load_model(parts)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_every_writes_the_jax_packages_file(karate_corpus,
                                                       tmp_path):
    """The checkpoint is <output>/bin/checkpoint.npz with w_in, w_out and
    epoch: the file the JAX package resumes from."""
    out = str(tmp_path / "o")
    assert cli.main(_flags(karate_corpus, out, "--iter", "3",
                           "--checkpointEvery", "2"), device="cpu") == 0
    assert n2v._checkpoint_path(out) == jn2v._checkpoint_path(out)
    z = np.load(n2v._checkpoint_path(out))
    assert sorted(z.files) == ["epoch", "w_in", "w_out"]
    assert int(z["epoch"]) == 1 and z["w_in"].shape == (34, 16)
    # --resume with no checkpoint starts from the beginning
    out2 = str(tmp_path / "o2")
    assert cli.main(_flags(karate_corpus, out2, "--iter", "1", "--resume",
                           "true"), device="cpu") == 0
    assert os.path.exists(os.path.join(out2, "bin", "model.npz"))


@pytest.mark.parametrize("cmd", ["randomwalk", "node2vec"])
@pytest.mark.parametrize("flag", [["--checkpointEvery", "1"],
                                  ["--resume", "true"]])
def test_walk_round_checkpoints_stay_unported(karate_path, tmp_path, cmd,
                                              flag):
    """With walks the two flags also mean the walk rounds' checkpoint files,
    which the port now writes in the JAX package's layout
    (tests/test_torch_walk_ckpt.py): /path byte for byte with the JAX CLI,
    and the round files too where --checkpointEvery asks for them."""
    small = ["--walkLength", "5", "--numWalks", "2", "--dim", "8", "--iter",
             "1", "--window", "2"]
    outs = {w: tmp_path / w for w in ("jax", "port")}
    argv = lambda out: ["--cmd", cmd, "--input", karate_path, "--output",
                        str(out), *small, *flag]
    with jax.enable_x64(False):
        assert jcli.main(argv(outs["jax"])) == 0
    assert cli.main(argv(outs["port"]), device="cpu") == 0
    subs = ["path/part-00000"]
    if "--checkpointEvery" in flag:
        subs += ["bin/walk_rounds/round-00001.npy",
                 "bin/walk_rounds/marker.json"]
    else:
        assert not os.path.exists(outs["port"] / "bin" / "walk_rounds")
    for sub in subs:
        assert (outs["jax"] / sub).read_bytes() == \
            (outs["port"] / sub).read_bytes(), sub


def test_run_walks_refuses_checkpoint_params(karate_path, tmp_path):
    """run_walks with --checkpointEvery and an output goes through the walk
    rounds' checkpoints and hands the corpus over on the device: the JAX
    package's run_walks corpus, bit for bit."""
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    jg = jio.load_edge_list(karate_path, weighted=False, directed=False)
    argv = ["--cmd", "randomwalk", "--input", karate_path, "--output",
            str(tmp_path / "o"), "--checkpointEvery", "1", "--walkLength",
            "5", "--numWalks", "2"]
    walks = n2v.run_walks(g, parse(argv), "cpu")
    assert isinstance(walks, torch.Tensor)
    with jax.enable_x64(False):
        want = jn2v.run_walks(jg, parse(argv[:5] + [str(tmp_path / "j")]
                                        + argv[6:]))
    np.testing.assert_array_equal(walks.numpy(), np.asarray(want))
    assert os.path.exists(tmp_path / "o" / "bin" / "walk_rounds" /
                          "round-00001.npy")
