"""The port's trainer and CLI end to end against the JAX package on karate:
one seeded epoch from the same init, /path byte for byte, /bin loading in
the JAX package, the karate quality gate, and the named errors for flags
the port does not serve. The port's side builds its graph with the port's
loader. JAX runs with x64 off."""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.graph import io
from stellar_rw_tpu.models import eval as ev
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.errors import NotPorted
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.models import eval as tev
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def karate(karate_path):
    """The port's graph, by the port's loader."""
    return tio.load_edge_list(karate_path, weighted=False, directed=False)


@pytest.fixture(scope="module")
def jkarate(karate_path):
    return io.load_edge_list(karate_path, weighted=False, directed=False)


@pytest.fixture(scope="module")
def karate_walks(karate):
    return engine.random_walks(karate, walk_length=20, num_walks=10, seed=2,
                               device="cpu")


@pytest.mark.parametrize("shared", [32, 0])
def test_one_epoch_matches_jax(karate, karate_walks, shared):
    """One epoch from the same init (the JAX package's own tables, handed
    over with params_from_numpy). Same pairs, windows and negatives bit for
    bit, so only the fp summation order of the scatter-adds differs:
    rtol 1e-4 / atol 1e-6."""
    V = karate.num_vertices
    rng = np.random.default_rng(0)
    init = ((rng.standard_normal((V, 16)) * 0.1).astype(np.float32),
            (rng.standard_normal((V, 16)) * 0.1).astype(np.float32))
    kw = dict(dim=16, window=4, negatives=5, lr=0.05, iters=1, seed=3,
              shared_negatives=shared)
    with jax.enable_x64(False):
        a_in, a_out = jw2v.train_skipgram(karate_walks, V,
                                          jw2v.SGNSConfig(**kw), init=init)
    b_in, b_out = w2v.train_skipgram(karate_walks, V, w2v.SGNSConfig(**kw),
                                     init=init, device="cpu")
    np.testing.assert_allclose(b_in, a_in, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b_out, a_out, rtol=1e-4, atol=1e-6)
    assert np.abs(b_in - init[0]).max() > 1e-3      # the epoch moved them


def test_fresh_init_and_epochs_match_jax(karate, karate_walks):
    """Two epochs from the seeded init (_init_embeddings' stream), with the
    per-epoch callback."""
    V = karate.num_vertices
    kw = dict(dim=8, window=3, negatives=3, lr=0.05, iters=2, seed=7,
              shared_negatives=16)
    with jax.enable_x64(False):
        a_in, _ = jw2v.train_skipgram(karate_walks, V, jw2v.SGNSConfig(**kw))
    seen = []
    b_in, _ = w2v.train_skipgram(karate_walks, V, w2v.SGNSConfig(**kw),
                                 device="cpu",
                                 on_epoch=lambda ep, wi, wo: seen.append(ep))
    assert seen == [0, 1]
    np.testing.assert_allclose(b_in, a_in, rtol=1e-4, atol=1e-6)


def test_params_from_numpy_roundtrip():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    a, b = w2v.params_from_numpy(w, -w, "cpu")
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    np.testing.assert_array_equal(a.numpy(), w)
    np.testing.assert_array_equal(b.numpy(), -w)
    a += 1                                   # a copy, not a view of w
    assert w[0, 0] == 0


def _flags(karate_path, out, cmd):
    return ["--input", karate_path, "--output", out, "--walkLength", "10",
            "--numWalks", "3", "--p", "0.5", "--q", "2", "--dim", "16",
            "--window", "3", "--iter", "2", "--validate", "true"] + cmd


@pytest.mark.parametrize("cmd", [["--cmd", "randomwalk"],
                                 ["--cmd", "node2vec", "--sharedNegatives",
                                  "32"]])
def test_cli_matches_jax_cli(karate_path, tmp_path, cmd):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with jax.enable_x64(False):
        assert jcli.main(_flags(karate_path, jout, cmd)) == 0
    report = {}
    assert cli.main(_flags(karate_path, tout, cmd), device="cpu",
                    report=report) == 0
    assert filecmp.cmp(os.path.join(jout, "path", "part-00000"),
                       os.path.join(tout, "path", "part-00000"),
                       shallow=False)
    assert report["invariants"] == {"bad_arcs": 0, "resurrected": 0,
                                    "out_of_range": 0}
    assert report["paths"] == 3 * 34
    if cmd[1] == "node2vec":
        tokens, w_in, w_out = jn2v.load_model(tout)      # the JAX loader
        jt, jw_in, _ = jn2v.load_model(jout)
        np.testing.assert_array_equal(tokens, jt)
        assert w_in.shape == (34, 16) and np.isfinite(w_in).all()
        np.testing.assert_allclose(w_in, jw_in, rtol=1e-4, atol=1e-6)
        t2, w2, _ = n2v.load_model(jout)                 # and the other way
        np.testing.assert_array_equal(w2, jw_in)
        assert os.path.exists(os.path.join(tout, "vec", "part-00000"))


def test_karate_quality_gate(karate):
    """The shared-negative gate of tests/test_word2vec.py on the port."""
    walks = engine.random_walks(karate, walk_length=20, num_walks=10, seed=2,
                                device="cpu")
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                         seed=1, shared_negatives=32)
    w_in, _ = w2v.train_skipgram(walks, karate.num_vertices, cfg,
                                 device="cpu")
    edges = [(v, int(d)) for v in range(karate.num_vertices)
             for d in karate.neighbors(v)[0] if v < int(d)]
    auc = tev.link_prediction_auc(w_in, np.asarray(edges),
                                  karate.num_vertices, seed=0)
    acc = tev.node_classification_accuracy(
        w_in, tev.karate_labels(karate.ids), seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)
    # the port's copy of the metrics is the JAX package's
    assert auc == ev.link_prediction_auc(w_in, np.asarray(edges),
                                         karate.num_vertices, seed=0)


def test_device_corpus_handoff(karate, jkarate):
    """as_numpy=False hands the trainer a tensor; same result as numpy."""
    walks = engine.random_walks(karate, walk_length=6, num_walks=2, seed=1,
                                as_numpy=False, device="cpu")
    assert torch.is_tensor(walks)
    cfg = w2v.SGNSConfig(dim=8, window=2, negatives=2, iters=1,
                         shared_negatives=8)
    a = w2v.train_skipgram(walks, 34, cfg, device="cpu")
    b = w2v.train_skipgram(walks.numpy(), 34, cfg, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    with jax.enable_x64(False):
        np.testing.assert_array_equal(
            walks.numpy(), jengine.random_walks(jkarate, walk_length=6,
                                                num_walks=2, seed=1,
                                                schedule="dynamic"))


@pytest.mark.parametrize("flags", [
    ["--cmd", "embedding", "--shards", "2"],
    ["--shards", "2"],
    ["--partitioned", "true"],
    ["--w2vPartitions", "2"],
    ["--w2vModelShards", "2"],
    ["--streaming", "true"],
    ["--sampler", "cdf"],
    ["--p", "0.01", "--q", "100"],
    ["--rngImpl", "rbg"],
    ["--rngImpl", "unsafe_rbg"],
    ["--checkpointEvery", "1"],
    ["--resume", "true"],
    ["--cmd", "randomwalk", "--checkpointEvery", "1"],
    ["--cmd", "randomwalk", "--resume", "true"],
    ["--cmd", "embedding", "--w2vPartitions", "2"],
    ["--profile", "/nonexistent/profile"],
])
def test_unserved_flags_raise(karate_path, tmp_path, flags):
    """Each flag value the port does not serve raises NotPorted before
    anything is written. The exact-CDF sampler (--sampler cdf, a p/q ratio
    above 32), the walk-round checkpoints (--checkpointEvery, --resume) and
    --shards / --partitioned (one walk shard on one device) are served:
    those cases run both CLIs and compare /path byte for byte and the
    trained tables to the trainer's tolerance (rtol 1e-4 / atol 1e-6, the
    scatter-adds' summation order)."""
    small = ["--walkLength", "6", "--numWalks", "2", "--dim", "8", "--iter",
             "1", "--window", "3", "--seed", "2"]
    argv = lambda out: ["--input", karate_path, "--output", str(out),
                        "--cmd", "node2vec"] + small + flags
    served = any(f in flags for f in ("--sampler", "--p", "--resume",
                                      "--checkpointEvery", "--shards",
                                      "--partitioned"))
    if not served:
        with pytest.raises(NotPorted):
            cli.main(argv(tmp_path / "o"), device="cpu")
        assert not os.path.exists(tmp_path / "o")
        return
    jout, tout = tmp_path / "jax", tmp_path / "port"
    with jax.enable_x64(False):
        assert jcli.main(argv(jout)) == 0
    assert cli.main(argv(tout), device="cpu") == 0
    if "embedding" not in flags:
        assert filecmp.cmp(jout / "path" / "part-00000",
                           tout / "path" / "part-00000", shallow=False)
    if "randomwalk" not in flags:
        for a, b in zip(jn2v.load_model(str(jout)),
                        n2v.load_model(str(tout))):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(shared_impl="pos", shared_negatives=8),
                                dict(shared_impl="band", shared_negatives=8),
                                dict(model_shards=2)])
def test_unported_trainer_forms_raise(kw):
    with pytest.raises(NotPorted):
        w2v.train_skipgram(np.zeros((2, 5), np.int32), 3,
                           w2v.SGNSConfig(dim=4, **kw), device="cpu")
    with pytest.raises(NotPorted):
        w2v.train_skipgram(np.zeros((2, 5), np.int32), 3,
                           w2v.SGNSConfig(dim=4), num_partitions=2,
                           device="cpu")


def test_cli_without_gpu_raises(karate_path, tmp_path, monkeypatch):
    """From the command line the device is CUDA; with none, a named error
    and no CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(cli.CudaUnavailable):
        cli.main(["--input", karate_path, "--output", str(tmp_path / "o"),
                  "--cmd", "randomwalk"])
    assert not os.path.exists(tmp_path / "o")
