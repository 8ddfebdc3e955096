"""The port's streaming pipeline (`node2vec --streaming true`: one walk
round on the device at a time) and `--profile` against the JAX package on
karate: /path byte for byte against the JAX CLI's streamed run and the
port's stored run, the tables within the trainers' tolerance (rtol 1e-4 /
atol 1e-6: the same pairs, windows and negatives bit for bit, only the
scatter-adds' summation order differs), the streaming trainer against the
JAX function on a fixed corpus, the karate quality gate, and the flag
ignored outside node2vec as the JAX CLI ignores it. JAX runs with x64 off."""

import filecmp
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.utils import config as jconfig
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.models import eval as tev
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.utils import config

torch.set_num_threads(2)

SMALL = ["--walkLength", "6", "--numWalks", "3", "--dim", "8", "--iter",
         "2", "--window", "3", "--seed", "2", "--weighted", "false"]


def _argv(karate_path, out, *extra):
    return ["--cmd", "node2vec", "--input", karate_path, "--output",
            str(out)] + SMALL + list(extra)


def _same_file(a, b) -> bool:
    return filecmp.cmp(a / "path" / "part-00000", b / "path" / "part-00000",
                       shallow=False)


@pytest.mark.parametrize("trainer", [[], ["--sharedNegatives", "8"],
                                     ["--p", "0.0625", "--q", "4"]],
                         ids=["exact", "shared8", "cdf"])
def test_streaming_cli_matches_jax_and_stored(karate_path, tmp_path,
                                              trainer):
    """Exact negatives, shared negatives and the exact-CDF walks (a p/q
    ratio of 64): the streamed /path equals the JAX CLI's streamed one and
    the port's stored one byte for byte; the tables equal the JAX run's
    within the trainers' tolerance."""
    jout, tout, sout = tmp_path / "jax", tmp_path / "port", tmp_path / "st"
    with jax.enable_x64(False):
        assert jcli.main(_argv(karate_path, jout, "--streaming", "true",
                               *trainer)) == 0
    report = {}
    assert cli.main(_argv(karate_path, tout, "--streaming", "true",
                          *trainer), device="cpu", report=report) == 0
    assert cli.main(_argv(karate_path, sout, *trainer), device="cpu") == 0
    assert _same_file(jout, tout) and _same_file(sout, tout)
    ja, ta = jn2v.load_model(str(jout)), n2v.load_model(str(tout))
    np.testing.assert_array_equal(ta[0], ja[0])
    for a, b in zip(ja[1:], ta[1:]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    assert report["paths"] == 3 * 34 and report["steps"] > 0
    assert report["walk_seconds"] > 0 and report["train_seconds"] > 0


@pytest.mark.parametrize("flags", [["--w2vModelShards", "2"],
                                   ["--w2vPartitions", "2",
                                    "--w2vModelShards", "2",
                                    "--sharedNegatives", "8"]],
                         ids=["model_shards", "both_shared8"])
def test_streaming_ignores_the_trainer_mesh_flags(karate_path, tmp_path,
                                                  flags):
    """The JAX streamed trainer reads neither model_shards nor
    num_partitions: `--streaming true` with --w2vModelShards 2 (and
    --w2vPartitions 2) runs on the port as on the JAX CLI, /path byte for
    byte and the tables within the trainers' tolerance, and equal to the
    port's streamed run without the flags."""
    jout, tout, plain = tmp_path / "jax", tmp_path / "port", tmp_path / "p"
    trainer = flags[-2:] if "--sharedNegatives" in flags else []
    with jax.enable_x64(False):
        assert jcli.main(_argv(karate_path, jout, "--streaming", "true",
                               *flags)) == 0
    assert cli.main(_argv(karate_path, tout, "--streaming", "true", *flags),
                    device="cpu") == 0
    assert cli.main(_argv(karate_path, plain, "--streaming", "true",
                          *trainer), device="cpu") == 0
    assert _same_file(jout, tout) and _same_file(plain, tout)
    ja, ta = jn2v.load_model(str(jout)), n2v.load_model(str(tout))
    for a, b in zip(ja[1:], ta[1:]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    for a, b in zip(n2v.load_model(str(plain))[1:], ta[1:]):
        np.testing.assert_array_equal(b, a)


def test_run_node2vec_streaming_matches_jax(karate_path, tmp_path):
    """The library entry: tokens, tables and the walk stats of JAX
    run_node2vec_streaming, and the streamed rounds are the stored
    corpus's."""
    argv = ["--cmd", "node2vec", "--input", karate_path] + SMALL + [
        "--sharedNegatives", "8"]
    jp = jconfig.parse(argv + ["--output", str(tmp_path / "j")])
    tp = config.parse(argv + ["--output", str(tmp_path / "t")])
    jg = jio.load_edge_list(karate_path, weighted=False, directed=False)
    tg = tio.load_edge_list(karate_path, weighted=False, directed=False)
    with jax.enable_x64(False):
        jt, jw_in, jw_out, jstats = jn2v.run_node2vec_streaming(jg, jp)
    report = {}
    tt, tw_in, tw_out, tstats = n2v.run_node2vec_streaming(
        tg, tp, "cpu", report=report)
    assert tt == jt
    assert tstats.as_dict() == jstats.as_dict()
    np.testing.assert_allclose(tw_in, jw_in, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tw_out, jw_out, rtol=1e-4, atol=1e-6)
    assert set(report) == {"walk_seconds", "train_seconds"}
    stored = n2v.run_walks(tg, tp, "cpu").numpy()
    streamed = tio.load_walks(str(tmp_path / "t" / "path"))
    assert streamed == jio.load_walks(str(tmp_path / "j" / "path"))
    assert streamed == [[int(tg.ids[v]) for v in row if v >= 0]
                        for row in stored]


@pytest.mark.parametrize("shared", [0, 8])
def test_train_skipgram_streaming_matches_jax(shared):
    """train_skipgram_streaming against the JAX function: a make_round over
    a fixed corpus of 3 rounds of 37 rows (two blocks of 32, the last with
    27 pad rows), two epochs, so the per-slice learning rate and the round
    keys fold_in(fold_in(key, epoch), r) are both exercised."""
    rng = np.random.default_rng(5)
    V, W, T, R = 40, 37, 9, 3
    corpus = rng.integers(0, V, size=(R, W, T)).astype(np.int32)
    corpus[:, ::5, 6:] = -1                   # ragged rows
    counts = np.bincount(corpus[corpus >= 0], minlength=V).astype(np.float64)
    kw = dict(dim=8, window=3, negatives=4, lr=0.05, iters=2, seed=11,
              shared_negatives=shared)
    seen = []

    def make_round(r):       # the rounds the trainer asks for, in order
        seen.append(r)
        return torch.as_tensor(corpus[r])

    with jax.enable_x64(False):
        a_in, a_out = jw2v.train_skipgram_streaming(
            lambda r: jax.numpy.asarray(corpus[r]), R, (W, T), V,
            jw2v.SGNSConfig(**kw), counts)
    b_in, b_out = w2v.train_skipgram_streaming(
        make_round, R, (W, T), V, w2v.SGNSConfig(**kw), counts,
        device="cpu")
    assert seen == [r for ep in range(2) for r in range(R)]
    np.testing.assert_allclose(b_in, a_in, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b_out, a_out, rtol=1e-4, atol=1e-6)
    assert np.abs(b_out).max() > 1e-3          # the epochs moved them


def test_streaming_karate_quality_gate(karate_path, tmp_path):
    """tests/test_cli.py's streaming gate on the port: link AUC > 0.7 and
    faction accuracy >= 0.85 from a streamed run, /path equal to the stored
    run's."""
    args = ["--input", karate_path, "--walkLength", "20", "--numWalks",
            "10", "--weighted", "false", "--dim", "32", "--window", "5", "--iter", "20", "--lr", "0.2",
            "--seed", "2"]
    out_a, out_b = tmp_path / "stored", tmp_path / "stream"
    assert cli.main(args + ["--cmd", "randomwalk", "--output", str(out_a)],
                    device="cpu") == 0
    assert cli.main(args + ["--cmd", "node2vec", "--output", str(out_b),
                            "--streaming", "true"], device="cpu") == 0
    assert _same_file(out_a, out_b)
    _, w_in, _ = n2v.load_model(str(out_b))
    g = tio.load_edge_list(karate_path, weighted=False, directed=False)
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = tev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices,
                                  seed=0)
    acc = tev.node_classification_accuracy(w_in, tev.karate_labels(g.ids),
                                           seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


@pytest.mark.parametrize("cmd", ["randomwalk", "embedding"])
def test_streaming_flag_ignored_outside_node2vec(karate_path, tmp_path,
                                                 cmd):
    """The JAX CLI honours --streaming only under node2vec; under randomwalk
    and embedding it runs the stored path, and so does the port."""
    walks = tmp_path / "walks"
    with jax.enable_x64(False):
        assert jcli.main(["--cmd", "randomwalk", "--input", karate_path,
                          "--output", str(walks)] + SMALL) == 0
    inp = str(walks / "path") if cmd == "embedding" else karate_path
    argv = lambda out: ["--cmd", cmd, "--input", inp, "--output", str(out),
                        "--streaming", "true"] + SMALL
    jout, tout = tmp_path / "jax", tmp_path / "port"
    with jax.enable_x64(False):
        assert jcli.main(argv(jout)) == 0
    assert cli.main(argv(tout), device="cpu") == 0
    if cmd == "randomwalk":
        assert _same_file(jout, tout)
        assert not os.path.exists(tout / "bin")
    else:
        for a, b in zip(jn2v.load_model(str(jout)),
                        n2v.load_model(str(tout))):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


def test_profile_writes_a_trace(karate_path, tmp_path):
    """--profile DIR on the CPU: one torch.profiler trace in DIR that parses
    as JSON and holds the job's host events; /path is the unprofiled
    run's."""
    prof = tmp_path / "prof"
    assert cli.main(_argv(karate_path, tmp_path / "a", "--sharedNegatives",
                          "8", "--profile", str(prof)), device="cpu") == 0
    assert cli.main(_argv(karate_path, tmp_path / "b", "--sharedNegatives",
                          "8"), device="cpu") == 0
    assert _same_file(tmp_path / "a", tmp_path / "b")
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(prof)
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name")).startswith("aten::") for e in events)
