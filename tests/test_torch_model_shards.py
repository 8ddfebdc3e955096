"""Dim-sharded tables (--w2vModelShards / SGNSConfig.model_shards) and
sgns_loss in the port, against the JAX package.

The JAX package shards both tables' columns over MP devices of a dp x mp
mesh and psums each dot's partial sums; the port trains the same function
on full rows on one device. Held here: the port's CLI against the JAX CLI
on conftest's CPU devices for node2vec and embedding, with and without
--w2vPartitions 2, exact and shared negatives (/path byte for byte, tables
rtol 1e-4 atol 1e-6); train_skipgram at P = 1 against JAX's, whose mesh
folds the epoch key by the dp index (so MP 2 differs from MP 1); the
refusals where JAX asserts; sgns_loss against JAX's at rtol 1e-6 and the
loss-falls probe of tests/test_word2vec.py on the port. JAX runs with x64
off.

At P = 1 and MP > 1 the JAX package's mesh branch does not trace under
this jax (0.9: its scan's carry turns varying over dp, since the key is
folded by the dp index and no psum over dp follows). Its reference there
is jax_one_slot_mesh: what that branch computes, the package's own
_train_epoch over the padded blocks with each epoch's key folded by dp
index 0 (the psum over mp being a dot's summation order). The JAX CLI runs
it in place of train_skipgram for that layout."""

import filecmp

import jax
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import prng
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)

SMALL = ["--walkLength", "6", "--numWalks", "2", "--dim", "8", "--iter",
         "1", "--window", "3", "--seed", "2", "--weighted", "false"]
LAYOUTS = {"mp2": ["--w2vModelShards", "2"],
           "dp2_mp2": ["--w2vPartitions", "2", "--w2vModelShards", "2"]}
NEGATIVES = {"exact": [], "shared8": ["--sharedNegatives", "8"]}


def jax_one_slot_mesh(corpus, vocab_size, cfg, counts=None,
                      num_partitions=1, init=None, start_epoch=0,
                      on_epoch=None):
    """jw2v.train_skipgram's mesh branch at P = 1 (stellar_rw_tpu/models/
    word2vec.py:578-666): its counts, alias table, init, block size and
    learning rates, and each epoch's _train_epoch with the key
    fold_in(epoch_key, 0) and the one-replica update (axis_name None)."""
    from stellar_rw_tpu.ops.alias import build_alias

    assert num_partitions == 1 and init is None and start_epoch == 0
    corpus = np.asarray(corpus)
    N, T = corpus.shape
    if counts is None:
        counts = np.bincount(corpus[corpus >= 0],
                             minlength=vocab_size).astype(np.float64)
    keep, alias = build_alias(np.maximum(counts, 1e-12) ** cfg.power)
    B = max(1, min(cfg.row_block, N))
    n_blocks = -(-N // B)
    padded = np.full((n_blocks * B, T), -1, dtype=np.int32)
    padded[:N] = corpus
    key = jax.random.PRNGKey(cfg.seed)
    w_in, w_out = jw2v._init_embeddings(vocab_size, cfg.dim,
                                        jax.random.fold_in(key, 0x1A17))
    lr_lo = cfg.lr * cfg.min_lr_frac
    for ep in range(cfg.iters):
        lr_s = cfg.lr + (lr_lo - cfg.lr) * ep / max(cfg.iters, 1)
        lr_e = cfg.lr + (lr_lo - cfg.lr) * (ep + 1) / max(cfg.iters, 1)
        w_in, w_out = jw2v._train_epoch(
            w_in, w_out, jax.numpy.asarray(padded.reshape(n_blocks, B, T)),
            jax.numpy.asarray(keep), jax.numpy.asarray(alias),
            jax.random.fold_in(jax.random.fold_in(key, ep), 0),
            np.float32(lr_s), np.float32(lr_e), cfg.window, cfg.negatives,
            shared_negatives=cfg.shared_negatives,
            shared_impl=cfg.shared_impl)
        if on_epoch is not None:
            on_epoch(ep, np.asarray(w_in), np.asarray(w_out))
    return np.asarray(w_in), np.asarray(w_out)


@pytest.fixture
def jax_mesh(monkeypatch):
    """The JAX package's trainer with jax_one_slot_mesh serving P = 1, MP
    > 1."""
    train = jw2v.train_skipgram

    def patched(corpus, vocab_size, cfg, counts=None, num_partitions=1,
                **kw):
        if num_partitions == 1 and cfg.model_shards > 1:
            return jax_one_slot_mesh(corpus, vocab_size, cfg, counts, **kw)
        return train(corpus, vocab_size, cfg, counts, num_partitions, **kw)

    monkeypatch.setattr(jw2v, "train_skipgram", patched)
    return train


@pytest.fixture(scope="module")
def karate(karate_path):
    return tio.load_edge_list(karate_path, weighted=False, directed=False)


@pytest.fixture(scope="module")
def walks_dir(karate_path, tmp_path_factory):
    """A karate /path for the embedding command, written by the port."""
    out = tmp_path_factory.mktemp("mp_walks")
    assert cli.main(["--cmd", "randomwalk", "--input", karate_path,
                     "--output", str(out)] + SMALL, device="cpu") == 0
    return str(out / "path")


@pytest.mark.parametrize("neg", list(NEGATIVES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("cmd", ["node2vec", "embedding"])
def test_cli_matches_jax_cli(karate_path, walks_dir, tmp_path, jax_mesh,
                             cmd, layout, neg):
    """The port's CLI against the JAX CLI (MP columns on MP of conftest's
    CPU devices): /path byte for byte, the tables at rtol 1e-4 atol 1e-6
    (the dots' summation order)."""
    source = karate_path if cmd == "node2vec" else walks_dir
    argv = lambda out: (["--cmd", cmd, "--input", source, "--output",
                         str(out)] + SMALL + LAYOUTS[layout]
                        + NEGATIVES[neg])
    jout, tout = tmp_path / "jax", tmp_path / "port"
    with jax.enable_x64(False):
        assert jcli.main(argv(jout)) == 0
    assert cli.main(argv(tout), device="cpu") == 0
    if cmd == "node2vec":
        assert filecmp.cmp(jout / "path" / "part-00000",
                           tout / "path" / "part-00000", shallow=False)
    jt, jw_in, jw_out = jn2v.load_model(str(jout))
    t, w_in, w_out = n2v.load_model(str(tout))
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(w_in, jw_in, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w_out, jw_out, rtol=1e-4, atol=1e-6)


def test_one_slot_mesh_fails_to_trace_in_jax(karate):
    """Why jax_one_slot_mesh stands in for the JAX package at P = 1, MP > 1:
    its mesh branch raises while tracing under this jax. (If a jax serves
    it again, this test fails and the reference can be the package's
    train_skipgram itself.)"""
    walks = np.zeros((4, 6), np.int32)
    with jax.enable_x64(False), pytest.raises(TypeError,
                                              match="varying manual axes"):
        jw2v.train_skipgram(walks, 3, jw2v.SGNSConfig(dim=4, iters=1,
                                                      model_shards=2))


@pytest.mark.parametrize("shared", [0, 16])
def test_train_skipgram_one_slot_takes_the_mesh_key(karate, shared):
    """At P = 1 and MP = 2 JAX's mesh folds the epoch key by dp index 0:
    the port matches that function there, and differs from MP = 1's
    one-device stream. At P = 2 both MP match the JAX package's
    train_skipgram itself."""
    walks = engine.random_walks(karate, walk_length=10, num_walks=3, seed=4,
                                device="cpu")
    V = karate.num_vertices
    kw = dict(dim=8, window=3, negatives=3, lr=0.5, iters=2, seed=7,
              shared_negatives=shared)
    with jax.enable_x64(False):
        want = jax_one_slot_mesh(walks, V,
                                 jw2v.SGNSConfig(**kw, model_shards=2))
    got = w2v.train_skipgram(walks, V, w2v.SGNSConfig(**kw, model_shards=2),
                             device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    one = w2v.train_skipgram(walks, V, w2v.SGNSConfig(**kw), device="cpu")
    assert np.abs(one[0] - got[0]).max() > 1e-3
    with jax.enable_x64(False):
        want = jw2v.train_skipgram(walks, V,
                                   jw2v.SGNSConfig(**kw, model_shards=2),
                                   num_partitions=2)
    got = w2v.train_skipgram(walks, V, w2v.SGNSConfig(**kw, model_shards=2),
                             num_partitions=2, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_model_shards_refusals():
    """dim % MP != 0 and MP > 1 in the multi-process trainer raise
    ValueError where JAX asserts, before any work."""
    corpus = np.zeros((4, 5), np.int32)
    with pytest.raises(ValueError, match="not divisible by model_shards=2"):
        w2v.train_skipgram(corpus, 3, w2v.SGNSConfig(dim=5, model_shards=2),
                           device="cpu")
    blocks, rows = w2v.full_corpus_blocks(corpus, 1)
    with pytest.raises(ValueError, match="single-process only"):
        w2v.train_skipgram_multiproc(
            blocks, rows, 3, w2v.SGNSConfig(dim=4, model_shards=2),
            device="cpu")


def test_cli_refuses_a_dim_the_shards_do_not_divide(karate_path, tmp_path):
    """Through the CLI the refusal comes before anything is written."""
    out = tmp_path / "o"
    with pytest.raises(ValueError, match="not divisible"):
        cli.main(["--cmd", "node2vec", "--input", karate_path, "--output",
                  str(out), "--dim", "5", "--w2vModelShards", "2"],
                 device="cpu")
    assert not out.exists()


@pytest.mark.parametrize("P,k,D,V", [(512, 4, 16, 34), (37, 1, 5, 10),
                                     (1000, 7, 64, 300)])
def test_sgns_loss_matches_jax(P, k, D, V):
    """sgns_loss against the JAX function on the same tables and pairs:
    rtol 1e-6, a 0-d tensor on the tables' device."""
    rng = np.random.default_rng(P)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    centers = rng.integers(0, V, P).astype(np.int32)
    contexts = rng.integers(0, V, P).astype(np.int32)
    negs = rng.integers(0, V, (P, k)).astype(np.int32)
    with jax.enable_x64(False):
        want = float(jw2v.sgns_loss(jax.numpy.asarray(w_in),
                                    jax.numpy.asarray(w_out), centers,
                                    contexts, negs))
    got = w2v.sgns_loss(torch.as_tensor(w_in), torch.as_tensor(w_out),
                        centers, torch.as_tensor(contexts), negs)
    assert got.dim() == 0 and got.device.type == "cpu"
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_loss_decreases(karate):
    """tests/test_word2vec.py's probe on the port: the loss of neighbor
    pairs against random negatives falls after ten epochs."""
    walks = engine.random_walks(karate, walk_length=10, num_walks=3, seed=0,
                                device="cpu")
    g = torch.Generator().manual_seed(9)
    centers = torch.randint(0, karate.num_vertices, (512,), generator=g)
    ctx = []
    for c in centers.tolist():
        cols, _ = karate.neighbors(c)
        ctx.append(int(cols[0]) if len(cols) else c)
    negs = torch.randint(0, karate.num_vertices, (512, 4), generator=g)
    probe = lambda w_in, w_out: float(w2v.sgns_loss(
        torch.as_tensor(w_in), torch.as_tensor(w_out), centers, ctx, negs))
    init = w2v._init_embeddings(karate.num_vertices, 16, prng.prng_key(0))
    loss0 = probe(*init)
    cfg = w2v.SGNSConfig(dim=16, window=4, negatives=4, lr=0.05, iters=10,
                         seed=0)
    loss1 = probe(*w2v.train_skipgram(walks, karate.num_vertices, cfg,
                                      device="cpu"))
    assert loss1 < loss0, (loss0, loss1)
