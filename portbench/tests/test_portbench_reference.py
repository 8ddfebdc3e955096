"""The plain reference against the port's CPU path at a tiny size: the
threefry streams, the walks of both samplers, the negatives' table and a
whole trainer job."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import graphgen, spec
from portbench.reference import graph as refgraph
from portbench.reference import prng as refprng
from portbench.reference import trainer as reftrainer
from portbench.reference import walks as refwalks
from stellar_rw_tpu_torch.graph.csr import from_edge_arrays
from stellar_rw_tpu_torch.models import word2vec
from stellar_rw_tpu_torch.ops import prng, sampling
from stellar_rw_tpu_torch.walk import engine

SEEDS = [0, 12345, 2**31 + 7, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_streams_equal_the_ports(seed):
    k, rk = prng.prng_key(seed), refprng.key(seed)
    assert torch.equal(k.to(torch.int64) & refprng.MASK32, rk)
    for d in (0, 1, 0x1A17, 2**31 + 5):
        assert torch.equal(prng.fold_in(k, d).to(torch.int64)
                           & refprng.MASK32, refprng.fold_in(rk, d))
    assert torch.equal(prng.uniform(k, (3, 50)), refprng.uniform(rk, (3, 50)))
    assert torch.equal(prng.randint(k, (4, 9), 1, 11),
                       refprng.randint(rk, (4, 9), 1, 11))


@pytest.mark.parametrize("n", [40, 5000])
def test_negatives_table_equals_the_ports(n):
    counts = np.random.default_rng(n).integers(0, 50, size=n).astype(
        np.float64)
    keep, alias = word2vec._negative_tables(counts, 0.75, "cpu")
    r_keep, r_alias = reftrainer.alias_table(counts, 0.75)
    assert np.array_equal(keep.numpy(), r_keep)
    assert np.array_equal(alias.numpy(), r_alias)


def _graph(V=200, E=1500, seed=11):
    src, dst = graphgen.power_law_arcs(V, E, seed)
    return (src, dst, from_edge_arrays(src, dst, num_vertices=V,
                                       symmetrize=True),
            refgraph.build(src, dst, V, True, "cpu"))


@pytest.mark.parametrize("p,q", [(0.25, 0.25), (1.0, 2.0), (4.0, 0.5)])
def test_rejection_walks_equal_the_ports(p, q):
    _, _, g, ref = _graph()
    V, L, R, seed = g.num_vertices, 7, 3, 2**33 + 17
    got = engine.random_walks(g, L, R, p, q, seed=seed, device="cpu")
    rows = np.arange(R * V)
    want = refwalks.replay(ref, "rejection", np.full(R * V, seed),
                           rows // V, rows % V, V, L, p, q)
    assert np.array_equal(got, want.numpy())


def test_cdf_walks_equal_the_ports(monkeypatch):
    monkeypatch.setattr(sampling, "CDF_PAD_LIMIT", 64)
    monkeypatch.setattr(refwalks, "CDF_PAD_LIMIT", 64)
    _, _, g, ref = _graph()
    V, L, R, seed, p, q = g.num_vertices, 7, 2, 2**32 + 9, 1 / 16, 4.0
    assert refwalks.uses_cdf(p, q)
    refwalks.check_cdf_exact(ref, p, q, R * V)
    got = engine.random_walks(g, L, R, p, q, seed=seed, device="cpu")
    rows = np.arange(R * V)
    want = refwalks.replay(ref, "cdf", np.full(R * V, seed), rows // V,
                           rows % V, V, L, p, q)
    assert np.array_equal(got, want.numpy())
    # the control's precision changes the walks
    low = refwalks.replay(ref, "cdf", np.full(R * V, seed), rows // V,
                          rows % V, V, L, p, q, torch.bfloat16)
    assert not np.array_equal(got, low.numpy())


def test_a_trainer_job_equals_the_ports():
    _, _, g, _ = _graph()
    V = g.num_vertices
    corpus = engine.random_walks(g, 6, 2, 0.25, 0.25, seed=5, device="cpu")
    cfg = word2vec.SGNSConfig(dim=16, window=3, negatives=2, lr=0.025,
                              iters=1, row_block=4, seed=2**31 + 3)
    got_in, got_out = word2vec.train_skipgram(corpus, V, cfg, device="cpu")
    corpus = torch.as_tensor(corpus)
    kw = dict(vocab=V, dim=16, window=3, k=2, row_block=4, seed=2**31 + 3)
    r_in, r_out, init = reftrainer.train(corpus, **kw)
    gaps = reftrainer.gaps(got_in, got_out, r_in, r_out, init)
    limits = spec.cell("blogcatalog.train_exact")["workload"]["check"][
        "limits"]
    assert all(v <= limits[k] for k, v in gaps.items()), gaps
    for wrong in ("tf32", "half"):
        w_in, w_out, _ = reftrainer.train(corpus, wrong=wrong, **kw)
        bad = reftrainer.gaps(w_in, w_out, r_in, r_out, init)
        assert any(v > limits[k] for k, v in bad.items()), (wrong, bad)
