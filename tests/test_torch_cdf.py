"""The port's exact-CDF samplers and walks (stellar_rw_tpu_torch) against the
JAX package: the float64 uniform, the plain samplers padded and chunked in
f32 and f64, corpora of random_walks(sampler="cdf") bit for bit, the
float64 oracle, two chi-square tests, the plan, batching, and the kernel
wrapper without a build.

Bit for bit where the JAX package's sums are reproducible: every partial
sum exact (unit or dyadic weights; p, q in {0.25, 1, 4}), or padded rows of
at most 17 entries, where XLA's CPU cumsum and sum run left to right as the
port's padded form does (test_xla_prefix_order_on_karate_rows). The chunked
form is forced by setting CDF_PAD_LIMIT and CDF_CHUNK in both packages'
modules. JAX runs with x64 off except for the float64 cases."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.graph import csr as jcsr
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.ops import sampling as jsampling
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu.walk import oracle
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.graph import csr as tcsr
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.ops import _build, cdf_walk, prng, sampling
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)

PQ = [(0.25, 0.25), (0.25, 1.0), (0.25, 4.0), (1.0, 0.25), (1.0, 1.0),
      (1.0, 4.0), (4.0, 0.25), (4.0, 1.0), (4.0, 4.0)]

# a self-loop and a multi self-edge (tests/test_engine.py:93-104)
MULTI = {0: [(0, 1.0), (1, 1.0)], 1: [(0, 1.0), (1, 1.0), (1, 1.0)]}
# dyadic weights: every biased partial sum is exact in f32
DYADIC = {0: [(1, 0.5), (2, 2.0), (3, 1.0)],
          1: [(0, 0.5), (2, 0.25), (4, 4.0), (5, 1.5)],
          2: [(0, 2.0), (1, 0.25), (3, 0.75), (5, 1.0)],
          3: [(0, 1.0), (2, 0.75), (4, 2.5)],
          4: [(1, 4.0), (3, 2.5), (5, 0.125)],
          5: [(1, 1.5), (2, 1.0), (4, 0.125)]}


def _graphs(name, karate_path, testgraph_path):
    """(the JAX package's graph, the port's) by each package's own loader."""
    if name == "karate":
        kw = dict(weighted=False, directed=False)
        return (jio.load_edge_list(karate_path, **kw),
                tio.load_edge_list(karate_path, **kw))
    if name == "testgraph":
        kw = dict(weighted=False, directed=True)
        return (jio.load_edge_list(testgraph_path, **kw),
                tio.load_edge_list(testgraph_path, **kw))
    adj = MULTI if name == "multi" else DYADIC
    return jcsr.from_adjacency(adj), tcsr.from_adjacency(adj)


def _chunked(monkeypatch, chunk=4):
    for mod in (jsampling, sampling):
        monkeypatch.setattr(mod, "CDF_PAD_LIMIT", 1)
        monkeypatch.setattr(mod, "CDF_CHUNK", chunk)


@pytest.mark.parametrize("seed", [0, 3, 2**40 + 7])
def test_float64_uniform_bitwise(seed):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    want = np.asarray(jax.random.uniform(k, (1000,), dtype=jnp.float64))
    tk = torch.as_tensor(np.asarray(jax.random.key_data(k)).astype(np.int64))
    got = prng.uniform_f64_at(tk, torch.arange(1000))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_xla_prefix_order_on_karate_rows(karate_path):
    """XLA's CPU cumsum and sum of karate's padded rows (17 entries) run left
    to right: the padded form's normalized prefix reproduces them exactly,
    on any weights. (Beyond 17 entries XLA cumsums in blocks of 16.)"""
    g = jio.load_edge_list(karate_path, weighted=False, directed=False)
    assert g.max_degree == 17
    x = np.random.default_rng(0).random((64, 17)).astype(np.float32)
    with jax.enable_x64(False):
        total = np.asarray(jnp.sum(jnp.asarray(x), axis=-1))
        c = np.asarray(jnp.cumsum(jnp.asarray(x) / total[:, None], axis=-1))
    seq_t = np.zeros(64, np.float32)
    for j in range(17):
        seq_t = (seq_t + x[:, j]).astype(np.float32)
    np.testing.assert_array_equal(seq_t, total)
    seq = np.zeros(64, np.float32)
    for j in range(17):
        seq = (seq + (x[:, j] / seq_t).astype(np.float32)).astype(np.float32)
        np.testing.assert_array_equal(seq, c[:, j])


@pytest.mark.parametrize("form", ["padded", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_samplers_match_jax(karate_path, testgraph_path, form, dtype):
    """Each sampler on its own, karate rows from random (cur, prev), u from
    numpy in the accumulation type."""
    jg, tg = _graphs("karate", karate_path, testgraph_path)
    rng = np.random.default_rng(1)
    W = 200
    cur = rng.integers(0, tg.num_vertices, W).astype(np.int32)
    nbr = [tg.cols[tg.offsets[c]:tg.offsets[c + 1]] for c in cur]
    prev = np.array([n[rng.integers(len(n))] if rng.random() < 0.7
                     else rng.integers(tg.num_vertices) for n in nbr],
                    dtype=np.int32)
    u = rng.random(W).astype(dtype)
    dg = sampling.device_put_graph(tg, "cpu", cdf=True)
    tc, tp, tu = (torch.as_tensor(a) for a in (cur, prev, u))
    md = tg.max_degree
    with jax.enable_x64(dtype == "float64"):
        jdg = jsampling.device_put_graph(jg)
        jc, jp, ju = (jnp.asarray(a) for a in (cur, prev, u))
        jdt = jnp.dtype(dtype)
        for p, q in ((0.25, 4.0), (1.0, 1.0), (4.0, 0.25)):
            if form == "padded":
                want1 = jsampling.cdf_sample_first_order(jdg, jc, ju, md, jdt)
                want2 = jsampling.cdf_sample_second_order(
                    jdg, jc, jp, jp, ju, p, q, md, dtype=jdt)
                got1 = sampling.cdf_sample_first_order(dg, tc, tu, md, dtype)
                got2 = sampling.cdf_sample_second_order(
                    dg, tc, tp, tp, tu, p, q, md, dtype)
            else:
                want1 = jsampling.cdf_sample_first_order_chunked(
                    jdg, jc, ju, 5, jdt)
                want2 = jsampling.cdf_sample_second_order_chunked(
                    jdg, jc, jp, jp, ju, p, q, 5, jdt)
                got1 = sampling.cdf_sample_first_order_chunked(
                    dg, tc, tu, 5, dtype)
                got2 = sampling.cdf_sample_second_order_chunked(
                    dg, tc, tp, tp, tu, p, q, 5, dtype)
            np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
            np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


CORPUS_CASES = (
    [("karate", "padded", pq) for pq in PQ]
    + [("karate", "chunked", pq) for pq in ((0.25, 4.0), (1.0, 1.0),
                                            (4.0, 0.25))]
    + [(name, form, (0.25, 4.0)) for name in ("testgraph", "multi")
       for form in ("padded", "chunked")]
    + [("dyadic", "padded", pq) for pq in ((0.25, 1.0), (1.0, 4.0),
                                           (4.0, 4.0))]
    + [("dyadic", "chunked", pq) for pq in ((0.25, 4.0), (4.0, 0.25))])


@pytest.mark.parametrize("name,form,pq", CORPUS_CASES)
def test_corpus_bitwise(karate_path, testgraph_path, monkeypatch, name, form,
                        pq):
    jg, tg = _graphs(name, karate_path, testgraph_path)
    if form == "chunked":
        _chunked(monkeypatch, chunk=3 if name == "dyadic" else 4)
    p, q = pq
    kw = dict(walk_length=9, num_walks=3, p=p, q=q, seed=4, sampler="cdf")
    with jax.enable_x64(False):
        want = jengine.random_walks(jg, **kw)
    got = engine.random_walks(tg, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    if name == "testgraph":
        assert (got == -1).any()                      # the dead end


@pytest.mark.parametrize("flags", [["--sampler", "cdf"],
                                   ["--p", "0.01", "--q", "1"]])
def test_cli_randomwalk_path_equals_jax_cli(karate_path, tmp_path, flags):
    """The CLI with the exact-CDF sampler (asked for, or planned for a p/q
    ratio of 100): /path byte for byte with the JAX package's CLI."""
    argv = lambda out: ["--cmd", "randomwalk", "--input", karate_path,
                        "--output", str(out), "--walkLength", "12",
                        "--numWalks", "3", "--seed", "7", *flags]
    with jax.enable_x64(False):
        assert jcli.main(argv(tmp_path / "jax")) == 0
    assert cli.main(argv(tmp_path / "port"), device="cpu") == 0
    assert filecmp.cmp(os.path.join(tmp_path, "jax", "path", "part-00000"),
                       os.path.join(tmp_path, "port", "path", "part-00000"),
                       shallow=False)


@pytest.mark.parametrize("p,q,walk_length,directed", [
    (1.0, 1.0, 1, False), (0.25, 0.25, 12, False), (4.0, 0.5, 12, False),
    (0.5, 2.0, 30, True)])
def test_float64_matches_oracle_elementwise(karate_path, p, q, walk_length,
                                            directed):
    """tests/test_engine.py's oracle test through the port's random_walks in
    float64: round 0 draws under fold_in(PRNGKey(seed), 0)."""
    g = tio.load_edge_list(karate_path, weighted=False, directed=directed)
    jg = jio.load_edge_list(karate_path, weighted=False, directed=directed)
    seed = 3
    paths = engine.random_walks(g, walk_length=walk_length, num_walks=1, p=p,
                                q=q, seed=seed, sampler="cdf",
                                dtype="float64", device="cpu")
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    us = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, t), (g.num_vertices,), dtype=jnp.float64))
        for t in range(walk_length + 1)])
    for w in range(g.num_vertices):
        expect = oracle.oracle_walk(jg, w, walk_length, p, q, us[:, w])
        np.testing.assert_array_equal(paths[w][paths[w] >= 0], expect)


def _transition_chi2(g, jg, walks, p, q, n_vertices):
    assert np.all(walks[:, 1] == 1)
    M = walks.shape[0]
    expected = oracle.exact_transition_probs(jg, 0, 1, p, q)
    freq = np.bincount(walks[:, 2], minlength=n_vertices) / M
    for v, pr in expected.items():
        se = np.sqrt(pr * (1 - pr) / M)
        assert abs(freq[v] - pr) < max(5 * se, 2e-3), (v, freq[v], pr)


def test_extreme_pq_distribution_via_engine():
    """tests/test_sampling.py's p = q = 100 case: plan_sampler sends it to
    the exact CDF; the transitions from (0, 1) follow the exact biased
    probabilities."""
    adj = {0: [(1, 1.0)], 1: [(0, 1.0), (2, 1.0), (3, 1.0), (4, 1.0)],
           2: [(1, 1.0), (0, 1.0)], 3: [(1, 1.0)], 4: [(1, 1.0)]}
    g, jg = tcsr.from_adjacency(adj), jcsr.from_adjacency(adj)
    M = 20000
    walks = engine.random_walks(g, walk_length=1, num_walks=1, p=100.0,
                                q=100.0, seed=3, sampler="rejection",
                                starts=np.zeros(M, np.int32), device="cpu")
    _transition_chi2(g, jg, walks, 100.0, 100.0, 5)


def test_cdf_chunked_distribution(monkeypatch):
    """tests/test_sampling.py's chunked case: non-dyadic weights, rows over
    several chunks."""
    _chunked(monkeypatch, chunk=3)
    adj = {0: [(1, 1.0)],
           1: [(0, 1.0), (2, 2.0), (3, 1.0), (4, 0.5), (5, 1.5)],
           2: [(1, 1.0), (0, 1.0)], 3: [(1, 1.0)], 4: [(1, 1.0)],
           5: [(1, 1.0), (0, 2.0)]}
    g, jg = tcsr.from_adjacency(adj), jcsr.from_adjacency(adj)
    M = 20000
    walks = engine.random_walks(g, walk_length=1, num_walks=1, p=100.0,
                                q=100.0, seed=3, starts=np.zeros(M, np.int32),
                                device="cpu")
    _transition_chi2(g, jg, walks, 100.0, 100.0, 6)


@pytest.mark.parametrize("pq,want", [((0.01, 1.0), "cdf"),
                                     ((100.0, 100.0), "cdf"),
                                     ((0.25, 4.0), "rejection")])
def test_plan_sampler_routes_like_jax(pq, want):
    assert sampling.plan_sampler("rejection", *pq) == \
        jsampling.plan_sampler("rejection", *pq)
    assert sampling.plan_sampler("rejection", *pq)[0] == want
    assert sampling.plan_cdf_chunk_corpus(10, 10_000, 39_303) == \
        jsampling.plan_cdf_chunk_corpus(10, 10_000, 39_303) == 256
    assert sampling.plan_cdf_chunk_corpus(10, 34, 17) == 0


@pytest.mark.parametrize("form", ["padded", "chunked"])
def test_batch_split_same_corpus(karate_path, monkeypatch, form):
    """max_batch_walkers splits the rounds over dispatches; the form comes
    from the whole corpus, so the corpus is the same."""
    if form == "chunked":
        _chunked(monkeypatch)
    g = tio.load_edge_list(karate_path, weighted=False, directed=False)
    kw = dict(walk_length=7, num_walks=5, p=0.01, q=1.0, seed=8,
              device="cpu")
    whole = engine.random_walks(g, **kw)
    split = engine.random_walks(g, max_batch_walkers=40, **kw)
    np.testing.assert_array_equal(whole, split)
    starts = np.arange(g.num_vertices, dtype=np.int32)
    spec = engine.walk_spec(g, 7, 5, 0.01, 1.0, "cdf", 16, "float32",
                            len(starts))
    assert spec.cdf_chunk == (4 if form == "chunked" else 0)


def test_cdf_kernel_wrapper_raises_without_a_build(karate_path, monkeypatch,
                                                   tmp_path):
    """A tensor off the CPU goes to the kernel or raises: with no compiler
    the build fails loudly, and nothing falls back to the plain version."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cdf_walk.CDF_WALK_KERNEL, "_fn", None)
    g = tio.load_edge_list(karate_path, weighted=False, directed=False)
    dg = sampling.device_put_graph(g, "cpu", cdf=True)
    meta = sampling.DeviceGraph(*(t.to("meta") for t in dg))
    starts = torch.arange(g.num_vertices, dtype=torch.int32, device="meta")
    before = cdf_walk.CDF_WALK_KERNEL.launches
    with pytest.raises(_build.KernelBuildError):
        cdf_walk.cdf_walk_rounds(meta, starts, prng.prng_key(0), 0, 1, 4,
                                 0.5, 2.0, 17, 0)
    assert cdf_walk.CDF_WALK_KERNEL.launches == before
    with pytest.raises(ValueError, match="cdf_rows"):
        cdf_walk.cdf_walk_rounds(
            sampling.device_put_graph(g, "cpu"),
            torch.arange(g.num_vertices, dtype=torch.int32),
            prng.prng_key(0), 0, 1, 4, 0.5, 2.0, 17, 0)


def _ks(v: np.ndarray) -> np.ndarray:
    """A piece's inclusive Kogge-Stone scan over the lanes (shfl_up by o)."""
    lanes, o = np.arange(32), 1
    while o < 32:
        v = np.where(lanes >= o, v + np.roll(v, o), v).astype(v.dtype)
        o *= 2
    return v


def _warp_pick(b: np.ndarray, u: np.float32, chunked: bool) -> int:
    """csrc/cdf_walk.cu's pick() for one walker, transcribed lane by lane in
    f32: the index of the picked entry, or -1 for the row head. Chunked:
    the lane sums and their butterfly, then the find loop (each piece's
    scan added to the sum before it, the ballot's first lane)."""
    d, lanes = len(b), np.arange(32)
    f32 = np.float32
    if chunked:
        acc = np.zeros(32, f32)
        for i in range(d):                     # lane i % 32 adds entry i
            acc[i % 32] = f32(acc[i % 32] + b[i])
        off = 16
        while off:                             # the xor butterfly
            acc = (acc + acc[lanes ^ off]).astype(f32)
            off //= 2
        thresh, cum = f32(u * acc[0]), f32(0)
        for base in range(0, d, 32):
            v = np.zeros(32, f32)
            v[:min(32, d - base)] = b[base:base + 32]
            c = (cum + _ks(v)).astype(f32)
            hit = np.flatnonzero((base + lanes < d) & (c >= thresh))
            if len(hit):
                return base + int(hit[0])
            cum = c[31]
        return -1
    total = f32(0)
    for x in b:                                # the serial broadcast
        total = f32(total + x)
    div = total if total > 0 else f32(1)
    c = f32(0)
    for i, x in enumerate(b):
        c = f32(c + f32(x / div))
        if c >= u:
            return i
    return -1


@pytest.mark.parametrize("chunked", [False, True])
def test_kernel_pick_transcription_equals_plain(chunked):
    """The kernel's lane-by-lane order, transcribed, picks what the plain
    samplers pick, on rows around a warp's width and of many pieces, with
    arbitrary f32 weights: the two share one summation order, so they agree
    bit for bit on any input (the card checks the kernel itself:
    chip_smoke.py phases 9-10)."""
    rng = np.random.default_rng(5)
    for d in (1, 5, 31, 32, 33, 100, 257, 2000):
        w = (rng.random(d) * 3 + 0.01).astype(np.float32)
        g = tcsr.from_adjacency({0: [(i + 1, float(x)) for i, x in
                                     enumerate(w)],
                                 **{i + 1: [(0, 1.0)] for i in range(d)}})
        dg = sampling.device_put_graph(g, "cpu", cdf=True)
        u = rng.random(60).astype(np.float32)
        u[:3] = (0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5)
        rows = torch.zeros(60, dtype=torch.int32)
        if chunked:
            got = sampling.cdf_sample_first_order_chunked(
                dg, rows, torch.as_tensor(u), sampling.CDF_CHUNK)
        else:
            got = sampling.cdf_sample_first_order(dg, rows, torch.as_tensor(u),
                                                  d)
        cols = g.cols[g.offsets[0]:g.offsets[1]]
        w_row = g.weights[g.offsets[0]:g.offsets[1]].astype(np.float32)
        for i in range(60):
            j = _warp_pick(w_row, u[i], chunked)
            assert got[i].item() == cols[max(j, 0)], (d, i)


def test_kernel_pick_finds_a_crossing_inside_a_piece():
    """A piece's scan need not grow over its lanes: with weights 1, 2^-24,
    2^-24 and zeros, lane 2 holds 1 + 2^-23 and lane 31 holds 1. A thresh
    between the two crosses inside the first piece, below the sum after it:
    a search over the sums after each piece would pass it by; the find loop
    stops there, as the plain sampler does."""
    b = np.zeros(96, np.float32)
    b[:3] = (1.0, 2.0 ** -24, 2.0 ** -24)
    b[32:] = 1.0
    x = _ks(b[:32].copy())
    assert x[2] == np.float32(1 + 2.0 ** -23) and x[31] == np.float32(1)
    total = np.float32(65)
    u = np.float32(np.float32(1 + 2.0 ** -23) / total)
    while np.float32(u * total) > np.float32(1 + 2.0 ** -23):
        u = np.nextafter(u, np.float32(0))
    assert np.float32(1) < np.float32(u * total)
    g = tcsr.from_adjacency({0: [(i + 1, float(x)) for i, x in enumerate(b)],
                             **{i + 1: [(0, 1.0)] for i in range(96)}})
    dg = sampling.device_put_graph(g, "cpu", cdf=True)
    w_row = g.weights[g.offsets[0]:g.offsets[1]].astype(np.float32)
    np.testing.assert_array_equal(w_row, b)
    got = sampling.cdf_sample_first_order_chunked(
        dg, torch.zeros(1, dtype=torch.int32), torch.as_tensor([u]),
        sampling.CDF_CHUNK)
    assert _warp_pick(w_row, u, True) == 2
    assert got.item() == g.cols[g.offsets[0] + 2]
