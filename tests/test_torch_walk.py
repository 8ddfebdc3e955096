"""The port's walk tables and engine (stellar_rw_tpu_torch) against the JAX
package on karate: host tables array for array, corpora bit for bit over the
p, q grid, invariant counters, and the errors for what is not ported.

JAX runs with x64 off (the production streams). The p, q grid holds the
port against the JAX package's dynamic schedule, which compiles in a second
or two; the static schedule, bitwise equal to it wherever it does not
overflow (tests/test_static_schedule.py), is held directly in one case here
and on the synth graph in tests/test_torch_walk_graphs.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.graph import io
from stellar_rw_tpu.ops import sampling as jsampling
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.errors import NotPorted
from stellar_rw_tpu_torch.graph import csr as tcsr
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.ops import _build, prng, sampling, walk_step
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)

PQ = [0.25, 1.0, 4.0]


@pytest.fixture(scope="module")
def karate(karate_path):
    """The port's graph, by the port's loader."""
    return tio.load_edge_list(karate_path, weighted=False, directed=False)


@pytest.fixture(scope="module")
def jkarate(karate_path):
    """The JAX package's graph, by its loader."""
    return io.load_edge_list(karate_path, weighted=False, directed=False)


def _jax_walks(g, **kw):
    with jax.enable_x64(False):
        return jengine.random_walks(g, **kw)


def test_host_tables_equal_jax_package(karate):
    karate.build_alias_tables()
    args = (karate.offsets, karate.cols, karate.alias_prob, karate.alias_pos)
    got = sampling.pack_tables_host(*args)
    want = jsampling.pack_tables_host(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sampling.vmeta_host(got[0], got[2]),
                                  jsampling.vmeta_host(want[0], want[2]))
    for a, b in zip(sampling.bucket_tables_host(karate.offsets, karate.cols),
                    jsampling.bucket_tables_host(karate.offsets, karate.cols)):
        np.testing.assert_array_equal(a, b)


def test_constants_equal_jax_package():
    assert sampling.BUCKET_SLOTS == jsampling.BUCKET_SLOTS
    assert sampling.HASH_MULT == jsampling.HASH_MULT
    assert sampling.DRAW_QUANTUM == jsampling.DRAW_QUANTUM
    assert walk_step.DENSE_TRIALS == jsampling.DENSE_TRIALS
    for n in (0, 1, 8191, 8192, 100_000):
        assert sampling.draw_width(n) == jsampling.draw_width(n)
    for d in (0, 1, 5, 1023, 1024):
        assert sampling.search_iters(d) == jsampling.search_iters(d)
    for p in (0.01, 0.25, 1.0, 4.0, 100.0):
        for q in (0.01, 0.25, 1.0, 4.0, 100.0):
            for s in ("rejection", "cdf"):
                assert sampling.plan_sampler(s, p, q) == \
                    jsampling.plan_sampler(s, p, q)


def test_device_tables_bitwise_equal(karate, jkarate):
    dg = sampling.device_put_graph(karate, "cpu")
    with jax.enable_x64(False):
        jg = jsampling.device_put_graph(jkarate)
    np.testing.assert_array_equal(dg.alias_packed.numpy(),
                                  np.asarray(jg.alias_packed))
    np.testing.assert_array_equal(dg.hash_buckets.numpy(),
                                  np.asarray(jg.hash_buckets))
    np.testing.assert_array_equal(dg.vmeta.numpy(), np.asarray(jg.vmeta))
    np.testing.assert_array_equal(dg.offsets.numpy(),
                                  np.asarray(jg.offsets).astype(np.int64))


@pytest.mark.parametrize("p", PQ)
@pytest.mark.parametrize("q", PQ)
def test_karate_corpus_bitwise(karate, jkarate, p, q):
    kw = dict(walk_length=12, num_walks=3, p=p, q=q, seed=3)
    want = _jax_walks(jkarate, schedule="dynamic", **kw)
    got = engine.random_walks(karate, device="cpu", **kw)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_karate_corpus_bitwise_static_schedule(karate, jkarate):
    kw = dict(walk_length=12, num_walks=3, p=0.25, q=0.25, seed=5)
    np.testing.assert_array_equal(
        engine.random_walks(karate, device="cpu", **kw),
        _jax_walks(jkarate, **kw))


def test_trial_keys_follow_the_jax_chain():
    keys = walk_step.trial_keys(prng.prng_key(3), 2, 2, 4, 5)
    with jax.enable_x64(False):
        base = jax.random.PRNGKey(3)
        for r in range(2):
            for t in range(5):
                for j in range(5):
                    k = jax.random.fold_in(jax.random.fold_in(
                        jax.random.fold_in(base, 2 + r), t), j)
                    np.testing.assert_array_equal(
                        keys[r, t, j].numpy().view(np.uint32), np.asarray(k))


def test_bias_constants_round_like_jax():
    inv_p, inv_q, max_f, mode = walk_step.bias_constants(0.3, 7.0)
    with jax.enable_x64(False):
        one = jnp.float32(1.0)
        assert inv_p == np.float32(one / 0.3)
        assert inv_q == np.float32(one / 7.0)
    assert max_f == np.float32(1 / 0.3) and mode == walk_step.MODE_GENERAL
    assert walk_step.bias_constants(1.0, 1.0)[3] == walk_step.MODE_PQ1
    assert walk_step.bias_constants(0.5, 1.0)[3] == walk_step.MODE_Q1


def test_corpus_invariants_agree_with_jax(karate, jkarate):
    walks = engine.random_walks(karate, walk_length=8, num_walks=2, p=0.5,
                                q=2.0, seed=1, device="cpu")
    bad = walks.copy()
    bad[0, 3] = (bad[0, 2] + 1) % karate.num_vertices   # maybe not an arc
    bad[1, 4:] = -1
    bad[1, 6] = 0                                         # resurrection
    bad[2, 5] = karate.num_vertices                       # out of range
    dg = sampling.device_put_graph(karate, "cpu")
    with jax.enable_x64(False):
        jg = jsampling.device_put_graph(jkarate)
        for w in (walks, bad):
            want = np.asarray(jengine.corpus_invariants(jg, jnp.asarray(w)))
            got = engine.corpus_invariants(dg, torch.as_tensor(w),
                                           chunk_rows=7)
            np.testing.assert_array_equal(got.numpy(), want)
    assert engine.assert_corpus_invariants(dg, torch.as_tensor(walks)) == \
        {"bad_arcs": 0, "resurrected": 0, "out_of_range": 0}
    with pytest.raises(AssertionError):
        engine.assert_corpus_invariants(dg, torch.as_tensor(bad))


@pytest.mark.parametrize("kw", [dict(sampler="cdf"),
                                dict(p=0.01, q=100.0),
                                dict(rng_impl="rbg"),
                                dict(dtype="float64")])
def test_unported_walk_options_raise(karate, jkarate, kw):
    """Only the XLA-only rbg streams stay refused. The exact-CDF sampler, a
    p/q ratio above 32 and the float64 accumulation type run, and give the
    JAX package's corpus bit for bit (tests/test_torch_cdf.py has the rest)."""
    args = dict(walk_length=4, num_walks=1, **kw)
    if "rng_impl" in kw:
        with pytest.raises(NotPorted):
            engine.random_walks(karate, device="cpu", **args)
        return
    np.testing.assert_array_equal(
        engine.random_walks(karate, device="cpu", **args),
        _jax_walks(jkarate, **args))


def test_empty_graph_has_no_packed_tables():
    g = tcsr.from_edge_arrays(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         num_vertices=3)
    with pytest.raises(sampling.PackingUnavailable):
        sampling.device_put_graph(g, "cpu")


def test_walk_kernel_wrapper_raises_without_a_build(karate, monkeypatch,
                                                    tmp_path):
    """A tensor off the CPU goes to the kernel or raises: with no compiler
    the build fails loudly, and nothing falls back to the plain version."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(walk_step.WALK_KERNEL, "_fn", None)
    dg = sampling.device_put_graph(karate, "cpu")
    meta = sampling.DeviceGraph(*(t if t is None else t.to("meta")
                                  for t in dg))
    starts = torch.arange(karate.num_vertices, dtype=torch.int32,
                          device="meta")
    keys = walk_step.trial_keys(prng.prng_key(0), 0, 1, 4, 64)
    before = walk_step.WALK_KERNEL.launches
    with pytest.raises(_build.KernelBuildError):
        walk_step.walk_rounds(meta, starts, keys, 4, 0.5, 2.0,
                              karate.num_vertices)
    assert walk_step.WALK_KERNEL.launches == before
