"""The port's resident-row walks (ops/resident_walk.py) against the JAX
package's Pallas walk kernel (ops/pallas/walk.py) in interpret mode: the row
tables field by field, the plain version of the CUDA kernel bit for bit
under external uniforms made with numpy, and resident_walks bit for bit
against pallas_walks(external_uniforms=True) from the same seed. Tolerance:
exact (integers). JAX runs with x64 off. Sizes stay near karate, W_pad 256,
L 10: interpret mode takes a second or two per case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.graph import csr as jcsr
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.ops.pallas import walk as pw
from stellar_rw_tpu_torch.graph import csr, io
from stellar_rw_tpu_torch.ops import _build
from stellar_rw_tpu_torch.ops import resident_walk as rw
from stellar_rw_tpu_torch.ops import sampling
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)

# the two small graphs of tests/test_pallas.py
WEIGHTED5 = {0: [(1, 1.0)], 1: [(0, 1.0), (2, 2.0), (3, 1.0), (4, 0.5)],
             2: [(1, 1.0), (0, 1.0)], 3: [(1, 1.0)], 4: [(1, 1.0)]}
CHAIN = {0: [(1, 1.0)], 1: [(2, 1.0)], 2: []}
PQ = [(0.25, 4.0), (1.0, 1.0), (0.5, 2.0), (4.0, 0.25)]


def _graphs(name, karate_path):
    """(the JAX package's graph, the port's graph), each by its own loader."""
    if name == "karate":
        return [m.load_edge_list(karate_path, weighted=False, directed=False)
                for m in (jio, io)]
    adj = {"weighted5": WEIGHTED5, "chain": CHAIN}[name]
    return [m.from_adjacency(adj) for m in (jcsr, csr)]


@pytest.mark.parametrize("name", ["karate", "weighted5", "chain"])
@pytest.mark.parametrize("extra", [0, 3])
def test_row_tables_field_by_field(name, extra, karate_path):
    jg, g = _graphs(name, karate_path)
    md = max(g.max_degree, 1) + extra
    want = pw.build_row_tables(jg, md)                 # f32 [V_pad, 128]
    got = rw.build_row_tables(g, md)                   # i32 [V, stride]
    V = g.num_vertices
    lay = rw.row_layout(md)
    assert got.dtype == np.int32 and got.shape == (V, lay.stride)
    # the ids lead, 16-byte aligned rows, stride / 4 odd, fields disjoint
    assert lay.stride % 4 == 0 and (lay.stride // 4) % 2 == 1
    assert max(md, rw.HELD_IDS) <= lay.pairs and lay.pairs % 4 == 0
    assert lay.pairs + 2 * md == lay.deg < lay.stride
    assert (got[:, md:lay.pairs] == -1).all()          # ids' padding
    assert (got[:, lay.deg + 1:] == 0).all()           # the row's tail
    deg, cols, acols, aprob = rw.row_fields(got, md)
    # an id word carries its vertex's degree above the id; -1 pads
    for words, ids in ((got[:, :md], cols),
                       (got[:, lay.pairs + 1:lay.deg:2], acols)):
        real = words != -1
        np.testing.assert_array_equal(real, ids >= 0)
        np.testing.assert_array_equal(
            words.view(np.uint32)[real] >> rw.ID_BITS, deg[ids[real]])
    np.testing.assert_array_equal(deg, want[:V, 0])
    np.testing.assert_array_equal(cols, want[:V, 1:1 + md])
    np.testing.assert_array_equal(acols, want[:V, 1 + md:1 + 2 * md])
    assert aprob.dtype == np.float32
    np.testing.assert_array_equal(aprob, want[:V, 1 + 2 * md:1 + 3 * md])


def test_row_tables_degree_bound(karate_path):
    _, g = _graphs("karate", karate_path)
    with pytest.raises(AssertionError):
        rw.build_row_tables(g, g.max_degree - 1)
    with pytest.raises(AssertionError):
        rw.build_row_tables(g, rw.MAX_MD + 1)
    assert rw.MAX_MD == pw.MAX_MD


@pytest.mark.parametrize("name,W_real,L", [("karate", 170, 10),
                                           ("weighted5", 250, 6),
                                           ("chain", 6, 4)])
@pytest.mark.parametrize("pq", PQ)
def test_ref_bitwise_under_external_uniforms(name, W_real, L, pq,
                                             karate_path):
    """walk_corpus_resident_ref == walk_corpus_vmem(interpret=True) on the
    same numpy uniforms, padding rows included."""
    jg, g = _graphs(name, karate_path)
    md, V, W_pad, T = max(g.max_degree, 1), g.num_vertices, 256, 8
    u = np.random.default_rng(11).random(
        rw.uniforms_shape(L, T, W_pad), dtype=np.float32)
    with jax.enable_x64(False):
        want = np.asarray(pw.walk_corpus_vmem(
            jnp.asarray(pw.build_row_tables(jg, md)),
            jnp.asarray([0, V, W_real], jnp.int32), L, pq[0], pq[1], md=md,
            W_pad=W_pad, max_trials=T, tile=256, interpret=True,
            uniforms=jnp.asarray(u)))
    tab = torch.as_tensor(rw.build_row_tables(g, md))
    got = rw.walk_corpus_resident(tab, 0, V, W_real, L, pq[0], pq[1], md,
                                  W_pad, T, uniforms=torch.as_tensor(u))
    assert got.dtype == torch.int32 and got.shape == (W_pad, L + 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[W_real:] == -1).all()


@pytest.mark.parametrize("name,num_walks", [("karate", 5), ("weighted5", 40),
                                            ("chain", 2)])
@pytest.mark.parametrize("pq", PQ)
def test_resident_walks_bitwise_from_seed(name, num_walks, pq, karate_path):
    """The seeded stream is the array pallas_walks(external_uniforms=True)
    draws, so the corpora are equal bit for bit."""
    jg, g = _graphs(name, karate_path)
    kw = dict(walk_length=10, num_walks=num_walks, p=pq[0], q=pq[1], seed=3,
              tile=256)
    with jax.enable_x64(False):
        want = pw.pallas_walks(jg, interpret=True, external_uniforms=True,
                               **kw)
    got = rw.resident_walks(g, device="cpu", **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_seeded_stream_is_the_jax_array():
    """The in-kernel draw of (row r, component c, walker w) is element
    (r*3 + c)*W_pad + w of jax.random.uniform(PRNGKey(seed), (R, 3, W_pad))."""
    L, T, W_pad, seed = 3, 4, 512, 9
    shape = rw.uniforms_shape(L, T, W_pad)
    with jax.enable_x64(False):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                             jnp.float32))
    d = rw._Draws(seed, None, W_pad, "cpu")
    gid = torch.arange(W_pad)
    for r, c in [(0, 0), (0, 1), (5, 2), (shape[0] - 1, 2)]:
        np.testing.assert_array_equal(d.at(r, c, gid).numpy(), want[r, c])


def test_early_exit_leaves_the_stream_in_place(karate_path):
    """A walker stops drawing at its first accept; the trials it skips do not
    shift later draws: the corpus under the seeded stream equals the corpus
    under that stream materialized as external uniforms."""
    _, g = _graphs("karate", karate_path)
    md, V, L, T, W_pad = g.max_degree, g.num_vertices, 8, 8, 256
    tab = torch.as_tensor(rw.build_row_tables(g, md))
    with jax.enable_x64(False):
        u = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(5), rw.uniforms_shape(L, T, W_pad),
            jnp.float32))
    a = rw.walk_corpus_resident(tab, 5, V, 200, L, 0.25, 4.0, md, W_pad, T)
    b = rw.walk_corpus_resident(tab, 5, V, 200, L, 0.25, 4.0, md, W_pad, T,
                                uniforms=torch.tensor(u))
    assert torch.equal(a, b)


def test_resident_walk_distribution():
    """tests/test_pallas.py's distribution test on the port: realized
    transition frequencies from a fixed (prev, cur) state match the exact
    node2vec probabilities."""
    from stellar_rw_tpu.walk import oracle

    g = csr.from_adjacency(WEIGHTED5)
    p, q = 0.5, 2.0
    w = rw.resident_walks(g, walk_length=1, num_walks=1600, p=p, q=q, seed=3,
                          tile=1024, device="cpu")
    rows = w[w[:, 0] == 0]
    assert np.all(rows[:, 1] == 1)          # deg(0) == 1
    M = len(rows)
    freq = np.bincount(rows[:, 2], minlength=5) / M
    expected = oracle.exact_transition_probs(jcsr.from_adjacency(WEIGHTED5),
                                             0, 1, p, q)
    for v, pr in expected.items():
        se = np.sqrt(pr * (1 - pr) / M)
        assert abs(freq[v] - pr) < max(5 * se, 5e-3), (v, freq[v], pr)


def test_resident_walk_shapes_and_dead_ends():
    """tests/test_pallas.py's dead-end and padding test on the port."""
    g = csr.from_adjacency(CHAIN)
    w = rw.resident_walks(g, walk_length=4, num_walks=2, p=1.0, q=1.0, seed=0,
                          tile=512, device="cpu")
    assert w.shape == (6, 6)
    by_start = {int(r[0]): r for r in w[:3]}
    np.testing.assert_array_equal(by_start[0], [0, 1, 2, -1, -1, -1])
    np.testing.assert_array_equal(by_start[1], [1, 2, -1, -1, -1, -1])
    np.testing.assert_array_equal(by_start[2], [2, -1, -1, -1, -1, -1])


@pytest.mark.parametrize("pq", [(0.25, 0.25), (1.0, 4.0)])
def test_corpus_passes_the_engine_invariants(pq, karate_path):
    """Every consecutive pair is an arc, nothing resurrects, ids in range:
    the general engine's invariant counters on a resident-row corpus."""
    _, g = _graphs("karate", karate_path)
    w = rw.resident_walks(g, walk_length=12, num_walks=4, p=pq[0], q=pq[1],
                          seed=1, as_numpy=False, device="cpu")
    assert w.shape == (4 * 34, 14)
    assert (w[:, 0] == torch.arange(4 * 34) % 34).all()
    dg = sampling.device_put_graph(g, "cpu")
    assert engine.corpus_invariants(dg, w).tolist() == [0, 0, 0]


def test_ref_counts_steps_and_trials(karate_path):
    _, g = _graphs("karate", karate_path)
    md, V = g.max_degree, g.num_vertices
    tab = torch.as_tensor(rw.build_row_tables(g, md))
    counts = {}
    rw.walk_corpus_resident_ref(tab, 0, V, 68, 5, 1.0, 1.0, md, 256, 8,
                                counts=counts)
    # p == q == 1: every first trial accepts; karate has no dead end
    assert {k: counts[k] for k in ("steps", "trials")} == {
        "steps": 68 * 5, "trials": 68 * 5}
    assert counts["acc_draws"] == counts["cold_steps"] == 0
    assert counts["walker_trials"].tolist() == [5] * 68 + [0] * 188
    rw.walk_corpus_resident_ref(tab, 0, V, 68, 5, 0.25, 4.0, md, 256, 8,
                                counts=counts)
    assert counts["steps"] == 68 * 5 < counts["trials"] <= 68 * 5 * 8


def test_row_placement():
    small = torch.zeros((1024, rw.row_words(16)), dtype=torch.int32)
    large = torch.zeros((4096, rw.row_words(16)), dtype=torch.int32)
    assert small.numel() * 4 == 212_992 and large.numel() * 4 == 851_968
    assert rw.row_placement(small) == "shared"
    assert rw.row_placement(large) == "global"
    assert rw.row_placement(small, "global") == "global"
    with pytest.raises(ValueError):
        rw.row_placement(large, "shared")
    with pytest.raises(ValueError):
        rw.row_placement(small, "vmem")


@pytest.mark.parametrize("bad", ["dtype", "shape", "uniforms", "walkers"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    tab = torch.zeros((4, rw.row_words(2)), dtype=torch.int32)
    args = dict(tab=tab, seed=0, V=4, W_real=4, walk_length=2, p=1.0, q=1.0,
                md=2, W_pad=8)
    if bad == "dtype":
        args["tab"] = tab.float()
    elif bad == "shape":
        args["md"] = 8        # another stride than the table's
    elif bad == "uniforms":
        args["uniforms"] = torch.zeros((3, 3, 8))
    else:
        args["W_real"] = 9
    with pytest.raises(ValueError):
        rw.walk_corpus_resident(**args)


def test_default_device_is_the_card(karate_path, monkeypatch):
    """resident_walks runs on the card unless asked for the CPU; with no
    card it raises instead of running the plain version."""
    _, g = _graphs("karate", karate_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rw.resident_walks(g, walk_length=2, num_walks=1, p=1.0, q=1.0)


def test_kernel_wrapper_raises_without_a_build(monkeypatch, tmp_path):
    """On a CUDA tensor the wrapper launches the kernel or raises; here the
    build fails (no nvcc), and the plain version is not a way out. A meta
    tensor stands in for the CUDA tensor: only its device type is read before
    the build."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        _build.KernelBuildError("nvcc not found")))
    monkeypatch.setattr(rw.RESIDENT_WALK_KERNEL, "_fn", None)
    tab = torch.zeros((4, rw.row_words(2)), dtype=torch.int32, device="meta")
    before = rw.RESIDENT_WALK_KERNEL.launches
    with pytest.raises(_build.KernelBuildError):
        rw.walk_corpus_resident(tab, 0, 4, 4, 2, 1.0, 1.0, 2, 8)
    assert rw.RESIDENT_WALK_KERNEL.launches == before
