"""The port's GNN-feed ops (ops/spmm.py) against the JAX package's
stellar_rw_tpu/ops/spmm.py on the same inputs.

Each case of tests/test_spmm.py has a twin here held against the JAX
function (and the dense NumPy reference where that test has one), on two
paths: the plain versions the CPU runs, and the card's autograd Functions
with csrc/spmm.cu's three kernels replaced by NumPy transcriptions of their
order (a warp an item of at most `chunk` arcs of a segment, its lane
groups' sums in float64 combined by a butterfly, a split hub segment's
partial sums summed in item order by a tree of groups of FAN,
the segment sum's optional index, weight and weight index; the SDDMM's dot
an arc in float64; the row softmax's running max and sum), so the backward
passes' wiring (which order, index and weights each gradient takes) is
checked without the card. The segment sum's transcription is also held to
float64 on its own at the widths that pick each lane layout, on a hub row
split into many items of many runs. Gradients of
spmm, spmm_mean, sddmm and sddmm_softmax against jax.grad at rtol 1e-5
(atol 1e-6: sums in another order). JAX runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.ops import spmm as jsp
from stellar_rw_tpu_torch.graph import io
from stellar_rw_tpu_torch.ops import spmm as sp

torch.set_num_threads(2)

PATHS = ["plain", "kernels"]


def _graphs(path, weighted=False, directed=False):
    load = lambda m: m.load_edge_list(path, weighted=weighted,
                                      directed=directed)
    jg, g = load(jio), load(io)
    return jg, g, jsp.EdgeStructure.from_csr(jg)


def _es(g, chunk=sp.CHUNK):
    return sp.EdgeStructure.from_csr(g, device="cpu", chunk=chunk)


# ------------------------------------------- the kernels' order in NumPy


def _lanes_a_row(D):
    """csrc/spmm.cu's G: the lanes a gathered row takes (16-byte loads where
    D % 4 == 0: 8, 16 or 32 lanes; else one float a lane, 32 lanes)."""
    if D % 4:
        return 32
    return 8 if D <= 32 else 16 if D <= 64 else 32


def _segment_sum_np(order, x, idx=None, w=None, widx=None, mean=False):
    """csrc/spmm.cu's segment_sum order: an item's arcs RUN at a time; in a
    run each of the warp's 32 / G lane groups sums its arcs (the group's
    index, then every 32 / G-th) in float64; the groups summed by the
    butterfly (xor 16, then 8, down to G lanes); a split segment's
    partials summed in item order, each group of FAN, then the groups'
    sums in group order; the row rounded to float32 once."""
    off = order.offsets.numpy()
    X = x.detach().numpy().astype(np.float64)
    D = X.shape[1]
    P = 32 // _lanes_a_row(D)          # arcs gathered at once
    W = None if w is None else w.detach().numpy().astype(np.float64)
    out = np.zeros((len(off) - 1, D), np.float32)
    partials = np.zeros((order.parts, D))
    for s, e0, part in zip(order.item_seg.numpy(), order.item_start.numpy(),
                           order.item_part.numpy()):
        e1 = min(e0 + order.chunk, off[s + 1])
        acc = np.zeros((P, D))
        for b in range(e0, e1, sp.RUN):
            for j in range(min(sp.RUN, e1 - b)):
                e = b + j
                r = e if idx is None else int(idx[e])
                wj = 1.0 if W is None else W[e if widx is None
                                             else int(widx[e])]
                acc[j % P] += wj * X[r]
        sh = P // 2
        while sh:                          # lanes xor 16, 8, ...: groups
            acc = acc + acc[np.arange(P) ^ sh]
            sh //= 2
        acc = acc[0]
        if part >= 0:
            partials[part] = acc
            n_seg = -(-(off[s + 1] - off[s]) // order.chunk)
            p0 = part - (e0 - off[s]) // order.chunk
            if part != p0 + n_seg - 1:
                continue       # once every partial is written:
            acc = np.zeros(D)  # each group of FAN in item order, then the
            for g0 in range(p0, p0 + n_seg, sp.FAN):   # groups in order
                grp = np.zeros(D)
                for p in range(g0, min(g0 + sp.FAN, p0 + n_seg)):
                    grp += partials[p]
                acc += grp
        deg = max(off[s + 1] - off[s], 1)
        out[s] = (acc / deg if mean else acc).astype(np.float32)
    return torch.from_numpy(out)


def _sddmm_np(es, x, y):
    X, Y = x.detach().numpy(), y.detach().numpy()
    col = es.col.numpy()
    out = np.zeros(len(col), np.float32)
    off = es.csr.offsets.numpy()
    for u, e0 in zip(es.csr.item_seg.numpy(), es.csr.item_start.numpy()):
        for e in range(e0, min(e0 + es.csr.chunk, off[u + 1])):
            out[e] = np.float32((X[u].astype(np.float64)
                                 * Y[col[e]].astype(np.float64)).sum())
    return torch.from_numpy(out)


def _row_softmax_np(es, a, da=None):
    A = a.detach().numpy()
    off = es.csr.offsets.numpy()
    out = np.zeros_like(A)
    for u in range(es.num_vertices):
        s = slice(off[u], off[u + 1])
        if off[u] == off[u + 1]:
            continue
        if da is None:
            mx, tot = -np.inf, np.float32(0)
            for v in A[s]:         # the running max and sum of exps
                if v > mx:
                    tot, mx = tot * np.exp(np.float32(mx - v)) + 1, v
                else:
                    tot += np.exp(v - mx)
            out[s] = np.exp(A[s] - mx) / max(tot, np.float32(1e-30))
        else:
            dA = da.detach().numpy()[s]
            out[s] = A[s] * (dA - (A[s] * dA).sum(dtype=np.float32))
    return torch.from_numpy(out)


@pytest.fixture
def kernels(monkeypatch):
    monkeypatch.setattr(sp, "segment_sum", _segment_sum_np)
    monkeypatch.setattr(sp, "sddmm_rows", _sddmm_np)
    monkeypatch.setattr(sp, "row_softmax", _row_softmax_np)


# the public ops on each path: CPU tensors take the plain versions; the
# card's Functions run on the transcriptions
OPS = {
    "plain": {
        "spmm": sp.spmm, "spmm_mean": sp.spmm_mean, "sddmm": sp.sddmm,
        "sddmm_softmax": sp.sddmm_softmax, "gather_rows": sp.gather_rows,
        "scatter_add_rows": sp.scatter_add_rows},
    "kernels": {
        "spmm": lambda es, x, weighted=True: sp._SpMM.apply(
            x, es, weighted, False),
        "spmm_mean": lambda es, x: sp._SpMM.apply(x, es, False, True),
        "sddmm": lambda es, x, y: sp._SDDMM.apply(x, y, es),
        "sddmm_softmax": lambda es, s: sp._RowSoftmax.apply(s, es),
        "gather_rows": lambda es, x, which="col": sp._GatherRows.apply(
            x, es, which),
        "scatter_add_rows": lambda es, m, which="row":
            sp._ScatterAddRows.apply(m, es, which)},
}


@pytest.fixture(params=PATHS)
def ops(request):
    if request.param == "kernels":
        request.getfixturevalue("kernels")
    return OPS[request.param]


def _dense_adj(g):
    A = np.zeros((g.num_vertices, g.num_vertices), dtype=np.float64)
    for v in range(g.num_vertices):
        cols, w = g.neighbors(v)
        for c, wi in zip(cols, w):
            A[v, int(c)] += float(wi)
    return A


# ------------------------------------------- twins of tests/test_spmm.py


def test_spmm_matches_dense(karate_path, ops):
    jg, g, jes = _graphs(karate_path)
    es = _es(g, chunk=4)                  # hub rows split into items
    x = np.random.default_rng(0).normal(size=(34, 16)).astype(np.float32)
    got = ops["spmm"](es, torch.as_tensor(x)).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jsp.spmm(jes, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _dense_adj(g) @ x.astype(np.float64),
                               rtol=1e-4, atol=1e-4)


def test_spmm_mean_and_isolates(testgraph_path, ops):
    jg, g, jes = _graphs(testgraph_path, directed=True)
    es = _es(g)
    x = np.array([[2.0, 4.0], [10.0, 20.0]], dtype=np.float32)
    idx = {int(o): i for i, o in enumerate(g.ids)}
    got = ops["spmm_mean"](es, torch.as_tensor(x)).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jsp.spmm_mean(jes, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[idx[1]], x[idx[2]])
    np.testing.assert_allclose(got[idx[2]], [0.0, 0.0])


def test_sddmm_matches_dense(karate_path, ops):
    jg, g, jes = _graphs(karate_path)
    es = _es(g)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(34, 8)).astype(np.float32)
    y = rng.normal(size=(34, 8)).astype(np.float32)
    got = ops["sddmm"](es, torch.as_tensor(x), torch.as_tensor(y)).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jsp.sddmm(jes, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    row, col = es.row.numpy(), es.col.numpy()
    np.testing.assert_allclose(got, np.einsum("ed,ed->e", x[row], y[col]),
                               rtol=1e-4, atol=1e-4)


def test_sddmm_softmax_rows_sum_to_one(karate_path, ops):
    jg, g, jes = _graphs(karate_path)
    es = _es(g)
    scores = np.random.default_rng(2).normal(
        size=(g.num_edges,)).astype(np.float32) * 4
    a = ops["sddmm_softmax"](es, torch.as_tensor(scores)).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jsp.sddmm_softmax(jes, jnp.asarray(scores)))
    np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-6)
    sums = np.zeros(g.num_vertices)
    np.add.at(sums, es.row.numpy(), a)
    np.testing.assert_allclose(sums[np.asarray(g.degrees) > 0], 1.0,
                               rtol=1e-5)


def test_spmm_is_differentiable(karate_path, ops):
    jg, g, jes = _graphs(karate_path)
    es = _es(g)
    x = torch.ones((g.num_vertices, 4), requires_grad=True)
    (ops["spmm_mean"](es, x) ** 2).sum().backward()
    assert x.grad.shape == x.shape and bool((x.grad != 0).any())
    with jax.enable_x64(False):
        want = jax.grad(lambda x: jnp.sum(jsp.spmm_mean(jes, x) ** 2))(
            jnp.ones((g.num_vertices, 4), jnp.float32))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ gradients


@pytest.mark.parametrize("op", ["spmm", "spmm weighted", "spmm_mean",
                                "sddmm", "sddmm_softmax"])
def test_gradients_match_jax(karate_path, tmp_path, ops, op):
    """Each op's gradient of a random linear loss against jax.grad, on a
    weighted directed power-law graph with split hub rows."""
    rng = np.random.default_rng(3)
    V = 60
    src = np.minimum((V * rng.random(500) ** 3).astype(int), V - 1)
    dst = np.minimum((V * rng.random(500) ** 3).astype(int), V - 1)
    keep = src != dst
    path = tmp_path / "g.txt"
    np.savetxt(path, np.stack([src[keep], dst[keep],
                               rng.random(keep.sum()) * 3 + 0.5], 1),
               fmt=["%d", "%d", "%.4f"])
    jg, g, jes = _graphs(str(path), weighted=True, directed=True)
    es = _es(g, chunk=8)
    assert int(np.diff(g.offsets).max()) > 8      # a split hub row
    V, E = g.num_vertices, g.num_edges
    x = rng.normal(size=(V, 12)).astype(np.float32)
    y = rng.normal(size=(V, 12)).astype(np.float32)
    s = rng.normal(size=E).astype(np.float32)
    r = rng.normal(size=(E,) if op.startswith("sddmm") else (V, 12)
                   ).astype(np.float32)
    fwd = {
        "spmm": lambda m, es, a, b: m["spmm"](es, a, weighted=False),
        "spmm weighted": lambda m, es, a, b: m["spmm"](es, a),
        "spmm_mean": lambda m, es, a, b: m["spmm_mean"](es, a),
        "sddmm": lambda m, es, a, b: m["sddmm"](es, a, b),
        "sddmm_softmax": lambda m, es, a, b: m["sddmm_softmax"](es, a),
    }[op]
    a0 = s if op == "sddmm_softmax" else x
    ta = torch.tensor(a0, requires_grad=True)
    tb = torch.tensor(y, requires_grad=True)
    (fwd(ops, es, ta, tb) * torch.as_tensor(r)).sum().backward()
    jops = {"spmm": jsp.spmm, "spmm_mean": jsp.spmm_mean,
            "sddmm": jsp.sddmm, "sddmm_softmax": jsp.sddmm_softmax}
    with jax.enable_x64(False):
        loss = lambda a, b: jnp.sum(fwd(jops, jes, a, b) * jnp.asarray(r))
        ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a0),
                                                 jnp.asarray(y))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5,
                               atol=1e-6)
    if op == "sddmm":
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["row", "col"])
def test_scatter_and_gather_rows_both_ways(karate_path, ops, which):
    jg, g, jes = _graphs(karate_path)
    es = _es(g, chunk=3)
    rng = np.random.default_rng(4)
    msgs = rng.normal(size=(g.num_edges, 5)).astype(np.float32)
    x = rng.normal(size=(g.num_vertices, 5)).astype(np.float32)
    tm = torch.tensor(msgs, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    got_s = ops["scatter_add_rows"](es, tm, which)
    got_g = ops["gather_rows"](es, tx, which)
    rs = rng.normal(size=got_s.shape).astype(np.float32)
    rg = rng.normal(size=got_g.shape).astype(np.float32)
    ((got_s * torch.as_tensor(rs)).sum()
     + (got_g * torch.as_tensor(rg)).sum()).backward()
    with jax.enable_x64(False):
        want_s = jsp.scatter_add_rows(jes, jnp.asarray(msgs), which)
        want_g = jsp.gather_rows(jes, jnp.asarray(x), which)
        gm = jax.grad(lambda m: jnp.sum(jsp.scatter_add_rows(jes, m, which)
                                        * jnp.asarray(rs)))(jnp.asarray(msgs))
        gx = jax.grad(lambda v: jnp.sum(jsp.gather_rows(jes, v, which)
                                        * jnp.asarray(rg)))(jnp.asarray(x))
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_g.detach().numpy(), np.asarray(want_g))
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(gm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        ops["gather_rows"](es, tx, "both")


# ------------------------------------------------ structure and plan


def test_edge_structure_and_transposed_order(karate_path, testgraph_path):
    for path, directed in ((karate_path, False), (testgraph_path, True)):
        jg, g, jes = _graphs(path, directed=directed)
        es = _es(g)
        for name in ("row", "col", "weight"):
            np.testing.assert_array_equal(getattr(es, name).numpy(),
                                          np.asarray(getattr(jes, name)))
        assert es.num_vertices == jes.num_vertices
        col = es.col.numpy()
        order = np.argsort(col, kind="stable")
        np.testing.assert_array_equal(es.t_order.numpy(), order)
        np.testing.assert_array_equal(es.t_row.numpy(),
                                      es.row.numpy()[order])
        off = es.trans.offsets.numpy()
        assert off[0] == 0 and off[-1] == len(col)
        for v in range(g.num_vertices):     # segment v: the arcs into v
            assert (col[order[off[v]:off[v + 1]]] == v).all()
        np.testing.assert_array_equal(es.csr.offsets.numpy(), g.offsets)
        deg = np.diff(g.offsets)
        np.testing.assert_array_equal(es.inv_deg.numpy(),
                                      (1.0 / np.maximum(deg, 1)
                                       ).astype(np.float32))


def test_segment_items_split_hub_rows():
    """The launch plan in plain Python: a run of at most `chunk` arcs an
    item, hub segments split, an empty segment one item of no arcs."""
    offsets = np.array([0, 3, 3, 13, 14, 14, 30])
    seg, start, part = sp.segment_items(offsets, chunk=4)
    assert seg.tolist() == [0, 1, 2, 2, 2, 3, 4, 5, 5, 5, 5]
    assert start.tolist() == [0, 3, 3, 7, 11, 13, 14, 14, 18, 22, 26]
    assert part.tolist() == [-1, -1, 0, 1, 2, -1, -1, 3, 4, 5, 6]
    covered = []
    for s, e0 in zip(seg, start):
        e1 = min(e0 + 4, offsets[s + 1])
        assert offsets[s] <= e0 <= e1 <= offsets[s + 1]
        assert (e0 == e1) == (offsets[s] == offsets[s + 1])
        covered.extend(range(e0, e1))
    assert covered == list(range(30))
    seg, start, part = sp.segment_items(offsets, chunk=1 << 30)  # a row a
    assert seg.tolist() == [0, 1, 2, 3, 4, 5]                    # warp
    assert start.tolist() == [0, 3, 3, 13, 14, 14] and (part == -1).all()
    order = sp.Order.build(offsets, "cpu", chunk=4)
    assert order.parts == 7 and order.item_part.tolist() == [
        -1, -1, 0, 1, 2, -1, -1, 3, 4, 5, 6]
    assert sp.segment_items(np.array([0]), 4)[0].shape == (0,)
    with pytest.raises(ValueError):
        sp.segment_items(offsets, chunk=0)


@pytest.mark.parametrize("D", [2, 32, 33, 64, 128])
def test_segment_sum_transcription_hub_rows(D):
    """The segment sum's order on a hub row of 3,000 arcs (24 items of
    four runs, two groups of partials), rows of one arc and of a few, and
    empty segments (isolates), at widths that pick each lane layout (D 2
    and 33: a float a lane; 32, 64 and 128: a 16-byte load a lane, 8, 16
    and 32 lanes a row): within rtol 1e-5 atol 1e-5 of float64, weighted,
    unweighted, the mean, and through a weight index."""
    rng = np.random.default_rng(D)
    deg = np.array([3000, 0, 1, 5, 129, 0, 40])
    offsets = np.concatenate([[0], np.cumsum(deg)])
    E, N = int(offsets[-1]), 500
    order = sp.Order.build(offsets, "cpu", chunk=128)
    assert order.parts == 24 + 2
    x = rng.standard_normal((N, D)).astype(np.float32) + 0.5
    idx = rng.integers(0, N, E).astype(np.int32)
    w = rng.random(E).astype(np.float32) * 2
    widx = rng.permutation(E).astype(np.int32)
    X = x.astype(np.float64)
    for wt, wi, mean in ((w, None, False), (None, None, False),
                         (None, None, True), (w, widx, False)):
        got = _segment_sum_np(
            order, torch.as_tensor(x), torch.as_tensor(idx),
            None if wt is None else torch.as_tensor(wt),
            None if wi is None else torch.as_tensor(wi), mean).numpy()
        arc_w = (np.ones(E) if wt is None else
                 wt[np.arange(E) if wi is None else wi].astype(np.float64))
        want = np.zeros((len(deg), D))
        np.add.at(want, np.repeat(np.arange(len(deg)), deg),
                  arc_w[:, None] * X[idx])
        if mean:
            want /= np.maximum(deg, 1)[:, None]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (got[[1, 5]] == 0).all()


def test_segment_grid():
    """The segment sum's persistent grid: a warp an item while the items
    fill fewer blocks than the card holds, then every resident block."""
    per_block = sp.THREADS // 32
    cap = sp.SEGMENT_BLOCKS_PER_SM * 132
    assert sp.segment_grid(1, 132) == 1
    assert sp.segment_grid(per_block * 10 + 1, 132) == 11
    assert sp.segment_grid(per_block * cap, 132) == cap
    assert sp.segment_grid(per_block * cap * 3 + 5, 132) == cap
    assert sp.segment_grid(10 ** 6, 2) == sp.SEGMENT_BLOCKS_PER_SM * 2
    assert sp.segment_grid(0, 132) == 1


def test_edge_structure_default_device_is_cuda(karate_path):
    from stellar_rw_tpu_torch.errors import CudaUnavailable

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is served")
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    with pytest.raises(CudaUnavailable):
        sp.EdgeStructure.from_csr(g)
