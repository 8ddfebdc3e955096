"""The port's own copies of the host modules (graph/csr.py, graph/io.py,
graph/datasets.py, graph/partition.py, native/, utils/, ops/alias.py,
models/eval.py, models/hsoftmax.py's build_huffman) against the JAX package's
originals on the same inputs. Everything here is NumPy on the host, so the
tolerance is exact: arrays equal, files byte for byte. The CSR tables are
held with the port's C++ builder and with its NumPy builders."""

import dataclasses
import filecmp
import logging
import os

import numpy as np
import pytest

from stellar_rw_tpu import native as jnative
from stellar_rw_tpu.graph import csr as jcsr
from stellar_rw_tpu.graph import datasets as jdatasets
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.graph import partition as jpartition
from stellar_rw_tpu.models import eval as jev
from stellar_rw_tpu.models import hsoftmax as jhs
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.ops import alias as jalias
from stellar_rw_tpu.utils import config as jconfig
from stellar_rw_tpu.utils import logging as jlogging
from stellar_rw_tpu.utils import stats as jstats
from stellar_rw_tpu_torch import native
from stellar_rw_tpu_torch.graph import csr, datasets, io, partition
from stellar_rw_tpu_torch.models import eval as ev
from stellar_rw_tpu_torch.models import hsoftmax as hs
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import alias
from stellar_rw_tpu_torch.utils import config, stats
from stellar_rw_tpu_torch.utils import logging as tlogging

CSR_FIELDS = ("offsets", "cols", "weights", "ids")
TABLE_FIELDS = ("alias_prob", "alias_pos", "hash_offsets", "hash_mask",
                "hash_table")


def _power_law_arcs(V=2048, E=32768, seed=1):
    rng = np.random.default_rng(seed)
    draw = lambda: np.minimum((V * rng.random(E) ** (1 / 0.3)).astype(np.int64),
                              V - 1)
    src, dst = draw(), draw()
    keep = src != dst
    wts = (rng.random(int(keep.sum())) * 4 + 0.25).astype(np.float32)
    return src[keep], dst[keep], wts


def _pair(name, karate_path, testgraph_path):
    """(the JAX package's graph, the port's graph), tables not built yet,
    each made by its own package from the same input."""
    if name == "karate":
        return [m.load_edge_list(karate_path, weighted=False, directed=False,
                                 use_native=False) for m in (jio, io)]
    if name == "testgraph":
        return [m.load_edge_list(testgraph_path, weighted=False,
                                 directed=True, use_native=False)
                for m in (jio, io)]
    if name == "loops":
        adj = {0: [(0, 1.0), (1, 3.0)], 1: [(0, 1.0), (1, 0.5), (1, 2.0)],
               7: [(1, 1.0), (0, 2.0), (0, 2.0)]}
        return [m.from_adjacency(adj) for m in (jcsr, csr)]
    src, dst, wts = _power_law_arcs()
    return [m.from_edge_arrays(src, dst, wts, num_vertices=2048,
                               symmetrize=True) for m in (jcsr, csr)]


GRAPHS = ["karate", "testgraph", "loops", "powerlaw2k"]


@pytest.fixture
def numpy_builders(monkeypatch):
    """Both packages on their NumPy builders."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.mark.parametrize("name", GRAPHS)
def test_csr_equal(name, karate_path, testgraph_path):
    jg, g = _pair(name, karate_path, testgraph_path)
    for f in CSR_FIELDS:
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (g.num_vertices, g.num_edges, g.max_degree) == \
        (jg.num_vertices, jg.num_edges, jg.max_degree)
    np.testing.assert_array_equal(g.degrees, jg.degrees)
    for a, b in zip(g.neighbors(1), jg.neighbors(1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", GRAPHS)
def test_tables_equal_numpy_builders(name, karate_path, testgraph_path,
                                     numpy_builders):
    jg, g = _pair(name, karate_path, testgraph_path)
    for x in (jg, g):
        x.build_alias_tables()
        x.build_hash_tables()
    for f in TABLE_FIELDS:
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", GRAPHS)
def test_tables_equal_cpp_builder(name, karate_path, testgraph_path,
                                  monkeypatch):
    """The port's C++ builder (built from the port's own source into
    build/native/) against the JAX package's NumPy builders."""
    assert native.available(), "the port's native library did not build"
    monkeypatch.setattr(jnative, "available", lambda: False)
    jg, g = _pair(name, karate_path, testgraph_path)
    for x in (jg, g):
        x.build_alias_tables()
        x.build_hash_tables()
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f),
                                      err_msg=f)


def test_native_library_is_the_ports_own():
    assert native.available()
    so = native._build_so()
    assert os.path.dirname(so) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("build", "native"))
    assert "stellar_rw_tpu_torch" in native._SRC
    assert not os.path.exists(os.path.join(os.path.dirname(native._SRC),
                                           "libstellar_native.so"))


def test_native_source_is_the_jax_packages_code():
    """The C++ source is a copy: beyond comment lines the two files agree."""
    code = lambda path: [ln for ln in open(path).read().splitlines()
                         if not ln.lstrip().startswith("//")]
    assert code(native._SRC) == code(jnative._SRC)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("use_native", [True, False])
def test_load_edge_list_equal(karate_path, directed, use_native):
    g = io.load_edge_list(karate_path, weighted=False, directed=directed,
                          use_native=use_native)
    jg = jio.load_edge_list(karate_path, weighted=False, directed=directed,
                            use_native=False)
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    if use_native:      # the C++ loader fills the tables too
        jg.build_alias_tables()
        jg.build_hash_tables()
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))


def test_weight_and_junk_parsing_equal(tmp_path):
    f = tmp_path / "edges.txt"
    f.write_text("1 2 0.5\n2 3 junk\n3 1\n\n4 4 2.5 extra 1.5\n")
    for kw in (dict(weighted=True), dict(weighted=False),
               dict(weighted=True, directed=True)):
        want = jio.load_edge_list(str(f), use_native=False, **kw)
        for un in (True, False):
            got = io.load_edge_list(str(f), use_native=un, **kw)
            for fld in CSR_FIELDS:
                np.testing.assert_array_equal(getattr(got, fld),
                                              getattr(want, fld))


@pytest.mark.parametrize("use_native", [True, False])
def test_partitioned_load_equal(tmp_path, use_native):
    f = tmp_path / "parts.txt"
    f.write_text("1 2 0 1.5\n2 3 1 0.5\n3 4 2\n4 1 1 2.0\n5 1 0\n")
    kw = dict(weighted=True, partitioned=True, num_partitions=3, seed=0,
              use_native=use_native)
    g, home = io.load_edge_list_partitioned(str(f), **kw)
    jg, jhome = jio.load_edge_list_partitioned(str(f), **kw)
    np.testing.assert_array_equal(home, jhome)
    for fld in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(g, fld), getattr(jg, fld))


def test_missing_input_raises():
    with pytest.raises(FileNotFoundError):
        io.load_edge_list("/nonexistent/edges.txt")


def _walks_and_graph(karate_path):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    rng = np.random.default_rng(0)
    walks = rng.integers(0, g.num_vertices, (50, 9)).astype(np.int32)
    walks[3, 4:] = -1
    walks[7, 1:] = -1
    return walks, g


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.mark.parametrize("partitions", [1, 4])
def test_save_walks_bytes_equal(tmp_path, karate_path, partitions):
    walks, g = _walks_and_graph(karate_path)
    a = io.save_walks(walks, g, str(tmp_path / "port"), partitions)
    b = jio.save_walks(walks, g, str(tmp_path / "jax"), partitions)
    assert a.endswith("path")
    _same_tree(a, b)


@pytest.mark.parametrize("partitions", [1, 3])
def test_save_walks_stream_bytes_equal(tmp_path, karate_path, partitions):
    walks, g = _walks_and_graph(karate_path)
    rounds = lambda: (walks[i:i + 10] for i in range(0, 50, 10))
    a = io.save_walks_stream(rounds(), 50, g, str(tmp_path / "port"),
                             partitions)
    b = jio.save_walks_stream(rounds(), 50, g, str(tmp_path / "jax"),
                              partitions)
    _same_tree(a, b)
    # and the streamed files are the one-shot writer's
    _same_tree(a, jio.save_walks(walks, g, str(tmp_path / "whole"),
                                 partitions))


def test_save_walk_blocks_bytes_equal(tmp_path, karate_path):
    walks, g = _walks_and_graph(karate_path)
    walks[20:25] = -1                      # padding rows are dropped
    blocks = [(s, walks[s:s + 25]) for s in (0, 25)]
    a = io.save_walk_blocks(blocks, g, str(tmp_path / "port"))
    b = jio.save_walk_blocks(blocks, g, str(tmp_path / "jax"))
    _same_tree(a, b)


@pytest.mark.parametrize("partitions", [1, 3])
def test_save_vectors_bytes_equal(tmp_path, partitions):
    rng = np.random.default_rng(1)
    ids = rng.permutation(40).astype(np.int64) * 7
    vecs = rng.standard_normal((40, 6)).astype(np.float32)
    a = io.save_vectors(ids, vecs, str(tmp_path / "port"), partitions)
    b = jio.save_vectors(ids, vecs, str(tmp_path / "jax"), partitions)
    assert a.endswith("vec")
    _same_tree(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_load_walks_equal(tmp_path, karate_path, use_native, monkeypatch):
    walks, g = _walks_and_graph(karate_path)
    path = io.save_walks(walks, g, str(tmp_path / "o"), 3)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    vals, offs = io.load_walks_ragged(path)
    jvals, joffs = jio.load_walks_ragged(path)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(offs, joffs)
    assert io.load_walks(path) == jio.load_walks(path)
    assert [vals[offs[i]:offs[i + 1]].tolist()
            for i in range(len(offs) - 1)] == io.load_walks(path)


@pytest.mark.parametrize("text", [b"", b"1\t2\n\n3 4 5", b"007 12\n\n\n9\n",
                                  b"12345678901234567 1\n"])
def test_parse_uint_lines_equal(text):
    data = np.frombuffer(text, dtype=np.uint8)
    want = jio._parse_uint_lines(data)
    for got in (io._parse_uint_lines(data), native.parse_walks(data)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_parse_overflow_raises():
    data = np.frombuffer(b"1 99999999999999999999\n", dtype=np.uint8)
    with pytest.raises(ValueError):
        io._parse_uint_lines(data)
    with pytest.raises(ValueError):
        native.parse_walks(data)


def test_gather_rows_equal():
    src = np.arange(100, dtype=np.int32)
    starts, lens = np.array([5, 50, 0]), np.array([3, 10, 2])
    out, jout = np.zeros(15, np.int32), np.zeros(15, np.int32)
    native.gather_rows(starts, lens, src, out)
    jnative.gather_rows(starts, lens, src, jout)
    np.testing.assert_array_equal(out, jout)


# the flag sets of tests/test_cli.py
ARGVS = [
    ["--cmd", "node2vec", "--input", "in.txt", "--output", "/tmp/o"],
    ["--cmd", "node2vec"],
    ["--cmd", "bogus", "--input", "x", "--output", "y"],
    ["--cmd", "randomwalk", "--input", "in.txt", "--output", "/tmp/o",
     "--walkLength", "5", "--numWalks", "2", "--p", "0.25", "--q", "4.0",
     "--rddPartitions", "8", "--weighted", "false", "--directed", "true",
     "--singleOutput", "false", "--w2vPartitions", "2", "--partitioned",
     "true", "--lr", "0.1", "--iter", "3", "--dim", "16", "--window", "4"],
    ["--cmd", "embedding", "--input", "o/path", "--output", "o2", "--dim",
     "8", "--iter", "2", "--window", "3"],
    ["--cmd", "randomwalk", "--input", "in.txt", "--output", "o", "--shards",
     "8", "--lanes", "2", "--streamed", "true", "--checkpointEvery", "2",
     "--seed", "9"],
    ["--cmd", "node2vec", "--input", "in.txt", "--output", "o", "--streaming",
     "true", "--sharedNegatives", "128", "--negatives", "7", "--resume",
     "true", "--w2vModelShards", "2", "--sampler", "cdf", "--rngImpl", "rbg",
     "--validate", "true", "--logDir", "logs", "--profile", "prof"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_equal(argv):
    got, want = config.parse(argv), jconfig.parse(argv)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.cmd.value == want.cmd.value
    assert str(got) == str(want)


def test_config_constants_equal():
    assert dataclasses.asdict(config.Params()) == \
        dataclasses.asdict(jconfig.Params())
    assert [t.value for t in config.TaskName] == \
        [t.value for t in jconfig.TaskName]
    assert (config.MODEL_SUFFIX, config.PATH_SUFFIX, config.VECTOR_SUFFIX) \
        == (jconfig.MODEL_SUFFIX, jconfig.PATH_SUFFIX, jconfig.VECTOR_SUFFIX)
    assert csr.HASH_MULT == jcsr.HASH_MULT
    assert csr.HASH_MAX_PROBES == jcsr.HASH_MAX_PROBES


@pytest.mark.parametrize("n", [1, 2, 17, 1000])
def test_build_alias_equal(n):
    probs = np.random.default_rng(n).random(n) ** 3
    for a, b in zip(alias.build_alias(probs), jalias.build_alias(probs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_alias_equal_numpy_path(numpy_builders):
    probs = np.random.default_rng(5).random(300)
    for a, b in zip(alias.build_alias(probs), jalias.build_alias(probs)):
        np.testing.assert_array_equal(a, b)


def test_walk_stats_and_validate_equal(karate_path):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    rng = np.random.default_rng(2)
    # real walks: each step a uniformly chosen neighbour
    walks = np.full((40, 8), -1, np.int32)
    walks[:, 0] = rng.integers(0, g.num_vertices, 40)
    for t in range(1, 8):
        for i in range(40):
            nb = g.neighbors(int(walks[i, t - 1]))[0]
            walks[i, t] = nb[rng.integers(len(nb))]
    walks[5, 3:] = -1
    walks[6, 1:] = -1
    assert dataclasses.asdict(stats.walk_stats(walks)) == \
        dataclasses.asdict(jstats.walk_stats(walks))
    assert stats.validate_walks(walks, g) == jstats.validate_walks(walks, g)
    route = (np.arange(g.num_vertices) % 3).astype(np.int32)
    assert stats.boundary_traffic(walks, route) == \
        jstats.boundary_traffic(walks, route)
    bad = walks.copy()
    bad[0, 1] = (bad[0, 0] + 17) % g.num_vertices
    if bad[0, 1] not in g.neighbors(int(bad[0, 0]))[0]:
        with pytest.raises(AssertionError):
            stats.validate_walks(bad, g)


def test_eval_functions_equal(karate_path):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    V = g.num_vertices
    emb = np.random.default_rng(3).standard_normal((V, 8)).astype(np.float32)
    edges = np.asarray([(v, int(d)) for v in range(V)
                        for d in g.neighbors(v)[0] if v < int(d)])
    assert ev.link_prediction_auc(emb, edges, V, seed=0) == \
        jev.link_prediction_auc(emb, edges, V, seed=0)
    labels = ev.karate_labels(g.ids)
    np.testing.assert_array_equal(labels, jev.karate_labels(g.ids))
    assert ev.node_classification_accuracy(emb, labels, seed=0) == \
        jev.node_classification_accuracy(emb, labels, seed=0)
    multi = np.random.default_rng(4).random((V, 3)) < 0.4
    assert ev.multilabel_micro_f1(emb, multi, seed=0) == \
        jev.multilabel_micro_f1(emb, multi, seed=0)
    np.testing.assert_array_equal(
        ev.sample_non_edges(edges, V, 30, np.random.default_rng(6)),
        jev.sample_non_edges(edges, V, 30, np.random.default_rng(6)))


def test_corpus_builders_equal():
    rng = np.random.default_rng(8)
    lists = [rng.integers(0, 30, rng.integers(1, 9)).tolist()
             for _ in range(60)]
    got, want = w2v.corpus_from_token_lists(lists), \
        jw2v.corpus_from_token_lists(lists)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    values = np.concatenate([np.asarray(r, np.int64) for r in lists])
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in lists])])
    got, want = w2v.corpus_from_ragged(values, offsets), \
        jw2v.corpus_from_ragged(values, offsets)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == w2v.corpus_from_token_lists(lists)[1]


def test_logging_configure(tmp_path):
    assert tlogging.LOG_FILE == jlogging.LOG_FILE
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        tlogging.configure(str(tmp_path / "logs"))
        assert os.path.isdir(tmp_path / "logs")
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()


def _graphs_equal(a, b):
    for f in CSR_FIELDS + ("num_vertices",):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("args", [(1500, 15_000, 6, 7), (400, 3_000, 4, 2)])
def test_synth_labeled_graph_equal(args):
    V, E, k, seed = args
    g, labels = datasets.synth_labeled_graph(V, E, communities=k, seed=seed)
    jg, jlabels = jdatasets.synth_labeled_graph(V, E, communities=k,
                                                seed=seed)
    _graphs_equal(g, jg)
    np.testing.assert_array_equal(labels, jlabels)


def test_blogcatalog_loader_equal(tmp_path):
    (tmp_path / "edges.csv").write_text("1,2\n2,3\n3,1\n4,2\n")
    (tmp_path / "group-edges.csv").write_text("1,1\n2,1\n2,2\n3,2\n4,2\n")
    (tmp_path / "nodes.csv").write_text("1\n2\n3\n4\n5\n")
    g, labels = datasets.load_blogcatalog(str(tmp_path))
    jg, jlabels = jdatasets.load_blogcatalog(str(tmp_path))
    _graphs_equal(g, jg)
    np.testing.assert_array_equal(labels, jlabels)


def test_mat_loader_equal(tmp_path):
    pytest.importorskip("scipy")
    from scipy import sparse
    from scipy.io import savemat

    rng = np.random.default_rng(0)
    V = 40
    a = sparse.random(V, V, density=0.1, random_state=1, format="coo")
    grp = sparse.coo_matrix(
        (np.ones(V), (np.arange(V), rng.integers(0, 3, V))), shape=(V, 3))
    path = tmp_path / "toy.mat"
    savemat(path, {"network": (a + a.T).tocoo(), "group": grp})
    g, labels = datasets.load_mat_graph(str(path))
    jg, jlabels = jdatasets.load_mat_graph(str(path))
    _graphs_equal(g, jg)
    np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.parametrize("counts", [
    np.random.default_rng(0).zipf(1.5, 200).astype(np.float64),
    np.ones(37),                          # every tie broken by index
    np.asarray([5.0]), np.asarray([3.0, 1.0]), np.zeros(0)])
def test_build_huffman_equal(counts):
    """Points, labels and mask array-equal (heapq's order on (count,
    index) ties included) at a Zipf(1.5) vocabulary of 200, all ties, and
    V 1, 2 and 0."""
    for got, want in zip(hs.build_huffman(counts),
                         jhs.build_huffman(counts)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _routes(V):
    """Hash (None) and a random VCut route over three shards."""
    rng = np.random.default_rng(5)
    return {"hash": None, "vcut": rng.integers(0, 3, V).astype(np.int32)}


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


# arrays the partitioner leaves uninitialized past each shard's fill
EDGE_FIELDS = ("cols", "weights", "alias_prob", "alias_pos")


def _fills(g, plan, s):
    """(arcs, hash-table entries) filled in shard s."""
    rows = plan.rows_per_shard[s]
    deg = np.diff(g.offsets)
    return int(deg[rows].sum()), int(np.diff(g.hash_offsets)[rows].sum())


def _same_shard(a, b, f, fills):
    if f in EDGE_FIELDS:
        a, b = a[:fills[0]], b[:fills[0]]
    elif f == "hash_table":
        a, b = a[:fills[1]], b[:fills[1]]
    _assert_same(a, b, f)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("route", ["hash", "vcut"])
def test_partition_equal(name, route, karate_path, testgraph_path):
    """graph/partition.py: partition_graph (every field, the stacked form),
    plan_shards and each shard of build_shard equal the JAX package's."""
    jg, g = _pair(name, karate_path, testgraph_path)
    r = _routes(g.num_vertices)[route]
    S = 3
    jh = jpartition.partition_graph(jg, S, r, build_glob2loc=True)
    th = partition.partition_graph(g, S, r, build_glob2loc=True)
    jp, tp = jpartition.plan_shards(jg, S, r), partition.plan_shards(g, S, r)
    for f in dataclasses.fields(jh):
        a, b = getattr(th, f.name), getattr(jh, f.name)
        if f.name in EDGE_FIELDS + ("hash_table",):
            for s in range(S):
                _same_shard(a[s], b[s], f.name, _fills(jg, jp, s))
        else:
            _assert_same(a, b, f.name)
    assert th.replication_factor == jh.replication_factor
    for f in dataclasses.fields(jp):
        if f.name == "rows_per_shard":
            for a, b in zip(tp.rows_per_shard, jp.rows_per_shard):
                _assert_same(a, b, "rows_per_shard")
        else:
            _assert_same(getattr(tp, f.name), getattr(jp, f.name), f.name)
    for s in range(S):
        js, ts = (m.build_shard(x, p, s) for m, x, p in
                  ((jpartition, jg, jp), (partition, g, tp)))
        assert set(ts) == set(js)
        for k in js:
            _same_shard(ts[k], js[k], k, _fills(jg, jp, s))
        assert partition.shard_bucket_sizes(g, tp, s, True) == \
            jpartition.shard_bucket_sizes(jg, jp, s, True)


def test_partition_dense_fallback_and_helpers_equal():
    """The packed route's int32 overflow falls back to glob2loc alike;
    _kv_bucket_table, pack_route and shard_bits equal."""
    owned = [np.arange(0, 10), np.arange(10, 20)]
    route = np.repeat([0, 1], 10).astype(np.int32)
    num_owned = np.array([10, 10], np.int32)
    for S in (2, 5, 64):
        assert partition.shard_bits(S) == jpartition.shard_bits(S)
    _assert_same(partition.pack_route(route, owned, num_owned, 2),
                 jpartition.pack_route(route, owned, num_owned, 2), "pack")
    big = np.array([2**30 + 1, 0], np.int32)
    assert partition.pack_route(route, owned, big, 2) is None
    assert jpartition.pack_route(route, owned, big, 2) is None
    keys = np.random.default_rng(1).integers(0, 10**6, 300)
    rows = np.arange(300)
    for mult in (2654435761, 7):
        a, b = (m._kv_bucket_table(keys, rows, mult)
                for m in (partition, jpartition))
        _assert_same(a[0], b[0], "buckets")
        assert a[1] == b[1]
