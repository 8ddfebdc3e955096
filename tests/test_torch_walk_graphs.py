"""Port corpora bit for bit against stellar_rw_tpu.walk.engine.random_walks
on the graphs the JAX engine tests use: directed with a dead end, self-loops
and multi-edges, weighted, isolated starts, a ~2K-vertex power-law graph,
and corpora split over several dispatches. Each side builds its graph with
its own package's loaders. JAX runs with x64 off."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import bench
from stellar_rw_tpu.graph import csr, io
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.graph import csr as tcsr
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _both(gs, schedule="dynamic", **kw):
    """gs = (the JAX package's graph, the port's graph)."""
    with jax.enable_x64(False):
        want = jengine.random_walks(gs[0], schedule=schedule, **kw)
    got = engine.random_walks(gs[1], device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.25, 4.0), (4.0, 1.0)])
def test_directed_dead_end(testgraph_path, pq):
    g = io.load_edge_list(testgraph_path, weighted=False, directed=True)
    tg = tio.load_edge_list(testgraph_path, weighted=False, directed=True)
    w = _both((g, tg), walk_length=5, num_walks=4, p=pq[0], q=pq[1], seed=0)
    idx = {int(o): i for i, o in enumerate(g.ids)}
    r2 = w[w[:, 0] == idx[2]]
    assert np.all(r2[:, 1:] == -1)          # isolated start: [s, -1, ...]


@pytest.mark.parametrize("pq", [(0.5, 2.0), (1.0, 0.25), (0.25, 0.25)])
def test_self_loop_and_multiedge(pq):
    adj = {0: [(0, 1.0), (1, 1.0)], 1: [(0, 1.0), (1, 1.0), (1, 1.0)]}
    gs = (csr.from_adjacency(adj), tcsr.from_adjacency(adj))
    w = _both(gs, walk_length=20, num_walks=2, p=pq[0], q=pq[1], seed=5)
    assert set(np.unique(w)) <= {0, 1}


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 2.0)])
def test_weighted_graph(pq):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 60, 400)
    dst = rng.integers(0, 60, 400)
    keep = src != dst
    wts = rng.random(keep.sum()).astype(np.float32) * 5 + 0.1
    gs = [m.from_edge_arrays(src[keep], dst[keep], wts, num_vertices=64,
                             symmetrize=True) for m in (csr, tcsr)]
    _both(gs, walk_length=10, num_walks=3, p=pq[0], q=pq[1], seed=11)


def test_isolated_and_repeated_starts(testgraph_path):
    gs = [m.load_edge_list(testgraph_path, weighted=False, directed=True)
          for m in (io, tio)]
    starts = np.array([1, 1, 0, 1, 0], dtype=np.int32)
    w = _both(gs, walk_length=4, num_walks=3, p=0.5, q=2.0, seed=2,
              starts=starts)
    assert w.shape == (15, 6)


@pytest.mark.parametrize("max_batch", [34, 70, 1000])
def test_several_dispatches(karate_path, max_batch):
    gs = [m.load_edge_list(karate_path, weighted=False, directed=False)
          for m in (io, tio)]
    _both(gs, walk_length=6, num_walks=5, p=0.25, q=4.0, seed=9,
          max_batch_walkers=max_batch)


@pytest.fixture(scope="module")
def synth2k():
    return (bench.synth_power_law_graph(2048, 32768, seed=1),
            _smoke().synth_power_law_graph(2048, 32768, seed=1))


def test_synth_power_law_static_schedule(synth2k):
    _both(synth2k, schedule="static", walk_length=10, num_walks=2, p=0.25,
          q=0.25, seed=0)


@pytest.mark.parametrize("pq", [(1.0, 1.0), (1.0, 4.0), (4.0, 0.25)])
def test_synth_power_law(synth2k, pq):
    _both(synth2k, walk_length=10, num_walks=2, p=pq[0], q=pq[1], seed=4)


def test_chip_smoke_graph_is_bench_graph():
    """chip_smoke.py re-implements bench.synth_power_law_graph without jax;
    the CSR it builds must be bench's."""
    a = _smoke().synth_power_law_graph(3000, 20000, seed=0)
    b = bench.synth_power_law_graph(3000, 20000, seed=0)
    for f in ("offsets", "cols", "weights", "ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
