"""The port's sharded walk engine (stellar_rw_tpu_torch/parallel/
distributed.py) on gloo ranks: subprocesses on the CPU
(CUDA_VISIBLE_DEVICES empty) joined through parallel/dp.py::init_group,
each holding only its own graph shard, the exchange by all_to_all_single.

Two ranks run every case of CASES in one spawn: the hash route, a vertex-cut
route (the homes of load_edge_list_partitioned on karate with a partition
column), 1 shard x 2 lanes, a directed graph with dead ends, W not divisible
by the ranks, a capacity of 1 (overflow rounds in every superstep), and
run_walks through --shards / --partitioned. Each corpus is held bitwise
against the JAX package's engine.random_walks and its
distributed_random_walks at the same shards, lanes, route and capacity on
conftest's CPU devices (both on JAX's dynamic schedule, whose corpus is the
static cascade's), and the exchange stats against JAX's. Then the
checkpointed sharded rounds, cut after a round and resumed, against the
uninterrupted corpus, and node2vec --streaming's sharded rounds against the
single-device run's /path. Eight ranks run once: karate and a ring of
8,191 vertices (W not divisible by 8), and layouts of fewer walk devices
than ranks (the walk on a subgroup of the first ranks, the corpus on every
rank): distributed_random_walks(num_shards=2), run_walks with --shards 2
--partitioned true and with --partitioned true --rddPartitions 3, and the
checkpointed rounds at --shards 2. The JAX references are computed while
the ranks run. JAX runs with x64 off."""

import filecmp
import json
import logging
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.graph.csr import from_edge_arrays as jfrom_edge_arrays
from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.ops import sampling as jsampling
from stellar_rw_tpu.parallel import distributed as jdist
from stellar_rw_tpu.utils import config as jconfig
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.ops import sampling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("num_shards", "lanes", "capacity", "replication_factor",
         "boundary_walkers", "zero_neighbors", "overflow_steps",
         "exchange_rounds_total", "exchange_rounds_with_traffic",
         "static_schedule_overflow")
WALK = dict(walk_length=6, num_walks=3, p=0.5, q=2.0, seed=3)

# the exact-CDF sampler: f64, or the chunked form (CDF_PAD_LIMIT and
# CDF_CHUNK set in both packages) at dyadic p, q; at p = 1/16, q = 4
# plan_sampler picks it
CDF64 = {"sampler": "cdf", "dtype": "float64"}
CHUNKED = {"sampler": "cdf", "chunk": 4, "p": 0.25, "q": 4.0}
AUTO_CDF = {"p": 0.0625, "q": 4.0}
# name -> (graph, lanes, route, capacity, starts, walk devices (None: the
# world), the walk's arguments beside WALK's)
CASES = {
    "hash": ("karate", 1, None, None, None, None, {}),
    "vcut": ("karate_vcut", 1, "home", None, None, None, {}),
    "lanes2": ("karate", 2, None, None, None, None, {}),
    "directed": ("karate_directed", 1, None, None, None, None, {}),
    "padded": ("karate", 1, None, None, 33, None, {}),
    "capacity1": ("karate", 1, None, 1, None, None, {}),
    "vcut_capacity1": ("karate_vcut", 1, "home", 1, None, None, {}),
    "cdf_hash": ("karate", 1, None, None, None, None, CDF64),
    "cdf_vcut_capacity1": ("karate_vcut", 1, "home", 1, None, None,
                           {"sampler": "cdf"}),
    "cdf_directed": ("karate_directed", 1, None, None, None, None, CDF64),
    "cdf_chunked": ("karate", 1, None, None, None, None, CHUNKED),
    "cdf_auto": ("karate", 1, None, None, None, None, AUTO_CDF),
}
# held to the port's single-device corpus, not JAX's: at p = q = 100 the
# quotient 0.01 is inexact and XLA's CPU cumsum sums in blocks
PORT_CASES = {"cdf_chunked_pq100": (
    "karate", 1, None, None, None, None,
    {"sampler": "cdf", "chunk": 4, "p": 100.0, "q": 100.0})}
EIGHT = {"karate8": ("karate", 1, None, None, None, None, {}),
         "ring8": ("ring", 1, None, None, None, None, {}),
         "sub2of8": ("karate", 1, None, None, None, 2, {}),
         "cdf8": ("karate", 1, None, None, None, None, CDF64)}
# run_walks on eight ranks at fewer walk devices: name -> (flags, the JAX
# case its corpus is)
SUB_RUNS = {"partitioned2": (["--shards", "2"],
                             ("karate_vcut", 1, "home", None, None, 2, {})),
            "partitioned3": (["--rddPartitions", "3"],
                             ("karate_vcut", 1, "home", None, None, 3, {}))}
# the CLI's walk at --shards 2, p = 1/16, q = 4 (two ranks)
CDF_CLI = ["--cmd", "randomwalk", "--shards", "2", "--walkLength", "6",
           "--numWalks", "3", "--p", "0.0625", "--q", "4", "--seed", "3",
           "--weighted", "false"]

WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from stellar_rw_tpu_torch.graph import io
from stellar_rw_tpu_torch.graph.csr import from_edge_arrays
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.ops import sampling
from stellar_rw_tpu_torch.parallel import distributed, dp
from stellar_rw_tpu_torch.utils.config import parse

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
cases, walk, paths = json.loads(sys.argv[5]), json.loads(sys.argv[6]), \
    json.loads(sys.argv[7])
dp.init_group(rank, world, "cpu", f"tcp://localhost:{port}")


def graph(name):
    if name == "ring":
        src = np.arange(8191)
        return from_edge_arrays(src, (src + 1) % 8191, num_vertices=8191,
                                symmetrize=True), None
    if name == "karate_vcut":
        return io.load_edge_list_partitioned(
            paths["vcut"], weighted=False, partitioned=True,
            num_partitions=3, use_native=False)
    return io.load_edge_list(paths["karate"], weighted=False,
                             directed=name == "karate_directed"), None


result = {}
limits = sampling.CDF_PAD_LIMIT, sampling.CDF_CHUNK
for name, (gname, lanes, route, cap, nstarts, shards, extra) in \
        cases.items():
    g, home = graph(gname)
    shards = shards or world
    r = None if route is None else (home % (shards // lanes)).astype(np.int32)
    starts = None if nstarts is None else np.arange(nstarts, dtype=np.int32)
    kw = dict(walk) if gname != "ring" else dict(walk_length=4, num_walks=2,
                                                 p=0.25, q=0.25, seed=9)
    kw.update(extra)
    chunk = kw.pop("chunk", None)
    if chunk:   # the chunked exact-CDF form
        sampling.CDF_PAD_LIMIT, sampling.CDF_CHUNK = 1, chunk
    walks, stats = distributed.distributed_random_walks(
        g, route=r, capacity=cap, lanes=lanes, starts=starts,
        return_stats=True, device="cpu", num_shards=shards, **kw)
    sampling.CDF_PAD_LIMIT, sampling.CDF_CHUNK = limits
    np.save(f"{out}/{name}_rank{rank}.npy", walks)
    result[name] = {k: v for k, v in stats.items() if k != "diag"}

base = ["--cmd", "randomwalk", "--walkLength", "6", "--numWalks", "3",
        "--p", "0.5", "--q", "2.0", "--seed", "3", "--weighted", "false"]
if world == 8:
    # fewer walk devices than ranks: run_walks through the flags, and the
    # checkpointed rounds
    g, home = graph("karate_vcut")
    for name, flags in json.loads(sys.argv[8]).items():
        p = parse(["--input", paths["vcut"], "--output", f"{out}/{name}",
                   "--partitioned", "true"] + flags + base)
        np.save(f"{out}/{name}_rank{rank}.npy",
                n2v.run_walks(g, p, device="cpu", home=home).numpy())
    g, _ = graph("karate")
    p = parse(["--input", paths["karate"], "--output", f"{out}/ck",
               "--shards", "2", "--checkpointEvery", "1"] + base)
    np.save(f"{out}/ckpt2_rank{rank}.npy",
            n2v.checkpointed_random_walks(g, p, "cpu")[0])

if world == 2:
    # run_walks through --shards / --partitioned (the shards report line)
    g, home = graph("karate_vcut")
    p = parse(["--input", paths["vcut"], "--output", f"{out}/rw",
               "--partitioned", "true", "--shards", "2"] + base)
    np.save(f"{out}/run_walks_rank{rank}.npy",
            n2v.run_walks(g, p, device="cpu", home=home).numpy())

    # the checkpointed rounds: whole, cut after round 0, resumed; then the
    # same at p = 1/16, q = 4 (the exact-CDF sampler)
    g, _ = graph("karate")

    class Cut(Exception):
        pass

    maker = n2v._round_maker

    def cut_maker(*a, **kw):
        make_round, V = maker(*a, **kw)

        def make(r):
            if r == 1:
                raise Cut
            return make_round(r)
        return make, V

    cdf_base = base + ["--p", "0.0625", "--q", "4"]
    for tag, flags in (("", base), ("_cdf", cdf_base)):
        ck = lambda o, resume: parse(
            ["--input", paths["karate"], "--output", f"{out}/{o}{tag}",
             "--shards", "2", "--checkpointEvery", "1", "--resume",
             "true" if resume else "false"] + flags)
        whole, _ = n2v.checkpointed_random_walks(g, ck("whole", False),
                                                 "cpu")
        n2v._round_maker = cut_maker
        try:
            n2v.checkpointed_random_walks(g, ck("cut", False), "cpu")
        except Cut:
            result["cut" + tag] = True
        n2v._round_maker = maker
        resumed, start = n2v.checkpointed_random_walks(g, ck("cut", True),
                                                       "cpu")
        result["resumed_from" + tag] = start
        np.save(f"{out}/ckpt{tag}_rank{rank}.npy", np.stack([whole, resumed]))

    # the CLI's walk over --shards 2 at p = 1/16, q = 4: each rank writes
    # its /path
    cli.do_random_walk(parse(["--input", paths["karate"], "--output",
                              f"{out}/cdf_cli{rank}"]
                             + json.loads(sys.argv[9])),
                       torch.device("cpu"), {})

    # node2vec --streaming true on the sharded rounds
    p = parse(["--input", paths["karate"], "--output", f"{out}/stream",
               "--cmd", "node2vec", "--streaming", "true", "--shards", "2",
               "--walkLength", "6", "--numWalks", "2", "--dim", "8",
               "--iter", "1", "--window", "3", "--seed", "2",
               "--weighted", "false"])
    n2v.run_node2vec_streaming(g, p, "cpu")
print("RESULT " + json.dumps(result), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _vcut_file(karate_path, out):
    """Karate with a partition column, pid = src % 3 (as tests/test_cli.py
    builds it)."""
    path = out / "karate_part.txt"
    with open(karate_path) as f, open(path, "w") as g:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                g.write(f"{toks[0]} {toks[1]} {int(toks[0]) % 3}\n")
    return str(path)


def _spawn(world, cases, karate_path, out, timeout, meanwhile):
    """Run the worker on `world` ranks; `meanwhile` runs here while they
    do. Returns each rank's (result, stdout)."""
    paths = {"karate": karate_path, "vcut": _vcut_file(karate_path, out)}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    runs = {k: flags for k, (flags, _) in SUB_RUNS.items()}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), port, str(out),
         json.dumps(cases), json.dumps(WALK), json.dumps(paths),
         json.dumps(runs), json.dumps(CDF_CLI)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results = []
    try:
        meanwhile()
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            results.append((json.loads(line[-1][len("RESULT "):]), stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


@pytest.fixture(scope="module")
def two_ranks(karate_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("walk_ranks")

    def refs():
        for spec in CASES.values():
            _jax_case(karate_path, out, 2, *spec)
        _jax_cli_path(karate_path, out)
    return _spawn(2, {**CASES, **PORT_CASES}, karate_path, out, 300,
                  refs), out


@pytest.fixture(scope="module")
def eight_ranks(karate_path, tmp_path_factory):
    out = tmp_path_factory.mktemp("walk_ranks8")

    def refs():
        for spec in list(EIGHT.values()) + [s for _, s in SUB_RUNS.values()]:
            _jax_case(karate_path, out, 8, *spec)
    return _spawn(8, EIGHT, karate_path, out, 240, refs), out


_JAX = {}


def _jax_case(karate_path, out, world, gname, lanes, route, cap, nstarts,
              shards, extra):
    """(single-device corpus, sharded corpus, sharded stats) of the JAX
    package for one case, at `shards` devices (None: `world`); each case is
    computed once."""
    shards = shards or world
    key = (gname, shards, lanes, route, cap, nstarts,
           json.dumps(extra, sort_keys=True))
    if key not in _JAX:
        _JAX[key] = _jax_walks(karate_path, out, *key[:-1], extra)
    return _JAX[key]


def _jax_cli_path(karate_path, out) -> str:
    """The JAX CLI's /path for CDF_CLI (its sharded engine on conftest's
    CPU devices); computed once."""
    if "cli" not in _JAX:
        args = CDF_CLI + ["--input", karate_path, "--output",
                          str(out / "jax_cdf_cli")]
        with jax.enable_x64(False):
            jcli.run_job(jconfig.parse(args))
        _JAX["cli"] = (out / "jax_cdf_cli" / "path" / "part-00000"
                       ).read_text()
    return _JAX["cli"]


def _jax_walks(karate_path, out, gname, shards, lanes, route, cap, nstarts,
               extra):
    if gname == "ring":
        src = np.arange(8191)
        g = jfrom_edge_arrays(src, (src + 1) % 8191, num_vertices=8191,
                              symmetrize=True)
        kw = dict(walk_length=4, num_walks=2, p=0.25, q=0.25, seed=9)
        home = None
    elif gname == "karate_vcut":
        g, home = jio.load_edge_list_partitioned(
            _vcut_file(karate_path, out), weighted=False, partitioned=True,
            num_partitions=3, use_native=False)
        kw = dict(WALK)
    else:
        g = jio.load_edge_list(karate_path, weighted=False,
                               directed=gname == "karate_directed")
        home, kw = None, dict(WALK)
    r = None if route is None else (home % (shards // lanes)).astype(np.int32)
    starts = None if nstarts is None else np.arange(nstarts, dtype=np.int32)
    kw.update(extra)
    chunk = kw.pop("chunk", None)
    limits = jsampling.CDF_PAD_LIMIT, jsampling.CDF_CHUNK
    if chunk:   # the chunked exact-CDF form
        jsampling.CDF_PAD_LIMIT, jsampling.CDF_CHUNK = 1, chunk
    # the dynamic schedule: the same corpus as the static cascade, which
    # takes some 40 s more to compile on the CPU for each layout; float64
    # draws need x64 on
    try:
        with jax.enable_x64(kw.get("dtype") == "float64"):
            single = np.asarray(jengine.random_walks(
                g, starts=starts, schedule="dynamic", **kw))
            multi, stats = jdist.distributed_random_walks(
                g, num_shards=shards, route=r, capacity=cap, lanes=lanes,
                starts=starts, return_stats=True, schedule="dynamic", **kw)
    finally:
        jsampling.CDF_PAD_LIMIT, jsampling.CDF_CHUNK = limits
    return single, np.asarray(multi), stats


def _check_case(name, spec, ranks, karate_path, world):
    results, out = ranks
    single, multi, jstats = _jax_case(karate_path, out, world, *spec)
    got = [np.load(out / f"{name}_rank{r}.npy") for r in range(world)]
    for g in got:
        np.testing.assert_array_equal(g, single)
    np.testing.assert_array_equal(multi, single)
    for stats, _ in results:
        for k in STATS:
            assert stats[name][k] == jstats[k], (k, stats[name][k], jstats[k])
    return results[0][0][name]


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_jax(name, two_ranks, karate_path):
    """The corpus on two gloo ranks is bitwise JAX's engine.random_walks
    and its distributed_random_walks at the same layout, on both ranks, and
    the exchange stats are JAX's."""
    stats = _check_case(name, CASES[name], two_ranks, karate_path, 2)
    if name in ("capacity1", "cdf_vcut_capacity1"):
        assert stats["overflow_steps"] > 0
    if name in ("directed", "cdf_directed"):
        assert stats["zero_neighbors"] > 0
    if name == "lanes2":
        assert (stats["num_shards"], stats["lanes"]) == (1, 2)


@pytest.mark.parametrize("name", list(EIGHT))
def test_eight_ranks_match_jax(name, eight_ranks, karate_path):
    """Eight gloo ranks, once: karate and a ring of 8,191 vertices (W
    padded to 8,192), bitwise and with JAX's stats; and karate on the
    first 2 of the 8 ranks (num_shards=2), with the corpus and the stats
    on all 8, JAX's at 2 devices."""
    stats = _check_case(name, EIGHT[name], eight_ranks, karate_path, 8)
    assert stats["num_shards"] == (EIGHT[name][5] or 8)


@pytest.mark.parametrize("name", list(SUB_RUNS))
def test_run_walks_on_fewer_devices_than_ranks(name, eight_ranks,
                                               karate_path):
    """run_walks on eight ranks with --partitioned true and --shards 2, or
    with --rddPartitions 3, walks on the first 2 or 3 ranks (the JAX
    package caps the shards at its devices and meshes that many), and
    every rank, walking or not, gets JAX's corpus at that many devices."""
    results, out = eight_ranks
    _, multi, _ = _jax_case(karate_path, out, 8, *SUB_RUNS[name][1])
    for r in range(8):
        np.testing.assert_array_equal(
            np.load(out / f"{name}_rank{r}.npy"), multi)
    S = SUB_RUNS[name][1][5]
    for _, stdout in results:
        assert f"shards: {S} x 1 lanes (vcut routing)" in stdout


def test_checkpointed_rounds_on_fewer_devices_than_ranks(eight_ranks,
                                                         karate_path):
    """The checkpointed sharded rounds at --shards 2 on eight ranks give
    every rank JAX's single-device corpus."""
    _, out = eight_ranks
    single, _, _ = _jax_case(karate_path, out, 8, "karate", 1, None, None,
                             None, 2, {})
    for r in range(8):
        np.testing.assert_array_equal(np.load(out / f"ckpt2_rank{r}.npy"),
                                      single)


def test_run_walks_sharded_vcut(two_ranks, karate_path):
    """run_walks with --shards 2 --partitioned true on each rank routes by
    home % 2 (the vertex-cut loader's homes), prints the JAX package's
    shards report line, and gives the JAX CLI's corpus."""
    results, out = two_ranks
    _, multi, _ = _jax_case(karate_path, out, 2, "karate_vcut", 1, "home",
                            None, None, None, {})
    for r in range(2):
        np.testing.assert_array_equal(
            np.load(out / f"run_walks_rank{r}.npy"), multi)
    for _, stdout in results:
        assert "shards: 2 x 1 lanes (vcut routing)" in stdout


def test_checkpointed_sharded_rounds_resume(two_ranks, karate_path):
    """The sharded rounds cut after round 0 and resumed (rank 0 read the
    marker and broadcast where to start) equal the uninterrupted corpus,
    which is JAX's."""
    _check_resumed(two_ranks, karate_path, "", {})


def test_checkpointed_sharded_cdf_rounds_resume(two_ranks, karate_path):
    """The same at p = 1/16, q = 4, where plan_sampler takes the exact-CDF
    sampler: the sharded CDF rounds cut after round 0 and resumed equal
    the uninterrupted corpus, which is JAX's."""
    _check_resumed(two_ranks, karate_path, "_cdf", AUTO_CDF)


def _check_resumed(two_ranks, karate_path, tag, extra):
    results, out = two_ranks
    assert all(r["cut" + tag] and r["resumed_from" + tag] == 1
               for r, _ in results)
    single, _, _ = _jax_case(karate_path, out, 2, "karate", 1, None, None,
                             None, None, extra)
    for r in range(2):
        whole, resumed = np.load(out / f"ckpt{tag}_rank{r}.npy")
        np.testing.assert_array_equal(whole, single)
        np.testing.assert_array_equal(resumed, whole)


@pytest.mark.parametrize("name", list(PORT_CASES))
def test_two_ranks_cdf_match_the_port_where_jax_sums_otherwise(
        name, two_ranks, karate_path, monkeypatch):
    """The chunked form at p = q = 100 (the quotient 0.01 inexact): the
    corpus on two ranks is bitwise the port's single-device exact-CDF
    corpus, which sums in the same order (JAX's XLA cumsum runs in blocks
    past 17 entries, so it is no yardstick here)."""
    from stellar_rw_tpu_torch.graph import io as tio
    from stellar_rw_tpu_torch.walk import engine

    results, out = two_ranks
    gname, *_, extra = PORT_CASES[name]
    kw = dict(WALK, **extra)
    monkeypatch.setattr(sampling, "CDF_PAD_LIMIT", 1)
    monkeypatch.setattr(sampling, "CDF_CHUNK", kw.pop("chunk"))
    g = tio.load_edge_list(karate_path, weighted=False)
    single = engine.random_walks(g, device="cpu", **kw)
    for r in range(2):
        np.testing.assert_array_equal(np.load(out / f"{name}_rank{r}.npy"),
                                      single)
    for stats, _ in results:
        assert stats[name]["num_shards"] == 2


def test_cli_cdf_path_over_two_shards_equals_jax_cli(two_ranks,
                                                     karate_path):
    """The CLI's walk at --shards 2, p = 1/16, q = 4 (plan_sampler: the
    exact-CDF sampler) on two ranks: each rank's /path is the JAX CLI's
    byte for byte."""
    _, out = two_ranks
    want = _jax_cli_path(karate_path, out)
    for r in range(2):
        assert (out / f"cdf_cli{r}" / "path" / "part-00000").read_text() \
            == want


def test_streaming_sharded_rounds_write_single_device_path(two_ranks,
                                                          karate_path,
                                                          tmp_path):
    """node2vec --streaming true on two ranks writes (rank 0) the /path of
    the single-device streamed run."""
    from stellar_rw_tpu_torch import cli

    _, out = two_ranks
    argv = ["--input", karate_path, "--output", str(tmp_path / "one"),
            "--cmd", "node2vec", "--streaming", "true", "--walkLength", "6",
            "--numWalks", "2", "--dim", "8", "--iter", "1", "--window", "3",
            "--seed", "2", "--weighted", "false"]
    assert cli.main(argv, device="cpu") == 0
    assert filecmp.cmp(tmp_path / "one" / "path" / "part-00000",
                       out / "stream" / "path" / "part-00000", shallow=False)


def test_resolve_lanes_like_jax(caplog):
    """--lanes clamps to a divisor of the device count, with the JAX
    package's warning (tests/test_distributed.py's cases)."""
    cases = [(6, 4), (8, 3), (8, 4), (8, 99), (7, 2), (1, 1)]
    for S, lanes in cases:
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            got = n2v.resolve_lanes(S, lanes)
            ours = [r.getMessage() for r in caplog.records]
            caplog.clear()
            want = jn2v.resolve_lanes(S, lanes)
            theirs = [r.getMessage() for r in caplog.records]
        assert got == want
        assert ours == theirs
    assert [n2v.resolve_lanes(S, la) for S, la in cases] == [3, 2, 4, 8, 1, 1]


def test_one_rank_walks_one_shard():
    """Without a process group the walk devices are one: --shards N and
    --partitioned true resolve to one shard, as the JAX package's cap at
    its device count does."""
    from stellar_rw_tpu_torch.utils.config import parse

    assert n2v.walk_devices() == 1
    for flags in (["--shards", "4"], ["--partitioned", "true"]):
        p = parse(["--cmd", "randomwalk", "--input", "x", "--output", "y"]
                  + flags)
        assert n2v.num_walk_shards(p) == 1


def test_sharded_refusals(two_ranks, eight_ranks):
    """'rbg' keys have no port: refused with NotPorted, threefry keys
    taken. The exact-CDF sampler is served at 2 and at 8 walk devices:
    the spawns' CDF cases ran on every rank (their corpora are held to
    JAX's above)."""
    from stellar_rw_tpu_torch.errors import NotPorted
    from stellar_rw_tpu_torch.parallel import distributed

    for impl in ("rbg", "unsafe_rbg"):
        with pytest.raises(NotPorted, match="rbg"):
            distributed.check_sharded(impl)
    distributed.check_sharded("threefry")
    for (results, _), name, D in ((two_ranks, "cdf_hash", 2),
                                  (eight_ranks, "cdf8", 8)):
        assert len(results) == D
        for stats, _ in results:
            assert stats[name]["num_shards"] == D
