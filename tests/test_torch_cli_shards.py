"""The port's CLI on what the JAX package's CLI resolves before it walks:
--shards and --partitioned (one walk shard on the port's one device, /path
byte-equal to the JAX CLI's sharded and vertex-cut runs), shared negatives
above D = 512 (served on the card, matching the JAX CLI on the CPU), the
span of walk_seconds and the path-count warning. JAX runs with x64 off
on conftest's CPU devices."""

import filecmp
import logging
import time

import jax
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.utils import config as jconfig
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.utils.config import parse

torch.set_num_threads(2)

SMALL = ["--cmd", "randomwalk", "--walkLength", "5", "--numWalks", "2",
         "--weighted", "false", "--seed", "9"]


def _vcut_file(karate_path, tmp_path):
    """Karate with a partition id column, pid = src % 3 (as
    tests/test_cli.py builds it)."""
    part_file = tmp_path / "karate_part.txt"
    with open(karate_path) as f, open(part_file, "w") as g:
        for line in f:
            toks = line.split()
            if len(toks) >= 2:
                g.write(f"{toks[0]} {toks[1]} {int(toks[0]) % 3}\n")
    return str(part_file)


@pytest.mark.parametrize("flags,vcut", [
    (["--shards", "4"], False),
    (["--partitioned", "true", "--rddPartitions", "3"], True),
    (["--partitioned", "true", "--shards", "2"], True),
    (["--shards", "8"], False),
])
def test_sharded_flags_walk_like_the_jax_cli(karate_path, tmp_path, flags,
                                             vcut):
    """The JAX CLI walks these on several devices (sharded engine, vertex-
    cut routing); the port on its one device. The corpora are the same
    bitwise, so /path is byte-equal."""
    src = _vcut_file(karate_path, tmp_path) if vcut else karate_path
    argv = lambda out: ["--input", src, "--output", str(out)] + SMALL + flags
    with jax.enable_x64(False):
        assert jn2v.num_walk_shards(jconfig.parse(argv("x"))) > 1
        assert jcli.main(argv(tmp_path / "jax")) == 0
    report = {}
    assert cli.main(argv(tmp_path / "port"), device="cpu",
                    report=report) == 0
    assert report["paths"] == 2 * 34
    assert filecmp.cmp(tmp_path / "jax" / "path" / "part-00000",
                       tmp_path / "port" / "path" / "part-00000",
                       shallow=False)


@pytest.mark.parametrize("flags", [
    [], ["--shards", "1"], ["--shards", "2"], ["--shards", "64"],
    ["--partitioned", "true"], ["--partitioned", "true", "--rddPartitions",
                                "3"],
    ["--partitioned", "true", "--rddPartitions", "1"],
    ["--partitioned", "true", "--shards", "5"],
])
def test_num_walk_shards_resolves_like_jax(flags):
    """On the JAX package's device count the two resolve --shards alike; on
    the port's one device (no process group: its walk devices are one)
    every case is one shard, which run_walks takes to the single-device
    engine."""
    argv = ["--cmd", "randomwalk", "--input", "x", "--output", "y"] + flags
    want = jn2v.num_walk_shards(jconfig.parse(argv))
    params = parse(argv)
    assert n2v.num_walk_shards(params, devices=len(jax.devices())) == want
    assert n2v.num_walk_shards(params) == 1
    assert n2v.num_walk_shards(params, devices=n2v.walk_devices()) == 1


def _dim768(karate_path, out, *extra):
    return (["--input", karate_path, "--output", str(out), "--walkLength",
             "4", "--numWalks", "1", "--dim", "768", "--iter", "1",
             "--window", "2", "--cmd", "node2vec"] + list(extra))


def test_shared_negatives_above_512_served_on_the_card(karate_path,
                                                       tmp_path):
    """The shared-negative kernel serves any D (its split form above 256), so
    check_flags, which refuses before anything is loaded or written on the
    card as on the CPU, lets the pair of flags through, with exact
    negatives and for walks alone as before."""
    shared = _dim768(karate_path, tmp_path / "o", "--sharedNegatives", "128")
    cli.check_flags(parse(shared))
    cli.check_flags(parse(_dim768(karate_path, tmp_path / "o")))
    cli.check_flags(parse(shared[:-4] + ["--cmd", "randomwalk",
                                         "--sharedNegatives", "128"]))
    assert not (tmp_path / "o").exists()


def test_shared_negatives_above_512_match_the_jax_cli(karate_path, tmp_path):
    """--sharedNegatives 128 at --dim 768 through the CPU CLI: /path
    byte-equal to the JAX CLI's and the model within the trainers' rtol."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    with jax.enable_x64(False):
        assert jcli.main(_dim768(karate_path, jout, "--sharedNegatives",
                                 "128")) == 0
    assert cli.main(_dim768(karate_path, tout, "--sharedNegatives", "128"),
                    device="cpu") == 0
    assert filecmp.cmp(jout / "path" / "part-00000",
                       tout / "path" / "part-00000", shallow=False)
    for a, b in zip(jn2v.load_model(str(jout)), n2v.load_model(str(tout))):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    assert n2v.load_model(str(tout))[1].shape == (34, 768)


def test_walk_seconds_cover_the_graph_load(karate_path, tmp_path,
                                           monkeypatch):
    """walk_seconds starts before the graph is loaded, as the JAX CLI's
    walk time does."""
    load = cli.gio.load_edge_list

    def slow_load(*args, **kw):
        time.sleep(0.5)
        return load(*args, **kw)

    monkeypatch.setattr(cli.gio, "load_edge_list", slow_load)
    report = {}
    assert cli.main(["--input", karate_path, "--output",
                     str(tmp_path / "o")] + SMALL, device="cpu",
                    report=report) == 0
    assert report["walk_seconds"] >= 0.5


def test_path_count_warning(karate_path, tmp_path, monkeypatch, caplog):
    """A corpus of other than numWalks * |V| paths is warned about (not
    failed), as by the JAX CLI."""
    run = n2v.run_walks
    monkeypatch.setattr(n2v, "run_walks",
                        lambda *a, **kw: run(*a, **kw)[:-1])
    with caplog.at_level(logging.WARNING):
        assert cli.main(["--input", karate_path, "--output",
                         str(tmp_path / "o")] + SMALL, device="cpu") == 0
    assert "expected numWalks*|V| = 68" in caplog.text
