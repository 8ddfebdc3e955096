"""The port's walk-round checkpoints (models/node2vec.py::
checkpointed_random_walks) against the JAX package's: resume bit for bit,
the fingerprint guard, a partial checkpoint written by one package resumed
by the other, and the CLI's /path byte for byte. JAX runs with x64 off."""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from stellar_rw_tpu import cli as jcli
from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.models import node2vec as jn2v
from stellar_rw_tpu.utils import config as jconfig
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.graph import io
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.utils import config
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def karate(karate_path):
    return io.load_edge_list(karate_path, weighted=False, directed=False)


@pytest.fixture(scope="module")
def jkarate(karate_path):
    return jio.load_edge_list(karate_path, weighted=False, directed=False)


def _base(karate_path, out, *extra):
    return ["--cmd", "randomwalk", "--input", karate_path, "--output",
            str(out), "--walkLength", "7", "--weighted", "false",
            "--checkpointEvery", "1", *extra]


@pytest.mark.parametrize("pq", [("1.0", "1.0"), ("0.01", "1.0")])
def test_walk_round_checkpoint_resume_bitwise(tmp_path, karate_path, karate,
                                              pq):
    """tests/test_stats_ckpt.py's case, with the rejection and the exact-CDF
    sampler: a run resumed from a partial checkpoint gives the
    uninterrupted corpus and reads the checkpointed rounds."""
    flags = ["--p", pq[0], "--q", pq[1]]
    base = _base(karate_path, tmp_path, *flags)
    uninterrupted = engine.random_walks(karate, walk_length=7, num_walks=5,
                                        p=float(pq[0]), q=float(pq[1]),
                                        seed=0, device="cpu")
    w2, resumed = n2v.checkpointed_random_walks(
        karate, config.parse(base + ["--numWalks", "2"]), "cpu")
    assert resumed == 0
    ckpt_dir = tmp_path / "bin" / n2v.WALK_CKPT_DIR
    marker = ckpt_dir / n2v.WALK_CKPT_MARKER
    assert json.loads(marker.read_text())["completed"] == 2
    assert sorted(f.name for f in ckpt_dir.glob("round-*.npy")) == [
        "round-00000.npy", "round-00001.npy"]
    np.testing.assert_array_equal(w2, uninterrupted[:2 * 34])

    w5, resumed = n2v.checkpointed_random_walks(
        karate, config.parse(base + ["--numWalks", "5", "--resume", "true"]),
        "cpu")
    assert resumed == 2
    np.testing.assert_array_equal(w5, uninterrupted)
    assert json.loads(marker.read_text())["completed"] == 5

    # the CLI goes through the same loop
    cli.run_job(config.parse(base + ["--numWalks", "3", "--resume", "true"]),
                torch.device("cpu"), {})
    assert json.loads(marker.read_text())["completed"] == 3


def test_walk_checkpoint_fingerprint_mismatch(tmp_path, karate_path, karate):
    """A changed seed voids the checkpoint; unchanged params resume it."""
    base = _base(karate_path, tmp_path, "--numWalks", "3")
    n2v.checkpointed_random_walks(karate, config.parse(base + ["--seed", "0"]),
                                  "cpu")
    p1 = config.parse(base + ["--seed", "1", "--resume", "true"])
    w1, resumed = n2v.checkpointed_random_walks(karate, p1, "cpu")
    assert resumed == 0
    fresh1 = engine.random_walks(karate, walk_length=7, num_walks=3, seed=1,
                                 device="cpu")
    np.testing.assert_array_equal(w1, fresh1)
    w1b, resumed = n2v.checkpointed_random_walks(karate, p1, "cpu")
    assert resumed == 3
    np.testing.assert_array_equal(w1b, fresh1)


def test_constants_and_fingerprint_equal_jax_package(tmp_path, karate_path):
    assert (n2v.WALK_CKPT_DIR, n2v.WALK_CKPT_MARKER) == \
        (jn2v.WALK_CKPT_DIR, jn2v.WALK_CKPT_MARKER)
    assert n2v._round_file("d", 12) == jn2v._round_file("d", 12)


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("pq", [("0.5", "2.0"), ("0.01", "1.0")])
def test_partial_checkpoint_resumes_in_the_other_package(
        tmp_path, karate_path, karate, jkarate, first, pq):
    """Two of five rounds checkpointed by one package, the rest walked by the
    other: the JAX package's uninterrupted corpus, bit for bit."""
    base = _base(karate_path, tmp_path, "--p", pq[0], "--q", pq[1],
                 "--seed", "6")
    part = base + ["--numWalks", "2"]
    full = base + ["--numWalks", "5", "--resume", "true"]
    kw = dict(walk_length=7, num_walks=5, p=float(pq[0]), q=float(pq[1]),
              seed=6)
    with jax.enable_x64(False):
        want = jengine.random_walks(jkarate, **kw)
        if first == "jax":
            jn2v.checkpointed_random_walks(jkarate, jconfig.parse(part))
        else:
            n2v.checkpointed_random_walks(karate, config.parse(part), "cpu")
        if first == "jax":
            got, resumed = n2v.checkpointed_random_walks(
                karate, config.parse(full), "cpu")
        else:
            got, resumed = jn2v.checkpointed_random_walks(
                jkarate, jconfig.parse(full))
    assert resumed == 2
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("extra", [[], ["--resume", "true"]])
def test_cli_randomwalk_checkpoint_every_matches_jax_cli(tmp_path,
                                                         karate_path, extra):
    """`--cmd randomwalk --checkpointEvery 1` (then again with --resume
    true, which reads every round back): /path byte for byte, and the same
    round files."""
    outs = {}
    for who in ("jax", "port"):
        out = tmp_path / who
        argv = _base(karate_path, out, "--numWalks", "3", "--p", "0.5",
                     "--q", "2")
        for flags in ([], extra) if extra else ([],):
            if who == "jax":
                with jax.enable_x64(False):
                    assert jcli.main(argv + flags) == 0
            else:
                assert cli.main(argv + flags, device="cpu") == 0
        outs[who] = out
    for sub in ("path/part-00000",
                "bin/walk_rounds/round-00002.npy",
                "bin/walk_rounds/marker.json"):
        assert filecmp.cmp(os.path.join(outs["jax"], sub),
                           os.path.join(outs["port"], sub), shallow=False), sub
