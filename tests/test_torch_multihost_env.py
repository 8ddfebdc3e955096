"""The port's CLI under the JAX package's multi-host environment variables.

The JAX CLI joins a jax.distributed process group when SRW_COORDINATOR or
SRW_NUM_PROCESSES is set (stellar_rw_tpu/parallel/multihost.py) and then
walks one shard of the corpus per host. The port serves one process: it
refuses a group of more than one (or a coordinator with no count) with
NotPorted naming ROADMAP Queue 1 item 12, before it reads the input or
makes the output directory, and runs SRW_NUM_PROCESSES=1 as with no
variable set."""

import filecmp

import pytest
import torch

from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.errors import NotPorted

torch.set_num_threads(2)

SMALL = ["--cmd", "randomwalk", "--walkLength", "5", "--numWalks", "2",
         "--weighted", "false", "--seed", "3"]


@pytest.mark.parametrize("env", [
    {"SRW_NUM_PROCESSES": "2"},
    {"SRW_NUM_PROCESSES": "4", "SRW_COORDINATOR": "localhost:9731",
     "SRW_PROCESS_ID": "0"},
    {"SRW_COORDINATOR": "localhost:9731"},
    {"SRW_COORDINATOR": "localhost:9731", "SRW_NUM_PROCESSES": "0"},
])
def test_multihost_env_is_refused_before_any_output(karate_path, tmp_path,
                                                    monkeypatch, env):
    for name in ("SRW_COORDINATOR", "SRW_NUM_PROCESSES", "SRW_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    out = tmp_path / "out"
    with pytest.raises(NotPorted, match="item 12"):
        cli.main(["--input", karate_path, "--output", str(out)] + SMALL,
                 device="cpu")
    assert not out.exists()


def test_one_process_runs_as_with_no_env(karate_path, tmp_path, monkeypatch):
    for name in ("SRW_COORDINATOR", "SRW_NUM_PROCESSES", "SRW_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    argv = lambda out: ["--input", karate_path, "--output", str(out)] + SMALL
    assert cli.main(argv(tmp_path / "unset"), device="cpu") == 0
    monkeypatch.setenv("SRW_NUM_PROCESSES", "1")
    assert cli.main(argv(tmp_path / "one"), device="cpu") == 0
    monkeypatch.setenv("SRW_COORDINATOR", "localhost:9731")
    assert cli.main(argv(tmp_path / "one_coord"), device="cpu") == 0
    for run in ("one", "one_coord"):
        assert filecmp.cmp(tmp_path / "unset" / "path" / "part-00000",
                           tmp_path / run / "path" / "part-00000",
                           shallow=False)
