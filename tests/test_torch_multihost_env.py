"""The port's CLI under the JAX package's multi-host environment variables.

The JAX CLI joins a jax.distributed process group when SRW_COORDINATOR or
SRW_NUM_PROCESSES is set (stellar_rw_tpu/parallel/multihost.py); so does
the port's (stellar_rw_tpu_torch/parallel/multihost.py, over
torch.distributed: tests/test_torch_multihost.py runs the groups). The
port has no TPU-pod autodetection: a group of more than one process needs
all three variables, and a missing or malformed one raises ValueError
naming it before the input is read or the output directory made.
SRW_NUM_PROCESSES=1 runs as with no variable set. Also here: the
backend's choice from every rank's (host, device), and each rank's
device."""

import filecmp

import pytest
import torch

from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.parallel import multihost

torch.set_num_threads(2)

SMALL = ["--cmd", "randomwalk", "--walkLength", "5", "--numWalks", "2",
         "--weighted", "false", "--seed", "3"]
COORD = "localhost:9731"


@pytest.mark.parametrize("env,missing", [
    ({"SRW_NUM_PROCESSES": "2"}, "SRW_COORDINATOR"),
    ({"SRW_NUM_PROCESSES": "4", "SRW_PROCESS_ID": "0"}, "SRW_COORDINATOR"),
    ({"SRW_COORDINATOR": COORD}, "SRW_NUM_PROCESSES"),
    ({"SRW_COORDINATOR": COORD, "SRW_NUM_PROCESSES": "0"},
     "SRW_NUM_PROCESSES"),
    ({"SRW_COORDINATOR": COORD, "SRW_NUM_PROCESSES": "2"},
     "SRW_PROCESS_ID"),
    ({"SRW_COORDINATOR": COORD, "SRW_NUM_PROCESSES": "2",
      "SRW_PROCESS_ID": "2"}, "SRW_PROCESS_ID"),
    ({"SRW_COORDINATOR": "9731", "SRW_NUM_PROCESSES": "2",
      "SRW_PROCESS_ID": "0"}, "SRW_COORDINATOR"),
])
def test_multihost_env_is_refused_before_any_output(karate_path, tmp_path,
                                                    monkeypatch, env,
                                                    missing):
    """A group with a variable missing (or out of range, or a coordinator
    that is not host:port): ValueError naming it, nothing written."""
    for name in ("SRW_COORDINATOR", "SRW_NUM_PROCESSES", "SRW_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=missing):
        cli.main(["--input", karate_path, "--output", str(out)] + SMALL,
                 device="cpu")
    assert not out.exists()
    assert not torch.distributed.is_initialized()


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
    assert not torch.distributed.is_initialized()


def test_arguments_take_precedence_over_the_environment(monkeypatch):
    """initialize's explicit arguments win over the variables, as in the
    JAX package; a count of 1 is no group."""
    monkeypatch.setenv("SRW_COORDINATOR", "elsewhere:1")
    monkeypatch.setenv("SRW_NUM_PROCESSES", "8")
    monkeypatch.setenv("SRW_PROCESS_ID", "7")
    assert multihost.settings("host0:9731", 4, 2) == ("host0:9731", 4, 2)
    assert multihost.settings(process_id=0) == ("elsewhere:1", 8, 0)
    assert multihost.settings(num_processes=1) is None
    assert multihost.settings(environ={}) is None


@pytest.mark.parametrize("places,backend", [
    ([("a", "cuda", 0), ("a", "cuda", 1)], "nccl"),
    ([("a", "cuda", 0), ("b", "cuda", 0)], "nccl"),
    ([("a", "cuda", 0), ("a", "cuda", 0)], "gloo"),
    ([("a", "cpu", None), ("a", "cpu", None)], "gloo"),
    ([("a", "cuda", 0), ("b", "cpu", None)], "gloo"),
])
def test_backend_from_every_ranks_place(places, backend):
    """nccl only where every rank has a card of its own: cuda:0 on two
    hosts is two cards, cuda:0 twice on one host is shared (NCCL refuses
    it), the CPU is gloo's."""
    assert multihost.backend_for_places(places) == backend


def test_rank_device(monkeypatch):
    """A rank's card is cuda:{rank % cards}; an index or the CPU asked for
    is kept."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.rank_device(6, "cuda") == torch.device("cuda", 2)
    assert multihost.rank_device(6, "cuda:1") == torch.device("cuda", 1)
    assert multihost.rank_device(6, "cpu") == torch.device("cpu")
