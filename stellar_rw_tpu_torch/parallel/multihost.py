"""Multi-host execution: the process group from the SRW_* environment, and
sharded walks whose every rank keeps and writes only its own corpus rows
(port of stellar_rw_tpu/parallel/multihost.py).

The JAX package runs one process a host over jax.distributed, each with
its local devices in one global mesh. Here one process is one rank of the
default torch.distributed process group, and each rank drives one device:
the JAX package's process count and device count are both the world size.

Launch (one process a card, on each host):
  SRW_COORDINATOR=host0:9731 SRW_NUM_PROCESSES=4 SRW_PROCESS_ID=<i> \\
      python -m stellar_rw_tpu_torch --cmd randomwalk ...
Rank i runs on cuda:{i % cards on its host}.

The backend is chosen before the group is formed: every rank puts its
(host, device) into a TCPStore served by rank 0 at SRW_COORDINATOR and
reads everyone's, so all ranks decide alike, nccl where every rank has a
card of its own and gloo where two ranks share a card (NCCL refuses them)
or run on the CPU. The same store then forms the group. There is no
fallback: a group that fails to form raises. The port has no TPU-pod
autodetection, so a group of more than one process needs all three
variables; a missing one raises ValueError naming it before anything is
read or written. SRW_NUM_PROCESSES=1 runs as one process with no group.
"""

from __future__ import annotations

import json
import logging
import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..graph.csr import CSRGraph
from . import distributed

logger = logging.getLogger("stellar_rw_tpu_torch.multihost")

ENV_COORD = "SRW_COORDINATOR"
ENV_NPROC = "SRW_NUM_PROCESSES"
ENV_PID = "SRW_PROCESS_ID"
# how long the store waits for every rank to join
JOIN_TIMEOUT = timedelta(seconds=300)


def settings(coordinator: str | None = None,
             num_processes: int | None = None,
             process_id: int | None = None, environ=os.environ):
    """(coordinator, num_processes, process_id) of a group to join, the
    arguments taking precedence over the SRW_* variables as in the JAX
    package; None for one process (no variable set, or a count of 1).
    Raises ValueError for a group with a variable missing or malformed."""
    coordinator = coordinator or environ.get(ENV_COORD) or None
    num_processes = num_processes or int(environ.get(ENV_NPROC) or 0) or None
    if process_id is None and environ.get(ENV_PID):
        process_id = int(environ[ENV_PID])
    if coordinator is None and num_processes is None:
        return None
    if num_processes is None:
        raise ValueError(f"{ENV_COORD}={coordinator!r} with no {ENV_NPROC}: "
                         "a process group needs its count (no "
                         "autodetection)")
    if num_processes == 1:
        return None
    if coordinator is None:
        raise ValueError(f"{ENV_NPROC}={num_processes} with no {ENV_COORD} "
                         "(host:port of rank 0)")
    if process_id is None:
        raise ValueError(f"{ENV_NPROC}={num_processes} with no {ENV_PID} "
                         "(this process's rank)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"{ENV_PID}={process_id} outside 0.."
                         f"{num_processes - 1}")
    _host_port(coordinator)
    return coordinator, num_processes, process_id


def _host_port(coordinator: str) -> tuple[str, int]:
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"{ENV_COORD}={coordinator!r} is not host:port")
    return host, int(port)


def rank_device(process_id: int, device) -> torch.device:
    """A rank's device: cuda:{process_id % cards} for "cuda" with no
    index, else the device asked for (the CPU too)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    return device


def backend_for_places(places) -> str:
    """The group's backend from every rank's (host, device type, index):
    nccl when every rank has a CUDA device of its own, else gloo."""
    places = [tuple(p) for p in places]
    cuda = all(kind == "cuda" for _, kind, _ in places)
    return "nccl" if cuda and len(set(places)) == len(places) else "gloo"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device="cuda") -> torch.device | None:
    """Join the default process group (explicit arguments or the SRW_*
    variables). Returns this rank's device (rank_device), or None where
    there is no group to join (one process)."""
    got = settings(coordinator, num_processes, process_id)
    if got is None:
        return None
    coordinator, n, pid = got
    device = rank_device(pid, device)
    host, port = _host_port(coordinator)
    store = dist.TCPStore(host, port, n, is_master=pid == 0,
                          timeout=JOIN_TIMEOUT)
    store.set(f"srw/place/{pid}", json.dumps(
        [socket.gethostname(), device.type, device.index]))
    places = [json.loads(store.get(f"srw/place/{r}")) for r in range(n)]
    backend = backend_for_places(places)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=pid, world_size=n)
    logger.info("multihost: process %d/%d on %s, backend %s", pid, n,
                device, backend)
    return device


def maybe_initialize_from_env(device="cuda") -> torch.device | None:
    """CLI hook: join a process group iff the SRW_* variables ask for one
    of more than one process. Returns initialize's device or None."""
    return initialize(device=device)


def shutdown(ok: bool = True) -> None:
    """Leave the default process group (a gloo rank that exits without
    destroy_process_group can abort): after a barrier when the job ran to
    its end on this rank."""
    if dist.is_available() and dist.is_initialized():
        if ok:
            dist.barrier()
        dist.destroy_process_group()


def multihost_random_walks(
    graph: CSRGraph,
    walk_length: int,
    num_walks: int,
    p: float = 1.0,
    q: float = 1.0,
    seed: int = 0,
    sampler: str = "rejection",
    dtype: str = "float32",
    num_shards: int | None = None,
    route: np.ndarray | None = None,
    capacity: int | None = None,
    rng_impl: str = "threefry",
    lanes: int = 1,
    *,
    device="cuda",
    timing: dict | None = None,
) -> tuple[list[tuple[int, np.ndarray]], np.ndarray]:
    """The sharded corpus over the ranks of the default group, every rank
    keeping only its own rows. Called on every rank with the same
    arguments; num_shards None walks on every rank.

    The walks are bitwise the single-device engine's; global corpus row
    r * W_pad + w is round r of walker w, and each rank's block (global
    row start, rows) is a contiguous slice of the padded corpus
    [num_walks * W_pad, L+2] (rows whose start slot was padding are all -1;
    W_pad = W rounded up to the walk devices). Returns (local blocks, diag
    summed over the ranks); a rank outside the walk group has no block.
    timing: see distributed.distributed_walk_corpus."""
    sw = distributed.walk_shards(
        graph, walk_length, num_walks, p, q, seed, sampler, dtype,
        num_shards, route, None, capacity, True, rng_impl, lanes,
        device=device, timing=timing)
    blocks = []
    if sw.paths is not None:
        n = sw.paths.shape[0]
        start = distributed.rank_world(sw.group)[0] * n
        blocks.append((start, sw.paths.cpu().numpy()))
    return blocks, sw.diag
