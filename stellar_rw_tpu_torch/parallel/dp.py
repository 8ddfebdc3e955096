"""Data parallelism of the skip-gram trainer: slots, the merged update and
the process group.

The counterpart of the dp `shard_map` of the JAX package's trainer
(stellar_rw_tpu/models/word2vec.py:631-668 for train_skipgram's
num_partitions, :776-823 for train_skipgram_multiproc). There a replica
is a device: it trains on its own corpus rows with its own key, and every
block's gradients are psum'd so that each replica applies the same merged
update. Here a replica is a *slot*:

  * global slot s = rank * local + j for local slot j of a process with
    `local` slots (slot_range); its corpus rows are one contiguous range
    of the padded corpus; its key for an epoch is
    fold_in(epoch_key, s) (slot_key), and block i's draws come from
    fold_in(that key, i), as in the JAX package;
  * the slots of one process share its card. With exact negatives their
    steps are one launch over all of them (ops/sgns_exact.py's slot
    form): in one process that launch is the merged update itself, with no
    buffer; across ranks it adds the slots' gradient sums and counts into
    the process's one reduction buffer (ops/dp_apply.py holds its layout).
    In the conv form each slot's step adds into the buffer in turn on one
    stream;
  * merge() makes one merged update from the buffer: where the trainer's
    slots span ranks, the buffer is summed across them by one
    all_reduce(SUM), then every rank applies the same update
    (ops/dp_apply.py::dp_apply), so the tables stay equal on every rank.

So P slots on one card compute the function that the JAX package's P
replicas compute on P devices, and so do P slots spread over ranks.

The process group (init_group) takes its backend from the device map:
nccl when every rank has a card of its own, gloo when ranks share a card
or run on the CPU (NCCL refuses two ranks on one device; gloo's all_reduce
and broadcast take CUDA tensors, staging them through the host). The
backend is chosen from the map, never as a fallback after a failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import prng
from ..ops.dp_apply import dp_apply

# all-reduces issued by all_reduce_sum, counted as a kernel's launches are
ALL_REDUCES = 0


def rank_world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when there
    is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def slot_range(rank: int, local: int) -> range:
    """The global slots of a process with `local` slots."""
    return range(rank * local, (rank + 1) * local)


def slot_key(epoch_key: torch.Tensor, slot: int) -> torch.Tensor:
    """A slot's key for an epoch: fold_in(epoch_key, slot)."""
    return prng.fold_in(epoch_key, slot)


def backend_for(devices) -> str:
    """The process group's backend for a device map (one device a rank):
    nccl when every rank has a CUDA device of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    cuda = all(d.type == "cuda" for d in devs)
    own = len({(d.type, d.index) for d in devs}) == len(devs)
    return "nccl" if cuda and own and all(d.index is not None
                                          for d in devs) else "gloo"


def init_group(rank: int, world: int, devices, init_method: str) -> str:
    """Join the default process group as `rank` of `world`. devices: the
    device map, one device a rank (or one device that every rank shares);
    init_method: e.g. "tcp://localhost:<port>". Returns the backend."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * world
    if len(devices) != world:
        raise ValueError(f"a device map of {len(devices)} for {world} ranks")
    backend = backend_for(devices)
    mine = torch.device(devices[rank])
    if mine.type == "cuda" and mine.index is not None:
        torch.cuda.set_device(mine)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return backend


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum t over the ranks of the default process group, in place."""
    global ALL_REDUCES
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    ALL_REDUCES += 1
    return t


def merge(w_in, w_out, buf: torch.Tensor, lr: float, reduce: bool) -> None:
    """One merged update from the reduction buffer `buf`: summed over the
    ranks first when `reduce` (the caller's slots span ranks), then the
    tables moved and the buffer emptied (dp_apply)."""
    if reduce:
        all_reduce_sum(buf)
    dp_apply(w_in, w_out, buf, lr)
