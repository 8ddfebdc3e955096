"""The sharded walk engine over torch.distributed ranks (port of
stellar_rw_tpu/parallel/distributed.py).

The JAX package runs the walks across S graph shards x L lanes of a device
mesh under shard_map. Here a device is a rank of the default process group,
one device a rank: rank d is graph shard d // L, lane d % L, and holds only
its own shard (graph/partition.py: plan_shards, then build_shard), so a
rank's host memory is the graph plus one shard.

Design ("remote sampling", as in the JAX package): walker state never
migrates. Each superstep
  * the first exchange round's buckets are built (ops/shard_walk.py::emit,
    K11's request-emit half), which also flags the walkers whose current
    vertex this shard owns;
  * every other live walker's request (cur, prev, gid) goes to its owner
    in one all_to_all_single of a packed [D, C, 3] int32 buffer, right
    after the emit (so the copy of the buffer to the host waits for the
    emit alone);
  * one launch of shard_walk.serve (K11's serve half) steps the flagged
    local walkers in place (the local fast path, no collective) and the
    requests received; the destinations go back in one all_to_all_single
    of [D, C + 1], whose last column carries each rank's count of requests
    still unsent, so every rank learns the global count from the same
    call. Overflow rounds (the serve on the requests alone) run while that
    count is above 0; every rank runs the same number of collectives.

Determinism: every uniform is addressed by the global walker id (round
gid // W_pad, lane gid % W_pad; step keys fold the round, then the step),
so the corpus is bitwise the single-device engine's for any shard count,
lane count, route and exchange capacity.

Collectives: all_to_all_single on the tensors where they are (gloo takes
CUDA tensors in it, as it must for ranks that share a card, where NCCL
refuses two ranks on one device). A layout of fewer walk devices than the
default group has ranks walks on the subgroup of its first ranks
(walk_group), as the JAX package meshes as many devices as the shards ask
for. walk_shards leaves each walking rank its own rows of the corpus
(the multi-host CLI writes and trains on them: parallel/multihost.py);
distributed_random_walks gathers them, so that every rank of the default
group gets the corpus.

The exact-CDF sampler (sampler "cdf", or a p/q ratio beyond 32) serves
both halves of a superstep by shard_walk.cdf_serve (K7's row scan applied
to one request, prev's neighbor set read from a bitmap at long rows, the
received buffer's fills skipped; its counters made once a corpus) on each
shard's cdf_rows: no trial-key table is made, and u is drawn at the
accumulation type from the seed key, addressed by the
request's global walker id, so the corpus is bitwise the single-device
exact-CDF engine's too. It keeps a launch a half, in the same order: the
local walkers by their flags, then the requests received. Padded against
chunked is decided from the whole corpus (engine.walk_spec), as in every
engine.

Left out: the static-schedule overflow re-dispatch (a per-thread trial
loop has no compaction buffer that could overflow; its diag column reads
0) and 'rbg' keys (no port).
"""

from __future__ import annotations

import logging
import math
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..errors import NotPorted, resolve_device
from ..graph.csr import CSRGraph
from ..graph.partition import ShardPlan, plan_shards
from ..ops import prng, sampling, shard_walk, walk_step
from ..walk import engine
from ..walk.engine import WalkSpec

logger = logging.getLogger("stellar_rw_tpu_torch.distributed")


class _Clock:
    """A corpus's timing, recorded around the engine's calls into `timing`
    (a dict) when it is given: emit_ms and serve_ms (CUDA events around
    each call, summed: the kernel and the gap before it on the stream) with
    their calls, collective_host_ms (host time in the exchanges),
    supersteps and exchange_rounds. Without it nothing is recorded."""

    def __init__(self, dev, timing: dict | None):
        self.timing = timing
        self.on = timing is not None
        self.cuda = self.on and dev.type == "cuda"
        self.events = {"emit": [], "serve": []}
        self.host = 0.0

    def device(self, kind, fn, *args, **kw):
        if not self.cuda:
            return fn(*args, **kw)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        self.events[kind].append((a, b))
        return out

    def collective(self, fn, *args):
        if not self.on:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        self.host += time.perf_counter() - t0
        return out

    def close(self, supersteps: int, rounds: int) -> None:
        if not self.on:
            return
        if self.cuda:
            torch.cuda.synchronize()
        for kind, ev in self.events.items():
            self.timing[f"{kind}_ms"] = sum(a.elapsed_time(b) for a, b in ev)
            self.timing[f"{kind}_calls"] = len(ev)
        self.timing.update(collective_host_ms=self.host * 1e3,
                           supersteps=supersteps, exchange_rounds=rounds)


def rank_world(group=None) -> tuple[int, int]:
    """(rank, world size) in `group` (None: the default process group);
    (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def walk_group(D: int):
    """(group, member): the process group of the D walk devices, the first
    D ranks of the default group (None when D is its world size), and
    whether this rank is one of them. Every rank of the default group calls
    it, in the same order."""
    rank, world = rank_world()
    if D == world:
        return None, True
    if D > world:
        raise ValueError(f"{D} walk devices, the group has {world} ranks")
    return dist.new_group(list(range(D))), rank < D


def for_backend(t: torch.Tensor, device) -> torch.Tensor:
    """t where the group's backend takes it for a small collective: on
    `device` under nccl, on the host under gloo."""
    return t.to(device) if dist.get_backend() == "nccl" else t.cpu()


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single of equal [D, k] chunks over `group`."""
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out


def _shard_slice_of_tiled(starts_s: torch.Tensor, gids: torch.Tensor,
                          W_pad: int, D: int, group=None) -> torch.Tensor:
    """starts for my gid range of the R-times-tiled global start array.

    The global walker order is gid = r*W_pad + w; device d holds a
    contiguous gid slice, which maps back to start index gid % W_pad.
    starts_s is only my W_pad/D slice of the starts array, so the full
    array comes by an all_gather over the group (once per corpus)."""
    mine = for_backend(starts_s, gids.device)
    parts = [torch.empty_like(mine) for _ in range(D)]
    dist.all_gather(parts, mine, group=group)
    starts_full = torch.cat(parts).to(gids.device)
    return starts_full[(gids % W_pad).long()]


def distributed_walk_corpus(tables: shard_walk.ShardTables,
                            starts_pad: torch.Tensor, key: torch.Tensor,
                            round_offset: int, spec: WalkSpec,
                            num_walks: int, S: int, C: int, L: int = 1,
                            timing: dict | None = None, group=None):
    """All num_walks rounds of one walk per (padded) start vertex, this
    rank's share of them, across S graph shards x L lanes (the ranks of
    `group`, None: the default group).

    Returns (paths i32[n, L+2] on the tables' device, diag i64[L+1, 4]):
    paths row i is walker gid = rank * n + i (round gid // W_pad of start
    gid % W_pad), bitwise the single-device engine's row; diag row t is
    (boundary walkers, new dead ends, exchange rounds, static-schedule
    overflow (0)) at superstep t, summed over the ranks.

    starts_pad: i32 [W_pad], W_pad a multiple of S*L, padding -1 (never
    sampled, all-(-1) rows); every rank passes the same array. C: the
    per-destination bucket capacity of the exchange. timing, when given,
    receives the corpus's timing (_Clock).
    """
    rank, world = rank_world(group)
    D = S * L
    if world != D:
        raise ValueError(f"{S} shards x {L} lanes need {D} ranks, the "
                         f"group has {world}")
    if tables.shard != rank // L or tables.S != S:
        raise ValueError(f"rank {rank} holds shard {tables.shard} of "
                         f"{tables.S}, not {rank // L} of {S}")
    dev = tables.device
    W_pad = starts_pad.shape[0]
    R = num_walks
    W_total = R * W_pad
    if W_pad % D or W_total >= 2**31:
        raise ValueError(f"W_pad {W_pad} not a multiple of {D}, or walker "
                         "ids beyond i32")
    n = W_total // D
    Lw = spec.walk_length
    ns = spec.n_stream or W_pad
    gid_base = rank * n
    gids = gid_base + torch.arange(n, dtype=torch.int64, device=dev)
    starts_pad = starts_pad.to(dev)
    if D == 1:
        starts_l = starts_pad.repeat(R)
    else:
        w = W_pad // D
        starts_l = _shard_slice_of_tiled(
            starts_pad[rank * w:(rank + 1) * w], gids, W_pad, D, group)
    real = starts_l >= 0
    start_rows = starts_l.clamp_min(0).to(torch.int32)
    T = spec.max_rounds * spec.k_candidates
    keys = []   # the trial-key table, made after the first emit
    work = (shard_walk.emit_work(n, D, C, dev) if dev.type == "cuda"
            else None)
    i32 = lambda: torch.empty(n, dtype=torch.int32, device=dev)
    pending, local = i32(), i32()
    clock = _Clock(dev, timing)
    if spec.sampler == "cdf":
        cdf_kw = dict(W_pad=W_pad, W_total=W_total, p=spec.p, q=spec.q,
                      cdf_chunk=spec.cdf_chunk, dtype=spec.dtype,
                      work=(torch.zeros(2, dtype=torch.int32, device=dev)
                            if dev.type == "cuda" else None))

        def serve(t, first, local=None, recv=None, dst=None):
            if local is not None:
                cur, prev, flags = local
                clock.device("serve", shard_walk.cdf_serve, tables,
                             (cur, prev, None), flags, gid_base, key,
                             round_offset, t, first, out=dst, **cdf_kw)
            reply = None
            if recv is not None:
                # D buckets, each its requests then fills
                reply = clock.device(
                    "serve", shard_walk.cdf_serve, tables,
                    recv.reshape(D * C, 3), None, 0, key, round_offset, t,
                    first, segments=D, **cdf_kw)
            return dst, reply
    else:
        serve_kw = dict(W_pad=W_pad, W_total=W_total, n_stream=ns,
                        p=spec.p, q=spec.q)

        def serve(t, first, **kw):
            if not keys:
                # the first serve runs as the table's programmatic
                # dependent
                keys.append(walk_step.trial_keys(key, round_offset, R, Lw,
                                                 T, device=dev))
            return clock.device("serve", shard_walk.serve, tables, keys[0],
                                t, first, gid_base=gid_base, **serve_kw,
                                **kw)

    def advance(cur, prev, alive, t, first):
        """One superstep: local fast path + bounded boundary exchange.
        Returns (dst i32[n] (-1 dead/inactive), local crossings, local new
        dead ends, exchange rounds)."""
        # slot n takes the fills' results, dropped
        dst = torch.empty(n + 1, dtype=torch.int32, device=dev)
        send, slot, counters = clock.device(
            "emit", shard_walk.emit, tables, cur, prev, pending,
            alive.to(torch.int32), local, L, D, gid_base, C, work)
        crossings = counters[0].clone()
        mine = (cur, prev, local)
        rounds = 0
        while True:
            recv = (clock.collective(_all_to_all, send.reshape(D, 3 * C),
                                     group).reshape(D, C, 3)
                    if D > 1 else None)
            _, reply = serve(t, first, local=mine, recv=recv, dst=dst[:n])
            if D == 1:
                break
            mine = None
            left = counters[1].reshape(1, 1).expand(D, 1)
            back = clock.collective(
                _all_to_all, torch.cat([reply.reshape(D, C), left], 1),
                group)
            dst.scatter_(0, slot.reshape(-1).long(), back[:, :C].reshape(-1))
            rounds += 1
            if int(back[:, C].sum()) == 0:
                break
            send, slot, counters = clock.device(
                "emit", shard_walk.emit, tables, cur, prev, pending, None,
                None, L, D, gid_base, C, work)
        dst = dst[:n]
        dead = (alive & (dst < 0)).sum()
        return dst, crossings, dead, rounds

    first, c0, d0, r0 = advance(start_rows, start_rows, real, 0, True)
    alive = real & (first >= 0)
    cur = torch.where(alive, first, start_rows)
    prev = start_rows
    cols = [torch.where(real, starts_l, -1).to(torch.int32),
            torch.where(alive, first, -1)]
    crossings, dead, rounds = [c0], [d0], [r0]
    for t in range(1, Lw + 1):
        dst, c, d, r = advance(cur, prev, alive, t, False)
        alive_next = alive & (dst >= 0)
        cols.append(torch.where(alive_next, dst, -1))
        prev = torch.where(alive_next, cur, prev)
        cur = torch.where(alive_next, dst, cur)
        alive = alive_next
        crossings.append(c)
        dead.append(d)
        rounds.append(r)
    paths = torch.stack(cols, dim=1)
    sums = torch.stack([torch.stack(crossings).long(),
                        torch.stack(dead).long()], 1)
    if D > 1:
        sums = for_backend(sums, dev)
        dist.all_reduce(sums, group=group)
    sums = sums.cpu()
    diag = np.zeros((Lw + 1, 4), dtype=np.int64)
    diag[:, :2] = sums.numpy()
    diag[:, 2] = rounds
    clock.close(Lw + 1, int(sum(rounds)))
    return paths, diag


def gather_corpus(paths: torch.Tensor | None, group, shape: tuple,
                  device) -> torch.Tensor:
    """Every walking rank's rows, in rank order, on every rank of the
    default group (on `device`). paths: this rank's rows, None on a rank
    outside the walk group `group` (walk_group); shape: the whole corpus's
    [rows, cols]."""
    D = rank_world(group)[1] if paths is not None else 0
    full = paths
    if D > 1:
        mine = for_backend(paths, device).contiguous()
        parts = [torch.empty_like(mine) for _ in range(D)]
        dist.all_gather(parts, mine, group=group)
        full = torch.cat(parts)
    if group is not None:
        # the ranks outside the walk group take it from rank 0, which walked
        if full is None:
            full = torch.empty(shape, dtype=torch.int32)
        full = for_backend(full, device)
        dist.broadcast(full, src=0)
    return full.to(device)


def auto_capacity(graph: CSRGraph, route: np.ndarray, S: int, n: int,
                  headroom: float = 1.5, floor: int = 32) -> int:
    """Per-destination bucket capacity from the graph's measured boundary-arc
    fraction: expected boundary walkers per shard ~= n * cross_frac, spread over
    S-1 destinations; headroom + overflow rounds absorb power-law skew."""
    E = graph.num_edges
    if E == 0 or S <= 1:
        return 1
    deg = (graph.offsets[1:] - graph.offsets[:-1]).astype(np.int64)
    src_route = np.repeat(route, deg)
    cross_frac = float((src_route != route[graph.cols]).mean())
    per_bucket = cross_frac * n / max(S - 1, 1)
    return int(np.clip(math.ceil(headroom * per_bucket), floor, n))


def log_shard_stats(graph: CSRGraph, plan: ShardPlan) -> None:
    """Per-shard replica/edge distributions — the reference's executor-side
    accumulator stats (UniformRandomWalk.scala:48-79, GraphMap.scala:70-77),
    from the plan (a rank builds only its own shard)."""
    logger.info("graph sharded: S=%d, replication factor=%.3f",
                plan.num_shards, plan.replication_factor)
    deg = (graph.offsets[1:] - graph.offsets[:-1]).astype(np.int64)
    for s in range(plan.num_shards):
        edges = int(deg[plan.rows_per_shard[s]].sum())
        logger.info("shard %d: owned=%d local=%d (halo=%d) edges=%d",
                    s, int(plan.num_owned[s]), int(plan.num_local[s]),
                    int(plan.num_local[s] - plan.num_owned[s]), edges)


def log_superstep_diag(diag: np.ndarray) -> None:
    """Per-superstep boundary/dead-end/overflow counters — the reference prints
    unfinished-walker counts and its Wrong Transports / Zero Neighbors accumulators
    every superstep (RandomWalk.scala:150-160).

    diag[:, 2] counts EXECUTED exchange rounds: the first round runs
    unconditionally whenever D > 1 (its request exchange is issued before the
    crossing count is known), so the column is >= 1 per superstep even with
    zero boundary walkers. Rounds that actually carried traffic are
    diag[:, 0] > 0 (first round) plus max(diag[:, 2] - 1, 0) overflow rounds;
    stats reports them as `exchange_rounds_with_traffic` next to the raw
    total."""
    for t, row in enumerate(np.asarray(diag)):
        crossings, dead, rounds = row[0], row[1], row[2]
        logger.info(
            "superstep %d: boundary walkers=%d, zero neighbors=%d, "
            "exchange rounds=%d%s", t, crossings, dead, rounds,
            " (overflow)" if rounds > 1 else "")


def check_sharded(rng_impl: str) -> None:
    """Raise NotPorted for what the sharded engine does not serve: 'rbg'
    keys, whose XLA RngBitGenerator streams have no port."""
    if not prng.use_slice_draws(rng_impl, "float32"):
        raise NotPorted(f"rng_impl {rng_impl!r}: XLA RngBitGenerator streams "
                        "have no port (ROADMAP Queue 1, not to port)")


class ShardedWalk(NamedTuple):
    """A sharded corpus as each rank holds it (walk_shards): paths, this
    rank's rows [n, L+2] of the padded corpus [num_walks * W_pad, L+2]
    (rows rank * n .. rank * n + n - 1; None on a rank outside the walk
    group); diag, the supersteps' counters summed over the walk group, on
    every rank of the default group; the layout."""
    paths: torch.Tensor | None
    diag: np.ndarray
    group: object
    S: int
    L: int
    C: int
    W: int
    W_pad: int
    replication_factor: float


def walk_shards(graph: CSRGraph, walk_length: int, num_walks: int,
                p: float = 1.0, q: float = 1.0, seed: int = 0,
                sampler: str = "rejection", dtype: str = "float32",
                num_shards: int | None = None,
                route: np.ndarray | None = None,
                starts: np.ndarray | None = None,
                capacity: int | None = None, verbose: bool = False,
                rng_impl: str = "threefry", lanes: int = 1, *,
                device="cuda", timing: dict | None = None) -> ShardedWalk:
    """The sharded walk up to each rank's own rows, called on every rank of
    the default process group: the walk runs on the first num_shards ranks
    (all of them when None), each building only its own graph shard; no
    rank gathers the corpus. distributed_random_walks gathers it for the
    single-process callers; the multi-host CLI keeps each rank's rows
    (parallel/multihost.py). Arguments as distributed_random_walks'."""
    device = resolve_device("walk_shards", device)
    rank, world = rank_world()
    D_req = num_shards or world
    lanes = max(1, min(lanes, D_req))
    if D_req % lanes:
        raise ValueError(f"device count {D_req} not divisible by "
                         f"lanes={lanes}")
    S, L = D_req // lanes, lanes
    D = S * L
    sampler, max_rounds = sampling.plan_sampler(sampler, p, q)
    check_sharded(rng_impl)
    group, member = walk_group(D)
    plan = plan_shards(graph, S, route)
    if verbose:
        log_shard_stats(graph, plan)
    if starts is None:
        starts = np.arange(graph.num_vertices, dtype=np.int32)
    W = len(starts)
    W_pad = -(-W // D) * D
    starts_pad = np.full(W_pad, -1, dtype=np.int32)
    starts_pad[:W] = starts
    n = num_walks * W_pad // D
    C = capacity if capacity is not None else auto_capacity(
        graph, plan.route, D, n)
    C = max(1, min(C, n))
    spec = engine.walk_spec(graph, walk_length, num_walks, p, q, sampler,
                            max_rounds, dtype, W)
    paths, diag = None, np.zeros((walk_length + 1, 4), dtype=np.int64)
    if member:
        tables = shard_walk.shard_tables(graph, plan, rank // L, device,
                                         cdf=sampler == "cdf")
        paths, diag = distributed_walk_corpus(
            tables, torch.as_tensor(starts_pad), prng.prng_key(seed), 0,
            spec, num_walks, S, C, L, timing, group)
    if group is not None:
        # rank 0's diag (summed over the walk group) for the other ranks
        d = for_backend(torch.as_tensor(diag), device)
        dist.broadcast(d, src=0)
        diag = d.cpu().numpy()
    return ShardedWalk(paths, diag, group, S, L, C, W, W_pad,
                       plan.replication_factor)


def shard_stats(sw: ShardedWalk) -> dict:
    """The exchange stats of a sharded walk (the JAX package's
    return_stats dict)."""
    diag = sw.diag
    return {
        "num_shards": sw.S,
        "lanes": sw.L,
        "capacity": sw.C,
        "replication_factor": sw.replication_factor,
        "boundary_walkers": int(diag[:, 0].sum()),
        "zero_neighbors": int(diag[:, 1].sum()),
        "overflow_steps": int((diag[:, 2] > 1).sum()),
        "exchange_rounds_total": int(diag[:, 2].sum()),
        "exchange_rounds_with_traffic": int(
            (diag[:, 0] > 0).sum() + np.maximum(diag[:, 2] - 1, 0).sum()),
        "static_schedule_overflow": int(diag[:, 3].sum()),
        "diag": diag,
    }


def distributed_random_walks(
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
    starts: np.ndarray | None = None,
    capacity: int | None = None,
    verbose: bool = False,
    return_stats: bool = False,
    rng_impl: str = "threefry",
    lanes: int = 1,
    *,
    device="cuda",
    as_numpy: bool = True,
    timing: dict | None = None,
):
    """Sharded corpus generation mirroring engine.random_walks, called on
    every rank of the default process group. Its devices are ranks: the
    walk runs on the first num_shards ranks (all of them when None), and
    num_shards may not exceed the world size. Bitwise identical results for
    any shard count / lane count / route / exchange capacity.

    route: explicit vertex->shard map (the VCut policy); None = hash policy
    dense_id % S. capacity: the exchange's bucket size; None = auto from
    the measured boundary-arc fraction. lanes: devices SHARING each graph
    shard. Every rank gets the whole corpus back [num_walks * W,
    walk_length + 2] (numpy, or a tensor on the device with
    as_numpy=False), and the stats. timing: see distributed_walk_corpus.
    """
    device = resolve_device("distributed_random_walks", device)
    sw = walk_shards(graph, walk_length, num_walks, p, q, seed, sampler,
                     dtype, num_shards, route, starts, capacity, verbose,
                     rng_impl, lanes, device=device, timing=timing)
    full = gather_corpus(sw.paths, sw.group,
                         (num_walks * sw.W_pad, walk_length + 2), device)
    walks = full.reshape(num_walks, sw.W_pad, -1)[:, :sw.W].reshape(
        num_walks * sw.W, -1)
    if as_numpy:
        walks = walks.cpu().numpy()
    if verbose:
        log_superstep_diag(sw.diag)
    if return_stats:
        return walks, shard_stats(sw)
    return walks
