"""CLI of the port: `python -m stellar_rw_tpu_torch --cmd
node2vec|randomwalk|embedding`.

Same flags as `python -m stellar_rw_tpu` (utils/config.py is the port's copy
of that parser) and the same outputs: <output>/path walks, <output>/vec
vectors and <output>/bin model; `embedding` reads a /path corpus back. One
process runs on one CUDA device; from the command line a machine without a
GPU gets CudaUnavailable, never a CPU run. --shards and --partitioned
resolve as in the JAX package (capped at the walk devices, the ranks of a
process group: one process walks one shard on its device; --partitioned
true still reads the vertex-cut file format, and its homes route the walks
wherever they are sharded). `node2vec --streaming true` keeps one walk
round on the device at a time (the flag is ignored by the other commands,
as in the JAX package); --profile DIR writes a torch.profiler trace of the
job into DIR (one a rank). --w2vPartitions P trains data-parallel as the
JAX package does on P devices: P slots on the one card, their gradients
summed into one merged update a block (models/word2vec.py,
parallel/dp.py); --w2vModelShards MP trains the dim-sharded tables'
function on full rows (ignored under `node2vec --streaming true`, as the
JAX package's streamed trainer ignores it).

Multi-host: with SRW_COORDINATOR, SRW_NUM_PROCESSES (above 1) and
SRW_PROCESS_ID set, every process joins one torch.distributed group, one
rank a device (parallel/multihost.py), and the job runs over the ranks as
the JAX CLI's runs over its processes: the walks sharded over every rank,
each rank writing its own /path parts, the trainer data-parallel over the
ranks, rank 0 writing the model and the vectors (_run_job_multihost).

A flag value the port does not serve exits with NotPorted naming its
ROADMAP item (or why it is not to port), before anything is read or
written.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .errors import CudaUnavailable, NotPorted, resolve_device  # noqa: F401
from .graph import io as gio
from .models import node2vec as n2v
from .models import word2vec as w2v
from .ops import sampling
from .parallel import distributed, multihost
from .parallel.distributed import for_backend, rank_world
from .utils.config import Params, TaskName, parse
from .utils.logging import configure
from .utils.stats import WalkStats, validate_walks, walk_stats
from .walk import engine

logger = logging.getLogger("stellar_rw_tpu_torch")

def check_flags(params: Params) -> None:
    """Raise, before anything is loaded or written, NotPorted for each flag
    value this port does not serve, and ValueError for model shards that
    the trainer would refuse (a dim they do not divide; more than one
    process)."""
    if params.rng_impl != "threefry":
        raise NotPorted("--rngImpl rbg|unsafe_rbg (not to port: XLA-only "
                        "streams) is not served by stellar_rw_tpu_torch")
    streamed = params.cmd == TaskName.node2vec and params.streaming
    if params.cmd != TaskName.randomwalk and not streamed:
        w2v.check_model_shards(n2v.sgns_config(params),
                               multiproc=rank_world()[1] > 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_graph(params: Params):
    """(graph, home): the edge list; with --partitioned true through the
    vertex-cut loader (a third column is a partition id), whose per-vertex
    home partitions route the sharded walks (None otherwise). One walk
    shard leaves them unused, as in the JAX package."""
    if params.partitioned:
        return gio.load_edge_list_partitioned(
            params.input, weighted=params.weighted, directed=params.directed,
            partitioned=True, num_partitions=params.rdd_partitions,
            seed=params.seed)
    return gio.load_edge_list(params.input, weighted=params.weighted,
                              directed=params.directed), None


def _device_graph(graph, params: Params, device: torch.device):
    """The graph's walk tables on the device, with the exact-CDF rows when
    plan_sampler takes that sampler."""
    cdf = sampling.plan_sampler(params.sampler, params.p,
                                params.q)[0] == "cdf"
    return sampling.device_put_graph(graph, device, cdf=cdf)


def _print_stats(ws, what: str) -> None:
    print(what)
    print(f"Zero Neighbors: {ws.dead_ends}  (isolated starts: "
          f"{ws.isolated_starts}, full paths: {ws.full_paths}, "
          f"mean length: {ws.mean_length:.1f})")


def do_random_walk(params: Params, device: torch.device, report: dict):
    """Load the graph, run the walks, save /path. Returns (walks on the
    device, graph). walk_seconds spans the graph load and the walks up to
    the corpus on the device, as the JAX package's CLI times its walks."""
    t0 = time.perf_counter()
    graph, home = _load_graph(params)
    logger.info("vertices: %d", graph.num_vertices)
    logger.info("edges: %d", graph.num_edges)
    print(f"vertices: {graph.num_vertices}")
    print(f"edges: {graph.num_edges}")
    dg = _device_graph(graph, params, device)
    # the shards report line, where the walks are sharded, comes from here
    walks = n2v.run_walks(graph, params, device, device_graph=dg, home=home)
    _sync(device)
    dt = time.perf_counter() - t0
    walks_np = walks.cpu().numpy()
    ws = walk_stats(walks_np)
    _print_stats(ws, f"walks: {ws.num_paths} paths, {ws.num_steps} steps "
                 f"in {dt:.3f}s ({ws.num_steps / max(dt, 1e-9):,.0f} "
                 f"steps/s, {device})")
    # the path-count check of the JAX package's CLI: warned, not failed
    expect = params.num_walks * graph.num_vertices
    if ws.num_paths != expect:
        logger.warning("corpus has %d paths, expected numWalks*|V| = %d",
                       ws.num_paths, expect)
    report.update(vertices=graph.num_vertices, edges=graph.num_edges,
                  paths=ws.num_paths, steps=ws.num_steps, walk_seconds=dt)
    if params.validate:
        report["invariants"] = engine.assert_corpus_invariants(dg, walks)
        validate_walks(walks_np, graph)
        print("walk invariants: ok")
    gio.save_walks(walks_np, graph, params.output,
                   n2v.output_partitions(params))
    return walks, graph


def do_streaming_node2vec(params: Params, device: torch.device,
                          report: dict):
    """node2vec --streaming true: one walk round on the device at a time
    (models/node2vec.py::run_node2vec_streaming). walk_seconds spans the
    graph load and the pre-pass that writes /path; train_seconds the
    epochs, which walk every round again. Returns (tokens, w_in, w_out)."""
    t0 = time.perf_counter()
    graph, home = _load_graph(params)
    print(f"vertices: {graph.num_vertices}")
    print(f"edges: {graph.num_edges}")
    dg = _device_graph(graph, params, device)
    times = {}
    t_load = time.perf_counter() - t0
    tokens, w_in, w_out, ws = n2v.run_node2vec_streaming(
        graph, params, device, dg, times, home)
    _print_stats(ws, f"walks (streamed): {ws.num_paths} paths, "
                     f"{ws.num_steps} steps")
    report.update(vertices=graph.num_vertices, edges=graph.num_edges,
                  paths=ws.num_paths, steps=ws.num_steps,
                  walk_seconds=t_load + times["walk_seconds"],
                  train_seconds=times["train_seconds"])
    return tokens, w_in, w_out


def _global_walk_stats(local_rows: np.ndarray,
                       device: torch.device) -> WalkStats:
    """WalkStats summed over the ranks (the JAX package's cluster-global
    counters): the five counts in one int64 all-reduce. torch carries int64
    whole on gloo and nccl, so the (hi, lo) uint32 halves that the JAX
    package gathers (its int64 payloads truncate to int32 without x64) are
    not needed."""
    ws = walk_stats(local_rows) if len(local_rows) else WalkStats(
        0, 0, 0, 0, 0, 0.0)
    vec = torch.tensor([ws.num_paths, ws.num_steps, ws.full_paths,
                        ws.dead_ends, ws.isolated_starts], dtype=torch.int64)
    if rank_world()[1] > 1:
        vec = for_backend(vec, device)
        dist.all_reduce(vec)
    paths, steps, full, dead, isolated = (int(v) for v in vec.cpu())
    return WalkStats(num_paths=paths, num_steps=steps, full_paths=full,
                     dead_ends=dead, isolated_starts=isolated,
                     mean_length=(steps + paths) / paths if paths else 0.0)


def _run_job_multihost(params: Params, device: torch.device,
                       report: dict) -> str:
    """The job over the ranks of the default group (port of the JAX CLI's
    _run_job_multihost), called on every rank: walks sharded over every
    rank, each keeping and writing its own /path parts (part-{rank}), the
    trainer data-parallel over the ranks' blocks; rank 0 prints the global
    stats and writes the model and the vectors. --streaming is refused and
    walk-round checkpoints are skipped, as in the JAX package; trainer
    epoch checkpoints are written by rank 0 and broadcast on --resume.
    report gets this rank's walk_seconds and train_seconds."""
    me, world = rank_world()
    if params.streaming:
        raise ValueError(
            "--streaming is not supported in multi-host runs; drop the flag "
            "(the multi-host corpus is already distributed per process)")
    walks = params.cmd in (TaskName.node2vec, TaskName.randomwalk)
    if walks:
        # refused before the graph is read
        distributed.check_sharded(params.rng_impl)
    if params.checkpoint_every:
        logger.warning("multi-host: walk-round checkpoints are single-host "
                       "only and are skipped; trainer epoch checkpoints "
                       "still apply (written by process 0)")
    if walks:
        t0 = time.perf_counter()
        graph, home = _load_graph(params)
        if me == 0:
            print(f"vertices: {graph.num_vertices}")
            print(f"edges: {graph.num_edges}")
        blocks, diag, num_rows, D = n2v.run_walks_multihost(
            graph, params, home, device)
        if me == 0:
            distributed.log_superstep_diag(diag)
        local = (np.concatenate([rows[rows[:, 0] >= 0] for _, rows in blocks])
                 if blocks else
                 np.zeros((0, params.walk_length + 2), np.int32))
        ws = _global_walk_stats(local, device)
        dt = time.perf_counter() - t0
        report.update(vertices=graph.num_vertices, edges=graph.num_edges,
                      paths=ws.num_paths, steps=ws.num_steps,
                      walk_seconds=dt)
        if me == 0:
            rate = ws.num_steps / max(dt, 1e-9)
            _print_stats(ws, f"walks: {ws.num_paths} paths, {ws.num_steps} "
                         f"steps in {dt:.3f}s ({rate:,.0f} steps/s, "
                         f"{world} processes x 1 devices)")
            expect = params.num_walks * graph.num_vertices
            if ws.num_paths != expect:
                logger.warning("corpus has %d paths, expected numWalks*|V| "
                               "= %d", ws.num_paths, expect)
        if params.validate:
            validate_walks(local, graph)   # every rank checks its own rows
            print(f"walk invariants: ok (process {me})")
        gio.save_walk_blocks(blocks, graph, params.output)
        if params.cmd == TaskName.randomwalk:
            return params.output
        t0 = time.perf_counter()
        tokens, w_in, w_out = n2v.embed_walk_blocks(
            blocks, num_rows, graph, params, num_devices=D,
            row_width=params.walk_length + 2, device=device)
    else:
        # every rank reads the same walks file; the trainer splits it
        values, offsets = gio.load_walks_ragged(params.input)
        report.update(paths=len(offsets) - 1, tokens=len(values))
        t0 = time.perf_counter()
        corpus, tokens = w2v.corpus_from_ragged(values, offsets)
        blocks, num_rows = w2v.full_corpus_blocks(corpus, rank=me,
                                                  world=world)
        w_in, w_out = n2v.train_multiproc_with_ckpt(
            blocks, num_rows, len(tokens), params,
            row_width=corpus.shape[1] if corpus.size else 1, device=device)
    report["train_seconds"] = time.perf_counter() - t0
    if me == 0:
        print(f"trainer: {params.w2v_iter} epoch(s) in "
              f"{report['train_seconds']:.3f}s ({world} processes)")
        n2v.save_model(params.output, tokens, w_in, w_out, params)
        gio.save_vectors(np.asarray(tokens), w_in, params.output,
                         n2v.output_partitions(params))
    return params.output


def run_job(params: Params, device: torch.device, report: dict) -> str:
    check_flags(params)
    if rank_world()[1] > 1:
        return _run_job_multihost(params, device, report)
    t0 = None
    if params.cmd == TaskName.embedding:
        # the walks file read back as ragged arrays (no per-token loop)
        values, offsets = gio.load_walks_ragged(params.input)
        report.update(paths=len(offsets) - 1, tokens=len(values))
        t0 = time.perf_counter()
        tokens, w_in, w_out = n2v.embed_ragged_corpus(values, offsets,
                                                      params, device)
    elif params.cmd == TaskName.node2vec and params.streaming:
        tokens, w_in, w_out = do_streaming_node2vec(params, device, report)
    else:
        walks, graph = do_random_walk(params, device, report)
        if params.cmd == TaskName.node2vec:
            t0 = time.perf_counter()
            tokens, w_in, w_out = n2v.embed_walks(walks, graph, params,
                                                  device)
    if t0 is not None:
        report["train_seconds"] = time.perf_counter() - t0
    if params.cmd != TaskName.randomwalk:
        print(f"trainer: {params.w2v_iter} epoch(s) in "
              f"{report['train_seconds']:.3f}s ({device})")
        n2v.save_model(params.output, tokens, w_in, w_out, params)
        gio.save_vectors(np.asarray(tokens), w_in, params.output,
                         n2v.output_partitions(params))
    return params.output


def profiled(profile_dir: str, device: torch.device):
    """torch.profiler over the job, its trace written into profile_dir as
    one *.pt.trace.json, one a rank in a process group (CUDA activity too
    on the card: the hand kernels appear under their own symbols)."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    rank, world = rank_world()
    worker = f"rank{rank}" if world > 1 else None
    return profile(activities=activities, on_trace_ready=(
        tensorboard_trace_handler(profile_dir, worker_name=worker)))


def main(argv: list[str] | None = None, device=None,
         report: dict | None = None) -> int:
    """Run one job. device None means the command line's CUDA device;
    report, when given, receives the run's counts and timings and, on the
    card, peak_device_bytes: the job's peak above what was allocated when
    it started. With the SRW_* variables asking for a group of more than
    one process, this process joins it as its rank (on cuda:{rank % cards},
    or the CPU when device="cpu" is asked for), runs the job over the ranks
    and leaves the group before it returns."""
    # a group with a variable missing raises here, before anything is read
    joining = multihost.settings() is not None
    params = parse(sys.argv[1:] if argv is None else argv)
    if params is None:
        return 1
    configure(params.log_dir)
    device = resolve_device("stellar_rw_tpu_torch",
                            "cuda" if device is None else device)
    if joining:
        device = multihost.maybe_initialize_from_env(device)
    ok = False
    try:
        print(params)
        _run(params, device, {} if report is None else report)
        ok = True
    finally:
        if joining:
            multihost.shutdown(ok)
    return 0


def _run(params: Params, device: torch.device, report: dict) -> None:
    """run_job, under --profile when asked, with the job's peak device
    bytes in report on the card."""
    if device.type == "cuda":
        # the process's peak counter, reset here and not in run_job, which
        # in-process jobs of the server share
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    if params.profile_dir:
        with profiled(params.profile_dir, device):
            run_job(params, device, report)
    else:
        run_job(params, device, report)
    if device.type == "cuda":
        # the job's own peak, above what the caller held when it started
        report["peak_device_bytes"] = (
            torch.cuda.max_memory_allocated(device) - held)


if __name__ == "__main__":
    sys.exit(main())
