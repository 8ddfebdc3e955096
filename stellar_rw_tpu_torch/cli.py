"""CLI of the port: `python -m stellar_rw_tpu_torch --cmd
node2vec|randomwalk|embedding`.

Same flags as `python -m stellar_rw_tpu` (utils/config.py is the port's copy
of that parser) and the same outputs: <output>/path walks, <output>/vec
vectors and <output>/bin model; `embedding` reads a /path corpus back. It runs on one CUDA
device; from the command line a machine without a GPU gets CudaUnavailable,
never a CPU run. --shards and --partitioned resolve as in the JAX package
(capped at the walk devices, which are the ranks of a process group: the
command line runs one process, so one walk shard on the one device;
--partitioned true still reads the vertex-cut file format, and its homes
route the walks wherever they are sharded). `node2vec --streaming true` keeps one walk round on
the device at a time (the flag is ignored by the other commands, as in the
JAX package); --profile DIR writes a torch.profiler trace of the job into
DIR. --w2vPartitions P trains data-parallel as the JAX package does on P
devices: P slots on the one card, their gradients summed into one merged
update a block (models/word2vec.py, parallel/dp.py); --w2vModelShards is
served under `node2vec --streaming true` alone, whose trainer ignores it
as the JAX package's does. Each flag value the port does not serve yet
exits with NotPorted
naming its ROADMAP item, and so does a multi-host environment
(SRW_NUM_PROCESSES above 1, or SRW_COORDINATOR with no count), where the
JAX CLI would join a process group: refused before anything is read or
written.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

from .errors import CudaUnavailable, NotPorted, resolve_device
from .graph import io as gio
from .models import node2vec as n2v
from .ops import sampling
from .utils.config import Params, TaskName, parse
from .utils.logging import configure
from .utils.stats import validate_walks, walk_stats
from .walk import engine

logger = logging.getLogger("stellar_rw_tpu_torch")

# the JAX package's process-group variables (its parallel/multihost.py)
ENV_COORD = "SRW_COORDINATOR"
ENV_NPROC = "SRW_NUM_PROCESSES"


def check_single_process(environ=os.environ) -> None:
    """Raise NotPorted where the JAX CLI would join a multi-process group:
    SRW_NUM_PROCESSES above 1, or SRW_COORDINATOR with no count (it reads
    an unset or zero count as none). SRW_NUM_PROCESSES=1 is one process."""
    nproc = int(environ.get(ENV_NPROC) or 0)
    if nproc > 1 or (ENV_COORD in environ and nproc == 0):
        raise NotPorted(
            f"{ENV_NPROC}={environ.get(ENV_NPROC)!r} {ENV_COORD}="
            f"{environ.get(ENV_COORD)!r}: multi-host walks are ROADMAP "
            "Queue 1 item 12, not served by stellar_rw_tpu_torch")


def check_flags(params: Params) -> None:
    """Raise NotPorted for each flag value this port does not serve, before
    anything is loaded or written."""
    streamed = params.cmd == TaskName.node2vec and params.streaming
    refused = [
        (params.w2v_model_shards > 1 and not streamed,
         "--w2vModelShards > 1 (ROADMAP Queue 1 item 15)"),
        (params.rng_impl != "threefry",
         "--rngImpl rbg|unsafe_rbg (not to port: XLA-only streams)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotPorted(f"{what} is not served by stellar_rw_tpu_torch")


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


def run_job(params: Params, device: torch.device, report: dict) -> str:
    check_flags(params)
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
    one *.pt.trace.json (CUDA activity too on the card: the hand kernels
    appear under their own symbols)."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def main(argv: list[str] | None = None, device=None,
         report: dict | None = None) -> int:
    """Run one job. device None means the command line's CUDA device;
    report, when given, receives the run's counts and timings and, on the
    card, peak_device_bytes: the job's peak above what was allocated when
    it started."""
    check_single_process()
    params = parse(sys.argv[1:] if argv is None else argv)
    if params is None:
        return 1
    configure(params.log_dir)
    device = resolve_device("stellar_rw_tpu_torch",
                            "cuda" if device is None else device)
    print(params)
    report = {} if report is None else report
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
