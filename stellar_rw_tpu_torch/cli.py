"""CLI of the port: `python -m stellar_rw_tpu_torch --cmd
node2vec|randomwalk|embedding`.

Same flags as `python -m stellar_rw_tpu` (utils/config.py is the port's copy
of that parser) and the same outputs: <output>/path walks, <output>/vec
vectors and <output>/bin model; `embedding` reads a /path corpus back. It runs on one CUDA
device; from the command line a machine without a GPU gets CudaUnavailable,
never a CPU run. --shards and --partitioned resolve as in the JAX package,
to one walk shard on the one device (--partitioned true still reads the
vertex-cut file format). Each flag value the port does not serve yet exits
with NotPorted naming its ROADMAP item.
"""

from __future__ import annotations

import logging
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


def check_flags(params: Params) -> None:
    """Raise NotPorted for each flag value this port does not serve, before
    anything is loaded or written."""
    refused = [
        (params.w2v_partitions > 1,
         "--w2vPartitions > 1 (ROADMAP Queue 1 item 11)"),
        (params.w2v_model_shards > 1,
         "--w2vModelShards > 1 (ROADMAP Queue 1 item 11)"),
        (params.streaming, "--streaming true (ROADMAP Queue 1 item 11)"),
        (params.rng_impl != "threefry",
         "--rngImpl rbg|unsafe_rbg (not to port: XLA-only streams)"),
        (params.profile_dir is not None, "--profile (not ported yet)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotPorted(f"{what} is not served by stellar_rw_tpu_torch")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_graph(params: Params):
    """The edge list; with --partitioned true through the vertex-cut loader
    (a third column is a partition id). One walk shard leaves the vertices'
    home partitions unused, as in the JAX package."""
    if params.partitioned:
        return gio.load_edge_list_partitioned(
            params.input, weighted=params.weighted, directed=params.directed,
            partitioned=True, num_partitions=params.rdd_partitions,
            seed=params.seed)[0]
    return gio.load_edge_list(params.input, weighted=params.weighted,
                              directed=params.directed)


def do_random_walk(params: Params, device: torch.device, report: dict):
    """Load the graph, run the walks, save /path. Returns (walks on the
    device, graph). walk_seconds spans the graph load and the walks up to
    the corpus on the device, as the JAX package's CLI times its walks."""
    t0 = time.perf_counter()
    graph = _load_graph(params)
    logger.info("vertices: %d", graph.num_vertices)
    logger.info("edges: %d", graph.num_edges)
    print(f"vertices: {graph.num_vertices}")
    print(f"edges: {graph.num_edges}")
    cdf = sampling.plan_sampler(params.sampler, params.p,
                                params.q)[0] == "cdf"
    dg = sampling.device_put_graph(graph, device, cdf=cdf)
    walks = n2v.run_walks(graph, params, device, device_graph=dg)
    _sync(device)
    dt = time.perf_counter() - t0
    walks_np = walks.cpu().numpy()
    ws = walk_stats(walks_np)
    print(f"walks: {ws.num_paths} paths, {ws.num_steps} steps in {dt:.3f}s "
          f"({ws.num_steps / max(dt, 1e-9):,.0f} steps/s, {device})")
    print(f"Zero Neighbors: {ws.dead_ends}  (isolated starts: "
          f"{ws.isolated_starts}, full paths: {ws.full_paths}, "
          f"mean length: {ws.mean_length:.1f})")
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


def run_job(params: Params, device: torch.device, report: dict) -> str:
    check_flags(params)
    if params.cmd == TaskName.embedding:
        # the walks file read back as ragged arrays (no per-token loop)
        values, offsets = gio.load_walks_ragged(params.input)
        report.update(paths=len(offsets) - 1, tokens=len(values))
    else:
        walks, graph = do_random_walk(params, device, report)
    if params.cmd != TaskName.randomwalk:
        t0 = time.perf_counter()
        if params.cmd == TaskName.embedding:
            tokens, w_in, w_out = n2v.embed_ragged_corpus(values, offsets,
                                                          params, device)
        else:
            tokens, w_in, w_out = n2v.embed_walks(walks, graph, params,
                                                  device)
        report["train_seconds"] = time.perf_counter() - t0
        print(f"trainer: {params.w2v_iter} epoch(s) in "
              f"{report['train_seconds']:.3f}s ({device})")
        n2v.save_model(params.output, tokens, w_in, w_out, params)
        gio.save_vectors(np.asarray(tokens), w_in, params.output,
                         n2v.output_partitions(params))
    return params.output


def main(argv: list[str] | None = None, device=None,
         report: dict | None = None) -> int:
    """Run one job. device None means the command line's CUDA device;
    report, when given, receives the run's counts and timings."""
    params = parse(sys.argv[1:] if argv is None else argv)
    if params is None:
        return 1
    configure(params.log_dir)
    device = resolve_device("stellar_rw_tpu_torch",
                            "cuda" if device is None else device)
    print(params)
    run_job(params, device, {} if report is None else report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
