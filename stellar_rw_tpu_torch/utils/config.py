"""Typed config + CLI flag system (the port's copy of the JAX package's
utils/config.py: same flags, same defaults, same Params).

Mirrors the reference's flag surface exactly (names, defaults, required flags) so a user
of the reference can reuse their invocations unchanged:
  - field set / defaults: reference common/Params.scala:7-23
  - flag names:           reference common/CommandParser.scala:12-29 (defs :34-104)
  - required flags:       --input/--output/--cmd (CommandParser.scala:64-75)
  - task names:           node2vec | randomwalk | embedding (CommandParser.scala:7-10)

Reinterpretations (documented, not silently changed):
  - rddPartitions: number of graph shards / output files (reference: Spark RDD partitions)
  - w2vPartitions: data-parallel degree of the skip-gram trainer
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from enum import Enum


class TaskName(str, Enum):
    node2vec = "node2vec"
    randomwalk = "randomwalk"
    embedding = "embedding"


@dataclass
class Params:
    """All 17 knobs of the reference `Params` case class, same defaults."""

    w2v_iter: int = 10
    w2v_lr: float = 0.025
    w2v_partitions: int = 1
    w2v_dim: int = 128
    w2v_window: int = 10
    walk_length: int = 80
    num_walks: int = 10
    p: float = 1.0
    q: float = 1.0
    weighted: bool = True
    directed: bool = False
    input: str | None = None
    output: str | None = None
    rdd_partitions: int = 200
    single_output: bool = True
    partitioned: bool = False
    cmd: TaskName = TaskName.node2vec

    # --- framework extensions (not in the reference flag set) ---
    shards: int = 0               # graph shards / devices for the walk engine;
    #                               0 = auto: 1, unless --partitioned true, then
    #                               min(devices, rddPartitions)
    lanes: int = 1                # devices SHARING each graph shard (the
    #                               per-host replication domain — the reference
    #                               shares one GraphMap per executor,
    #                               GraphMap.scala:11): total walk devices =
    #                               (shards/lanes) graph shards x lanes, cutting
    #                               halo replication by ~lanes
    streamed: bool = False        # shard-at-a-time graph build + upload (peak
    #                               host memory = graph + ONE shard, not all
    #                               stacked shards; same bitwise corpus)
    seed: int = 0
    sampler: str = "rejection"  # "rejection" (alias+accept, prod) | "cdf" (exact inverse-CDF)
    w2v_negatives: int = 5
    resume: bool = False          # resume skip-gram training from <output>/bin checkpoint
    checkpoint_every: int = 0     # save a trainer checkpoint every N epochs (0 = off)
    shared_negatives: int = 0     # >0: block-shared negatives (dense-product skip-gram path)
    w2v_model_shards: int = 1     # >1: shard embedding tables over the embedding dim
    #                               across devices (column parallelism); total devices
    #                               used by the trainer = w2vPartitions * this
    log_dir: str | None = None    # also log to a midnight-rolling file here
    #                               (the reference's log4j rolling appender analog)
    profile_dir: str | None = None  # capture a profiler trace of the run here
    validate: bool = False        # runtime invariant checks on the realized corpus
    #                               (every transition is a real arc, no walker
    #                               resurrection, ids in range)
    streaming: bool = False       # node2vec with one walk round resident at a
    #                               time (rounds regenerated per epoch from the
    #                               counter-based streams; bounded memory)
    rng_impl: str = "threefry"    # walk-engine PRNG: "threefry" (cross-platform
    #                               reproducible streams) | "rbg" (XLA
    #                               RngBitGenerator; the JAX package only).

    def __str__(self) -> str:  # reference AbstractParams.scala:39-52 pretty-print
        d = dataclasses.asdict(self)
        d["cmd"] = self.cmd.value
        return json.dumps(d, indent=2)


def _bool(x: str) -> bool:
    # scopt's opt[Boolean] takes a literal true/false value
    if x.lower() in ("true", "1", "yes"):
        return True
    if x.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {x!r}")


def build_parser() -> argparse.ArgumentParser:
    d = Params()
    ap = argparse.ArgumentParser(
        prog="stellar-rw-tpu-torch",
        description="2nd-order random walk (node2vec) + word2vec on one GPU",
    )
    ap.add_argument("--walkLength", type=int, default=d.walk_length, help=f"walkLength: {d.walk_length}")
    ap.add_argument("--numWalks", type=int, default=d.num_walks, help=f"numWalks: {d.num_walks}")
    ap.add_argument("--p", type=float, default=d.p, help=f"return parameter p: {d.p}")
    ap.add_argument("--q", type=float, default=d.q, help=f"in-out parameter q: {d.q}")
    ap.add_argument("--rddPartitions", type=int, default=d.rdd_partitions,
                    help=f"Number of graph shards / output partitions: {d.rdd_partitions}")
    ap.add_argument("--weighted", type=_bool, default=d.weighted, help=f"weighted: {d.weighted}")
    ap.add_argument("--directed", type=_bool, default=d.directed, help=f"directed: {d.directed}")
    ap.add_argument("--singleOutput", type=_bool, default=d.single_output,
                    help=f"generate single output file: {d.single_output}")
    ap.add_argument("--w2vPartitions", type=int, default=d.w2v_partitions,
                    help=f"Data-parallel degree of word2vec: {d.w2v_partitions}")
    ap.add_argument("--input", required=True, help="Input edge file path")
    ap.add_argument("--output", required=True, help="Output path")
    ap.add_argument("--cmd", required=True, choices=[t.value for t in TaskName],
                    help=f"command: {d.cmd.value}")
    ap.add_argument("--partitioned", type=_bool, default=d.partitioned,
                    help=f"Whether the graph is partitioned: {d.partitioned}")
    ap.add_argument("--lr", type=float, default=d.w2v_lr, help=f"Learning rate in word2vec: {d.w2v_lr}")
    ap.add_argument("--iter", type=int, default=d.w2v_iter, help=f"Number of iterations in word2vec: {d.w2v_iter}")
    ap.add_argument("--dim", type=int, default=d.w2v_dim, help=f"Number of dimensions in word2vec: {d.w2v_dim}")
    ap.add_argument("--window", type=int, default=d.w2v_window, help=f"Window size in word2vec: {d.w2v_window}")
    # extensions
    ap.add_argument("--shards", type=int, default=d.shards,
                    help="graph shards (devices) for the walk engine; 0 = auto "
                         "(1 unless --partitioned true, then min(devices, "
                         "rddPartitions)); >1 runs the sharded shard_map engine")
    ap.add_argument("--lanes", type=int, default=d.lanes,
                    help="devices sharing each graph shard (per-host replication "
                         "domain; walk devices = shards, graph shards = "
                         "shards/lanes)")
    ap.add_argument("--streamed", type=_bool, default=d.streamed,
                    help="build + upload graph shards one at a time (peak host "
                         "memory = graph + one shard; identical corpus)")
    ap.add_argument("--seed", type=int, default=d.seed, help="PRNG seed (counter-based keys)")
    ap.add_argument("--sampler", choices=["rejection", "cdf"], default=d.sampler,
                    help="transition sampler: rejection (alias+accept) or cdf (exact inverse-CDF)")
    ap.add_argument("--negatives", type=int, default=d.w2v_negatives, help="negative samples per pair")
    ap.add_argument("--resume", type=_bool, default=d.resume,
                    help="resume word2vec training from the checkpoint in <output>/bin")
    ap.add_argument("--checkpointEvery", type=int, default=d.checkpoint_every,
                    help="save a trainer checkpoint every N epochs (0 = off)")
    ap.add_argument("--sharedNegatives", type=int, default=d.shared_negatives,
                    help="block-shared negatives kB for the dense-product "
                         "skip-gram path (0 = per-pair negatives)")
    ap.add_argument("--w2vModelShards", type=int, default=d.w2v_model_shards,
                    help="shard word2vec embedding tables over the embedding dim "
                         "across this many devices (1 = replicated tables)")
    ap.add_argument("--logDir", default=d.log_dir,
                    help="also write logs to a midnight-rolling file in this dir")
    ap.add_argument("--profile", default=d.profile_dir, dest="profile",
                    help="capture a profiler trace of the pipeline to this dir")
    ap.add_argument("--validate", type=_bool, default=d.validate,
                    help="check walk invariants on the realized corpus "
                         "(every transition is a real arc; fails loudly)")
    ap.add_argument("--streaming", type=_bool, default=d.streaming,
                    help="node2vec with one walk round in memory at a time "
                         "(rounds regenerated deterministically per epoch)")
    ap.add_argument("--rngImpl", choices=["threefry", "rbg", "unsafe_rbg"],
                    default=d.rng_impl, dest="rngImpl",
                    help="walk-engine PRNG: threefry (cross-platform streams) "
                         "or rbg (hardware-rate XLA generator)")
    return ap


def parse(argv: list[str]) -> Params | None:
    """Parse argv into Params; None on failure (reference CommandParser.parse:107-109)."""
    try:
        ns = build_parser().parse_args(argv)
    except SystemExit:
        return None
    return Params(
        w2v_iter=ns.iter, w2v_lr=ns.lr, w2v_partitions=ns.w2vPartitions,
        w2v_dim=ns.dim, w2v_window=ns.window, walk_length=ns.walkLength,
        num_walks=ns.numWalks, p=ns.p, q=ns.q, weighted=ns.weighted,
        directed=ns.directed, input=ns.input, output=ns.output,
        rdd_partitions=ns.rddPartitions, single_output=ns.singleOutput,
        partitioned=ns.partitioned, cmd=TaskName(ns.cmd), shards=ns.shards,
        lanes=ns.lanes, streamed=ns.streamed, seed=ns.seed,
        sampler=ns.sampler, w2v_negatives=ns.negatives,
        resume=ns.resume, checkpoint_every=ns.checkpointEvery,
        shared_negatives=ns.sharedNegatives, w2v_model_shards=ns.w2vModelShards,
        log_dir=ns.logDir, profile_dir=ns.profile, validate=ns.validate,
        streaming=ns.streaming, rng_impl=ns.rngImpl,
    )


# Output subdirectory layout (reference common/Property.scala:5-7, README.md:141-148)
MODEL_SUFFIX = "bin"
PATH_SUFFIX = "path"
VECTOR_SUFFIX = "vec"
