"""Single-device walk engine (port of stellar_rw_tpu/walk/engine.py).

All rounds of a dispatch run in one launch of a walk kernel. The rejection
sampler (ops/walk_step.py, csrc/walk.cu) runs one thread per walker and
round, the whole walk inside the kernel; its corpora are bitwise equal to
stellar_rw_tpu.walk.engine.random_walks for the same graph, seed, p and q:
every uniform is the JAX package's own threefry element. The exact-CDF
sampler (`--sampler cdf`, or a p/q ratio above 32; ops/cdf_walk.py,
csrc/cdf_walk.cu) runs one warp per walker; its corpora equal the JAX
package's bit for bit wherever every partial sum of the CDF is exact or the
padded rows are at most 17 entries long, and in distribution elsewhere
(ops/sampling.py says why).

Left out on purpose: the static cascade's overflow counter and the dynamic
re-dispatch. A per-thread trial loop has no compaction buffer to overflow,
and runs the trial budget exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..errors import NotPorted, resolve_device
from ..graph.csr import CSRGraph
from ..ops import cdf_walk, prng, sampling, walk_step
from ..ops.sampling import DeviceGraph


class WalkSpec(NamedTuple):
    """Static walk configuration."""

    walk_length: int
    p: float
    q: float
    sampler: str = "rejection"   # "rejection" | "cdf"
    max_degree: int = 0          # padded row width (cdf sampler)
    max_rounds: int = 16         # rejection-sampler round cap
    k_candidates: int = 4        # candidates evaluated per rejection round
    dtype: str = "float32"       # CDF accumulation type ("float64": oracle)
    n_stream: int = 0            # unpadded walker count the uniform-stream
    #                              width derives from (0 = the batch size)
    cdf_chunk: int = 0           # >0: the chunked exact CDF, else padded


def walk_corpus(g: DeviceGraph, starts: torch.Tensor, key: torch.Tensor,
                spec: WalkSpec, num_walks: int,
                round_offset: int = 0) -> torch.Tensor:
    """Rounds round_offset .. round_offset+num_walks-1 in one dispatch ->
    i32 [num_walks*W, L+2]; round r of walker w at row r*W + w."""
    if spec.sampler == "cdf":
        return cdf_walk.cdf_walk_rounds(
            g, starts, key, round_offset, num_walks, spec.walk_length,
            spec.p, spec.q, spec.max_degree, spec.cdf_chunk, spec.dtype)
    keys = walk_step.trial_keys(key, round_offset, num_walks,
                                spec.walk_length,
                                spec.max_rounds * spec.k_candidates,
                                device=g.device)
    return walk_step.walk_rounds(
        g, starts, keys, spec.walk_length, spec.p, spec.q,
        spec.n_stream or starts.shape[0])


def in_row_hash(g: DeviceGraph, rows: torch.Tensor,
                queries: torch.Tensor) -> torch.Tensor:
    """Exact membership queries[i] in N(rows[i]) by the bucket tables.
    Rows beyond V read row V-1, as the JAX package's clamped gather does."""
    meta = g.vmeta[rows.clamp(0, g.num_vertices - 1).long()]
    return walk_step.member(g, meta[..., 2], meta[..., 3], queries)


def corpus_invariants(g: DeviceGraph, walks: torch.Tensor,
                      chunk_rows: int = 1 << 18) -> torch.Tensor:
    """Invariant counters over a dense corpus on its device, i64[3]:
    [0] consecutive pairs that are not arcs, [1] -1 followed by a live id,
    [2] ids outside [-1, V). All zero on a correct corpus."""
    V = g.num_vertices
    out = torch.zeros(3, dtype=torch.int64, device=walks.device)
    for s in range(0, walks.shape[0], chunk_rows):
        w = walks[s:s + chunk_rows]
        a, b = w[:, :-1], w[:, 1:]
        valid = (a >= 0) & (b >= 0)
        member = in_row_hash(g, a.clamp_min(0), b.clamp_min(0))
        out[0] += (valid & ~member).sum()
        out[1] += ((a < 0) & (b >= 0)).sum()
        out[2] += ((w >= V) | (w < -1)).sum()
    return out


def assert_corpus_invariants(g: DeviceGraph, walks: torch.Tensor) -> dict:
    """Raise if the invariant counters are nonzero; returns them."""
    c = corpus_invariants(g, walks).tolist()
    out = {"bad_arcs": c[0], "resurrected": c[1], "out_of_range": c[2]}
    if any(out.values()):
        raise AssertionError(f"walk invariant violations: {out}")
    return out


def walk_spec(graph: CSRGraph, walk_length: int, num_walks: int, p: float,
              q: float, sampler: str, max_rounds: int, dtype: str,
              n_starts: int) -> WalkSpec:
    """The spec of a corpus of num_walks rounds from n_starts starts, with
    the sampler planned by plan_sampler. The padded-or-chunked CDF decision
    comes from the whole corpus (plan_cdf_chunk_corpus), never a batch."""
    return WalkSpec(
        walk_length=walk_length, p=float(p), q=float(q), sampler=sampler,
        max_degree=max(graph.max_degree, 1), max_rounds=max_rounds,
        dtype=dtype, n_stream=n_starts,
        cdf_chunk=(sampling.plan_cdf_chunk_corpus(
            num_walks, n_starts, graph.max_degree)
            if sampler == "cdf" else 0))


def random_walks(
    graph: CSRGraph,
    walk_length: int,
    num_walks: int,
    p: float = 1.0,
    q: float = 1.0,
    seed: int = 0,
    sampler: str = "rejection",
    dtype: str = "float32",
    starts: np.ndarray | None = None,
    device_graph: DeviceGraph | None = None,
    max_batch_walkers: int = 2_000_000,
    as_numpy: bool = True,
    rng_impl: str = "threefry",
    schedule: str = "static",
    *,
    device="cuda",
) -> np.ndarray | torch.Tensor:
    """Full corpus: num_walks rounds of one walk per start. Returns
    [num_walks * W, walk_length + 2] dense ids (-1 pad); round r of walker w
    at row r*W + w. Same signature and result as the JAX package's
    random_walks, plus the device (the card unless device="cpu" is asked
    for; no GPU raises CudaUnavailable); as_numpy=False returns the device
    tensor.

    Rounds are grouped into as few dispatches as fit max_batch_walkers
    (whole rounds only: streams are indexed by in-round lane). `schedule`
    names the JAX package's execution plans; both give the one corpus the
    per-thread trial loop computes. dtype is the exact-CDF sampler's
    accumulation type ("float64" for the oracle); the padded or chunked
    form follows from the whole corpus's walker count.
    """
    sampler, max_rounds = sampling.plan_sampler(sampler, p, q)
    if sampler not in ("rejection", "cdf"):
        raise ValueError(f"sampler must be 'rejection' or 'cdf', "
                         f"got {sampler!r}")
    if rng_impl not in ("threefry", "threefry2x32"):
        raise NotPorted(f"rng_impl {rng_impl!r}: XLA RngBitGenerator streams "
                        "have no port (ROADMAP Queue 1, not to port)")
    if dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be 'float32' or 'float64', "
                         f"got {dtype!r}")
    if schedule not in ("static", "dynamic"):
        raise ValueError(f"schedule must be 'static' or 'dynamic', "
                         f"got {schedule!r}")
    device = resolve_device("random_walks", device)
    g = (device_graph if device_graph is not None
         else sampling.device_put_graph(graph, device))
    if g.device.type != device.type:
        raise ValueError(f"device_graph lies on {g.device}, not {device}")
    device = g.device
    if sampler == "cdf":
        g = sampling.with_cdf_rows(g, graph)
    if starts is None:
        starts = np.arange(graph.num_vertices, dtype=np.int32)
    W = len(starts)
    spec = walk_spec(graph, walk_length, num_walks, p, q, sampler, max_rounds,
                     dtype, W)
    starts_dev = torch.as_tensor(np.asarray(starts, dtype=np.int32),
                                 device=device)
    base = prng.prng_key(seed)
    per_batch = max(1, min(num_walks, max_batch_walkers // max(W, 1)))
    rounds = []
    for r in range(0, num_walks, per_batch):
        rb = min(per_batch, num_walks - r)
        rounds.append(walk_corpus(g, starts_dev, base, spec, rb, r))
    out = torch.cat(rounds) if len(rounds) > 1 else rounds[0]
    return out.cpu().numpy() if as_numpy else out
