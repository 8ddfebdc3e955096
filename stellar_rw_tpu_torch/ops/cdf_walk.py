"""Whole walks by the exact inverse CDF: kernel and plain version.

The JAX package's walk_corpus, cdf branch (stellar_rw_tpu/walk/engine.py:
226-275): a first-order draw, then walk_length second-order steps, each by
the padded or the chunked inverse CDF of ops/sampling.py; u for step t of
round r, walker w is element w of uniform(fold_in(fold_in(seed_key,
round_offset + r), t), (W,)) in the accumulation type. A walker whose
current vertex has no out-arcs writes -1 from then on.

`cdf_walk_rounds` launches csrc/cdf_walk.cu (one warp a walker) for CUDA
tensors and runs the plain version `cdf_walk_ref` for CPU tensors; the two
agree bit for bit on any input: they sum in one order.
"""

from __future__ import annotations

import ctypes

import torch

from . import prng, sampling
from ._build import Kernel, ptr, require_cuda, stream
from .sampling import DeviceGraph

CDF_WALK_KERNEL = Kernel(
    "cdf_walk.cu", "srw_cdf_walk_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 3
    + [ctypes.c_double] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def cdf_walk_ref(g: DeviceGraph, starts: torch.Tensor, key: torch.Tensor,
                 round_offset: int, num_rounds: int, walk_length: int,
                 p: float, q: float, max_degree: int, cdf_chunk: int,
                 dtype: str = "float32") -> torch.Tensor:
    """Plain torch version of csrc/cdf_walk.cu on the tensors' device:
    i32 [R*W, L+2], row r*W + w round r of walker w. cdf_chunk 0 takes the
    padded form (rows padded to max_degree), else the chunked form."""
    dev = starts.device
    R, W = num_rounds, starts.shape[0]
    key = key.to(dev)
    rk = prng.fold_in(key, torch.arange(R, device=dev) + round_offset)
    row = torch.arange(R * W, device=dev)
    rnd, lane = row // W, row % W
    starts_b = starts.repeat(R)
    deg = g.vmeta[:, 1]

    def uniforms(t: int) -> torch.Tensor:
        draw = prng.uniform_f64_at if dtype == "float64" else prng.uniform_at
        return draw(prng.fold_in(rk, t)[rnd], lane)

    def draw(cur, prev, u, second: bool):
        if cdf_chunk:
            if second:
                return sampling.cdf_sample_second_order_chunked(
                    g, cur, prev, prev, u, p, q, cdf_chunk, dtype)
            return sampling.cdf_sample_first_order_chunked(
                g, cur, u, cdf_chunk, dtype)
        if second:
            return sampling.cdf_sample_second_order(
                g, cur, prev, prev, u, p, q, max_degree, dtype)
        return sampling.cdf_sample_first_order(g, cur, u, max_degree, dtype)

    alive = deg[starts_b.long()] > 0
    first = torch.full_like(starts_b, -1)
    idx = alive.nonzero().squeeze(1)
    if idx.numel():
        first[idx] = draw(starts_b[idx], None, uniforms(0)[idx], False)
    cur, prev = first, starts_b
    cols = [starts_b, first]
    for t in range(1, walk_length + 1):
        cur = cur.clamp_min(0)
        alive = alive & (deg[cur.long()] > 0)
        dst = torch.full_like(cur, -1)
        idx = alive.nonzero().squeeze(1)
        if idx.numel():
            dst[idx] = draw(cur[idx], prev[idx], uniforms(t)[idx], True)
        cols.append(dst)
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, dst, cur)
    return torch.stack(cols, dim=1).to(torch.int32)


def cdf_walk_rounds(g: DeviceGraph, starts: torch.Tensor, key: torch.Tensor,
                    round_offset: int, num_rounds: int, walk_length: int,
                    p: float, q: float, max_degree: int, cdf_chunk: int,
                    dtype: str = "float32") -> torch.Tensor:
    """R rounds of exact-CDF walks from `starts` (i32 [W]) under the seed
    key `key` -> i32 [R*W, L+2]. CUDA tensors launch csrc/cdf_walk.cu; CPU
    tensors run cdf_walk_ref. g needs its `cdf_rows`."""
    if g.cdf_rows is None:
        raise ValueError("cdf_walk_rounds: the graph has no cdf_rows "
                         "(sampling.with_cdf_rows)")
    if dtype not in ("float32", "float64"):
        raise ValueError(f"cdf_walk_rounds: dtype {dtype!r}")
    if starts.device.type == "cpu":
        return cdf_walk_ref(g, starts, key, round_offset, num_rounds,
                            walk_length, p, q, max_degree, cdf_chunk, dtype)
    CDF_WALK_KERNEL.fn()
    W = starts.shape[0]
    N = num_rounds * W
    if N * 32 >= 2**32 or g.num_edges >= 2**31:
        raise ValueError("cdf_walk_rounds: batch or graph beyond the "
                         "kernel's indexing")
    if round_offset < 0 or round_offset + num_rounds > 2**32:
        raise ValueError("cdf_walk_rounds: round offset beyond 32 bits")
    for name, t in (("starts", starts), ("vmeta", g.vmeta),
                    ("cdf_rows", g.cdf_rows),
                    ("hash_buckets", g.hash_buckets)):
        if t.dtype != torch.int32:
            raise ValueError(f"cdf_walk_rounds: {name} must be int32, "
                             f"got {t.dtype}")
    require_cuda("cdf_walk_rounds", starts, g.vmeta, g.cdf_rows,
                 g.hash_buckets)
    out = torch.empty((N, walk_length + 2), dtype=torch.int32,
                      device=starts.device)
    inv_p, inv_q = sampling.bias_quotients(p, q, dtype)
    k0, k1 = (int(v) for v in key.tolist())
    CDF_WALK_KERNEL.launch(
        ptr(starts), ptr(g.vmeta), ptr(g.cdf_rows), ptr(g.hash_buckets),
        ptr(out), W, N, walk_length, k0, k1, round_offset, inv_p, inv_q,
        int(cdf_chunk > 0), int(dtype == "float64"), stream(starts.device))
    return out
