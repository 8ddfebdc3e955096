"""node2vec walks replayed row by row, in plain torch.

The semantics are those of the program's walk engine, as its docstrings and
the JAX package state them (stellar_rw_tpu_torch/walk/engine.py,
ops/walk_step.py, ops/cdf_walk.py, ops/sampling.py), written again here over
the reference's own CSR rows (reference/graph.py):

  * row r*W + w of a corpus is round r of walker w, which starts at vertex
    w; column 0 is the start, column 1 a first-order draw, columns 2..L+1
    second-order steps; a walker at a vertex without arcs writes -1 from
    then on;
  * the rejection sampler: trial j of step t in round r reads, for lane w,
    elements (w, Wd+w, 2Wd+w) of uniform(k, (3, Wd)) for j < 2, else
    uniform(fold_in(k, w), (3,)), with k = fold_in(fold_in(fold_in(
    PRNGKey(seed), r), t), j) and Wd the multiple of 8,192 strictly above
    W; the candidate is entry min(int(u_pos * deg), deg - 1) of the row
    (unit weights: the alias table keeps every entry), accepted iff
    u_acc * max_f < f(cand), f = 1/p at prev, 1 in N(prev), 1/q elsewhere;
    the first accepted trial wins, else the last of T;
  * the exact-CDF sampler (its chunked form): u of step t is element w of
    uniform(fold_in(fold_in(PRNGKey(seed), r), t), (W,)); the pick is the
    first entry whose running sum of weighed entries reaches u * total.

Every product and comparison is taken in `dtype` (float32: the program's
precision; bfloat16: the control's). The CDF replay sums in float64 and holds
itself to inputs on which every partial sum is exact in float32 (unit
weights, dyadic 1/p and 1/q, short enough rows): there any order of
summation gives one answer, the program's included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng
from .graph import RefGraph

DRAW_QUANTUM = 8192
DENSE_TRIALS = 2
CDF_PAD_LIMIT = 1 << 27    # walkers x widest row above which the CDF is chunked
ROW_BLOCK_ELEMS = 1 << 25  # padded entries a CDF replay block holds


def draw_width(n_starts: int) -> int:
    return (n_starts // DRAW_QUANTUM + 1) * DRAW_QUANTUM


def rejection_trials(p: float, q: float, k_candidates: int = 4) -> int:
    """T: the trial budget of a second-order step (16 rounds of 4, more at
    bias ratios above 8)."""
    fs = (1.0 / p, 1.0, 1.0 / q)
    ratio = max(fs) / min(fs)
    if ratio > 32.0:
        raise ValueError(f"p={p}, q={q}: ratio {ratio} takes the CDF sampler")
    return max(16, int(2.0 * ratio) + 1) * k_candidates


def uses_cdf(p: float, q: float) -> bool:
    fs = (1.0 / p, 1.0, 1.0 / q)
    return max(fs) / min(fs) > 32.0


def _f32(x: float) -> float:
    return float(np.float32(x))


def _constants(p: float, q: float):
    inv_p = float(np.float32(1.0) / np.float32(p))
    inv_q = float(np.float32(1.0) / np.float32(q))
    return inv_p, inv_q, _f32(max(1.0 / p, 1.0, 1.0 / q))


def _row_keys(seeds: torch.Tensor, rounds: torch.Tensor) -> torch.Tensor:
    """fold_in(PRNGKey(seed), r) for each row; seeds int64 [n] below 2**63."""
    k = torch.stack([seeds >> 32, seeds & prng.MASK32], dim=-1)
    return prng.fold_in(k, rounds)


def rejection_rows(g: RefGraph, seeds, rounds, lanes, n_starts: int,
                   walk_length: int, p: float, q: float,
                   dtype=torch.float32) -> torch.Tensor:
    """Rows (seed, round, lane) of rejection-sampled corpora -> i64 [n, L+2]."""
    dev = g.offsets.device
    seeds, rounds, lanes = (torch.as_tensor(x, dtype=torch.int64).to(dev)
                            for x in (seeds, rounds, lanes))
    T = rejection_trials(p, q)
    Wd = draw_width(n_starts)
    inv_p, inv_q, max_f = _constants(p, q)
    c = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    inv_p, inv_q, max_f, one = c(inv_p), c(inv_q), c(max_f), c(1.0)
    deg = g.degrees

    def pick(rows, u_pos):
        d = deg[rows]
        j = (u_pos.to(dtype) * d.to(dtype)).to(torch.int64)
        j = torch.minimum(j, (d - 1).clamp_min(0))
        return g.cols[(g.offsets[rows] + j).clamp(0, g.cols.numel() - 1)]

    rk = _row_keys(seeds, rounds)
    starts = lanes
    alive = deg[starts] > 0
    k0 = prng.fold_in(prng.fold_in(rk, 0), 0)
    first = torch.where(alive, pick(starts, prng.uniform_at(k0, lanes)), -1)
    cur, prev = torch.where(alive, first, starts), starts
    cols = [starts, first]
    for t in range(1, walk_length + 1):
        alive = alive & (deg[cur] > 0)
        kt = prng.fold_in(rk, t)
        dst = torch.zeros_like(cur)
        open_ = alive.clone()
        for j in range(T):
            idx = open_.nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            kj = prng.fold_in(kt[idx], j)
            three = torch.arange(3, device=dev)[:, None]
            if j < DENSE_TRIALS:
                u = prng.uniform_at(kj, lanes[idx] + three * Wd)
            else:
                u = prng.uniform_at(prng.fold_in(kj, lanes[idx]), three)
            cand = pick(cur[idx], u[0])
            dst[idx] = cand
            f = torch.where(cand == prev[idx], inv_p,
                            torch.where(g.member(prev[idx], cand), one, inv_q))
            open_[idx[u[2].to(dtype) * max_f < f]] = False
        cols.append(torch.where(alive, dst, -1))
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, dst, cur)
    return torch.stack(cols, dim=1)


def check_cdf_exact(g: RefGraph, p: float, q: float, n_walkers: int) -> None:
    """Raise unless the program takes the chunked CDF on these inputs and
    every partial sum of a weighed row is exact in float32."""
    max_deg = int(g.degrees.max()) if g.num_vertices else 0
    if n_walkers * max(max_deg, 1) <= CDF_PAD_LIMIT:
        raise NotImplementedError("the padded exact-CDF form has no replay")
    inv_p, inv_q, _ = _constants(p, q)
    fs = (inv_p, 1.0, inv_q)
    dyadic = all(math.frexp(f)[0] == 0.5 for f in fs)
    if not dyadic or max_deg * max(fs) / min(fs) >= 2**24:
        raise NotImplementedError(f"p={p}, q={q} at rows of {max_deg}: the "
                                  "CDF's partial sums are not exact")


def cdf_rows(g: RefGraph, seeds, rounds, lanes, walk_length: int, p: float,
             q: float, dtype=torch.float32) -> torch.Tensor:
    """Rows (seed, round, lane) of exact-CDF corpora -> i64 [n, L+2]."""
    dev = g.offsets.device
    seeds, rounds, lanes = (torch.as_tensor(x, dtype=torch.int64).to(dev)
                            for x in (seeds, rounds, lanes))
    inv_p, inv_q, _ = _constants(p, q)
    sums = torch.float64 if dtype == torch.float32 else dtype
    deg = g.degrees
    rk = _row_keys(seeds, rounds)

    def pick(rows, prv, u):
        out = torch.empty_like(rows)
        d = deg[rows]
        step = max(1, ROW_BLOCK_ELEMS // max(int(d.max()), 1))
        for a in range(0, rows.numel(), step):
            r, uu, dd = rows[a:a + step], u[a:a + step], d[a:a + step]
            pos = torch.arange(int(dd.max()), device=dev)
            valid = pos[None, :] < dd[:, None]
            dst = g.cols[(g.offsets[r][:, None] + pos[None, :]).clamp(
                0, g.cols.numel() - 1)]
            if prv is None:
                b = torch.ones(dst.shape, dtype=sums, device=dev)
            else:
                pv = prv[a:a + step, None].expand_as(dst)
                b = torch.where(dst == pv, inv_p, torch.where(
                    g.member(pv, dst), 1.0, inv_q)).to(sums)
            b = torch.where(valid, b, torch.zeros((), dtype=sums, device=dev))
            prefix = torch.cumsum(b, dim=1)
            total = prefix[:, -1]
            if dtype == torch.float32:
                thresh = (uu * total.to(torch.float32)).to(sums)
            else:
                thresh = uu.to(dtype) * total.to(dtype)
            hit = (prefix >= thresh[:, None]) & valid
            first = torch.argmax(hit.to(torch.int8), dim=1)
            got = torch.gather(dst, 1, first[:, None])[:, 0]
            out[a:a + step] = torch.where(hit.any(dim=1), got, dst[:, 0])
        return out

    starts = lanes
    alive = deg[starts] > 0
    first = torch.full_like(starts, -1)
    u0 = prng.uniform_at(prng.fold_in(rk, 0), lanes)
    idx = alive.nonzero().squeeze(1)
    if idx.numel():
        first[idx] = pick(starts[idx], None, u0[idx])
    cur, prev = first, starts
    cols = [starts, first]
    for t in range(1, walk_length + 1):
        cur = cur.clamp_min(0)
        alive = alive & (deg[cur] > 0)
        u = prng.uniform_at(prng.fold_in(rk, t), lanes)
        dst = torch.full_like(cur, -1)
        idx = alive.nonzero().squeeze(1)
        if idx.numel():
            dst[idx] = pick(cur[idx], prev[idx], u[idx])
        cols.append(dst)
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, dst, cur)
    return torch.stack(cols, dim=1)


def replay(g: RefGraph, sampler: str, seeds, rounds, lanes, n_starts: int,
           walk_length: int, p: float, q: float,
           dtype=torch.float32) -> torch.Tensor:
    if sampler == "cdf":
        return cdf_rows(g, seeds, rounds, lanes, walk_length, p, q, dtype)
    return rejection_rows(g, seeds, rounds, lanes, n_starts, walk_length, p,
                          q, dtype)
