"""Resident-row walks: whole node2vec walks over a table that holds every
vertex's full row on chip (port of stellar_rw_tpu/ops/pallas/walk.py).

The regime is small, degree-bounded graphs (max degree <= 42): each vertex's
degree, neighbour ids, alias partner ids and alias keep-probabilities ride
one row, membership of a candidate in N(prev) is a compare against prev's
neighbour ids (no hash tables), and a step touches nothing but that table.
`walk/engine.py` stays the general engine.

  build_row_tables          <- build_row_tables          (walk.py:60)
  walk_corpus_resident_ref  <- _walk_kernel, plain torch (walk.py:95)
  walk_corpus_resident      <- walk_corpus_vmem          (walk.py:207)
  resident_walks            <- pallas_walks              (walk.py:253)

Semantics (one walker per gid in [0, W_pad)): gid < W_real starts at
gid % V, else the row is padding and -1 throughout. Column 1 is a
first-order alias draw on the start's row; each of L steps runs up to
max_trials trials: an alias candidate of cur, accepted iff
u_acc * max_f < f with f = 1/p for cand == prev, 1 for cand in N(prev), 1/q
otherwise; the first accept wins, else the last trial's candidate. A walker
on a vertex of degree 0 writes -1 from then on.

Draws: the uniform of (draw row r, component c, walker w) is element
(r*3 + c)*W_pad + w of jax.random.uniform(PRNGKey(seed), (1 + L*max_trials,
3, W_pad)); the first-order step reads row 0, trial j of step t row
1 + t*max_trials + j. That is the array pallas_walks(external_uniforms=True)
feeds its kernel, so the corpora are equal bit for bit. (The TPU kernel's
default stream is the core's hardware generator, which nothing else
reproduces.) External `uniforms` of that shape replace the stream.

CUDA tensors launch csrc/resident_walk.cu, CPU tensors run
walk_corpus_resident_ref; the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..errors import resolve_device
from . import prng
from ._build import Kernel, ptr, require_cuda, stream
from .walk_step import bias_constants

MAX_MD = 42   # the JAX package's degree bound (1 + 3*MD lanes in a 128-lane row)
# dynamic shared memory one block may use on sm_90
SHARED_TABLE_BYTES = 232_448

RESIDENT_WALK_KERNEL = Kernel(
    "resident_walk.cu", "srw_resident_walk_launch",
    [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_uint] * 2
    + [ctypes.c_void_p] + [ctypes.c_float] * 3
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def row_words(md: int) -> int:
    return 1 + 3 * md


def build_row_tables(graph, max_degree: int | None = None) -> np.ndarray:
    """Host prep: one row per vertex, i32[V, 1 + 3*MD]:
    [deg | neighbour ids (MD) | alias partner ids (MD) | keep-prob (MD)],
    ids as i32 with -1 in padded slots (never drawn: jpos < deg; never a
    member), probabilities as f32 bits with 1.0 in padded slots. Same fields
    as the JAX package's 128-lane f32 row, without its lane padding."""
    graph.build_alias_tables()
    MD = int(max_degree or max(graph.max_degree, 1))
    assert graph.max_degree <= MD <= MAX_MD, (graph.max_degree, MD)
    V = graph.num_vertices
    deg = (graph.offsets[1:] - graph.offsets[:-1]).astype(np.int64)
    E = graph.num_edges
    pos = np.arange(MD)
    valid = pos[None, :] < deg[:, None]
    idxc = np.clip(graph.offsets[:-1, None] + pos[None, :], 0, max(E - 1, 0))
    aidx = np.clip(graph.offsets[:-1, None] + graph.alias_pos[idxc], 0,
                   max(E - 1, 0))
    tab = np.zeros((V, row_words(MD)), np.int32)
    tab[:, 0] = deg
    tab[:, 1:1 + MD] = np.where(valid, graph.cols[idxc], -1)
    tab[:, 1 + MD:1 + 2 * MD] = np.where(valid, graph.cols[aidx], -1)
    tab[:, 1 + 2 * MD:] = np.where(valid, graph.alias_prob[idxc], 1.0
                                   ).astype(np.float32).view(np.int32)
    return tab


def row_fields(tab, md: int):
    """(deg, neighbour ids, alias partner ids, keep-prob f32) views of a row
    table (numpy array or tensor)."""
    prob = tab[:, 1 + 2 * md:1 + 3 * md]
    prob = (prob.view(torch.float32) if torch.is_tensor(prob)
            else prob.view(np.float32))
    return tab[:, 0], tab[:, 1:1 + md], tab[:, 1 + md:1 + 2 * md], prob


def uniforms_shape(walk_length: int, max_trials: int, W_pad: int):
    return (1 + walk_length * max_trials, 3, W_pad)


def _check_stream(walk_length: int, max_trials: int, W_pad: int) -> None:
    if int(np.prod(uniforms_shape(walk_length, max_trials, W_pad))) >= 2**32:
        raise ValueError("resident walk: the draw array (1 + L*max_trials, 3, "
                         "W_pad) has 2**32 elements or more")


class _Draws:
    """Uniforms by (draw row, component, walker)."""

    def __init__(self, seed, uniforms, W_pad, device):
        self.flat = None if uniforms is None else uniforms.reshape(-1)
        self.key = prng.prng_key(seed, device)
        self.W_pad = W_pad

    def at(self, row: int, c: int, gid: torch.Tensor) -> torch.Tensor:
        idx = (row * 3 + c) * self.W_pad + gid
        return (prng.uniform_at(self.key, idx) if self.flat is None
                else self.flat[idx])


def _sample(tab, md, vid, deg, u_pos, u_keep):
    """Alias draw on the rows of `vid` -> candidate ids (i32)."""
    j = torch.minimum((u_pos * deg.to(torch.float32)).to(torch.int32),
                      (deg - 1).clamp_min(0)).long()
    keep = tab[vid, 1 + 2 * md + j].view(torch.float32)
    return torch.where(u_keep < keep, tab[vid, 1 + j], tab[vid, 1 + md + j])


def walk_corpus_resident_ref(tab: torch.Tensor, seed: int, V: int,
                             W_real: int, walk_length: int, p: float,
                             q: float, md: int, W_pad: int,
                             max_trials: int = 8, uniforms=None,
                             counts: dict | None = None) -> torch.Tensor:
    """Plain torch version of csrc/resident_walk.cu: vectorized over
    walkers, a Python loop over steps and trials (a trial runs only for the
    walkers still open). Returns i32 [W_pad, L+2]. `counts`, when given,
    receives the steps taken and the trials run."""
    _check_stream(walk_length, max_trials, W_pad)
    dev = tab.device
    inv_p, inv_q, max_f, _ = bias_constants(p, q)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    inv_p, inv_q, max_f, one = f32(inv_p), f32(inv_q), f32(max_f), f32(1.0)
    u = _Draws(seed, uniforms, W_pad, dev)
    gid = torch.arange(W_pad, device=dev)
    real = gid < W_real
    start = (gid % V).to(torch.int32)
    cur = start.long()
    deg = tab[cur, 0]
    alive = real & (deg > 0)
    first = _sample(tab, md, cur, deg, u.at(0, 0, gid), u.at(0, 1, gid))
    cols = [torch.where(real, start, -1), torch.where(alive, first, -1)]
    prev = cur
    cur = torch.where(alive, first.long(), cur)
    n_steps = n_trials = 0
    for t in range(walk_length):
        alive = alive & (tab[cur, 0] > 0)
        dst = torch.zeros(W_pad, dtype=torch.int32, device=dev)
        open_ = alive.nonzero().squeeze(1)
        n_steps += open_.numel()
        for j in range(max_trials):
            if open_.numel() == 0:
                break
            n_trials += open_.numel()
            r = 1 + t * max_trials + j
            c_o, p_o = cur[open_], prev[open_]
            cand = _sample(tab, md, c_o, tab[c_o, 0], u.at(r, 0, open_),
                           u.at(r, 1, open_))
            dst[open_] = cand
            member = (tab[p_o, 1:1 + md] == cand[:, None]).any(dim=1)
            f = torch.where(cand == p_o, inv_p,
                            torch.where(member, one, inv_q))
            open_ = open_[~(u.at(r, 2, open_) * max_f < f)]
        cols.append(torch.where(alive, dst, -1))
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, dst.long(), cur)
    if counts is not None:
        counts.update(steps=n_steps, trials=n_trials)
    return torch.stack(cols, dim=1).to(torch.int32)


def row_placement(tab: torch.Tensor, rows: str | None = None) -> str:
    """Where walk_corpus_resident's kernel reads this table's rows from:
    "shared" (the block's copy in shared memory) when the table fits, else
    "global" (device memory, in place). `rows` forces one of the two."""
    fits = tab.numel() * 4 <= SHARED_TABLE_BYTES
    if rows is None:
        return "shared" if fits else "global"
    if rows not in ("shared", "global"):
        raise ValueError(f"rows must be 'shared' or 'global', got {rows!r}")
    if rows == "shared" and not fits:
        raise ValueError(f"a table of {tab.numel() * 4} bytes does not fit "
                         f"{SHARED_TABLE_BYTES} bytes of shared memory")
    return rows


def walk_corpus_resident(tab: torch.Tensor, seed: int, V: int, W_real: int,
                         walk_length: int, p: float, q: float, md: int,
                         W_pad: int, max_trials: int = 8, uniforms=None,
                         rows: str | None = None) -> torch.Tensor:
    """Walk corpus over the row table `tab` (build_row_tables, with the md
    it was built with) -> i32 [W_pad, walk_length + 2]. Walker gid starts at
    gid % V; rows beyond W_real are -1. `uniforms`, optional f32
    [1 + walk_length*max_trials, 3, W_pad], replaces the seeded stream.
    CUDA tensors launch csrc/resident_walk.cu (rows in shared memory when
    the table fits, see row_placement); CPU tensors run
    walk_corpus_resident_ref."""
    if tab.dtype != torch.int32 or tab.shape != (V, row_words(md)):
        raise ValueError(f"resident walk: table {tab.dtype} "
                         f"{tuple(tab.shape)}, expected int32 "
                         f"{(V, row_words(md))}")
    if not (0 < V and 0 <= W_real <= W_pad and walk_length >= 0
            and max_trials >= 1):
        raise ValueError("resident walk: need V > 0, 0 <= W_real <= W_pad, "
                         "walk_length >= 0, max_trials >= 1")
    shape = uniforms_shape(walk_length, max_trials, W_pad)
    if uniforms is not None and (uniforms.dtype != torch.float32
                                 or tuple(uniforms.shape) != shape
                                 or uniforms.device != tab.device):
        raise ValueError(f"resident walk: uniforms must be float32 {shape} "
                         "on the table's device")
    if tab.device.type == "cpu":
        return walk_corpus_resident_ref(tab, seed, V, W_real, walk_length, p,
                                        q, md, W_pad, max_trials, uniforms)
    _check_stream(walk_length, max_trials, W_pad)
    RESIDENT_WALK_KERNEL.fn()
    require_cuda("walk_corpus_resident", tab,
                 *(() if uniforms is None else (uniforms,)))
    place = row_placement(tab, rows)
    key = prng.prng_key(seed)
    inv_p, inv_q, max_f, _ = bias_constants(p, q)
    out = torch.empty((walk_length + 2, W_pad), dtype=torch.int32,
                      device=tab.device)
    RESIDENT_WALK_KERNEL.launch(
        ptr(tab), V, md, W_real, W_pad, walk_length, max_trials,
        int(key[0]), int(key[1]),
        None if uniforms is None else ptr(uniforms), float(inv_p),
        float(inv_q), float(max_f), int(place == "shared"), ptr(out),
        stream(tab.device))
    return out.t().contiguous()


def resident_walks(graph, walk_length: int, num_walks: int, p: float,
                   q: float, seed: int = 0, tile: int = 256,
                   max_trials: int = 8, as_numpy: bool = True, *,
                   device="cuda") -> np.ndarray | torch.Tensor:
    """Host row tables + the resident-row kernel -> dense corpus
    [num_walks * V, walk_length + 2], laid out like engine.random_walks
    (row r*V + v is round r from vertex v) and equal bit for bit to the JAX
    package's pallas_walks(..., external_uniforms=True) with the same seed
    and tile. `tile` only pads the walker count (it is the stream's width
    quantum). `device` defaults to the card and raises when there is none;
    as_numpy=False returns the device tensor."""
    device = resolve_device("resident_walks", device)
    md = max(graph.max_degree, 1)
    tab = torch.as_tensor(build_row_tables(graph, md)).to(device)
    V = graph.num_vertices
    W = num_walks * V
    W_pad = _pad_to(max(W, tile), tile)
    out = walk_corpus_resident(tab, seed, V, W, walk_length, float(p),
                               float(q), md, W_pad, max_trials)[:W]
    return out.cpu().numpy() if as_numpy else out
