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

Rows (row_layout): a row is `stride` words, 16-byte aligned,
[md4 neighbour ids | md pairs (keep-probability, alias partner id) | deg]
with md4 = md rounded up to 4 and at least HELD_IDS: the ids lead so that
the kernel reads them as int4s (the first HELD_IDS of prev's into
registers), a slot's keep-probability and alias partner come by one 8-byte
read, and stride / 4 is odd so that the reads spread over shared memory's
bank groups. An id word (ids and alias partner ids) holds the id in
its low ID_BITS bits and that vertex's own degree above them, so that a step
knows its row's degree without reading it; -1 marks a padded slot. The
fields (row_fields) are those of the JAX package's 128-lane row
(ops/pallas/walk.py:60-92).

Draws: the uniform of (draw row r, component c, walker w) is element
(r*3 + c)*W_pad + w of jax.random.uniform(PRNGKey(seed), (1 + L*max_trials,
3, W_pad)); the first-order step reads row 0, trial j of step t row
1 + t*max_trials + j. That is the array pallas_walks(external_uniforms=True)
feeds its kernel, so the corpora are equal bit for bit. (The TPU kernel's
default stream is the core's hardware generator, which nothing else
reproduces.) External `uniforms` of that shape replace the stream.

CUDA tensors launch csrc/resident_walk.cu, CPU tensors run
walk_corpus_resident_ref; the two agree bit for bit. Where the kernel reads
rows from (row_placement) and how many blocks and threads it gets
(launch_plan) are decided here, from the table's size, the walker count and
the card's SM count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..errors import resolve_device
from . import prng
from ._build import Kernel, ptr, require_cuda, stream
from .walk_step import bias_constants, warp_max

MAX_MD = 42   # the JAX package's degree bound (1 + 3*MD lanes in a 128-lane row)
# an id word: the id below, the vertex's degree (<= MAX_MD) above
ID_BITS = 26
ID_MASK = (1 << ID_BITS) - 1
HELD_IDS = 16  # id slots a row has at least: the kernel holds so many of prev's
# shared memory one block may use on sm_90, and what the kernel keeps of it
# beside the table (its copy barrier)
SHARED_TABLE_BYTES = 232_448
SHARED_RESERVED_BYTES = 16
# the kernel's __launch_bounds__ by row placement
MAX_THREADS = {"shared": 1024, "global": 256}
# blocks an SM gets where rows are read from device memory, before blocks
# grow beyond one warp: as many as it can hold at once
GLOBAL_BLOCKS_PER_SM = 32
# threads a block has at least where rows are in shared memory: a warp for
# each of an SM's four schedulers costs no time and saves table copies
SHARED_MIN_THREADS = 128

RESIDENT_WALK_KERNEL = Kernel(
    "resident_walk.cu", "srw_resident_walk_launch",
    [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_uint] * 2
    + [ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p, ctypes.c_void_p])


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


class RowLayout(NamedTuple):
    """Word offsets inside a row; the neighbour ids start at word 0."""
    stride: int
    pairs: int    # (keep-probability, alias partner id) of slot j at pairs + 2j
    deg: int


def row_layout(md: int) -> RowLayout:
    md4 = max(_pad_to(md, 4), HELD_IDS)
    stride = _pad_to(md4 + 2 * md + 1, 4)
    if (stride // 4) % 2 == 0:
        stride += 4
    return RowLayout(stride, md4, md4 + 2 * md)


def row_words(md: int) -> int:
    return row_layout(md).stride


def build_row_tables(graph, max_degree: int | None = None) -> np.ndarray:
    """Host prep: one row per vertex, i32[V, row_words(MD)], laid out by
    row_layout(MD): [neighbour ids | (keep-prob, alias partner id) pairs | deg],
    ids as id words (id | degree of that vertex << ID_BITS) with -1 in
    padded slots (never drawn: jpos < deg; never a member), probabilities as
    f32 bits with 1.0 in padded slots, zeros in the row's tail. Same fields
    as the JAX package's 128-lane f32 row."""
    graph.build_alias_tables()
    MD = int(max_degree or max(graph.max_degree, 1))
    assert graph.max_degree <= MD <= MAX_MD, (graph.max_degree, MD)
    lay = row_layout(MD)
    V = graph.num_vertices
    if V > ID_MASK:
        raise ValueError(f"resident walk: {V} vertices, an id word holds "
                         f"ids below {ID_MASK + 1}")
    deg = (graph.offsets[1:] - graph.offsets[:-1]).astype(np.int64)
    word = lambda ids: (ids | (deg[ids] << ID_BITS)).astype(np.uint32).view(
        np.int32)
    E = graph.num_edges
    pos = np.arange(MD)
    valid = pos[None, :] < deg[:, None]
    idxc = np.clip(graph.offsets[:-1, None] + pos[None, :], 0, max(E - 1, 0))
    aidx = np.clip(graph.offsets[:-1, None] + graph.alias_pos[idxc], 0,
                   max(E - 1, 0))
    tab = np.zeros((V, lay.stride), np.int32)
    tab[:, :lay.pairs] = -1
    tab[:, :MD] = np.where(valid, word(graph.cols[idxc]), -1)
    tab[:, lay.pairs:lay.deg:2] = np.where(
        valid, graph.alias_prob[idxc], 1.0).astype(np.float32).view(np.int32)
    tab[:, lay.pairs + 1:lay.deg:2] = np.where(valid, word(graph.cols[aidx]),
                                               -1)
    tab[:, lay.deg] = deg
    return tab


def row_fields(tab, md: int):
    """(deg, neighbour ids, alias partner ids, keep-prob f32) of a row
    table (numpy array or tensor), the ids without the degrees above them."""
    lay = row_layout(md)
    prob = tab[:, lay.pairs:lay.deg:2].contiguous() if torch.is_tensor(
        tab) else np.ascontiguousarray(tab[:, lay.pairs:lay.deg:2])
    where = torch.where if torch.is_tensor(tab) else np.where
    prob = (prob.view(torch.float32) if torch.is_tensor(prob)
            else prob.view(np.float32))
    ids = lambda w: where(w == -1, w, w & ID_MASK)
    return (tab[:, lay.deg], ids(tab[:, :md]),
            ids(tab[:, lay.pairs + 1:lay.deg:2]), prob)


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


def _sample(fields, vid, u_pos, u_keep):
    """Alias draw on the rows of `vid` (fields: row_fields) -> candidate ids
    (i32)."""
    deg, ids, alias, keep = fields
    deg = deg[vid]
    j = torch.minimum((u_pos * deg.to(torch.float32)).to(torch.int32),
                      (deg - 1).clamp_min(0)).long()
    return torch.where(u_keep < keep[vid, j], ids[vid, j], alias[vid, j])


def walk_corpus_resident_ref(tab: torch.Tensor, seed: int, V: int,
                             W_real: int, walk_length: int, p: float,
                             q: float, md: int, W_pad: int,
                             max_trials: int = 8, uniforms=None,
                             counts: dict | None = None) -> torch.Tensor:
    """Plain torch version of csrc/resident_walk.cu: vectorized over
    walkers, a Python loop over steps and trials (a trial runs only for the
    walkers still open). Returns i32 [W_pad, L+2]. `counts`, when given,
    receives `steps` (second-order steps taken), `trials`, `acc_draws` (the
    trials whose u_acc could decide: f < max_f and a later trial exists),
    `cold_steps` (steps whose trial 0 was such a trial: the kernel's cold
    path), `walker_trials` (i64 [W_pad], each walker's trials),
    `step_warp_max` (the sum over steps and over warps of 32 consecutive
    walkers of the most trials a lane of the warp ran in the step) and
    `warp_cold_steps` (steps x warps with a lane on the cold path)."""
    _check_stream(walk_length, max_trials, W_pad)
    dev = tab.device
    inv_p, inv_q, max_f, _ = bias_constants(p, q)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    inv_p, inv_q, max_f, one = f32(inv_p), f32(inv_q), f32(max_f), f32(1.0)
    u = _Draws(seed, uniforms, W_pad, dev)
    fields = row_fields(tab, md)
    deg, ids = fields[:2]
    gid = torch.arange(W_pad, device=dev)
    real = gid < W_real
    start = (gid % V).to(torch.int32)
    cur = start.long()
    alive = real & (deg[cur] > 0)
    first = _sample(fields, cur, u.at(0, 0, gid), u.at(0, 1, gid))
    cols = [torch.where(real, start, -1), torch.where(alive, first, -1)]
    prev = cur
    cur = torch.where(alive, first.long(), cur)
    n_steps = n_trials = n_acc = n_cold = warp_max_sum = warp_cold = 0
    walker_trials = torch.zeros(W_pad, dtype=torch.int64, device=dev)
    for t in range(walk_length):
        alive = alive & (deg[cur] > 0)
        dst = torch.zeros(W_pad, dtype=torch.int32, device=dev)
        open_ = alive.nonzero().squeeze(1)
        n_steps += open_.numel()
        step_trials = torch.zeros_like(walker_trials)
        for j in range(max_trials):
            if open_.numel() == 0:
                break
            n_trials += open_.numel()
            step_trials[open_] += 1
            r = 1 + t * max_trials + j
            c_o, p_o = cur[open_], prev[open_]
            cand = _sample(fields, c_o, u.at(r, 0, open_), u.at(r, 1, open_))
            dst[open_] = cand
            member = (ids[p_o] == cand[:, None]).any(dim=1)
            f = torch.where(cand == p_o, inv_p,
                            torch.where(member, one, inv_q))
            if j < max_trials - 1:
                decides = f < max_f
                n_acc += int(decides.sum())
                if j == 0:
                    n_cold += int(decides.sum())
                    cold = torch.zeros(W_pad, dtype=torch.bool, device=dev)
                    cold[open_[decides]] = True
                    warp_cold += int(warp_max(cold).sum())
            open_ = open_[~(u.at(r, 2, open_) * max_f < f)]
        walker_trials += step_trials
        warp_max_sum += int(warp_max(step_trials).sum())
        cols.append(torch.where(alive, dst, -1))
        prev = torch.where(alive, cur, prev)
        cur = torch.where(alive, dst.long(), cur)
    if counts is not None:
        counts.update(steps=n_steps, trials=n_trials, acc_draws=n_acc,
                      cold_steps=n_cold, walker_trials=walker_trials,
                      step_warp_max=warp_max_sum, warp_cold_steps=warp_cold)
    return torch.stack(cols, dim=1).to(torch.int32)


def row_placement(tab: torch.Tensor, rows: str | None = None) -> str:
    """Where walk_corpus_resident's kernel reads this table's rows from:
    "shared" (the block's copy in shared memory) when the table fits beside
    the kernel's copy barrier, else "global" (device memory, in place,
    through the read-only cache). `rows` forces one of the two."""
    nbytes = tab.numel() * 4
    fits = nbytes + SHARED_RESERVED_BYTES <= SHARED_TABLE_BYTES
    if rows is None:
        return "shared" if fits else "global"
    if rows not in ("shared", "global"):
        raise ValueError(f"rows must be 'shared' or 'global', got {rows!r}")
    if rows == "shared" and not fits:
        raise ValueError(f"a table of {nbytes} bytes does not fit "
                         f"{SHARED_TABLE_BYTES} bytes of shared memory")
    return rows


class LaunchPlan(NamedTuple):
    blocks: int
    threads: int          # a block; a multiple of 32
    walkers_a_thread: int  # the most one thread walks


def launch_plan(W_pad: int, place: str, sm_count: int) -> LaunchPlan:
    """Blocks and threads for W_pad walkers on a card of sm_count SMs.

    Rows in shared memory: the table takes an SM's whole shared memory, so
    one block lives on an SM: at most sm_count blocks, each with its share
    of the walkers rounded up to a warp, at least SHARED_MIN_THREADS (every
    block copies the table) and at most 1,024 threads; beyond that a thread
    walks several walkers in turn. Rows in device memory: blocks of one
    warp, and larger ones only past GLOBAL_BLOCKS_PER_SM an SM, so that the
    SMs' schedulers fill evenly and a block that ends early makes room for
    the next (one warp a block was the fastest on the card)."""
    if W_pad <= 0 or sm_count <= 0:
        raise ValueError("launch_plan: need W_pad > 0 and sm_count > 0")
    top = MAX_THREADS[place]
    if place == "shared":
        share = -(-W_pad // sm_count)
    else:
        share = -(-W_pad // (GLOBAL_BLOCKS_PER_SM * sm_count))
    least = SHARED_MIN_THREADS if place == "shared" else 32
    threads = min(max(_pad_to(share, 32), least), top)
    blocks = -(-W_pad // threads)
    if place == "shared":
        blocks = min(blocks, sm_count)
    return LaunchPlan(blocks, threads, -(-W_pad // (blocks * threads)))


def walk_corpus_resident(tab: torch.Tensor, seed: int, V: int, W_real: int,
                         walk_length: int, p: float, q: float, md: int,
                         W_pad: int, max_trials: int = 8, uniforms=None,
                         rows: str | None = None) -> torch.Tensor:
    """Walk corpus over the row table `tab` (build_row_tables, with the md
    it was built with) -> i32 [W_pad, walk_length + 2]. Walker gid starts at
    gid % V; rows beyond W_real are -1. `uniforms`, optional f32
    [1 + walk_length*max_trials, 3, W_pad], replaces the seeded stream.
    CUDA tensors launch csrc/resident_walk.cu (rows in shared memory when
    the table fits, see row_placement; blocks and threads by launch_plan);
    CPU tensors run walk_corpus_resident_ref."""
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
    RESIDENT_WALK_KERNEL.fn()       # on a CUDA tensor: the kernel, or raise
    require_cuda("walk_corpus_resident", tab,
                 *(() if uniforms is None else (uniforms,)))
    place = row_placement(tab, rows)
    if W_pad == 0:
        return torch.empty((0, walk_length + 2), dtype=torch.int32,
                           device=tab.device)
    plan = launch_plan(W_pad, place, torch.cuda.get_device_properties(
        tab.device).multi_processor_count)
    return launch_kernel(tab, seed, V, W_real, walk_length, p, q,
                         row_layout(md), W_pad, max_trials, uniforms, place,
                         plan)


def launch_kernel(tab, seed, V, W_real, walk_length, p, q, layout, W_pad,
                  max_trials, uniforms, place, plan,
                  kernel: Kernel = RESIDENT_WALK_KERNEL) -> torch.Tensor:
    """One launch of the kernel (checked arguments, CUDA tensors) -> the
    corpus, i32 [W_pad, walk_length + 2]."""
    _check_stream(walk_length, max_trials, W_pad)
    key = prng.prng_key(seed)
    inv_p, inv_q, max_f, _ = bias_constants(p, q)
    out = torch.empty((W_pad, walk_length + 2), dtype=torch.int32,
                      device=tab.device)
    kernel.launch(
        ptr(tab), V, *layout, W_real, W_pad, walk_length, max_trials,
        int(key[0]), int(key[1]),
        None if uniforms is None else ptr(uniforms), float(inv_p),
        float(inv_q), float(max_f), int(place == "shared"), plan.blocks,
        plan.threads, ptr(out), stream(tab.device))
    return out


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
