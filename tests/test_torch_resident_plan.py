"""What can be held on the CPU of the resident-row walk kernel's design
(stellar_rw_tpu_torch/csrc/resident_walk.cu):

  * the kernel's schedule, transcribed for one walker at a time in plain
    Python integers (trial-0 draws made kAhead steps ahead, later trials and
    every deciding u_acc in a cold path that draws the next trial's pair
    beside it, no draw in the last trial, a row's degree taken from the id
    word that led to it, prev's first ids held from the step before), gives
    walk_corpus_resident_ref's corpus bit for bit, reads no uniform outside
    the array, and draws u_acc as often as the plain version counts;
  * the launch plan covers every walker within the kernel's launch bounds
    and one SM's shared memory;
  * the plain version's counts against a direct count.

Tolerance: exact (integers).
"""

import re

import numpy as np
import pytest
import torch

import chip_resident_parts
from stellar_rw_tpu_torch.graph import csr as tcsr
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.ops import _build, prng
from stellar_rw_tpu_torch.ops import resident_walk as rw
from stellar_rw_tpu_torch.ops.walk_step import bias_constants

torch.set_num_threads(2)

WALK_PQ = [(0.25, 0.25), (1.0, 1.0), (1.0, 4.0), (4.0, 0.25), (0.25, 4.0)]
M32 = 0xFFFFFFFF
WEIGHTED5 = {0: [(1, 1.0)], 1: [(0, 1.0), (2, 2.0), (3, 1.0), (4, 0.5)],
             2: [(1, 1.0), (0, 1.0)], 3: [(1, 1.0)], 4: [(1, 1.0)]}
CHAIN = {0: [(1, 1.0)], 1: [(2, 1.0)], 2: []}
SOURCE = (_build.CSRC / rw.RESIDENT_WALK_KERNEL.source).read_text()
K_AHEAD = int(re.search(r"constexpr int kAhead = (\d+);", SOURCE).group(1))


def _rotl(v, d):
    return ((v << d) & M32) | (v >> (32 - d))


def _threefry(k0, k1, c0, c1):
    """One threefry-2x32 block on Python integers (csrc/threefry.cuh)."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    x0, x1 = (c0 + k0) & M32, (c1 + k1) & M32
    inject = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3), (k1, ks2, 4),
              (ks2, k0, 5))
    for i, (a, b, n) in enumerate(inject):
        for r in ((13, 15, 26, 6) if i % 2 == 0 else (17, 29, 16, 24)):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + a) & M32
        x1 = (x1 + b + n) & M32
    return x0, x1


class Draws:
    """The kernel's Draws: uniform (row, c) of one walker, from the key or
    from the flat external array; counts the reads by component."""

    def __init__(self, key, ext, w_pad):
        self.key, self.ext, self.w_pad = key, ext, w_pad
        self.gid = 0
        self.reads = [0, 0, 0]

    def at(self, row, c):
        self.reads[c] += 1
        i = ((row * 3 + c) * self.w_pad + self.gid) & M32
        if self.ext is not None:
            return self.ext[i]              # IndexError when out of range
        o0, o1 = _threefry(self.key[0], self.key[1], 0, i)
        bits = np.uint32(((o0 ^ o1) >> 9) | 0x3F800000)
        return bits.view(np.float32) - np.float32(1.0)


def _sample(tab, lay, r0, deg, u_pos, u_keep):
    j = min(int(np.float32(u_pos) * np.float32(deg)), deg - 1)
    at = r0 + lay.pairs + 2 * j
    assert at % 2 == 0                     # one aligned 8-byte read
    keep = tab[at:at + 1].astype(np.uint32).view(np.float32)[0]
    return int(tab[r0 + j]) if u_keep < keep else int(tab[at + 1])


def _load_ids(tab, r0):
    assert r0 % 4 == 0                     # aligned int4s
    return tab[r0:r0 + rw.HELD_IDS].tolist()


def _bias(tab, lay, prev, pdeg, pids, cand, scan, inv_p, inv_q):
    """Id words compared whole: prev's first ids from registers, the rest of
    a long row from the table."""
    member = False
    if scan:
        member = cand in pids
        if pdeg > rw.HELD_IDS:
            p0 = (prev & rw.ID_MASK) * lay.stride
            for k in range(rw.HELD_IDS, pdeg, 4):
                member |= cand in tab[p0 + k:p0 + k + 4].tolist()
    if cand == prev:
        return inv_p
    return np.float32(1.0) if member else inv_q


def _draw_ahead(u, t0, L, T):
    """u_pos and u_keep of trial 0 of steps t0 .. t0 + kAhead - 1 (steps past
    the last clamped)."""
    up, uk = [], []
    for i in range(K_AHEAD):
        t = min(t0 + i, L - 1)
        row = 0 if t < 0 else 1 + t * T
        up.append(u.at(row, 0))
        uk.append(u.at(row, 1))
    return up, uk


def kernel_schedule_corpus(tab2d, md, seed, V, W_real, L, p, q, W_pad, T,
                           ext=None):
    """csrc/resident_walk.cu's resident_walk_kernel for one walker at a
    time. Returns the corpus [W_pad, L+2] and the u_acc draws made."""
    lay = rw.row_layout(md)
    # the table's words as unsigned integers, so that an id word's degree
    # is a plain shift
    tab = np.ascontiguousarray(tab2d).reshape(-1).view(np.uint32).astype(
        np.int64)
    inv_p, inv_q, max_f, _ = bias_constants(p, q)
    scan = inv_q != np.float32(1.0)
    key = [int(k) for k in prng.prng_key(seed)]
    u = Draws(key, None if ext is None else ext.reshape(-1), W_pad)
    out = np.full((W_pad, L + 2), -1, dtype=np.int32)
    for gid in range(W_pad):
        u.gid = gid
        u_pos0, u_keep0 = u.at(0, 0), u.at(0, 1)
        up, uk = _draw_ahead(u, 0, L, T)
        if gid >= W_real:
            continue
        start = gid % V
        out[gid, 0] = start
        r0 = start * lay.stride
        deg = int(tab[r0 + lay.deg])
        if deg <= 0:
            continue
        prev, pdeg = start | (deg << rw.ID_BITS), deg
        pids = _load_ids(tab, r0)
        cur = _sample(tab, lay, r0, deg, u_pos0, u_keep0)
        out[gid, 1] = cur & rw.ID_MASK
        deg = cur >> rw.ID_BITS
        live = True
        t0 = 0
        while live and t0 < L:
            nup = nuk = None
            for i in range(K_AHEAD):
                t = t0 + i
                if not live or t >= L:
                    break
                if deg <= 0:
                    live = False
                    break
                r0 = (cur & rw.ID_MASK) * lay.stride
                if i == 0:
                    nup, nuk = _draw_ahead(u, t0 + K_AHEAD, L, T)
                cand = _sample(tab, lay, r0, deg, up[i], uk[i])
                f = _bias(tab, lay, prev, pdeg, pids, cand, scan, inv_p,
                          inv_q)
                j = 0
                while f < max_f and j < T - 1:
                    row = 1 + t * T + j
                    u_acc = u.at(row, 2)
                    u_pos, u_keep = u.at(row + 1, 0), u.at(row + 1, 1)
                    if np.float32(u_acc * max_f) < f:
                        break
                    cand = _sample(tab, lay, r0, deg, u_pos, u_keep)
                    f = _bias(tab, lay, prev, pdeg, pids, cand, scan, inv_p,
                              inv_q)
                    j += 1
                out[gid, t + 2] = cand & rw.ID_MASK
                pids = _load_ids(tab, r0)
                prev, pdeg, cur, deg = cur, deg, cand, cand >> rw.ID_BITS
            up, uk = nup, nuk
            t0 += K_AHEAD
    return out, u.reads[2]


def _regular(num_vertices=24, degree=6, seed=4):
    """Union of degree/2 random Hamiltonian cycles, weighted."""
    rng = np.random.default_rng(seed)
    orders = [rng.permutation(num_vertices) for _ in range(degree // 2)]
    src = np.concatenate(orders)
    dst = np.concatenate([np.roll(o, -1) for o in orders])
    w = rng.random(len(src)).astype(np.float32) * 4 + 0.25
    return tcsr.from_edge_arrays(src, dst, w, num_vertices=num_vertices,
                                 symmetrize=True)


@pytest.fixture(scope="module")
def graphs(karate_path):
    return {"karate": tio.load_edge_list(karate_path, weighted=False,
                                         directed=False),
            "weighted5": tcsr.from_adjacency(WEIGHTED5),
            "chain": tcsr.from_adjacency(CHAIN),
            "regular": _regular()}


LENGTHS = sorted({0, 1, max(K_AHEAD - 1, 0), K_AHEAD + 1, 20})


@pytest.mark.parametrize("draws", ["seeded", "external"])
@pytest.mark.parametrize("pq", WALK_PQ)
@pytest.mark.parametrize("name", ["karate", "weighted5", "chain", "regular"])
def test_kernel_schedule_equals_the_plain_version(graphs, name, pq, draws):
    g = graphs[name]
    md, V = max(g.max_degree, 1), g.num_vertices
    tab = rw.build_row_tables(g, md)
    W_pad = 64
    W_real = min(W_pad - 3, 2 * V)        # padded walkers, too
    rng = np.random.default_rng(21)
    for L in LENGTHS:
        for T in (1, 8):
            ext = (rng.random(rw.uniforms_shape(L, T, W_pad),
                              dtype=np.float32)
                   if draws == "external" else None)
            counts = {}
            want = rw.walk_corpus_resident_ref(
                torch.as_tensor(tab), 13, V, W_real, L, pq[0], pq[1], md,
                W_pad, T, None if ext is None else torch.as_tensor(ext),
                counts=counts)
            got, acc_draws = kernel_schedule_corpus(
                tab, md, 13, V, W_real, L, pq[0], pq[1], W_pad, T, ext)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"L={L} T={T}")
            # u_acc is drawn where it can decide, nowhere else (padded
            # walkers draw nothing in the cold path)
            assert acc_draws == counts["acc_draws"], (L, T)


def test_ahead_constant_is_in_the_source():
    assert K_AHEAD >= 1
    assert SOURCE.count("constexpr int kAhead = ") == 1


@pytest.mark.parametrize("name", [n for n, edits in
                                  chip_resident_parts.VARIANTS.items()
                                  if edits])
def test_parts_variant_edits_the_source_once(name):
    """chip_resident_parts.py patches the kernel by text: each piece must
    occur exactly once in the source it is applied to, and change it."""
    text = SOURCE
    for old, new in chip_resident_parts.VARIANTS[name]:
        assert text.count(old) == 1 and new != old
        text = text.replace(old, new)


# --- the launch plan -------------------------------------------------------

WALKERS = [256, 512, 10_240, 40_960, 81_920, 135_168, 135_424, 2**20]


@pytest.mark.parametrize("sm_count", [1, 108, 132])
@pytest.mark.parametrize("W_pad", WALKERS)
@pytest.mark.parametrize("place", ["shared", "global"])
def test_launch_plan_covers_every_walker(place, W_pad, sm_count):
    plan = rw.launch_plan(W_pad, place, sm_count)
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads <= rw.MAX_THREADS[place] <= 1024
    if place == "shared":
        assert plan.threads >= rw.SHARED_MIN_THREADS
    assert plan.blocks >= 1
    # a thread walks gid, gid + blocks*threads, ...: every walker has one
    assert plan.blocks * plan.threads * plan.walkers_a_thread >= W_pad
    assert plan.blocks * plan.threads * (plan.walkers_a_thread - 1) < W_pad
    assert (plan.blocks - 1) * plan.threads < W_pad    # no idle block
    if place == "shared":
        assert plan.blocks <= sm_count                 # one block an SM
    else:
        assert plan.walkers_a_thread == 1
        # several blocks an SM (rounding a block up to a warp can halve
        # them), or single warps where walkers are few
        assert (2 * plan.blocks >= rw.GLOBAL_BLOCKS_PER_SM * sm_count
                or plan.threads == 32 or plan.threads == 256)


def test_launch_plan_at_the_smoke_shapes():
    assert rw.launch_plan(10_240, "shared", 132) == rw.LaunchPlan(80, 128, 1)
    assert rw.launch_plan(256, "shared", 132) == rw.LaunchPlan(2, 128, 1)
    assert rw.launch_plan(81_920, "shared", 132) == rw.LaunchPlan(128, 640, 1)
    assert rw.launch_plan(40_960, "global", 132) == rw.LaunchPlan(1280, 32, 1)
    assert rw.launch_plan(2**20, "global", 132) == rw.LaunchPlan(4096, 256, 1)
    assert rw.launch_plan(2**20, "shared", 132) == rw.LaunchPlan(132, 1024, 8)
    with pytest.raises(ValueError):
        rw.launch_plan(0, "shared", 132)


@pytest.mark.parametrize("md", range(1, rw.MAX_MD + 1))
def test_shared_table_bytes(md):
    """A table that row_placement puts in shared memory fits one block's
    shared memory beside the barrier, in 16-byte multiples."""
    lay = rw.row_layout(md)
    assert lay.stride * 4 % 16 == 0 and lay.stride > lay.deg
    most = (rw.SHARED_TABLE_BYTES - rw.SHARED_RESERVED_BYTES) // (
        lay.stride * 4)
    for V, place in ((most, "shared"), (most + 1, "global")):
        tab = torch.zeros((V, lay.stride), dtype=torch.int32, device="meta")
        assert rw.row_placement(tab) == place
        nbytes = V * lay.stride * 4
        assert nbytes % 16 == 0
        assert (nbytes + rw.SHARED_RESERVED_BYTES <= rw.SHARED_TABLE_BYTES
                ) == (place == "shared")


# --- the plain version's counts ---------------------------------------------

@pytest.mark.parametrize("pq", WALK_PQ)
@pytest.mark.parametrize("T", [1, 2, 8])
def test_ref_counts_against_a_direct_count(graphs, pq, T):
    """acc_draws, cold_steps and the per-warp counts of
    walk_corpus_resident_ref, recounted walker by walker from the corpus
    rule: trial j's u_acc can decide iff f < max_f and j < T - 1."""
    g = graphs["karate"]
    md, V, L, W_pad, W_real = g.max_degree, g.num_vertices, 6, 64, 50
    tab = rw.build_row_tables(g, md)
    ext = np.random.default_rng(3).random(rw.uniforms_shape(L, T, W_pad),
                                          dtype=np.float32)
    counts = {}
    corpus = rw.walk_corpus_resident_ref(
        torch.as_tensor(tab), 0, V, W_real, L, pq[0], pq[1], md, W_pad, T,
        torch.as_tensor(ext), counts=counts).numpy()
    inv_p, inv_q, max_f, _ = bias_constants(*pq)
    _, ids, _, _ = rw.row_fields(tab, md)
    lay = rw.row_layout(md)
    flat = tab.reshape(-1).view(np.uint32).astype(np.int64)
    trials = np.zeros((L, W_pad), dtype=np.int64)
    acc = cold = 0
    cold_at = np.zeros((L, W_pad), dtype=bool)
    for w in range(W_real):
        for t in range(L):
            prev, cur = int(corpus[w, t]), int(corpus[w, t + 1])
            for j in range(T):
                trials[t, w] += 1
                r = 1 + t * T + j
                cand = _sample(flat, lay, cur * lay.stride,
                               int(tab[cur, lay.deg]), ext[r, 0, w],
                               ext[r, 1, w]) & rw.ID_MASK
                f = (inv_p if cand == prev else np.float32(1.0)
                     if cand in ids[prev].tolist() else inv_q)
                if f < max_f and j < T - 1:
                    acc += 1
                    if j == 0:
                        cold += 1
                        cold_at[t, w] = True
                if np.float32(ext[r, 2, w] * max_f) < f:
                    break
            assert cand == corpus[w, t + 2]
    assert counts["steps"] == W_real * L
    assert counts["trials"] == trials.sum()
    assert counts["acc_draws"] == acc and counts["cold_steps"] == cold
    np.testing.assert_array_equal(counts["walker_trials"].numpy(),
                                  trials.sum(axis=0))
    by_warp = lambda a: a.reshape(L, W_pad // 32, 32).max(axis=2).sum()
    assert counts["step_warp_max"] == by_warp(trials)
    assert counts["warp_cold_steps"] == by_warp(cold_at)
