"""K11's two halves (stellar_rw_tpu_torch/ops/shard_walk.py,
csrc/shard_walk.cu) on the CPU, where their plain versions run:

  * emit_ref against a NumPy transcription of the JAX package's bucket build
    (stellar_rw_tpu/parallel/distributed.py:345-378: argsort(stable=True),
    counts, bucket starts, ranks, the sent mask, put) on random
    destinations, capacities 1 to n, lanes 1 and 2, a superstep's first
    round and a later one;
  * the emit kernel's design (tiles of EMIT_THREADS walkers taken in
    order, a warp's peers, per-warp counts, each tile's status words and
    the decoupled look-back over them, in an order of its own and with
    statuses of the last launch in the way; the last tile's re-fill of
    what the last launch filled) transcribed in NumPy against emit_ref,
    one round and a sequence of rounds and supersteps into one reused
    work;
  * serve_ref (and the wrapper's received form) over every superstep's
    requests of a corpus, each served by the shard that owns its vertex,
    against the single-device corpus's next column, under hash and
    vertex-cut shards (halo prev rows among them) on karate, directed
    karate and tests/data/testgraph.txt (dead ends); the serve kernel's
    map of its threads to the flagged local walkers and the received
    buffer's slots transcribed against serve_plain;
  * cdf_serve_ref (and the wrapper's two request forms) the same way,
    against cdf_walk_ref's exact-CDF corpus, padded and chunked, f32 and
    f64, and its invalid requests;
  * the CDF serve kernel transcribed (a warp a request; prev's neighbor
    set from a bitmap of the vertices at long rows, its weights held to
    weigh's) against cdf_serve_ref, on received buffers with fills and on
    the local form; the heavy-row table of chip_cdf_serve_parts.py's kept
    redesigns;
  * the key table's redesign (a warp a (round, step)) transcribed against
    trial_keys_ref;
  * the constants and entry points ops/shard_walk.py mirrors, against the
    source; a CUDA tensor goes to the kernel or raises.
Exact throughout: the kernels compute integers, threefry bits and sums
in one fixed order."""

import re

import numpy as np
import pytest
import torch

from stellar_rw_tpu_torch.graph import io, partition
from stellar_rw_tpu_torch.ops import _build, prng, sampling, shard_walk
from stellar_rw_tpu_torch.ops import walk_step
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)
SOURCE = (_build.CSRC / "shard_walk.cu").read_text()
WALK_SOURCE = (_build.CSRC / "walk.cu").read_text()


def _route_tables(S, shard, route):
    """ShardTables carrying only a dense route: what the emit reads."""
    return shard_walk.ShardTables(
        g=None, route_mode=shard_walk.ROUTE_DENSE,
        route=torch.as_tensor(route, dtype=torch.int32), halo_buckets=None,
        halo_nb=0, glob2loc=None, S=S, shard=shard)


def _jax_exchange(dest, cur, prev, gids, C, D):
    """distributed.py:361-378 in NumPy: dest = D where nothing is sent."""
    n = len(dest)
    order = np.argsort(dest, kind="stable")
    sd = dest[order]
    counts = np.zeros(D, np.int64)
    np.add.at(counts, dest[dest < D], 1)
    bstart = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(n) - bstart[np.clip(sd, 0, D - 1)]
    ok = (sd < D) & (rank < C)
    sent = np.zeros(n, bool)
    sent[order] = ok

    def put(field, fill):
        buf = np.full((D, C), fill, np.int64)
        buf[sd[ok], rank[ok]] = field[order][ok]
        return buf
    send = np.stack([put(cur, 0), put(prev, 0), put(gids, -1)], -1)
    return send, put(np.arange(n), n), sent


def _walkers(n, S, seed):
    rng = np.random.default_rng(seed)
    V = 50
    route = rng.integers(0, S, V)
    cur = rng.integers(0, V, n)
    prev = rng.integers(0, V, n)
    alive = rng.random(n) < 0.8
    return route, cur, prev, alive


@pytest.mark.parametrize("C", [1, 3, 17, 1000])
@pytest.mark.parametrize("L", [1, 2])
def test_emit_ref_matches_jax_transcription(C, L):
    """Order, counts, buffers, slots and the sent mask of the first round
    and of the next, at random destinations over 3 shards x L lanes."""
    S, n, my = 3, 400, 1
    D = S * L
    C = min(C, n)
    route, cur, prev, alive = _walkers(n, S, C + L)
    tab = _route_tables(S, my, route)
    gid_base = my * L * n
    gids = gid_base + np.arange(n)
    t = lambda x: torch.as_tensor(x, dtype=torch.int32)
    pending, local = t(np.zeros(n)), t(np.zeros(n))
    ds = np.where(alive, route[cur], my)
    want_local = alive & (ds == my)
    rem = alive & ~want_local
    for first in (True, False):
        send, slot, counters = shard_walk.emit_ref(
            tab, t(cur), t(prev), pending, t(alive) if first else None,
            local, L, D, gid_base, C)
        dest = np.where(rem, route[cur] * L + gids % L, D)
        w_send, w_slot, sent = _jax_exchange(dest, cur, prev, gids, C, D)
        np.testing.assert_array_equal(local.numpy(), want_local)
        np.testing.assert_array_equal(send.numpy(), w_send)
        np.testing.assert_array_equal(slot.numpy(), w_slot)
        np.testing.assert_array_equal(counters.numpy(),
                                      [rem.sum(), (rem & ~sent).sum()])
        rem = rem & ~sent
        np.testing.assert_array_equal(pending.numpy(), rem)


class _EmitWorkModel:
    """ops/shard_walk.py::EmitWork's buffers as the kernel keeps them, in
    NumPy: filled when made, then left by each launch for the next."""

    def __init__(self, n, D, C):
        tiles = max(1, -(-n // shard_walk.EMIT_THREADS))
        self.n, self.D, self.C = n, D, C
        self.send = np.zeros((D, C, 3), np.int64)
        self.send[..., 2] = -1
        self.slot = np.full((D, C), n, np.int64)
        # each (tile, column): epoch, flag, count
        self.status = np.zeros((tiles, D, 3), np.int64)
        self.totals = np.zeros(D, np.int64)
        self.counters = np.zeros(3, np.int64)
        self.epoch = 0
        self.prefix_hits = self.spins = 0


def _emit_transcribed(work, col, cur, prev, gid_base, pending, first, rng):
    """csrc/shard_walk.cu's emit for the walkers' columns `col` (destination
    device, D none): the tiles taken in order (tile k holds
    walkers k * EMIT_THREADS ...), each warp's count a column and each
    warp's offset in its tile; each tile's status words published (a random
    half before any look-back, the rest when a look-back first waits on
    them: a status of the last epoch is not ready), the look-backs in a
    random order, a warp a column summing the counts of 32 tiles at a time
    up to the nearest prefix; each walker's place (the tiles' prefix + the
    warps before + the lanes before among its peers): a request sent below
    C; the last tile's fills of [total, the last launch's total) and the
    counts. pending is updated in place."""
    T, D, C = shard_walk.EMIT_THREADS, work.D, work.C
    cols, n = D, len(col)
    ntiles = work.status.shape[0]
    work.epoch = work.epoch % shard_walk.MAX_EPOCH + 1
    ep = work.epoch
    pad = np.full(ntiles * T, cols)
    pad[:n] = col
    tiles = pad.reshape(ntiles, T // 32, 32)               # tile, warp, lane
    wcnt = np.stack([(tiles == c).sum(axis=2) for c in range(cols)], -1)
    own = wcnt.sum(axis=1)                                 # [tile, column]
    woff = np.cumsum(wcnt, axis=1) - wcnt                  # warps' offsets
    peers = np.zeros_like(pad)                             # lanes before
    for c in range(cols):
        hit = tiles == c
        peers = np.where(pad == c, (np.cumsum(hit, axis=2) - hit).reshape(-1),
                         peers)

    def publish(j):
        work.status[j, :, 0] = ep
        work.status[j, :, 1] = (shard_walk.TILE_PREFIX if j == 0
                                else shard_walk.TILE_COUNT)
        work.status[j, :, 2] = own[j]

    for j in np.flatnonzero(rng.random(ntiles) < 0.5):
        publish(j)
    before = np.zeros((ntiles, cols), np.int64)
    lanes = np.arange(32)
    for k in rng.permutation(ntiles):
        if work.status[k, 0, 0] != ep:
            publish(k)
        for c in range(1 if k == 0 else 0, cols if k else 0):
            total, base = 0, k - 1
            while True:
                j = base - lanes
                for jj in j[j >= 0]:
                    if work.status[jj, c, 0] != ep:   # the warp waits on it
                        work.spins += 1
                        publish(jj)
                st = work.status[np.maximum(j, 0), c]
                prefix = (j < 0) | (st[:, 1] == shard_walk.TILE_PREFIX)
                upto = int(np.argmax(prefix)) if prefix.any() else 31
                total += int(st[(j >= 0) & (lanes <= upto), 2].sum())
                if prefix.any():
                    work.prefix_hits += int(j[upto] >= 0)
                    break
                base -= 32
            before[k, c] = total
            work.status[k, c] = (ep, shard_walk.TILE_PREFIX, total + own[k, c])
    for i in range(n):
        c = col[i]
        tl, w = i // T, (i % T) // 32
        if c < cols:
            at = before[tl, c] + woff[tl, w, c] + peers[i]
            if at < C:
                work.send[c, at] = (cur[i], prev[i], gid_base + i)
                work.slot[c, at] = i
            pending[i] = int(at >= C)
        elif first:
            pending[i] = 0
    last = ntiles - 1
    total = before[last] + own[last]
    for d in range(D):
        lo, high = min(total[d], C), min(work.totals[d], C)
        work.send[d, lo:high] = (0, 0, -1)
        work.slot[d, lo:high] = n
    work.totals = total.copy()
    work.counters[:] = (total.sum(), np.maximum(total - C, 0).sum(), 0)


def _emit_columns(route, cur, alive, pending, local, my, L, D, gid_base):
    """Each walker's column as the kernel decides it: its destination
    device (pending), D (none). The first round (alive given) writes the
    local flags."""
    gids = gid_base + np.arange(len(cur))
    dest = route[cur] * L + gids % L
    if alive is not None:
        loc = alive & (route[cur] == my)
        local[:] = loc
        return np.where(alive & ~loc, dest, D)
    return np.where(pending != 0, dest, D)


def _held_to_emit_ref(work, ref, pending, local, what):
    send, slot, counters = (x.numpy() for x in ref)
    np.testing.assert_array_equal(work.send, send, err_msg=what)
    np.testing.assert_array_equal(work.slot, slot, err_msg=what)
    np.testing.assert_array_equal(work.counters[:2], counters, err_msg=what)
    assert work.counters[2] == 0
    np.testing.assert_array_equal(pending[0], pending[1].numpy(),
                                  err_msg=what)
    if local is not None:
        np.testing.assert_array_equal(local[0], local[1].numpy(),
                                      err_msg=what)


@pytest.mark.parametrize("n,D,C", [(1500, 2, 600), (1500, 8, 50),
                                   (512, 3, 512), (37, 5, 1), (0, 2, 4),
                                   (40_000, 3, 9_000)])
def test_emit_kernel_design_matches_emit_ref(n, D, C):
    """The kernel's tiles, warps, status words and look-back give emit_ref's
    buffers, counts and flags, in a superstep's first round (alive: the
    local walkers flagged) and the round after: several tiles (79 at
    n 40,000, more than a window of 32), destinations crowded and sparse,
    capacity 1."""
    rng = np.random.default_rng(n + D)
    route = rng.integers(0, D, 64)
    cur = rng.integers(0, 64, n)
    prev = rng.integers(0, 64, n)
    alive = rng.random(n) < 0.7
    my = D - 1
    tab = _route_tables(D, my, route)
    t = lambda x: torch.as_tensor(x, dtype=torch.int32)
    work = _EmitWorkModel(n, D, C)
    pend, loc = np.zeros(n, np.int64), np.zeros(n, np.int64)
    pr, lr = t(np.zeros(n)), t(np.zeros(n))
    for first in (True, False):
        col = _emit_columns(route, cur, alive if first else None, pend,
                            loc, my, 1, D, 0)
        _emit_transcribed(work, col, cur, prev, 0, pend, first, rng)
        ref = shard_walk.emit_ref(tab, t(cur), t(prev), pr,
                                  t(alive) if first else None, lr, 1, D, 0,
                                  C)
        _held_to_emit_ref(work, ref, (pend, pr),
                          (loc, lr) if first else None, f"first {first}")
    if n >= 40_000:
        assert work.prefix_hits > 0 and work.spins > 0


def test_emit_reused_work_refills_to_the_high_water():
    """Supersteps of rounds into one reused work, the alive share and the
    routes changing so that bucket counts grow and shrink (past C and back
    to 0): after every launch each buffer equals a fresh emit_ref's. So the
    last tile's re-fill of [total, the last launch's total) leaves the
    fills where a fresh buffer has them, and the epochs keep the last
    launch's statuses out of the look-back."""
    n, D, C, L = 3000, 4, 300, 2
    rng = np.random.default_rng(11)
    t = lambda x: torch.as_tensor(x, dtype=torch.int32)
    work = _EmitWorkModel(n, D, C)
    seen = set()
    for step, share in enumerate((0.9, 0.2, 1.0, 0.0, 0.5, 0.05, 0.95)):
        S, my = D // L, 1
        route = rng.integers(0, S, 128)
        if step % 2:
            route[rng.random(128) < 0.7] = my    # most walkers local
        tab = _route_tables(S, my, route)
        cur = rng.integers(0, 128, n)
        prev = rng.integers(0, 128, n)
        alive = rng.random(n) < share
        gid_base = my * n
        pend, loc = np.zeros(n, np.int64), np.zeros(n, np.int64)
        pr, lr = t(np.zeros(n)), t(np.zeros(n))
        first = True
        while True:
            col = _emit_columns(route, cur, alive if first else None, pend,
                                loc, my, L, D, gid_base)
            _emit_transcribed(work, col, cur, prev, gid_base, pend, first,
                              rng)
            ref = shard_walk.emit_ref(tab, t(cur), t(prev), pr,
                                      t(alive) if first else None, lr, L, D,
                                      gid_base, C)
            _held_to_emit_ref(work, ref, (pend, pr),
                              (loc, lr) if first else None,
                              f"superstep {step}, first {first}")
            seen.add(tuple(min(int(x), C) for x in work.totals))
            first = False
            if work.counters[1] == 0:
                break
    # fills grew and shrank in every bucket of the other shard (shard 0's
    # lanes: a rank sends its own shard nothing)
    highs = np.array(sorted(seen))[:, :L]
    assert (highs.max(axis=0) == C).all() and (highs.min(axis=0) == 0).all()
    assert len(seen) > 8


GRAPHS = ["karate", "karate_directed", "testgraph"]


def _graph(name, karate_path, testgraph_path):
    if name == "testgraph":
        return io.load_edge_list(testgraph_path, weighted=False,
                                 directed=True)
    return io.load_edge_list(karate_path, weighted=False,
                             directed=name == "karate_directed")


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("route", ["hash", "vcut"])
@pytest.mark.parametrize("pq", [(0.5, 2.0), (1.0, 1.0)])
def test_serve_ref_steps_the_single_device_corpus(name, route, pq,
                                                  karate_path,
                                                  testgraph_path):
    """Every superstep's requests, each served by the shard owning its
    vertex (prev's row owned or a halo row), give the single-device
    corpus's next column, -1 at dead ends."""
    g = _graph(name, karate_path, testgraph_path)
    V, R, Lw, S = g.num_vertices, 2, 5, 3
    p, q = pq
    r = (None if route == "hash" else
         np.random.default_rng(2).integers(0, S, V).astype(np.int32))
    corpus = torch.as_tensor(engine.random_walks(
        g, walk_length=Lw, num_walks=R, p=p, q=q, seed=4, device="cpu"))
    _, max_rounds = sampling.plan_sampler("rejection", p, q)
    keys = walk_step.trial_keys_ref(prng.prng_key(4), 0, R, Lw,
                                    4 * max_rounds)
    plan = partition.plan_shards(g, S, r)
    tabs = [shard_walk.shard_tables(g, plan, s, "cpu") for s in range(S)]
    W_pad = V + 2                     # gids of a padded layout
    rows = torch.arange(R * V)
    gid = ((rows // V) * W_pad + rows % V).to(torch.int32)
    owner = torch.as_tensor(plan.route).long()
    halo = 0
    for t in range(Lw + 1):
        cur = corpus[:, t] if t else corpus[:, 0]
        prev = corpus[:, t - 1] if t > 1 else corpus[:, 0]
        alive = cur >= 0
        for s, tab in enumerate(tabs):
            m = alive & (owner[cur.clamp_min(0)] == s)
            halo += int((m & (owner[prev.clamp_min(0)] != s)).sum())
            req = torch.stack([cur[m], prev[m], gid[m]], 1).to(torch.int32)
            _, got = shard_walk.serve(tab, keys, t, t == 0, W_pad, R * W_pad,
                                      V, p, q, recv=req)
            np.testing.assert_array_equal(got.numpy(),
                                          corpus[m, t + 1].numpy())
            alone = shard_walk.serve_ref(tab, cur[m], prev[m], gid[m], None,
                                         keys, t, t == 0, W_pad, R * W_pad,
                                         V, p, q)
            np.testing.assert_array_equal(alone.numpy(), got.numpy())
    if name == "karate":
        assert halo > 0
    if name != "karate":
        assert bool((corpus == -1).any())


# dyadic weights: every biased partial sum exact in f32
DYADIC = {0: [(1, 0.5), (2, 2.0), (3, 1.0)],
          1: [(0, 0.5), (2, 0.25), (4, 4.0), (5, 1.5)],
          2: [(0, 2.0), (1, 0.25), (3, 0.75), (5, 1.0)],
          3: [(0, 1.0), (2, 0.75), (4, 2.5)],
          4: [(1, 4.0), (3, 2.5), (5, 0.125)],
          5: [(1, 1.5), (2, 1.0), (4, 0.125)]}


@pytest.mark.parametrize("name", ["karate", "karate_directed", "dyadic"])
@pytest.mark.parametrize("route", ["hash", "vcut"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_cdf_serve_ref_steps_the_single_device_corpus(
        name, route, dtype, chunk, karate_path, testgraph_path,
        monkeypatch):
    """Every superstep's requests, each served by the shard owning its
    vertex (prev's row owned or a halo row) over 3 shards, give the next
    column of cdf_walk_ref's corpus, -1 at dead ends: in the request
    tensor form, and in the local form (gid = gid_base + i) with only the
    shard's walkers valid; padded and chunked (CDF_PAD_LIMIT and CDF_CHUNK
    set small), f32 and f64, at p = 1/16, q = 4."""
    from stellar_rw_tpu_torch.graph import csr
    from stellar_rw_tpu_torch.ops import cdf_walk

    if chunk:
        monkeypatch.setattr(sampling, "CDF_PAD_LIMIT", 1)
        monkeypatch.setattr(sampling, "CDF_CHUNK", chunk)
    g = (csr.from_adjacency(DYADIC) if name == "dyadic"
         else _graph(name, karate_path, testgraph_path))
    V, R, Lw, S, p, q = g.num_vertices, 2, 5, 3, 0.0625, 4.0
    r = (None if route == "hash" else
         np.random.default_rng(2).integers(0, S, V).astype(np.int32))
    key = prng.prng_key(4)
    spec = engine.walk_spec(g, Lw, R, p, q, "cdf", 16, dtype, V)
    assert spec.cdf_chunk == chunk
    corpus = cdf_walk.cdf_walk_ref(
        sampling.device_put_graph(g, "cpu", cdf=True),
        torch.arange(V, dtype=torch.int32), key, 3, R, Lw, p, q,
        spec.max_degree, spec.cdf_chunk, dtype)
    plan = partition.plan_shards(g, S, r)
    tabs = [shard_walk.shard_tables(g, plan, s, "cpu", cdf=True)
            for s in range(S)]
    W_pad = V + 2                     # gids of a padded layout
    rows = torch.arange(R * V)
    gid = ((rows // V) * W_pad + rows % V).to(torch.int32)
    owner = torch.as_tensor(plan.route).long()
    kw = dict(W_pad=W_pad, W_total=R * W_pad, p=p, q=q,
              cdf_chunk=spec.cdf_chunk, dtype=dtype)
    halo = 0
    for t in range(Lw + 1):
        cur = corpus[:, t] if t else corpus[:, 0]
        prev = corpus[:, t - 1] if t > 1 else corpus[:, 0]
        alive = cur >= 0
        for s, tab in enumerate(tabs):
            m = alive & (owner[cur.clamp_min(0)] == s)
            halo += int((m & (owner[prev.clamp_min(0)] != s)).sum())
            req = torch.stack([cur[m], prev[m], gid[m]], 1).to(torch.int32)
            got = shard_walk.cdf_serve(tab, req, None, 0, key, 3, t, t == 0,
                                       **kw)
            np.testing.assert_array_equal(got.numpy(),
                                          corpus[m, t + 1].numpy())
            # the local form: round r's walkers at gid_base r * W_pad
            for rnd in range(R):
                sl = slice(rnd * V, (rnd + 1) * V)
                loc = shard_walk.cdf_serve(
                    tab, (cur[sl].to(torch.int32), prev[sl].to(torch.int32),
                          None), m[sl].to(torch.int32), rnd * W_pad, key, 3,
                    t, t == 0, **kw)
                want = torch.where(m[sl], corpus[sl, t + 1], -1)
                np.testing.assert_array_equal(loc.numpy(), want.numpy())
    if name == "karate":
        assert halo > 0
    if name == "karate_directed":
        assert bool((corpus == -1).any())


def test_cdf_serve_invalid_requests(karate_path):
    """A request with gid -1 (the exchange's fill) or an invalid flag is
    served -1; the shard's cdf_rows hold its own rows' arcs in vmeta's
    order."""
    g = io.load_edge_list(karate_path, weighted=False)
    plan = partition.plan_shards(g, 2)
    tab = shard_walk.shard_tables(g, plan, 1, "cpu", cdf=True)
    vm = tab.g.vmeta
    rows_owned = plan.rows_per_shard[1]
    E_s = int((g.offsets[1:] - g.offsets[:-1])[rows_owned].sum())
    assert tab.g.cdf_rows.shape == (E_s, 2)
    for i, v in enumerate(rows_owned):
        s0, d = int(vm[i, 0]), int(vm[i, 1])
        np.testing.assert_array_equal(
            tab.g.cdf_rows[s0:s0 + d, 0].numpy(),
            g.cols[g.offsets[v]:g.offsets[v + 1]])
    key = prng.prng_key(1)
    cur = torch.tensor([1, 3, 5], dtype=torch.int32)
    req = torch.stack([cur, cur, torch.tensor([0, -1, 2],
                                              dtype=torch.int32)], 1)
    got = shard_walk.cdf_serve(tab, req, None, 0, key, 0, 0, True, 34, 34,
                               1.0, 1.0, 0)
    assert got[1] == -1 and (got[[0, 2]] >= 0).all()
    valid = torch.tensor([1, 0, 1], dtype=torch.int32)
    got = shard_walk.cdf_serve(tab, (cur, cur, None), valid, 0, key, 0, 0,
                               True, 34, 34, 1.0, 1.0, 0)
    assert got[1] == -1 and (got[[0, 2]] >= 0).all()
    with pytest.raises(ValueError, match="cdf_rows"):
        shard_walk.cdf_serve(shard_walk.shard_tables(g, plan, 1, "cpu"),
                             req, None, 0, key, 0, 0, True, 34, 34, 1.0,
                             1.0, 0)


def _scan32(v):
    """A piece's inclusive Kogge-Stone scan over the lanes (shfl_up by o)."""
    lanes, o = np.arange(32), 1
    while o < 32:
        v = np.where(lanes >= o, v + np.roll(v, o), v).astype(v.dtype)
        o *= 2
    return v


def _lane_sums(b, chunk):
    """The total pass: lane i % 32 adds entry i, chunk after chunk; then the
    xor butterfly."""
    dt, lanes = b.dtype.type, np.arange(32)
    acc = np.zeros(32, b.dtype)
    for c0 in range(0, len(b), chunk):
        for e, x in enumerate(b[c0:c0 + chunk]):
            acc[e % 32] = dt(acc[e % 32] + x)
    off = 16
    while off:
        acc = (acc + acc[lanes ^ off]).astype(b.dtype)
        off //= 2
    return acc[0]


def _warp_pick(b, u, chunked):
    """cdf_pick.cuh's pick (a warp a light request): the chunked form's
    find loop piece by piece, or the padded form's serial sums."""
    dt, d, lanes = b.dtype.type, len(b), np.arange(32)
    if chunked:
        thresh, cum = dt(u * _lane_sums(b, 32)), dt(0)
        for base in range(0, d, 32):
            v = np.zeros(32, b.dtype)
            v[:min(32, d - base)] = b[base:base + 32]
            c = (cum + _scan32(v)).astype(b.dtype)
            hit = np.flatnonzero((base + lanes < d) & (c >= thresh))
            if len(hit):
                return base + int(hit[0])
            cum = c[31]
        return -1
    total = dt(0)
    for x in b:
        total = dt(total + x)
    div, c = (total if total > 0 else dt(1)), dt(0)
    for i, x in enumerate(b):
        c = dt(c + dt(x / div))
        if c >= u:
            return i
    return -1


def _row_weights(tab, row, prev_id, prev_row, first, p, q, dtype):
    """(cols, weigh()'s weights) of a request's row on the shard."""
    dt = np.float64 if dtype == "float64" else np.float32
    vm, g = tab.g.vmeta.numpy(), tab.g
    s, d = int(vm[row, 0]), int(vm[row, 1])
    ent = g.cdf_rows.numpy()[s:s + d]
    col, w = ent[:, 0], ent[:, 1].view(np.float32).astype(dt)
    if first:
        return col, w
    inv_p, inv_q = sampling.bias_quotients(p, q, dtype)
    h = ((col.astype(np.uint64) * np.uint64(HASH)) & np.uint64(0xFFFFFFFF)
         ).astype(np.int64) & int(vm[prev_row, 3])
    member = (g.hash_buckets.numpy()[int(vm[prev_row, 2]) + h]
              == col[:, None]).any(1)
    f = np.where(col == prev_id, dt(inv_p),
                 np.where(member, dt(1), dt(inv_q))).astype(dt)
    return col, (w * f).astype(dt)


HASH = 2654435761


def _bits_weights(tab, row, prev_id, prev_row, p, q, dtype):
    """pick_bits' weights for one request: prev's neighbor set as a bitmap
    of the vertices, set from the keys of prev's bucket rows, then w * f
    with f = 1/p at prev, 1 at a set bit, 1/q elsewhere."""
    dt = np.float64 if dtype == "float64" else np.float32
    vm, g = tab.g.vmeta.numpy(), tab.g
    s, d = int(vm[row, 0]), int(vm[row, 1])
    ent = g.cdf_rows.numpy()[s:s + d]
    cols, w = ent[:, 0], ent[:, 1].view(np.float32).astype(dt)
    base, nb = int(vm[prev_row, 2]), int(vm[prev_row, 3]) + 1
    bm = np.zeros(-(-tab.V // 32), np.uint32)
    for key in g.hash_buckets.numpy()[base:base + nb].reshape(-1):
        if key >= 0:
            bm[key >> 5] |= np.uint32(1) << np.uint32(key & 31)
    inv_p, inv_q = sampling.bias_quotients(p, q, dtype)
    bit = (bm[cols >> 5] >> (cols & 31).astype(np.uint32)) & 1
    f = np.where(cols == prev_id, dt(inv_p),
                 np.where(bit == 1, dt(1), dt(inv_q))).astype(dt)
    return (w * f).astype(dt)


def _cdf_serve_transcribed(tab, fcur, fprev, fgid, valid, segments, key, t,
                           first, W_pad, W_total, p, q, chunked, dtype,
                           min_entries):
    """csrc/shard_walk.cu's CDF serve transcribed: the requests counted
    (with segments, over each bucket's filled prefix, found by the kernel's
    binary search, the fills -1), then each by a warp: -1 for a fill (gid
    < 0), an invalid request or a dead end; else pick over cur's row, a
    second-order chunked step at a row of at least `min_entries` entries
    whose prev has no more bucket rows than the row has entries weighing by
    the bitmap (pick_bits, where the vertices fit BITMAP_WORDS), held equal
    to weigh's weights. Returns (dst, the bitmap steps)."""
    m = fcur.shape[0]
    dst = np.full(m, -2, np.int64)
    order = np.arange(m)
    if segments:
        length, start = m // segments, [0]
        for b in range(segments):
            lo, hi = 0, length
            while lo < hi:
                mid = (lo + hi) // 2
                if fgid[b * length + mid] >= 0:
                    lo = mid + 1
                else:
                    hi = mid
            start.append(start[-1] + lo)
        order = []
        for k in range(start[-1]):      # the k-th request's slot
            b = max(j for j in range(segments) if start[j] <= k)
            order.append(b * length + k - start[b])
        order = np.asarray(order, np.int64)
        fills = np.setdiff1d(np.arange(m), order)
        assert (fgid[fills] < 0).all()
        dst[fills] = -1
    cur_row, prev_row = (x.numpy() for x in shard_walk._rows(tab, fcur,
                                                              fprev))
    gc = fgid.clamp(0, W_total - 1).long()
    step = prng.fold_in(prng.fold_in(key, gc // W_pad), t)
    draw = prng.uniform_f64_at if dtype == "float64" else prng.uniform_at
    u = draw(step, gc % W_pad).numpy()
    vm = tab.g.vmeta.numpy()
    words = shard_walk.bitmap_words(tab.V, int(chunked))
    bits = 0
    for i in order:
        d = int(vm[cur_row[i], 1])
        if int(fgid[i]) < 0 or (valid is not None and not valid[i]) \
                or d <= 0:
            dst[i] = -1
            continue
        col, b = _row_weights(tab, cur_row[i], int(fprev[i]), prev_row[i],
                              first, p, q, dtype)
        if (words and not first and d >= min_entries
                and vm[prev_row[i], 3] < d):
            np.testing.assert_array_equal(b, _bits_weights(
                tab, cur_row[i], int(fprev[i]), prev_row[i], p, q, dtype))
            bits += 1
        dst[i] = col[max(_warp_pick(b, u[i], chunked), 0)]
    assert (dst != -2).all()     # every slot written
    return dst, bits


def _star(leaves, seed=0):
    from stellar_rw_tpu_torch.graph.csr import from_edge_arrays

    rng = np.random.default_rng(seed)
    return from_edge_arrays(
        np.zeros(leaves, np.int64), np.arange(1, leaves + 1),
        rng.random(leaves).astype(np.float32) * 4 + 0.25,
        num_vertices=leaves + 1, symmetrize=True)


@pytest.mark.parametrize("name", ["karate", "star"])
@pytest.mark.parametrize("route", ["hash", "vcut"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_cdf_serve_transcription_matches_ref(name, route, dtype, chunk,
                                             karate_path, monkeypatch):
    """The CDF serve (csrc/shard_walk.cu, transcribed in NumPy with the
    bitmap's least row forced small: 4 entries on karate, 50 on a star of
    120 leaves with random f32 weights) over every superstep of a corpus on
    2 shards: the received form (two buckets, each its requests then
    fills, counted over the buckets' prefixes) and the local form (the
    other walkers invalid). Every slot is written, and dst equals
    cdf_serve_ref bit for bit: f32 and f64, padded and chunked (the bitmap
    weights where prev's bucket rows are few), first order (t = 0) and
    second, hash and vertex cut."""
    from stellar_rw_tpu_torch.ops import cdf_walk

    if chunk:
        monkeypatch.setattr(sampling, "CDF_PAD_LIMIT", 1)
        monkeypatch.setattr(sampling, "CDF_CHUNK", chunk)
    g = (_star(120) if name == "star"
         else io.load_edge_list(karate_path, weighted=False))
    least = 50 if name == "star" else 4
    V, R, Lw, S, p, q = g.num_vertices, 2, 3, 2, 0.0625, 4.0
    r = (None if route == "hash" else
         np.random.default_rng(3).integers(0, S, V).astype(np.int32))
    key = prng.prng_key(6)
    spec = engine.walk_spec(g, Lw, R, p, q, "cdf", 16, dtype, V)
    assert spec.cdf_chunk == chunk
    corpus = cdf_walk.cdf_walk_ref(
        sampling.device_put_graph(g, "cpu", cdf=True),
        torch.arange(V, dtype=torch.int32), key, 0, R, Lw, p, q,
        spec.max_degree, spec.cdf_chunk, dtype)
    plan = partition.plan_shards(g, S, r)
    tabs = [shard_walk.shard_tables(g, plan, s, "cpu", cdf=True)
            for s in range(S)]
    assert all(tab.V == V for tab in tabs)
    gid = torch.arange(R * V, dtype=torch.int32)
    owner = torch.as_tensor(plan.route).long()
    kw = dict(W_pad=V, W_total=R * V, p=p, q=q)
    bits = 0
    for t in range(Lw + 1):
        cur = (corpus[:, t] if t else corpus[:, 0]).contiguous()
        prev = (corpus[:, t - 1] if t > 1 else corpus[:, 0]).contiguous()
        for s, tab in enumerate(tabs):
            m = (cur >= 0) & (owner[cur.clamp_min(0)] == s)
            req = torch.stack([cur[m], prev[m], gid[m]], 1)
            half = req.shape[0] // 2
            C = req.shape[0] - half + 1
            fill = torch.tensor([0, 0, -1], dtype=torch.int32)
            recv = torch.cat([req[:half], fill.repeat(C - half, 1),
                              req[half:], fill.repeat(C - req.shape[0] + half,
                                                      1)])
            for fcur, fprev, fgid, valid, segs in (
                    (recv[:, 0], recv[:, 1], recv[:, 2], None, 2),
                    (cur, prev, gid, m, 0)):
                got, n = _cdf_serve_transcribed(
                    tab, fcur, fprev, fgid, valid, segs, key, t, t == 0,
                    chunked=bool(chunk), dtype=dtype, min_entries=least,
                    **kw)
                want = shard_walk.cdf_serve_ref(
                    tab, fcur, fprev, fgid, valid, key, 0, t, t == 0,
                    cdf_chunk=spec.cdf_chunk, dtype=dtype, **kw)
                np.testing.assert_array_equal(got, want.numpy())
                bits += n
            np.testing.assert_array_equal(got[m.numpy()],
                                          corpus[m, t + 1].numpy())
    assert (bits > 0) == bool(chunk)


def test_kept_heavy_row_table():
    """chip_cdf_serve_parts.heavy_rows, the heavy-row table the kept
    redesigns take: the rows of at least the degree, numbered by degree,
    largest first (ties by row), at most KEPT_MAX_HEAVY; the others -1."""
    import chip_cdf_serve_parts as parts

    deg = np.array([5, 9, 2, 9, 12, 40, 7])
    table, n = parts.heavy_rows(deg, 8)
    assert n == 4
    np.testing.assert_array_equal(table, [-1, 2, -1, 3, 1, 0, -1])
    table, n = parts.heavy_rows(np.full(3000, 8), 8)
    assert n == parts.KEPT_MAX_HEAVY
    np.testing.assert_array_equal(table[:n], np.arange(n))
    assert (table[n:] == -1).all()


def test_serve_local_form_and_validity(karate_path):
    """The local form (gid = gid_base + i, a local flag per walker) serves
    only the flagged walkers; -1 elsewhere and for gid -1 requests."""
    g = io.load_edge_list(karate_path, weighted=False)
    plan = partition.plan_shards(g, 1)
    tab = shard_walk.shard_tables(g, plan, 0, "cpu")
    V = g.num_vertices
    keys = walk_step.trial_keys_ref(prng.prng_key(1), 0, 1, 3, 64)
    corpus = torch.as_tensor(engine.random_walks(
        g, walk_length=3, num_walks=1, p=0.5, q=2.0, seed=1, device="cpu"))
    cur = corpus[:, 1].to(torch.int32)
    prev = corpus[:, 0].to(torch.int32)
    valid = (torch.arange(V) % 2).to(torch.int32)
    dst = torch.full((V,), -7, dtype=torch.int32)
    got, none = shard_walk.serve(tab, keys, 1, False, V, V, V, 0.5, 2.0,
                                 local=(cur, prev, valid), dst=dst)
    assert got is dst and none is None
    want = torch.where(valid != 0, corpus[:, 2], -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    req = torch.stack([cur, prev, torch.full_like(cur, -1)], 1)
    _, reply = shard_walk.serve(tab, keys, 1, False, V, V, V, 0.5, 2.0,
                                recv=req)
    assert (reply == -1).all()


def _serve_transcribed(tab, keys, t, first, W_pad, W_total, n_stream, p, q,
                       cur, prev, flags, gid_base, recv):
    """csrc/shard_walk.cu's serve: a grid of SERVE_THREADS-thread blocks
    over n + D * C slots; slot k < n is walker k (stepped where its flag is
    set, else -1), slot n + e entry e of the received buffer (-1 for a
    fill). Each request is stepped as serve_ref steps it. Returns (dst,
    reply; -7 where nothing was written), each slot written once."""
    n, m = cur.shape[0], recv.shape[0] * recv.shape[1]
    flat = recv.reshape(-1, 3)
    dst = np.full(n, -7, np.int64)
    reply = np.full(m, -7, np.int64)
    B = shard_walk.SERVE_THREADS
    stepped, entries = [], []
    for k in range(-(-(n + m) // B) * B):
        if k < n:
            assert dst[k] == -7
            dst[k] = -1
            if flags[k] != 0:
                stepped.append(k)
        elif k - n < m:
            assert reply[k - n] == -7
            entries.append(k - n)
    kw = dict(keys=keys, t=t, first=first, W_pad=W_pad, W_total=W_total,
              n_stream=n_stream, p=p, q=q)
    i = torch.as_tensor(stepped, dtype=torch.int64)
    dst[stepped] = shard_walk.serve_ref(
        tab, cur[i], prev[i], (gid_base + i).to(torch.int32), None, **kw)
    r = flat[torch.as_tensor(entries, dtype=torch.int64)]
    reply[entries] = shard_walk.serve_ref(tab, r[:, 0], r[:, 1], r[:, 2],
                                          None, **kw)
    return dst, reply


@pytest.mark.parametrize("name", ["karate", "karate_directed"])
@pytest.mark.parametrize("C", [40, 300])
def test_serve_kernel_index_map_matches_serve_plain(name, C, karate_path,
                                                    testgraph_path):
    """The serve kernel's threads over one superstep's slots (rank 0's
    walkers with their local flags, then a received buffer of 2 buckets:
    shard 0's requests from two senders, each bucket's prefix then fills
    of gid -1) step every flagged walker and every request once, write -1
    at every other walker and every fill, and equal serve_plain, which is
    serve_ref on each half; dead ends among the steps on directed
    karate."""
    g = _graph(name, karate_path, testgraph_path)
    V, R, Lw, S, p, q = g.num_vertices, 4, 4, 2, 0.5, 2.0
    corpus = torch.as_tensor(engine.random_walks(
        g, walk_length=Lw, num_walks=R, p=p, q=q, seed=2, device="cpu"))
    _, max_rounds = sampling.plan_sampler("rejection", p, q)
    keys = walk_step.trial_keys_ref(prng.prng_key(2), 0, R, Lw,
                                    4 * max_rounds)
    plan = partition.plan_shards(g, S)
    tab = shard_walk.shard_tables(g, plan, 0, "cpu")
    owner = torch.as_tensor(plan.route).long()
    t, n = 1, R * V
    cur = corpus[:, t].to(torch.int32)
    prev = corpus[:, t - 1].to(torch.int32)
    alive = cur >= 0
    mine = alive & (owner[cur.clamp_min(0)] == 0)
    # rank 0 walks the first half of the rows, rank 1 the rest
    half = n // 2
    flags = mine[:half].to(torch.int32)
    rows = mine.nonzero().squeeze(1)
    gid = rows.to(torch.int32)
    reqs = torch.stack([cur[rows], prev[rows], gid], 1)
    recv = torch.zeros((2, C, 3), dtype=torch.int32)
    recv[..., 2] = -1
    for b, part in enumerate((reqs[:len(rows) // 3],
                              reqs[len(rows) // 3:])):
        part = part[:C]
        recv[b, :part.shape[0]] = part
    kw = dict(W_pad=V, W_total=n, n_stream=V, p=p, q=q)
    dst, reply = _serve_transcribed(
        tab, keys, t, False, cur=cur[:half], prev=prev[:half], flags=flags,
        gid_base=0, recv=recv, **kw)
    pdst, preply = shard_walk.serve_plain(
        tab, keys, t, False, local=(cur[:half], prev[:half], flags),
        recv=recv, dst=torch.full((half,), -7, dtype=torch.int32), **kw)
    np.testing.assert_array_equal(dst, pdst.numpy())
    np.testing.assert_array_equal(reply, preply.numpy())
    assert (reply != -7).all() and (dst != -7).all()
    assert (dst[~mine[:half].numpy()] == -1).all()
    np.testing.assert_array_equal(dst[mine[:half].numpy()],
                                  corpus[:half, t + 1][mine[:half]].numpy())
    served = recv.reshape(-1, 3)[:, 2] >= 0
    np.testing.assert_array_equal(reply[served.numpy()],
                                  corpus[recv.reshape(-1, 3)[served, 2]
                                         .long(), t + 1].numpy())
    dead = (reply == -1).sum() - (~served).sum() + (
        dst[mine[:half].numpy()] == -1).sum()
    assert (dead > 0) == (name == "karate_directed")
    assert flags.any() and served.any() and (~served).any()


@pytest.mark.parametrize("R,L,T", [(2, 6, 64), (3, 0, 1), (2, 5, 33)])
def test_key_table_design_matches_ref(R, L, T):
    """csrc/walk.cu's trial_keys_kernel: a warp a (round, step) derives the
    round key and the step key once, lane l makes trials l, l+32, ...:
    every key of the table once, equal to trial_keys_ref."""
    k = prng.prng_key(7)
    want = walk_step.trial_keys_ref(k, 5, R, L, T).long() & prng.MASK32
    got = torch.full((R, L + 1, T, 2), -1, dtype=torch.int64)
    for warp in range(R * (L + 1)):
        r, t = divmod(warp, L + 1)
        sk = prng.fold_in(prng.fold_in(k, 5 + r), t)
        for lane in range(32):
            for j in range(lane, T, 32):
                assert (got[r, t, j] == -1).all()
                got[r, t, j] = prng.fold_in(sk, j)
    assert torch.equal(got, want)
    assert "for (int j = lane; j < T; j += 32)" in WALK_SOURCE
    # the table releases K11's serve (or the emit), programmatic
    # dependents that wait for the grid before them, and the emit releases
    # the serve after it; the walk kernel and the CDF serve are ordinary
    # launches
    assert "griddepcontrol.launch_dependents" in WALK_SOURCE
    assert "griddepcontrol.wait" not in WALK_SOURCE
    assert SOURCE.count("griddepcontrol.wait") == 2
    assert SOURCE.count("griddepcontrol.launch_dependents") == 1
    assert SOURCE.count("srw::launch_dependent(") == 2
    assert "cudaLaunchCooperativeKernel" not in SOURCE
    assert "grid.sync" not in SOURCE


MIRRORED = {"kEmitThreads": "EMIT_THREADS", "kMaxDevices": "MAX_DEVICES",
            "kServeThreads": "SERVE_THREADS",
            "kCdfServeThreads": "CDF_SERVE_THREADS",
            "kBitmapWords": "BITMAP_WORDS",
            "kBitmapMinEntries": "BITMAP_MIN_ENTRIES",
            "kTileCount": "TILE_COUNT", "kTilePrefix": "TILE_PREFIX",
            "kMaxEpoch": "MAX_EPOCH",
            "kRouteHash": "ROUTE_HASH", "kRoutePacked": "ROUTE_PACKED",
            "kRouteDense": "ROUTE_DENSE"}


@pytest.mark.parametrize("name", list(MIRRORED))
def test_constants_mirror_the_source(name):
    value = getattr(shard_walk, MIRRORED[name])
    assert SOURCE.count(f"constexpr int {name} = ") == 1
    assert f"constexpr int {name} = {value};" in SOURCE


@pytest.mark.parametrize("kernel", [shard_walk.EMIT_KERNEL,
                                    shard_walk.SERVE_KERNEL,
                                    shard_walk.CDF_SERVE_KERNEL])
def test_entry_points_take_the_bound_arguments(kernel):
    """Each C entry point's parameter count is the argtypes' count."""
    m = re.search(rf'extern "C" int {kernel.symbol}\((.*?)\)\s*\{{', SOURCE,
                  re.S)
    assert m, kernel.symbol
    assert len(m.group(1).split(",")) == len(kernel.argtypes)


def test_wrappers_raise_without_a_build(karate_path, monkeypatch, tmp_path):
    """Tensors off the CPU go to the kernels or raise: with no compiler the
    build fails loudly and nothing falls back to the plain versions."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    kernels = (shard_walk.EMIT_KERNEL, shard_walk.SERVE_KERNEL,
               shard_walk.CDF_SERVE_KERNEL)
    for k in kernels:
        monkeypatch.setattr(k, "_fn", None)
    g = io.load_edge_list(karate_path, weighted=False)
    tab = shard_walk.shard_tables(g, partition.plan_shards(g, 2), 0, "cpu",
                                  cdf=True)
    x = torch.zeros(8, dtype=torch.int32, device="meta")
    keys = torch.zeros((1, 2, 4, 2), dtype=torch.int32, device="meta")
    before = [k.launches for k in kernels]
    with pytest.raises(_build.KernelBuildError):
        shard_walk.emit(tab, x, x, x, x, x, 1, 2, 0, 4)
    with pytest.raises(_build.KernelBuildError):
        shard_walk.serve(tab, keys, 1, False, 8, 8, 8, 1.0, 1.0,
                         local=(x, x, x))
    with pytest.raises(_build.KernelBuildError):
        shard_walk.serve(tab, keys, 1, False, 8, 8, 8, 1.0, 1.0,
                         recv=x[:6].reshape(1, 2, 3))
    with pytest.raises(_build.KernelBuildError):
        shard_walk.cdf_serve(tab, (x, x, None), x, 0, prng.prng_key(0), 0,
                             1, False, 8, 8, 1.0, 1.0, 0)
    assert [k.launches for k in kernels] == before


def test_launch_form_edits_apply_once():
    """chip_compare.py's launch forms edit the sources they time: the walk
    kernel made the table's programmatic dependent (it then waits for the
    table first), K11's serve made an ordinary launch; each piece once."""
    import chip_compare
    import chip_smoke

    walk = chip_smoke.edited(WALK_SOURCE, chip_compare.WALK_AS_DEPENDENT)
    assert "srw::launch_dependent(\n        walk_kernel," in walk
    assert walk.count("griddepcontrol.wait") == 1
    serve = chip_smoke.edited(SOURCE, chip_compare.SERVE_ORDINARY)
    assert "shard_serve_kernel<<<" in serve
    assert "launch_dependent(\n        shard_serve_kernel" not in serve
