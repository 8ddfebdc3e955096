"""K11's two halves (stellar_rw_tpu_torch/ops/shard_walk.py,
csrc/shard_walk.cu) on the CPU, where their plain versions run:

  * emit_ref against a NumPy transcription of the JAX package's bucket build
    (stellar_rw_tpu/parallel/distributed.py:345-378: argsort(stable=True),
    counts, bucket starts, ranks, the sent mask, put) on random
    destinations, capacities 1 to n, lanes 1 and 2, a superstep's first
    round and a later one;
  * the emit kernel's design (tiles of EMIT_THREADS walkers, a warp's
    peers, per-warp counts, the tiles' offsets scanned) transcribed in
    NumPy against emit_ref;
  * serve_ref (and the wrapper's two request forms) over every superstep's
    requests of a corpus, each served by the shard that owns its vertex,
    against the single-device corpus's next column, under hash and
    vertex-cut shards (halo prev rows among them) on karate, directed
    karate and tests/data/testgraph.txt (dead ends);
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


def _emit_kernel_transcription(dest, C, D, tile=shard_walk.EMIT_THREADS):
    """csrc/shard_walk.cu's emit for given destinations (D: nothing sent):
    (1) a tile's count for each destination, (2) the tiles' counts scanned,
    (3) rank = tile offset + the counts of the warps before + the lanes
    before among the warp's peers. Returns (slot [D, C], sent mask)."""
    n = len(dest)
    ntiles = -(-n // tile)
    pad = np.full(ntiles * tile, D)
    pad[:n] = dest
    tiles = pad.reshape(ntiles, tile // 32, 32)          # tile, warp, lane
    wcnt = np.stack([(tiles == d).sum(axis=2) for d in range(D)], -1)
    tile_counts = wcnt.sum(axis=1)                       # [tiles, D]
    offs = np.cumsum(tile_counts, axis=0) - tile_counts  # exclusive scan
    slot = np.full((D, C), n)
    sent = np.zeros(n, bool)
    for i in range(n):
        d = dest[i]
        if d == D:
            continue
        tl, w, lane = i // tile, (i % tile) // 32, i % 32
        peers_before = int((tiles[tl, w, :lane] == d).sum())
        rank = offs[tl, d] + wcnt[tl, :w, d].sum() + peers_before
        if rank < C:
            slot[d, rank] = i
            sent[i] = True
    return slot, sent


@pytest.mark.parametrize("n,D,C", [(1500, 2, 600), (1500, 8, 50),
                                   (512, 3, 512), (37, 5, 1), (0, 2, 4)])
def test_emit_kernel_design_matches_emit_ref(n, D, C):
    """The kernel's tiles, warps and scans give emit_ref's slots and sent
    mask: several tiles, destinations crowded and sparse, capacity 1."""
    rng = np.random.default_rng(n + D)
    route = rng.integers(0, D, 64)
    cur = rng.integers(0, 64, n)
    pending = rng.random(n) < 0.7
    tab = _route_tables(D, D - 1, route)
    t = lambda x: torch.as_tensor(x, dtype=torch.int32)
    pend = t(pending)
    _, slot, _ = shard_walk.emit_ref(tab, t(cur), t(cur), pend, None, None,
                                     1, D, 0, C)
    dest = np.where(pending, route[cur], D)
    k_slot, k_sent = _emit_kernel_transcription(dest, C, D)
    np.testing.assert_array_equal(slot.numpy(), k_slot)
    np.testing.assert_array_equal(pend.numpy(), pending & ~k_sent)


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
            got = shard_walk.serve(tab, req, None, 0, keys, t, t == 0, W_pad,
                                   R * W_pad, V, p, q)
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
    """The local form (gid = gid_base + i, a valid flag per walker) serves
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
    got = shard_walk.serve(tab, (cur, prev, None), valid, 0, keys, 1, False,
                           V, V, V, 0.5, 2.0)
    want = torch.where(valid != 0, corpus[:, 2], -1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    req = torch.stack([cur, prev, torch.full_like(cur, -1)], 1)
    assert (shard_walk.serve(tab, req, None, 0, keys, 1, False, V, V, V,
                             0.5, 2.0) == -1).all()


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
    # the table releases K11's serve, a programmatic dependent that waits
    # for it; the walk kernel is an ordinary launch
    assert "griddepcontrol.launch_dependents" in WALK_SOURCE
    assert "griddepcontrol.wait" not in WALK_SOURCE
    assert SOURCE.count("griddepcontrol.wait") == 1


MIRRORED = {"kEmitThreads": "EMIT_THREADS", "kMaxDevices": "MAX_DEVICES",
            "kServeThreads": "SERVE_THREADS",
            "kCdfServeThreads": "CDF_SERVE_THREADS",
            "kBitmapWords": "BITMAP_WORDS",
            "kBitmapMinEntries": "BITMAP_MIN_ENTRIES",
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
        shard_walk.serve(tab, (x, x, None), x, 0, keys, 1, False, 8, 8, 8,
                         1.0, 1.0)
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
