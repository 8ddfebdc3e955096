"""K11: the two halves of a superstep of the sharded walk engine.

The JAX package's superstep (stellar_rw_tpu/parallel/distributed.py ->
shard_fn, :121-453, lowered by XLA) samples the walkers whose current
vertex this shard owns in place, and sends every other live walker's
request (cur, prev, gid) to its owner through a capacity-bounded bucketed
all_to_all, in rounds until none is left. parallel/distributed.py runs the
collectives; the work on either side of them is here:

  * `emit` builds one exchange round's buckets (`exchange`, :345-378):
    each pending walker's destination device dest_shard * L + gid % L, its
    rank in its bucket in the stable order by destination, the [D, C, 3]
    send buffer of (cur, prev, gid) with the slots [D, C] they came from
    (fill (0, 0, -1) and slot n), the sent walkers' pending flags cleared,
    and the counts (pending before the round, pending after). The first
    round of a superstep takes the alive flags and decides which walkers
    are local (their vertex is this shard's) and which are pending. Its
    kernel is one ordinary launch in a single pass (a decoupled look-back
    over the tiles' counts; `EmitWork` keeps what a launch leaves for the
    next);
  * `serve` runs one step for a superstep's requests on this shard's
    tables in one launch (`sample_req`, :204-323): the walkers the emit
    flagged local and the received buffer's requests; the rows of cur and
    prev (hash arithmetic, the packed VCut route, the halo bucket rows, or
    glob2loc), then the first-order alias draw or the rejection trials, the
    uniforms addressed by the request's global walker id, so the step is
    the single-device engine's wherever it is served. -1 for a dead end or
    a fill; its plain version is `serve_plain` (serve_ref on each half);
  * `cdf_serve` runs the same step by the exact inverse CDF (the CDF branch
    of `sample_req`, :262-286): the padded or chunked pick of
    ops/sampling.py over the shard's `cdf_rows`, u element w of
    uniform(fold_in(fold_in(seed_key, round_offset + r), t), (n_stream,))
    in the accumulation type for the request's round r and lane w, the
    bias by prev's neighbor set on this shard (an owned or a halo bucket
    row). Its kernel is K7's row scan (csrc/cdf_pick.cuh) applied to one
    request, by persistent warps that take the requests from a counter
    (two ints at 0 between launches, `work`; a received buffer's fills
    skipped, `segments`); a second-order step at a row of
    BITMAP_MIN_ENTRIES entries or more reads prev's neighbor set from a
    bitmap of the graph's vertices in shared memory, where they fit
    BITMAP_WORDS words.

For CUDA tensors each wrapper launches its kernel of csrc/shard_walk.cu;
for CPU tensors it runs its plain version (`emit_ref`, `serve_plain`,
`cdf_serve_ref`), with which it agrees bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import prng, sampling, walk_step
from ._build import Kernel, ptr, require_cuda, stream
from .sampling import HASH_MULT, DeviceGraph

# csrc/shard_walk.cu's constants (tests/test_torch_shard_walk.py holds them)
EMIT_THREADS = 512        # walkers a tile of the emit
MAX_DEVICES = 256         # devices D the emit's shared tables hold
SERVE_THREADS = 128
CDF_SERVE_THREADS = 256     # 8 warps a block
TILE_COUNT, TILE_PREFIX = 1, 2   # an emit tile status's flags
MAX_EPOCH = 1073741823      # 2^30 - 1: an emit launch's epochs 1 .. this
BITMAP_WORDS = 2048         # a warp's bitmap of the vertices: V <= 65,536
BITMAP_MIN_ENTRIES = 1024   # rows whose steps read the bitmap
ROUTE_HASH, ROUTE_PACKED, ROUTE_DENSE = 0, 1, 2

_P, _I = ctypes.c_void_p, ctypes.c_int
EMIT_KERNEL = Kernel(
    "shard_walk.cu", "srw_shard_emit_launch",
    [_P] * 6 + [_I] * 9 + [_P] * 5 + [ctypes.c_uint] + [_P])
SERVE_KERNEL = Kernel(
    "shard_walk.cu", "srw_shard_serve_launch",
    [_P] * 3 + [_I] * 2 + [_P] * 2 + [_I] + [_P] * 2 + [_I] * 4 + [_P]
    + [_I] + [_P] * 5 + [_I] * 8 + [ctypes.c_float] * 3 + [_I] + [_P])
CDF_SERVE_KERNEL = Kernel(
    "shard_walk.cu", "srw_shard_cdf_serve_launch",
    [_P] * 3 + [_I] + [_P] + [_I] * 2 + [_P] + [_P] + [_I] * 4 + [_P]
    + [_I] + [_P] * 4 + [_I] * 2 + [_P] + [ctypes.c_uint] * 3 + [_I] * 4
    + [ctypes.c_double] * 2 + [_I] * 2 + [_P])


class ShardTables(NamedTuple):
    """One graph shard's walk tables on a device, with its routing.

    g: the shard's packed tables (rows owned first, then halo; cols hold
    global ids); route: i32[V], the packed VCut route (ROUTE_PACKED) or
    the dense route (ROUTE_DENSE), None for hash; halo_buckets: i32[nb, 8]
    (4 keys, 4 rows) and halo_nb, for the compact modes; glob2loc: i32[V],
    ROUTE_DENSE only. shard: this shard's index of S; V: the graph's
    vertices (0: unknown)."""

    g: DeviceGraph
    route_mode: int
    route: torch.Tensor | None
    halo_buckets: torch.Tensor | None
    halo_nb: int
    glob2loc: torch.Tensor | None
    S: int
    shard: int
    V: int = 0

    @property
    def rbits(self) -> int:
        return max(1, (self.S - 1).bit_length())

    @property
    def device(self) -> torch.device:
        return self.g.device


def _dest_shard(tab: ShardTables, cur: torch.Tensor) -> torch.Tensor:
    if tab.route_mode == ROUTE_HASH:
        return cur % tab.S
    e = tab.route[cur.clamp_min(0).long()]
    if tab.route_mode == ROUTE_PACKED:
        return e & ((1 << tab.rbits) - 1)
    return e


def emit_ref(tab: ShardTables, cur, prev, pending, alive, local, L: int,
             D: int, gid_base: int, C: int):
    """Plain version of the emit: the transcription of the JAX package's
    bucket build by a stable argsort. pending (and, with alive, local) are
    int32 [n] updated in place. Returns (send i32 [D, C, 3], slot i32
    [D, C], counters i32 [2]: pending before the round, left after)."""
    n = cur.shape[0]
    dev = cur.device
    if alive is not None:
        a = alive != 0
        ds = torch.where(a, _dest_shard(tab, cur),
                         torch.full_like(cur, tab.shard))
        loc = a & (ds == tab.shard)
        local.copy_(loc.to(torch.int32))
        pending.copy_((a & ~loc).to(torch.int32))
    p = pending != 0
    gid = gid_base + torch.arange(n, dtype=torch.int64, device=dev)
    dest = torch.where(p, _dest_shard(tab, cur).long() * L + gid % L,
                       torch.full_like(gid, D))
    order = torch.sort(dest, stable=True).indices
    sd = dest[order]
    counts = torch.bincount(dest, minlength=D + 1)[:D]
    bstart = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - bstart[sd.clamp_max(D - 1)]
    sent = (sd < D) & (rank < C)
    send = torch.zeros((D, C, 3), dtype=torch.int32, device=dev)
    send[..., 2] = -1
    slot = torch.full((D, C), n, dtype=torch.int32, device=dev)
    idx = order[sent]
    d_s, r_s = sd[sent], rank[sent]
    send[d_s, r_s] = torch.stack([cur[idx], prev[idx],
                                  gid[idx].to(torch.int32)], 1)
    slot[d_s, r_s] = idx.to(torch.int32)
    pending[idx] = 0
    counters = torch.stack([p.sum(), (pending != 0).sum()]).to(torch.int32)
    return send, slot, counters


class EmitWork:
    """The emit's buffers for n walkers, D devices and capacity C, reused
    launch after launch (the launches one after another on a stream):

      send i32 [D, C, 3], slot i32 [D, C]: filled (0, 0, -1) and n here; a
          launch re-fills only the entries the last one filled and it does
          not;
      status i64 [tiles * D]: each tile's status word a column (the
          launch's epoch, a flag, a count), never cleared;
      totals i32 [D]: the last launch's count a bucket;
      counters i32 [3]: pending before the round, left after, and the
          counter the tiles are taken from (0 between launches);
      epoch: the last launch's (0: none yet)."""

    def __init__(self, n: int, D: int, C: int, device):
        tiles = max(1, -(-n // EMIT_THREADS))
        i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        self.n = n
        self.send = i32(D, C, 3)
        self.send[..., 2] = -1
        self.slot = torch.full((D, C), n, dtype=torch.int32, device=device)
        self.status = torch.zeros(tiles * D, dtype=torch.int64,
                                  device=device)
        self.totals = i32(D)
        self.counters = i32(3)
        self.epoch = 0

    def tensors(self) -> list:
        return [self.send, self.slot, self.status, self.totals,
                self.counters]


def emit_work(n: int, D: int, C: int, device) -> EmitWork:
    return EmitWork(n, D, C, device)


def emit(tab: ShardTables, cur, prev, pending, alive, local, L: int, D: int,
         gid_base: int, C: int, work: EmitWork | None = None):
    """One exchange round's buckets (see the module note). cur, prev: i32
    [n]; pending: i32 [n], read and updated; alive (the superstep's first
    round) i32 [n] or None; local: i32 [n], written when alive is given.
    CPU tensors run emit_ref; CUDA tensors launch the emit kernel into
    `work` (made here when None; one work serves the launches of one n, D
    and C on one stream). Returns (send, slot, counters) as emit_ref
    does."""
    if cur.device.type == "cpu":
        return emit_ref(tab, cur, prev, pending, alive, local, L, D,
                        gid_base, C)
    EMIT_KERNEL.fn()
    n = cur.shape[0]
    if not 1 <= D <= MAX_DEVICES or C < 1:
        raise ValueError(f"emit: D={D} outside 1..{MAX_DEVICES} or C={C}")
    if gid_base + n >= 2**31 or D * C * 3 >= 2**31:
        raise ValueError("emit: walker ids or buffers beyond i32")
    work = emit_work(n, D, C, cur.device) if work is None else work
    if work.send.shape != (D, C, 3) or work.n != n:
        raise ValueError("emit: work buffers of another shape")
    first = alive is not None
    tensors = [cur, prev, pending, *work.tensors()]
    if first:
        tensors += [alive, local]
    if tab.route is not None:
        tensors.append(tab.route)
    for t in tensors:
        if t.dtype != torch.int32 and t is not work.status:
            raise ValueError("emit: int32 tensors expected")
    require_cuda("emit", *tensors)
    null = ctypes.c_void_p(0)
    work.epoch = work.epoch % MAX_EPOCH + 1
    EMIT_KERNEL.launch(
        ptr(cur), ptr(prev), ptr(alive) if first else null, ptr(pending),
        ptr(local) if first else null,
        ptr(tab.route) if tab.route is not None else null, tab.route_mode,
        tab.S, tab.rbits, tab.shard, L, D, gid_base, n, C, ptr(work.send),
        ptr(work.slot), ptr(work.status), ptr(work.totals),
        ptr(work.counters), work.epoch, stream(cur.device))
    return work.send, work.slot, work.counters[:2]


def _rows(tab: ShardTables, fcur, fprev):
    """(cur's row, prev's row) on this shard, as the JAX package resolves
    them (distributed.py:215-240)."""
    if tab.route_mode == ROUTE_DENSE:
        g2l = tab.glob2loc
        return (g2l[fcur.long()].clamp_min(0),
                g2l[fprev.long()].clamp_min(0))
    pv = fprev.clamp_min(0)
    if tab.route_mode == ROUTE_HASH:
        cur_row = fcur.clamp_min(0) // tab.S
        p_owned = pv % tab.S == tab.shard
        p_row = pv // tab.S
    else:
        cur_row = tab.route[fcur.clamp_min(0).long()] >> tab.rbits
        pr = tab.route[pv.long()]
        p_owned = (pr & ((1 << tab.rbits) - 1)) == tab.shard
        p_row = pr >> tab.rbits
    hh = ((pv.to(torch.int64) * int(HASH_MULT)) & prng.MASK32) \
        & (tab.halo_nb - 1)
    row8 = tab.halo_buckets[hh]
    hit = row8[:, :4] == pv[:, None]
    hrow = torch.where(hit, row8[:, 4:], -1).max(dim=1).values
    prev_row = torch.where(p_owned, p_row, hrow).clamp_min(0)
    return cur_row, prev_row


def serve_ref(tab: ShardTables, fcur, fprev, fgid, valid, keys, t: int,
              first: bool, W_pad: int, W_total: int, n_stream: int,
              p: float, q: float, counts: dict | None = None) -> torch.Tensor:
    """Plain version of the serve kernel over m requests (i32 [m] each;
    valid bool [m] or None): walk_step's trial arithmetic on the shard's
    rows. Returns dst i32 [m]. `counts`, when given, receives what the
    requests needed: `served` (requests stepped), `dense_trials`,
    `lane_trials` and `acc_draws` (as walk_step.walk_corpus_ref counts
    them; a first-order step is one dense trial with no u_acc) and
    `max_trials`, the most trials one request ran."""
    g = tab.g
    m = fcur.shape[0]
    if m == 0:
        return torch.zeros(0, dtype=torch.int32, device=fcur.device)
    ok = fgid >= 0
    if valid is not None:
        ok = ok & valid
    gc = fgid.clamp(0, W_total - 1).long()
    rnd, lane = gc // W_pad, gc % W_pad
    Wd = walk_step.draw_width(n_stream)
    cur_row, prev_row = _rows(tab, fcur, fprev)
    cm = g.vmeta[cur_row.long()]
    can = ok & (cm[:, 1] > 0)
    kw = keys.to(torch.int64) & prng.MASK32
    tally = walk_step._Tally(kw.shape[2], m, fcur.device)
    if first:
        k0 = kw[rnd, 0, 0]
        dst = walk_step._alias_draw(g, cm[:, 0], cm[:, 1],
                                    prng.uniform_at(k0, lane),
                                    prng.uniform_at(k0, lane + Wd))
        tally.trials[0] = int(can.sum())
    else:
        pm = g.vmeta[prev_row.long()]
        inv_p, inv_q, max_f, mode = walk_step.bias_constants(p, q)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32,
                                     device=fcur.device)
        consts = (f32(inv_p), f32(inv_q), f32(max_f), mode)
        dst = walk_step._second_order(g, kw[:, t], rnd, lane, Wd, cm, pm,
                                      fprev, can, consts, tally)
    if counts is not None:
        counts.update(
            served=int(can.sum()),
            dense_trials=sum(tally.trials[:walk_step.DENSE_TRIALS]),
            lane_trials=sum(tally.trials[walk_step.DENSE_TRIALS:]),
            acc_draws=tally.acc_draws,
            max_trials=(int(bool(can.any())) if first
                        else int(tally.step.max())))
    return torch.where(can, dst, -1).to(torch.int32)


def serve_plain(tab: ShardTables, keys, t: int, first: bool, W_pad: int,
                W_total: int, n_stream: int, p: float, q: float, *,
                local=None, recv=None, gid_base: int = 0, dst=None,
                reply=None):
    """Plain version of the serve kernel (the arguments of `serve`, on any
    device): serve_ref on the walkers by their local flags, then on the
    received buffer. Returns (dst, reply)."""
    kw = dict(keys=keys, t=t, first=first, W_pad=W_pad, W_total=W_total,
              n_stream=n_stream, p=p, q=q)
    if local is not None:
        cur, prev, flags = local
        gid = gid_base + torch.arange(cur.shape[0], dtype=torch.int32,
                                      device=cur.device)
        got = serve_ref(tab, cur, prev, gid, flags != 0, **kw)
        dst = got if dst is None else dst.copy_(got)
    if recv is not None:
        r = recv.reshape(-1, 3)
        got = serve_ref(tab, r[:, 0], r[:, 1], r[:, 2], None, **kw)
        reply = got if reply is None else reply.copy_(got)
    return dst, reply


def serve(tab: ShardTables, keys, t: int, first: bool, W_pad: int,
          W_total: int, n_stream: int, p: float, q: float, *, local=None,
          recv=None, gid_base: int = 0, dst=None, reply=None):
    """One step for a superstep's requests on this shard, in one launch.
    local: (cur, prev, flags), i32 [n] each: walker i steps from (cur[i],
    prev[i]) as walker gid_base + i where flags[i] (the emit's local flags)
    is not 0, into dst[i] (i32 [n], made when None), -1 elsewhere. recv:
    the received buffer, i32 [D, C, 3] or [m, 3] of requests (cur, prev,
    gid), into reply i32 [D * C] or [m] (made when None), -1 for a fill
    (gid < 0). -1 for a dead end. keys: the trial-key table of the rounds
    (walk_step.trial_keys). CPU tensors run serve_plain; CUDA tensors
    launch the serve kernel. Returns (dst, reply), None for a half not
    given."""
    args = (tab, keys, t, first, W_pad, W_total, n_stream, p, q)
    kw = dict(local=local, recv=recv, gid_base=gid_base, dst=dst,
              reply=reply)
    some = local[0] if local is not None else recv
    if some is None:
        return dst, reply
    if some.device.type == "cpu":
        return serve_plain(*args, **kw)
    SERVE_KERNEL.fn()
    g = tab.g
    R, L1, T = keys.shape[0], keys.shape[1], keys.shape[2]
    if keys.shape[3] != 2 or not 0 <= t < L1:
        raise ValueError(f"serve: key table {tuple(keys.shape)}, step {t}")
    if W_total >= 2**31 or R * W_pad < W_total:
        raise ValueError("serve: walker ids beyond i32 or the key table")
    null = ctypes.c_void_p(0)
    tensors = [g.vmeta, g.alias_packed, g.hash_buckets, keys]
    tensors += [getattr(tab, f) for f in ("route", "halo_buckets",
                                          "glob2loc")
                if getattr(tab, f) is not None]
    lp, n = [null] * 4, 0
    if local is not None:
        cur, prev, flags = local
        n = cur.shape[0]
        if dst is None:
            dst = torch.empty_like(cur)
        if any(x.shape != (n,) for x in (prev, flags, dst)):
            raise ValueError("serve: local walkers of other shapes")
        tensors += [cur, prev, flags, dst]
        lp = [ptr(cur), ptr(prev), ptr(flags), ptr(dst)]
    rp, m = [null] * 2, 0
    if recv is not None:
        m = recv.numel() // 3
        if recv.shape[-1] != 3 or not recv.is_contiguous():
            raise ValueError(f"serve: received buffer {tuple(recv.shape)}")
        if reply is None:
            reply = torch.empty(m, dtype=torch.int32, device=recv.device)
        if reply.shape != (m,):
            raise ValueError("serve: reply of another shape")
        tensors += [recv, reply]
        rp = [ptr(recv), ptr(reply)]
    for x in tensors:
        if x.dtype != torch.int32:
            raise ValueError("serve: int32 tensors expected")
    require_cuda("serve", *tensors)
    opt = lambda x: ptr(x) if x is not None else null
    inv_p, inv_q, max_f, mode = walk_step.bias_constants(p, q)
    SERVE_KERNEL.launch(
        *lp[:3], n, gid_base, lp[3], rp[0], m, rp[1], opt(tab.route),
        tab.route_mode, tab.S, tab.rbits, tab.shard, opt(tab.halo_buckets),
        max(tab.halo_nb, 1), opt(tab.glob2loc), ptr(g.vmeta),
        ptr(g.alias_packed), ptr(g.hash_buckets), ptr(keys), t, int(first),
        W_pad, W_total, walk_step.draw_width(n_stream), L1, T, g.num_edges,
        float(inv_p), float(inv_q), float(max_f), mode,
        stream(some.device))
    return dst, reply


def _fields(req):
    """(cur, prev, gid or None, stride) of a request form: an i32 [m, 3]
    tensor (stride 3) or a tuple of i32 [m] tensors."""
    if torch.is_tensor(req):
        return req[:, 0], req[:, 1], req[:, 2], 3
    fcur, fprev, fgid = req
    return fcur, fprev, fgid, 1


def _launch_args(name: str, tab: ShardTables, req, valid, gid_base: int,
                 tables: list, out):
    """(out, the leading arguments of the CDF serve's entry point: the
    requests, validity, out and the routing), after checking every tensor
    the launch reads (the requests, the routing, vmeta and `tables`) is
    int32 on the card. out: i32 [m], made here when None."""
    fcur, fprev, fgid, stride = _fields(req)
    m = fcur.shape[0]
    base = req if torch.is_tensor(req) else None
    tensors = [tab.g.vmeta, *tables]
    tensors += [base] if base is not None else [fcur, fprev]
    if fgid is not None and base is None:
        tensors.append(fgid)
    for field in ("route", "halo_buckets", "glob2loc"):
        if getattr(tab, field) is not None:
            tensors.append(getattr(tab, field))
    if valid is not None:
        tensors.append(valid)
    out = (torch.empty(m, dtype=torch.int32, device=fcur.device)
           if out is None else out)
    tensors.append(out)
    for x in tensors:
        if x.dtype != torch.int32:
            raise ValueError(f"{name}: int32 tensors expected")
    require_cuda(name, *tensors)
    if out.shape != (m,):
        raise ValueError(f"{name}: out of another shape")
    null = ctypes.c_void_p(0)
    if base is not None:
        at = base.data_ptr()
        pcur, pprev, pgid = (ctypes.c_void_p(at + 4 * k) for k in range(3))
    else:
        pcur, pprev = ptr(fcur), ptr(fprev)
        pgid = ptr(fgid) if fgid is not None else null
    opt = lambda x: ptr(x) if x is not None else null
    return out, (pcur, pprev, pgid, stride, opt(valid), gid_base, m,
                 ptr(out), opt(tab.route), tab.route_mode, tab.S, tab.rbits,
                 tab.shard, opt(tab.halo_buckets), max(tab.halo_nb, 1),
                 opt(tab.glob2loc))


def cdf_serve_ref(tab: ShardTables, fcur, fprev, fgid, valid, key,
                  round_offset: int, t: int, first: bool, W_pad: int,
                  W_total: int, p: float, q: float, cdf_chunk: int,
                  dtype: str = "float32") -> torch.Tensor:
    """Plain version of the CDF serve kernel over m requests (i32 [m]
    each; valid bool [m] or None): the exact inverse CDF of ops/sampling.py
    on the shard's rows, u for the request's round r = gid // W_pad and
    lane w = gid % W_pad from the seed key `key` (cdf_chunk 0: the padded
    form, else the chunked form). Returns dst i32 [m], -1 for a dead end
    or an invalid request."""
    g = tab.g
    m = fcur.shape[0]
    dev = fcur.device
    dst = torch.full((m,), -1, dtype=torch.int32, device=dev)
    if m == 0:
        return dst
    ok = fgid >= 0
    if valid is not None:
        ok = ok & valid
    gc = fgid.clamp(0, W_total - 1).long()
    cur_row, prev_row = _rows(tab, fcur, fprev)
    deg = g.vmeta[cur_row.long(), 1]
    idx = (ok & (deg > 0)).nonzero().squeeze(1)
    if not idx.numel():
        return dst
    rnd, lane = gc[idx] // W_pad, gc[idx] % W_pad
    step = prng.fold_in(prng.fold_in(key.to(dev), rnd + round_offset), t)
    draw = prng.uniform_f64_at if dtype == "float64" else prng.uniform_at
    u = draw(step, lane)
    cr = cur_row[idx]
    if cdf_chunk:
        picked = (sampling.cdf_sample_first_order_chunked(
            g, cr, u, cdf_chunk, dtype) if first else
            sampling.cdf_sample_second_order_chunked(
                g, cr, prev_row[idx], fprev[idx], u, p, q, cdf_chunk, dtype))
    else:
        md = int(deg[idx].max())
        picked = (sampling.cdf_sample_first_order(g, cr, u, md, dtype)
                  if first else sampling.cdf_sample_second_order(
                      g, cr, prev_row[idx], fprev[idx], u, p, q, md, dtype))
    dst[idx] = picked.to(torch.int32)
    return dst


def cdf_serve(tab: ShardTables, req, valid, gid_base: int, key,
              round_offset: int, t: int, first: bool, W_pad: int,
              W_total: int, p: float, q: float, cdf_chunk: int,
              dtype: str = "float32", out: torch.Tensor | None = None,
              work: torch.Tensor | None = None,
              segments: int = 0) -> torch.Tensor:
    """One exact-CDF step for requests on this shard (the request forms
    of `serve`). key: the seed key (i32 [2], on the host); round_offset:
    the corpus's first round; cdf_chunk 0 the padded form, else the
    chunked form; dtype the accumulation type. tab.g needs its cdf_rows
    (shard_tables(..., cdf=True)). CPU tensors run cdf_serve_ref, CUDA
    tensors the CDF serve kernel, into `out` (i32 [m], made here when
    None); the kernel with the counters `work` (i32 [2] at 0, as each launch leaves
    them; made here when None). segments > 0: the requests are that many
    buckets of equal length, each its requests and then fills (gid < 0),
    as the exchange receives them: the kernel counts only each bucket's
    filled prefix. Returns dst i32 [m]."""
    g = tab.g
    if g.cdf_rows is None:
        raise ValueError("cdf_serve: the shard has no cdf_rows "
                         "(shard_tables(..., cdf=True))")
    if dtype not in ("float32", "float64"):
        raise ValueError(f"cdf_serve: dtype {dtype!r}")
    fcur, fprev, fgid, _ = _fields(req)
    m = fcur.shape[0]
    if segments < 0 or segments > MAX_DEVICES or (
            segments and (fgid is None or m % segments)):
        raise ValueError(f"cdf_serve: {m} requests in {segments} buckets")
    if fcur.device.type == "cpu":
        if fgid is None:
            fgid = gid_base + torch.arange(m, dtype=torch.int32)
        dst = cdf_serve_ref(tab, fcur, fprev, fgid,
                            None if valid is None else valid != 0, key,
                            round_offset, t, first, W_pad, W_total, p, q,
                            cdf_chunk, dtype)
        return dst if out is None else out.copy_(dst)
    CDF_SERVE_KERNEL.fn()
    rounds = -(-W_total // W_pad)
    if W_total >= 2**31 or round_offset < 0 \
            or round_offset + rounds > 2**32:
        raise ValueError("cdf_serve: walker ids beyond i32 or rounds "
                         "beyond 32 bits")
    if work is None:
        work = torch.zeros(2, dtype=torch.int32, device=fcur.device)
    if work.shape != (2,):
        raise ValueError("cdf_serve: work of another shape")
    out, launch_args = _launch_args("cdf_serve", tab, req, valid, gid_base,
                                    [g.cdf_rows, g.hash_buckets, work], out)
    inv_p, inv_q = sampling.bias_quotients(p, q, dtype)
    k0, k1 = (int(v) & prng.MASK32 for v in key.tolist())
    CDF_SERVE_KERNEL.launch(
        *launch_args, ptr(g.vmeta), ptr(g.cdf_rows), ptr(g.hash_buckets),
        bitmap_words(tab.V, cdf_chunk), segments, ptr(work), k0, k1,
        round_offset, t, int(first), W_pad, W_total, inv_p, inv_q,
        int(cdf_chunk > 0), int(dtype == "float64"), stream(fcur.device))
    return out


def bitmap_words(V: int, cdf_chunk: int) -> int:
    """Words of a warp's bitmap of the vertices for the CDF serve: the
    chunked form's, where V vertices fit BITMAP_WORDS; else 0 (prev's
    bucket rows are read)."""
    words = -(-V // 32)
    return words if cdf_chunk > 0 and 0 < words <= BITMAP_WORDS else 0


def shard_tables(graph, plan, s: int, device,
                 cdf: bool = False) -> ShardTables:
    """Shard s of a ShardPlan (graph/partition.py), built alone on the host
    and uploaded: the rank's share of the graph (its host memory is the
    graph plus this one shard). cdf=True adds the CDF serve's `cdf_rows`
    (col, weight bits) of the shard's arcs, in the order its vmeta row
    starts index."""
    from ..graph import partition as part
    from .sampling import PackingUnavailable

    sh = part.build_shard(graph, plan, s, build_packed=True)
    if "vmeta" not in sh:
        raise PackingUnavailable(f"shard {s} has no packed tables")
    put = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                    dtype=torch.int32).to(device)
    g = DeviceGraph(
        offsets=torch.as_tensor(sh["offsets"]).to(device),
        alias_packed=put(sh["alias_packed"]),
        hash_buckets=put(sh["hash_buckets"]), vmeta=put(sh["vmeta"]))
    if cdf:
        E_s = int(sh["offsets"][-1])
        g = g._replace(cdf_rows=put(np.stack(
            [sh["cols"][:E_s], sh["weights"][:E_s].view(np.int32)], 1)))
    if plan.is_hash:
        mode, route = ROUTE_HASH, None
    elif plan.route_packed is not None:
        mode, route = ROUTE_PACKED, put(plan.route_packed)
    else:
        mode, route = ROUTE_DENSE, put(plan.route)
    compact = mode != ROUTE_DENSE
    return ShardTables(
        g=g, route_mode=mode, route=route,
        halo_buckets=put(sh["halo_buckets"]) if compact else None,
        halo_nb=int(sh["halo_nb"]) if compact else 0,
        glob2loc=None if compact else put(sh["glob2loc"]),
        S=plan.num_shards, shard=s, V=len(plan.route))
