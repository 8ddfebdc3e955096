// K11: the two halves of a superstep of the sharded walk engine (sm_90a).
//
// Replaces the superstep that XLA lowers in the JAX package:
// stellar_rw_tpu/parallel/distributed.py::distributed_walk_corpus ->
// shard_fn (:121-453). There a superstep samples the walkers whose current
// vertex this shard owns in place, and sends every other live walker's
// request (cur, prev, gid) to the owner through a capacity-bounded
// bucketed all_to_all, in rounds until none is left. Here the collectives
// are torch.distributed's (parallel/distributed.py), and the two pieces of
// work around them are these kernels:
//
//   shard_emit   the bucket build of one exchange round (`exchange`,
//                :345-378: the destination device of each walker, its
//                stable order by destination (argsort(stable=True)),
//                the counts, each request's rank in its bucket, the
//                [D, C] send buffer and the sent mask);
//   shard_serve  `sample_req` (:204-323): the rows of a request's cur and
//                prev on this shard, then one step of the walk: the
//                first-order alias draw, or the rejection trials of
//                walk_trial.cuh, whose uniforms are addressed by the
//                request's global walker id (round gid / W_pad, lane
//                gid % W_pad), so a request draws the same bits wherever
//                it is served;
//   shard_cdf_serve  the same step by the exact inverse CDF (the CDF
//                branch of `sample_req`, :262-286): cdf_pick.cuh's row
//                scan, which cdf_walk.cu's whole-walk kernel (K7)
//                compiles too, over the shard's cdf_rows, u addressed by
//                the request's global walker id as above.
//
// shard_emit. What bounds it: bytes (it reads cur, prev and the pending
// flag of n walkers and writes at most D * C requests) and, far more, the
// latency of its one pass at the shapes of a walk: a grid of a few dozen
// tiles that each load, count, scan and write once. Its design: one
// ordinary launch (a programmatic dependent of the grid before it, and it
// releases the serve after it) of a block a tile of kEmitThreads walkers, a
// walker a thread, in a single pass with no grid barrier:
//   * a block takes its tile from a counter (counters[2]), so that every
//     tile it waits on below is already running;
//   * each walker's column: its destination device, or none (a local
//     walker, or one not pending); a warp's walkers of one column found by
//     __match_any_sync and counted by its lowest lane into a per-warp table;
//   * the tile publishes a status word for each of its D columns at once:
//     the launch's epoch, a flag (its own count, or the count of the tiles
//     up to it) and the count. A warp a column looks back over the
//     tiles before, 32 at a time, and sums counts until it meets a tile
//     with its prefix; then it publishes the tile's own prefix. A status of
//     another epoch is not yet written in this launch, so no launch clears
//     the statuses;
//   * each request's rank in its bucket: the tiles' prefix, plus the warps
//     before it in the tile, plus its rank among its warp's peers. That is
//     its position in the stable order by destination, less the bucket's
//     start, exactly as the JAX package ranks it. A rank below C is sent
//     (its fields written, its pending flag cleared);
//   * the last tile taken sees the totals: it writes the fill (0, 0, -1)
//     and slot n into each bucket's entries that the last launch into this
//     work filled and this one does not ([total, last total), the buffers
//     filled once when made), the totals for the next launch, counters[0]
//     (requests pending before the round), counters[1] (left after) and
//     counters[2] = 0.
// The first round of a superstep also decides each live walker's place:
// `local` (its vertex is this shard's) or pending.
//
// shard_serve. What bounds it: the longest chain of trials one request
// needs (each trial two or three threefry blocks around two dependent
// 16-byte row reads, as the walk kernel): at phase 22's superstep its
// slowest warp takes most of the launch. So a superstep's two serves go
// into one launch, which lets the local walkers' tail and the received
// requests' tail run side by side. A thread a slot: the n walkers first
// (those the emit flagged local step, the others get -1), then every
// entry of the received buffer (a fill gets -1). Serving the requests
// alone, compacted, bought nothing: every warp of the grid is resident at
// once, and the slowest is as slow either way. The rows: cur's owned row
// by arithmetic (hash: cur / S) or from the packed route's high bits,
// prev's as owned or through the 8-wide halo bucket row (one 32-byte read:
// 4 keys, 4 rows), or both through glob2loc where the partitioner kept
// it. prev's vmeta row is read again every step (a carried row would
// index another shard).
// Launched as a programmatic dependent: it waits for the grid before it
// (the key table, the emit, or the exchange's copy) before its first
// access. The grid is sized from the slots, so no count goes to the host.
//
// shard_cdf_serve. What bounds it: the row entries weighed (deg(cur) a
// request, each in the total pass and again in the find pass up to the
// crossing, with a 16-byte bucket row of prev for a second-order weight),
// as K7. At a superstep those entries are almost all a few heavy rows'
// (a walker stands on a vertex in proportion to its degree, so the
// entries go as the sum of deg^2): at walk_10k's, one hub row takes 6,797
// requests of 27,877 and 2.67e8 of the 2.82e8 entries, and their prevs
// are hubs too, whose bucket rows miss L1: the bucket reads are a third of
// the time. A warp a request, as K7 is one warp a walker: a hub's row of
// tens of thousands of entries goes by deg/32 turns of coalesced reads. A
// second-order step of the chunked form at a row of at least
// kBitmapMinEntries entries reads prev's neighbor set from the warp's
// bitmap of the vertices in shared memory instead (cdf_pick.cuh's
// pick_bits, where V fits kBitmapWords words and prev has no more bucket
// rows than cur has entries): a bit an entry where the bucket read was a
// 16-byte row. It reads no key table (its one draw a step is made from the
// seed key), so it is an ordinary launch, of persistent warps that take
// the requests from a counter: a warp that drew a hub's row holds no other
// warp's block slot (a block leaves the SM only with its slowest warp, so
// a block of warps a request each would); a received buffer is counted
// over each bucket's filled prefix alone. Bit for bit its plain version
// on any input: the sums run in K7's order, each operation rounded on its
// own. Three forms that compacted the requests on the card, or staged a
// heavy row in shared memory for a group of its requests, measured slower
// and stay outside the package (chip_cdf_serve_tile.cu,
// chip_cdf_serve_staged.cu, chip_cdf_serve_compact.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "cdf_pick.cuh"
#include "threefry.cuh"
#include "walk_trial.cuh"

namespace {

constexpr int kEmitThreads = 512;                 // walkers a tile
constexpr int kEmitWarps = kEmitThreads / 32;
constexpr int kMaxDevices = 256;                  // D the emit takes
constexpr int kServeThreads = 128;
constexpr int kCdfServeThreads = 256;        // 8 warps a block
constexpr int kBitmapWords = 2048;    // a warp's bitmap: V <= 65,536
constexpr int kBitmapMinEntries = 1024;   // rows that read the bitmap
// a tile's status word: (epoch << 2 | flag) << 32 | count, where the flag
// says whether the count is the tile's own or the tiles' up to it
constexpr int kTileCount = 1;
constexpr int kTilePrefix = 2;
constexpr int kMaxEpoch = 1073741823;   // 2^30 - 1: epochs 1 .. kMaxEpoch

// route modes: hash (v % S), packed VCut (shard | row << rbits), dense
// route (shard only; rows through glob2loc)
constexpr int kRouteHash = 0;
constexpr int kRoutePacked = 1;
constexpr int kRouteDense = 2;

struct Route {
  const int* route;   // V entries (packed or dense); null for hash
  int mode;
  int S;              // graph shards
  int rbits;          // shard bits of a packed entry
};

__device__ __forceinline__ int dest_shard(const Route& rt, int v) {
  if (rt.mode == kRouteHash) return v % rt.S;
  const int e = rt.route[v];
  return rt.mode == kRoutePacked ? (e & ((1 << rt.rbits) - 1)) : e;
}

// The emit's arguments (see srw_shard_emit_launch).
struct Emit {
  const int* cur;
  const int* prev;
  const int* alive;     // the superstep's first round; else null
  int* pending;
  int* local;
  Route rt;
  int my, L, D, gid_base, n, C;
  int* send;            // [D, C, 3]
  int* slot;            // [D, C]
  unsigned long long* status;   // [tiles, D]
  int* totals;          // [D] the last launch's totals
  int* counters;        // [3]
  unsigned epoch;
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned epoch, int flag,
                                             int count) {
  const unsigned long long v =
      (static_cast<unsigned long long>(epoch << 2 | flag) << 32) |
      static_cast<unsigned>(count);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The count of column k in the tiles before `tile`: a warp reads the
// statuses of 32 tiles at a time (lane l the tile `base - l`), waits until
// each is of this launch, and sums the counts up to the nearest tile that
// holds its prefix (tile -1 holds 0).
__device__ __forceinline__ int look_back(const Emit& a, int tile, int k,
                                         int lane) {
  int sum = 0;
  for (int base = tile - 1;; base -= 32) {
    const int j = base - lane;
    unsigned long long s = 0;
    bool ready;
    do {
      if (j >= 0) s = load_status(a.status + (size_t)j * a.D + k);
      ready = j < 0 || static_cast<unsigned>(s >> 34) == a.epoch;
    } while (!__all_sync(0xffffffffu, ready));
    const bool prefix =
        j < 0 || static_cast<int>((s >> 32) & 3u) == kTilePrefix;
    const unsigned found = __ballot_sync(0xffffffffu, prefix);
    const int upto = found ? __ffs(found) - 1 : 31;
    int x = (j >= 0 && lane <= upto) ? static_cast<int>(s & 0xffffffffu) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    sum += x;
    if (found) return sum;
  }
}

__global__ void __launch_bounds__(kEmitThreads)
shard_emit_kernel(const Emit a) {
  __shared__ int wcnt[kEmitWarps * kMaxDevices];   // [warp, column]
  __shared__ int own[kMaxDevices];       // the tile's count a column
  __shared__ int before[kMaxDevices];    // the tiles' before it
  __shared__ int tile_at;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = a.D;
  if (threadIdx.x == 0) tile_at = atomicAdd(a.counters + 2, 1);
  for (int k = threadIdx.x; k < kEmitWarps * cols; k += kEmitThreads)
    wcnt[k] = 0;
  __syncthreads();
  const int tile = tile_at;
  const int i = tile * kEmitThreads + threadIdx.x;

  // the walker's column: its destination device, D none. Its fields are
  // read here, ahead of the barriers, for the write below
  int c = cols, fcur = 0, fprev = 0;
  if (i < a.n) {
    fcur = a.cur[i];
    fprev = a.prev[i];
    if (a.alive != nullptr) {
      const bool al = a.alive[i] != 0;
      const int ds = al ? dest_shard(a.rt, fcur) : 0;
      const bool loc = al && ds == a.my;
      a.local[i] = loc;
      if (al && !loc) c = ds * a.L + (a.gid_base + i) % a.L;
    } else if (a.pending[i] != 0) {
      c = dest_shard(a.rt, fcur) * a.L + (a.gid_base + i) % a.L;
    }
  }
  const unsigned peers = __match_any_sync(0xffffffffu, c);
  if (c < cols && lane == __ffs(peers) - 1)
    wcnt[warp * cols + c] = __popc(peers);
  __syncthreads();

  // the tile's count a column, published at once; wcnt becomes each warp's
  // offset in the tile
  for (int k = threadIdx.x; k < cols; k += kEmitThreads) {
    int s = 0;
    for (int w = 0; w < kEmitWarps; ++w) {
      const int x = wcnt[w * cols + k];
      wcnt[w * cols + k] = s;
      s += x;
    }
    own[k] = s;
    if (tile == 0) before[k] = 0;
    store_status(a.status + (size_t)tile * cols + k, a.epoch,
                 tile == 0 ? kTilePrefix : kTileCount, s);
  }
  if (tile > 0) {
    __syncthreads();
    for (int k = warp; k < cols; k += kEmitWarps) {
      const int sum = look_back(a, tile, k, lane);
      if (lane == 0) {
        before[k] = sum;
        store_status(a.status + (size_t)tile * cols + k, a.epoch,
                     kTilePrefix, sum + own[k]);
      }
    }
  }
  __syncthreads();

  // each request's rank in its bucket; the first C are sent
  if (c < cols) {
    const int at = before[c] + wcnt[warp * cols + c] +
                   __popc(peers & ((1u << lane) - 1u));
    if (at < a.C) {
      const size_t e = (size_t)c * a.C + at;
      a.send[3 * e] = fcur;
      a.send[3 * e + 1] = fprev;
      a.send[3 * e + 2] = a.gid_base + i;
      a.slot[e] = i;
    }
    a.pending[i] = at >= a.C;
  } else if (a.alive != nullptr && i < a.n) {
    a.pending[i] = 0;
  }

  // the last tile taken: the fills past this launch's totals, the counts
  if (tile == static_cast<int>(gridDim.x) - 1) {
    __syncthreads();
    int* high = wcnt;   // each bucket's filled prefix in the last launch
    for (int d = threadIdx.x; d < a.D; d += kEmitThreads) {
      high[d] = min(a.totals[d], a.C);
      a.totals[d] = before[d] + own[d];
    }
    __syncthreads();
    for (int d = 0; d < a.D; ++d) {
      const int lo = min(before[d] + own[d], a.C);
      for (int r = lo + threadIdx.x; r < high[d]; r += kEmitThreads) {
        const size_t e = (size_t)d * a.C + r;
        a.send[3 * e] = 0;
        a.send[3 * e + 1] = 0;
        a.send[3 * e + 2] = -1;
        a.slot[e] = a.n;
      }
    }
    if (threadIdx.x == 0) {
      int pend = 0, left = 0;
      for (int d = 0; d < a.D; ++d) {
        const int total = before[d] + own[d];
        pend += total;
        left += max(total - a.C, 0);
      }
      a.counters[0] = pend;
      a.counters[1] = left;
      a.counters[2] = 0;
    }
  }
}

// The rows of a request's cur and prev on this shard (`sample_req`,
// :215-240): cur's owned row by arithmetic (hash: cur / S) or from the
// packed route's high bits, prev's as owned or through the 8-wide halo
// bucket row (one 32-byte read: 4 keys, 4 rows), or both through glob2loc
// where the partitioner kept it (the dense route). A row not found is
// row 0, as the JAX package clamps it. Returns (cur's row, prev's row).
__device__ __forceinline__ int2 request_rows(const Route& rt, int my,
                                             const int4* __restrict__ halo,
                                             int halo_nb,
                                             const int* __restrict__ glob2loc,
                                             int fcur, int fprev) {
  int cur_row, prev_row;
  if (rt.mode == kRouteDense) {
    cur_row = max(glob2loc[fcur], 0);
    prev_row = max(glob2loc[fprev], 0);
  } else {
    const int cv = max(fcur, 0), pv = max(fprev, 0);
    bool p_owned;
    int p_row;
    if (rt.mode == kRouteHash) {
      cur_row = cv / rt.S;
      p_owned = pv % rt.S == my;
      p_row = pv / rt.S;
    } else {
      cur_row = rt.route[cv] >> rt.rbits;
      const int pr = rt.route[pv];
      p_owned = (pr & ((1 << rt.rbits) - 1)) == my;
      p_row = pr >> rt.rbits;
    }
    int hrow = -1;
    if (!p_owned) {
      // the halo bucket row: keys k0..k3, rows v0..v3
      const int hh = (int)((uint32_t)pv * 2654435761u) & (halo_nb - 1);
      const int4 k4 = halo[2 * hh], v4 = halo[2 * hh + 1];
      if (k4.x == pv) hrow = max(hrow, v4.x);
      if (k4.y == pv) hrow = max(hrow, v4.y);
      if (k4.z == pv) hrow = max(hrow, v4.z);
      if (k4.w == pv) hrow = max(hrow, v4.w);
    }
    prev_row = max(p_owned ? p_row : hrow, 0);
  }
  return make_int2(cur_row, prev_row);
}

// The serve's arguments (see srw_shard_serve_launch).
struct Serve {
  const int* cur;       // [n] the walkers' fields
  const int* prev;
  const int* local;     // [n] the emit's local flags
  int n, gid_base;
  int* dst;             // [n] a walker's result
  const int* recv;      // [m, 3] received
  int m;
  int* reply;           // [m]
  Route rt;
  int my;
  const int4* halo;
  int halo_nb;
  const int* glob2loc;
  const int4* vmeta;
  const int4* alias_packed;
  const int4* buckets;
  const uint2* keys;
  int t, first, W_pad, W_total, Wd, L1, T, E;
  float inv_p, inv_q, max_f;
  int mode;
};

// One step of the request (cur, prev, gid): -1 for gid < 0 or a dead end.
__device__ __forceinline__ int serve_one(const Serve& a, int fcur, int fprev,
                                         int g) {
  if (g < 0) return -1;
  const int gc = min(g, a.W_total - 1);
  const int r = gc / a.W_pad;
  const uint32_t w = (uint32_t)(gc - r * a.W_pad);
  const int2 rows = request_rows(a.rt, a.my, a.halo, a.halo_nb, a.glob2loc,
                                 fcur, fprev);
  const int4 cm = a.vmeta[rows.x];
  if (cm.y <= 0) return -1;
  const uint2* kt = a.keys + ((size_t)r * a.L1 + a.t) * a.T;
  if (a.first)
    return srw::first_order(a.alias_packed, cm, a.E, kt[0], w, a.Wd);
  const int4 pm = a.vmeta[rows.y];
  return srw::second_order(a.alias_packed, a.buckets, kt, a.T, w, a.Wd, cm,
                           pm, fprev, a.E, a.inv_p, a.inv_q, a.max_f, a.mode);
}

// A thread a slot: slot k < n is walker k, which steps if the emit flagged
// it local (else -1), slot n + e is entry e of the received buffer.
__global__ void __launch_bounds__(kServeThreads)
shard_serve_kernel(const Serve a) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int k = blockIdx.x * kServeThreads + threadIdx.x;
  if (k < a.n) {
    a.dst[k] = a.local[k] != 0
                   ? serve_one(a, a.cur[k], a.prev[k], a.gid_base + k)
                   : -1;
  } else if (k - a.n < a.m) {
    const int* f = a.recv + 3 * (size_t)(k - a.n);
    a.reply[k - a.n] = serve_one(a, f[0], f[1], f[2]);
  }
}

// The CDF serve's arguments (the launch's, one struct for its four
// instantiations).
struct CdfServe {
  const int* cur;
  const int* prev;
  const int* gid;      // null: gid_base + i
  int stride;          // elements between a request's fields
  const int* valid;    // null: every request with gid >= 0
  int gid_base, m;
  int* dst;
  Route rt;
  int my;
  const int4* halo;
  int halo_nb;
  const int* glob2loc;
  const int4* vmeta;
  const int2* rows;    // cdf_rows: (col, weight bits) in vmeta's arc order
  const int4* buckets;
  int words;           // a warp's bitmap of the vertices (0: none)
  int segments;        // > 0: m / segments requests a bucket, prefix filled
  int* next;           // [2] the next request, the warps out: 0 between
  uint32_t k0, k1, round_offset;
  int t, first, W_pad, W_total;
};

// One request by the calling warp: its rows, its u (element w of
// uniform(fold_in(fold_in(seed_key, round_offset + r), t), (n_stream,)) in
// T, r = gid / W_pad, w = gid % W_pad, the step key made here as
// cdf_walk_kernel makes it), then cdf_pick.cuh's pick over cur's row; a
// second-order step weighs by prev's neighbor set on this shard (an owned
// or a halo bucket row), read from the warp's bitmap bm (`words`, set from
// prev's bucket rows) at a chunked row of kBitmapMinEntries entries or
// more. Every branch is the warp's own, so the lanes of a warp stay
// together.
template <typename T, bool kChunked>
__device__ __forceinline__ void cdf_serve_one(const CdfServe& a, int i,
                                              int lane, unsigned* bm, T inv_p,
                                              T inv_q) {
  const size_t at = (size_t)i * a.stride;
  const int g = a.gid != nullptr ? a.gid[at] : a.gid_base + i;
  int out = -1;
  if (g >= 0 && (a.valid == nullptr || a.valid[i] != 0)) {
    const int gc = min(g, a.W_total - 1);
    const int r = gc / a.W_pad;
    const uint32_t w = (uint32_t)(gc - r * a.W_pad);
    const int fprev = a.prev[at];
    const int2 rw = request_rows(a.rt, a.my, a.halo, a.halo_nb, a.glob2loc,
                                 a.cur[at], fprev);
    const int4 cm = a.vmeta[rw.x];
    if (cm.y > 0) {
      const uint2 rk =
          srw::threefry(a.k0, a.k1, 0u, a.round_offset + (uint32_t)r);
      const T u = Ops<T>::draw(
          srw::threefry(rk.x, rk.y, 0u, static_cast<uint32_t>(a.t)), w);
      int j;
      if (a.first) {
        const Prev none{0, 0, 0};
        j = pick<T, kChunked, false>(a.rows, cm.x, cm.y, u, none, a.buckets,
                                     inv_p, inv_q, lane);
      } else {
        const int4 pm = a.vmeta[rw.y];
        const Prev pv{fprev, pm.z, pm.w};
        if (kChunked && a.words > 0 && cm.y >= kBitmapMinEntries &&
            pv.bucket_mask < cm.y) {
          for (int k = lane; k < a.words; k += 32) bm[k] = 0u;
          __syncwarp();
          mark_neighbors(pv, a.buckets, bm, lane);
          j = pick_bits<T>(a.rows, cm.x, cm.y, u, fprev, bm, inv_p, inv_q,
                           lane);
        } else {
          j = pick<T, kChunked, true>(a.rows, cm.x, cm.y, u, pv, a.buckets,
                                      inv_p, inv_q, lane);
        }
      }
      out = a.rows[cm.x + max(j, 0)].x;
    }
  }
  if (lane == 0) a.dst[i] = out;
}

// Persistent warps, as many as the card holds at once (at most one a
// request): each takes the next request from the counter next[0] until
// none is left, so a warp that drew a hub's row holds no other warp's
// block slot. A received buffer (segments buckets, each its requests and
// then fills of gid -1) is counted over its requests only: each bucket's
// filled prefix is found by a binary search, the fills written -1 by a
// pass of their own. The last warp out sets the counters back to 0
// (next[1] counts the warps out).
template <typename T, bool kChunked>
__global__ void __launch_bounds__(kCdfServeThreads)
shard_cdf_serve_kernel(const CdfServe a, T inv_p, T inv_q) {
  extern __shared__ unsigned bits[];
  __shared__ int seg_start[kMaxDevices + 1];
  const int lane = threadIdx.x & 31;
  unsigned* bm = bits + (threadIdx.x >> 5) * a.words;
  int n = a.m;
  const int len = a.segments > 0 ? a.m / a.segments : 0;
  if (a.segments > 0) {
    for (int b = threadIdx.x; b < a.segments; b += kCdfServeThreads) {
      int lo = 0, hi = len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a.gid[(size_t)(b * len + mid) * a.stride] >= 0)
          lo = mid + 1;
        else
          hi = mid;
      }
      seg_start[b + 1] = lo;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      seg_start[0] = 0;
      for (int b = 0; b < a.segments; ++b) seg_start[b + 1] += seg_start[b];
    }
    __syncthreads();
    n = seg_start[a.segments];
    for (int i = blockIdx.x * kCdfServeThreads + threadIdx.x; i < a.m;
         i += gridDim.x * kCdfServeThreads) {
      const int b = i / len;
      if (i - b * len >= seg_start[b + 1] - seg_start[b]) a.dst[i] = -1;
    }
  }
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(a.next, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n) break;
    int i = k;
    if (len > 0) {   // the k-th request: its bucket, the last starting <= k
      int lo = 0, hi = a.segments;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (seg_start[mid] <= k)
          lo = mid;
        else
          hi = mid;
      }
      i = lo * len + (k - seg_start[lo]);
    }
    cdf_serve_one<T, kChunked>(a, i, lane, bm, inv_p, inv_q);
  }
  const int warps = gridDim.x * (kCdfServeThreads / 32);
  if (lane == 0 && atomicAdd(a.next + 1, 1) == warps - 1) {
    atomicExch(a.next, 0);
    atomicExch(a.next + 1, 0);
  }
}

template <typename T, bool kChunked>
cudaError_t launch_cdf_serve(const CdfServe& a, double inv_p, double inv_q,
                             cudaStream_t stream) {
  auto kernel = shard_cdf_serve_kernel<T, kChunked>;
  const size_t smem =
      kChunked ? (size_t)(kCdfServeThreads / 32) * a.words * sizeof(int) : 0;
  static int sms = 0, resident = 0;
  static size_t sized = 0;   // the shared memory `resident` is for
  if (sms == 0 || sized != smem) {
    int dev = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kCdfServeThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
    sized = smem;
  }
  const long long want =
      (static_cast<long long>(a.m) + kCdfServeThreads / 32 - 1) /
      (kCdfServeThreads / 32);
  const int blocks = static_cast<int>(want < resident ? want : resident);
  kernel<<<blocks, kCdfServeThreads, smem, stream>>>(
      a, static_cast<T>(inv_p), static_cast<T>(inv_q));
  return cudaGetLastError();
}

}  // namespace

// One exchange round's bucket build over n walkers (see the note at the
// top). alive: the superstep's first round (the local and pending flags
// are written from it), else null (pending is read). send [D, C, 3] and
// slot [D, C], filled (0, 0, -1) and n when made; status [max(ceil(n /
// 512), 1) * D] of 64 bits; totals [D], 0 when made; counters [3], 0 when
// made: (pending before, left after, 0). The work's launches come one
// after another with n, D, C unchanged, each with an epoch in 1 ..
// kMaxEpoch other than the last one's. Returns the CUDA error of the
// launch.
extern "C" int srw_shard_emit_launch(
    const int* cur, const int* prev, const int* alive, int* pending,
    int* local, const int* route, int route_mode, int S, int rbits, int my,
    int L, int D, int gid_base, int n, int C, int* send, int* slot,
    unsigned long long* status, int* totals, int* counters, unsigned epoch,
    void* stream) {
  if (D < 1 || D > kMaxDevices || C < 1 || n < 0 || epoch < 1 ||
      epoch > static_cast<unsigned>(kMaxEpoch))
    return (int)cudaErrorInvalidValue;
  const int tiles = n > 0 ? (n + kEmitThreads - 1) / kEmitThreads : 1;
  const Emit a{cur, prev, alive, pending, local,
               Route{route, route_mode, S, rbits}, my, L, D, gid_base, n, C,
               send, slot, status, totals, counters, epoch};
  const cudaError_t err =
      srw::launch_dependent(shard_emit_kernel, dim3(tiles),
                            dim3(kEmitThreads), (cudaStream_t)stream, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One step for a superstep's requests in one launch: the n walkers (cur,
// prev of walker i, gid gid_base + i; null: none) into dst[i], -1 where
// local[i] is 0, and the m received requests recv [m, 3] (null: none) into
// reply [m], -1 for a fill (gid < 0) or a dead end.
extern "C" int srw_shard_serve_launch(
    const int* cur, const int* prev, const int* local, int n, int gid_base,
    int* dst, const int* recv, int m, int* reply, const int* route,
    int route_mode, int S, int rbits, int my, const int* halo, int halo_nb,
    const int* glob2loc, const int* vmeta, const int* alias_packed,
    const int* buckets, const unsigned* keys, int t, int first, int W_pad,
    int W_total, int Wd, int L1, int T, int E, float inv_p, float inv_q,
    float max_f, int mode, void* stream) {
  if (cur == nullptr) n = 0;
  if (recv == nullptr) m = 0;
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n + m;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (items > 0) {
    const Serve a{cur, prev, local, n, gid_base, dst, recv, m, reply,
                  Route{route, route_mode, S, rbits}, my,
                  reinterpret_cast<const int4*>(halo), halo_nb, glob2loc,
                  reinterpret_cast<const int4*>(vmeta),
                  reinterpret_cast<const int4*>(alias_packed),
                  reinterpret_cast<const int4*>(buckets),
                  reinterpret_cast<const uint2*>(keys), t, first, W_pad,
                  W_total, Wd, L1, T, E, inv_p, inv_q, max_f, mode};
    const cudaError_t err = srw::launch_dependent(
        shard_serve_kernel,
        dim3((unsigned)((items + kServeThreads - 1) / kServeThreads)),
        dim3(kServeThreads), (cudaStream_t)stream, a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// One exact-CDF step for m requests (the request forms of
// srw_shard_serve_launch) on the shard's cdf_rows: dst [m], -1 for a dead
// end, an invalid request or gid -1. words: a warp's bitmap of the graph's
// vertices (ceil(V / 32) <= kBitmapWords; 0: prev's bucket rows only);
// segments > 0: the requests are that many buckets of m / segments, each
// its requests and then fills (gid < 0); next: two ints at 0, as each
// launch leaves them.
// inv_p, inv_q come rounded to the accumulation type (f32: the f32
// quotients, exact in a double); f64 draws and sums in double. An ordinary
// launch of persistent warps: no key table comes before it. Returns the
// CUDA error of the launch.
extern "C" int srw_shard_cdf_serve_launch(
    const int* cur, const int* prev, const int* gid, int stride,
    const int* valid, int gid_base, int m, int* dst, const int* route,
    int route_mode, int S, int rbits, int my, const int* halo, int halo_nb,
    const int* glob2loc, const int* vmeta, const int* rows,
    const int* buckets, int words, int segments, int* next, unsigned k0,
    unsigned k1, unsigned round_offset,
    int t, int first, int W_pad, int W_total, double inv_p, double inv_q,
    int chunked, int f64, void* stream) {
  if (m <= 0) return 0;
  if (words < 0 || words > kBitmapWords || next == nullptr ||
      segments < 0 || segments > kMaxDevices ||
      (segments > 0 && (gid == nullptr || m % segments != 0)))
    return (int)cudaErrorInvalidValue;
  const CdfServe a{cur, prev, gid, stride, valid, gid_base, m, dst,
                   Route{route, route_mode, S, rbits}, my,
                   reinterpret_cast<const int4*>(halo), halo_nb, glob2loc,
                   reinterpret_cast<const int4*>(vmeta),
                   reinterpret_cast<const int2*>(rows),
                   reinterpret_cast<const int4*>(buckets), words, segments,
                   next, k0, k1, round_offset, t, first, W_pad, W_total};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f64)
    err = chunked ? launch_cdf_serve<double, true>(a, inv_p, inv_q, s)
                  : launch_cdf_serve<double, false>(a, inv_p, inv_q, s);
  else
    err = chunked ? launch_cdf_serve<float, true>(a, inv_p, inv_q, s)
                  : launch_cdf_serve<float, false>(a, inv_p, inv_q, s);
  return static_cast<int>(err);
}
