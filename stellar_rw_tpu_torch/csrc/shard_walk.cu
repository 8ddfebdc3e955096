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
// flag of n walkers and writes at most D * C requests) and, far more, its
// launch and the two grid barriers at the shapes of a walk. Its design: one
// cooperative launch of persistent blocks over tiles of kEmitThreads
// walkers, a walker a thread, in three phases:
//   (1) each tile's count of requests for each destination: a warp's
//       requests for one destination found by __match_any_sync, counted by
//       its lowest lane into a per-warp table in shared memory, the warps
//       summed into the tile's row of `tile_counts`;
//   (2) after a grid barrier, an exclusive scan of each destination's
//       column over the tiles (a block a destination), the total in the
//       last row;
//   (3) after a second barrier, each request's rank in its bucket: its
//       tile's offset + the counts of the warps before it in the tile +
//       its rank among its warp's peers. That is its position in the
//       stable order by destination, less the bucket's start, exactly as
//       the JAX package ranks it. A rank below C is sent (its fields
//       written, its pending flag cleared); the entries past each bucket's
//       count are filled (0, 0, -1) and slot n. counters[0] gets the
//       requests pending before the round, counters[1] those left after.
// The first round of a superstep also decides each live walker's place:
// `local` (its vertex is this shard's) or pending.
//
// shard_serve. What bounds it: int32 issue, as the walk kernel (a trial is
// two or three threefry blocks around two dependent 16-byte row reads).
// One thread a request; the rows: cur's owned row by arithmetic (hash:
// cur / S) or from the packed route's high bits, prev's as owned or
// through the 8-wide halo bucket row (one 32-byte read: 4 keys, 4 rows),
// or both through glob2loc where the partitioner kept it. prev's vmeta row
// is read again every step (a carried row would index another shard).
// Launched as a programmatic dependent: it waits for the grid before it
// (the key table, or the emit) before its first access.
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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cdf_pick.cuh"
#include "threefry.cuh"
#include "walk_trial.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kEmitThreads = 512;                 // walkers a tile
constexpr int kEmitWarps = kEmitThreads / 32;
constexpr int kMaxDevices = 256;                  // D the emit takes
constexpr int kServeThreads = 128;
constexpr int kCdfServeThreads = 256;        // 8 warps a block
constexpr int kBitmapWords = 2048;    // a warp's bitmap: V <= 65,536
constexpr int kBitmapMinEntries = 1024;   // rows that read the bitmap

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

// A walker's destination device, or D where it sends nothing this round.
// first: decides local / pending from `alive` and writes both flags.
__device__ __forceinline__ int emit_dest(const int* __restrict__ cur,
                                         const int* __restrict__ alive,
                                         int* __restrict__ pending,
                                         int* __restrict__ local,
                                         const Route& rt, int my, int L,
                                         int D, int gid_base, int i, int n) {
  if (i >= n) return D;
  bool p;
  int ds = 0;
  if (alive != nullptr) {
    const bool a = alive[i] != 0;
    if (a) ds = dest_shard(rt, cur[i]);
    const bool loc = a && ds == my;
    p = a && !loc;
    local[i] = loc;
    pending[i] = p;
  } else {
    p = pending[i] != 0;
    if (p) ds = dest_shard(rt, cur[i]);
  }
  return p ? ds * L + (gid_base + i) % L : D;
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kEmitWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kEmitWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

__global__ void __launch_bounds__(kEmitThreads)
shard_emit_kernel(const int* __restrict__ cur, const int* __restrict__ prev,
                  const int* __restrict__ alive, int* __restrict__ pending,
                  int* __restrict__ local, Route rt, int my, int L, int D,
                  int gid_base, int n, int C, int* __restrict__ send,
                  int* __restrict__ slot, int* __restrict__ tile_counts,
                  int* __restrict__ counters) {
  __shared__ int wcnt[kEmitWarps * kMaxDevices];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (n + kEmitThreads - 1) / kEmitThreads;
  if (blockIdx.x == 0 && threadIdx.x == 0) counters[1] = 0;

  // (1) each tile's count of requests for each destination
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int i = tile * kEmitThreads + threadIdx.x;
    const int d = emit_dest(cur, alive, pending, local, rt, my, L, D,
                            gid_base, i, n);
    for (int k = threadIdx.x; k < kEmitWarps * D; k += kEmitThreads)
      wcnt[k] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < D && lane == __ffs(peers) - 1) wcnt[warp * D + d] = __popc(peers);
    __syncthreads();
    for (int k = threadIdx.x; k < D; k += kEmitThreads) {
      int s = 0;
      for (int w = 0; w < kEmitWarps; ++w) s += wcnt[w * D + k];
      tile_counts[(size_t)tile * D + k] = s;
    }
    __syncthreads();
  }
  grid.sync();

  // (2) each destination's column scanned over the tiles; totals last
  for (int d = blockIdx.x; d < D; d += gridDim.x) {
    const int per = (ntiles + kEmitThreads - 1) / kEmitThreads;
    const int t0 = min(threadIdx.x * per, ntiles);
    const int t1 = min(t0 + per, ntiles);
    int s = 0;
    for (int t = t0; t < t1; ++t) s += tile_counts[(size_t)t * D + d];
    int total;
    int run = block_exclusive_scan(s, &total);
    for (int t = t0; t < t1; ++t) {
      const int c = tile_counts[(size_t)t * D + d];
      tile_counts[(size_t)t * D + d] = run;
      run += c;
    }
    if (threadIdx.x == 0) tile_counts[(size_t)ntiles * D + d] = total;
  }
  grid.sync();

  // (3) each request's rank in its bucket; the first C are sent
  const int* totals = tile_counts + (size_t)ntiles * D;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int i = tile * kEmitThreads + threadIdx.x;
    // pending and the destination again (this thread wrote the flags in
    // (1) for the first round)
    const int d = emit_dest(cur, nullptr, pending, nullptr, rt, my, L, D,
                            gid_base, i, n);
    for (int k = threadIdx.x; k < kEmitWarps * D; k += kEmitThreads)
      wcnt[k] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d < D && lane == __ffs(peers) - 1) wcnt[warp * D + d] = __popc(peers);
    __syncthreads();
    bool left = false;
    if (d < D) {
      int rank = tile_counts[(size_t)tile * D + d]
                 + __popc(peers & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += wcnt[w * D + d];
      if (rank < C) {
        const size_t e = (size_t)d * C + rank;
        send[3 * e] = cur[i];
        send[3 * e + 1] = prev[i];
        send[3 * e + 2] = gid_base + i;
        slot[e] = i;
        pending[i] = 0;
      } else {
        left = true;
      }
    }
    const int n_left = __syncthreads_count(left);
    if (threadIdx.x == 0 && n_left) atomicAdd(counters + 1, n_left);
  }
  // the entries past each bucket's count
  const size_t stride = (size_t)gridDim.x * kEmitThreads;
  for (size_t e = (size_t)blockIdx.x * kEmitThreads + threadIdx.x;
       e < (size_t)D * C; e += stride) {
    const int d = (int)(e / C);
    if ((int)(e - (size_t)d * C) >= totals[d]) {
      send[3 * e] = 0;
      send[3 * e + 1] = 0;
      send[3 * e + 2] = -1;
      slot[e] = n;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int s = 0;
    for (int d = 0; d < D; ++d) s += totals[d];
    counters[0] = s;
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

__global__ void __launch_bounds__(kServeThreads)
shard_serve_kernel(const int* __restrict__ cur, const int* __restrict__ prev,
                   const int* __restrict__ gid, int stride,
                   const int* __restrict__ valid, int gid_base, int m,
                   int* __restrict__ dst, Route rt, int my,
                   const int4* __restrict__ halo, int halo_nb,
                   const int* __restrict__ glob2loc,
                   const int4* __restrict__ vmeta,
                   const int4* __restrict__ alias_packed,
                   const int4* __restrict__ buckets,
                   const uint2* __restrict__ keys, int t, int first,
                   int W_pad, int W_total, int Wd, int L1, int T, int E,
                   float inv_p, float inv_q, float max_f, int mode) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t at = (size_t)i * stride;
  const int g = gid != nullptr ? gid[at] : gid_base + i;
  int out = -1;
  if (g >= 0 && (valid == nullptr || valid[i] != 0)) {
    const int gc = min(g, W_total - 1);
    const int r = gc / W_pad;
    const uint32_t w = (uint32_t)(gc - r * W_pad);
    const int fcur = cur[at], fprev = prev[at];
    const int2 rows = request_rows(rt, my, halo, halo_nb, glob2loc, fcur,
                                   fprev);
    const int4 cm = vmeta[rows.x];
    if (cm.y > 0) {
      const uint2* kt = keys + ((size_t)r * L1 + t) * T;
      if (first) {
        out = srw::first_order(alias_packed, cm, E, kt[0], w, Wd);
      } else {
        const int4 pm = vmeta[rows.y];
        out = srw::second_order(alias_packed, buckets, kt, T, w, Wd, cm, pm,
                                fprev, E, inv_p, inv_q, max_f, mode);
      }
    }
  }
  dst[i] = out;
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

int emit_grid(int ntiles) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shard_emit_kernel,
                                                  kEmitThreads, 0);
    resident = sms * per_sm;
  }
  return ntiles < resident ? ntiles : resident;
}

}  // namespace

// One exchange round's bucket build over n walkers (see the note at the
// top). alive: the superstep's first round (the local and pending flags
// are written from it), else null (pending is read). send [D, C, 3], slot
// [D, C], tile_counts [(ceil(n / 512) + 1) * D], counters [2]. Returns
// the CUDA error of the launch (a refused cooperative launch included).
extern "C" int srw_shard_emit_launch(
    const int* cur, const int* prev, const int* alive, int* pending,
    int* local, const int* route, int route_mode, int S, int rbits, int my,
    int L, int D, int gid_base, int n, int C, int* send, int* slot,
    int* tile_counts, int* counters, void* stream) {
  if (D < 1 || D > kMaxDevices || C < 1) return (int)cudaErrorInvalidValue;
  const int ntiles = (n + kEmitThreads - 1) / kEmitThreads;
  const int blocks = emit_grid(ntiles > 0 ? ntiles : 1);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  Route rt{route, route_mode, S, rbits};
  void* args[] = {&cur, &prev, &alive, &pending, &local, &rt, &my, &L, &D,
                  &gid_base, &n, &C, &send, &slot, &tile_counts, &counters};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)shard_emit_kernel, dim3(blocks), dim3(kEmitThreads), args, 0,
      (cudaStream_t)stream);
  cudaGetLastError();  // a refused launch leaves no error for later calls
  return (int)err;
}

// One step for m requests: cur, prev, gid at element stride `stride` (gid
// null: gid_base + i), valid (null: every request with gid >= 0) -> dst
// [m], -1 for a dead end or an invalid request.
extern "C" int srw_shard_serve_launch(
    const int* cur, const int* prev, const int* gid, int stride,
    const int* valid, int gid_base, int m, int* dst, const int* route,
    int route_mode, int S, int rbits, int my, const int* halo, int halo_nb,
    const int* glob2loc, const int* vmeta, const int* alias_packed,
    const int* buckets, const unsigned* keys, int t, int first, int W_pad,
    int W_total, int Wd, int L1, int T, int E, float inv_p, float inv_q,
    float max_f, int mode, void* stream) {
  if (m > 0) {
    Route rt{route, route_mode, S, rbits};
    const cudaError_t err = srw::launch_dependent(
        shard_serve_kernel, dim3((m + kServeThreads - 1) / kServeThreads),
        dim3(kServeThreads), (cudaStream_t)stream, cur, prev, gid, stride,
        valid, gid_base, m, dst, rt, my, reinterpret_cast<const int4*>(halo),
        halo_nb, glob2loc, reinterpret_cast<const int4*>(vmeta),
        reinterpret_cast<const int4*>(alias_packed),
        reinterpret_cast<const int4*>(buckets),
        reinterpret_cast<const uint2*>(keys), t, first, W_pad, W_total, Wd,
        L1, T, E, inv_p, inv_q, max_f, mode);
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
