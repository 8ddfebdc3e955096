// The CDF serve's third redesign, kept outside the package as a
// variant of chip_cdf_serve_parts.py: csrc/shard_walk.cu as it stood, with
// csrc/cdf_pick.cuh written in. One cooperative launch: the requests
// classified and compacted on the card into records (a received buffer
// read as far as each bucket's filled prefix), the heavy ones placed by
// row, heaviest first, after two grid barriers every request a warp from
// one counter, the heavy ones first, a second-order step reading prev's
// neighbor set from a bitmap of the vertices. Bit for bit cdf_serve_ref;
// at chip_smoke phase 25 (a)'s hash superstep 0.80-0.85 ms against the
// one-warp-a-request serve's 1.09-1.12, but the smaller serves slower
// (the requests sent 0.29 against 0.20, VCut's local walkers 0.28 against
// 0.19; PERF.md): the classify pass, its two grid barriers and the
// order by row cost more than the compaction saves. Its entry point is
// the one chip_cdf_serve_parts.py::kept_serve launches.

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
// requests of 27,877, 2.67e8 of the 2.82e8 entries, and the bucket reads
// are a third of the time. One cooperative launch of persistent blocks:
//   (a) classify, a thread a request: validity, rows (request_rows),
//       deg(cur), u, kept in a record; a request at a row of the shard's
//       heavy table (owned rows of at least the table's degree, numbered
//       by degree, largest first; chunked form only) is counted at its
//       row, any other servable one appended to the light list (warp-
//       aggregated atomics; each request writes only its own dst). A
//       received buffer of D equal buckets is read only as far as each
//       bucket's filled prefix (entries past a bucket's count carry gid
//       -1), found in the kernel;
//   (b) after a grid barrier, every block scans the heavy rows' counts
//       and the heavy requests are placed by row, heaviest first;
//   (c) after a second barrier, warps take the requests from a counter,
//       the heavy ones first (the longest first, so that no long one
//       starts last): cdf_pick.cuh's pick, one warp a request as K7; a
//       second-order step of the chunked form reads prev's neighbor set
//       from the warp's bitmap of the vertices (pick_bits, where V fits
//       kBitmapWords) instead of a bucket row an entry.
// Every sum is pick's in pick's order, each operation rounded on its own:
// bit for bit its plain version on any input. It reads no key table (its
// one draw a step is made from the seed key). The workspace's counters
// end each launch at 0. Two forms that staged a heavy row in shared
// memory for a group of its requests measured slower and stay outside
// (chip_cdf_serve_tile.cu, chip_cdf_serve_staged.cu).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

// K7's row scan as __device__ code: the exact inverse-CDF pick over one
// row by a warp, shared by cdf_walk.cu's cdf_walk_kernel (whole walks, a
// warp a walker) and shard_walk.cu's shard_cdf_serve (one step of a
// request on its owner shard, a warp a request), so that both compile
// the same text and pick the same entry. Beside it pick_bits, the chunked
// second-order pick with prev's neighbor set read from a bitmap, which the
// CDF serve runs where the graph's vertices fit one: the same butterfly
// and piece scan, and weigh's product, so the two round alike.
//
// The semantics and the summation order are cdf_walk.cu's note: padded
// form left to right, entry by entry; chunked form as lane sums joined by a
// butterfly and a Kogge-Stone scan of each 32-entry piece; every product,
// sum and quotient rounded on its own (_rn intrinsics, no FMA
// contraction). Build without --use_fast_math.
//
// The definitions sit in an unnamed namespace: each source that includes
// the header gets its own copy, as it had when they were cdf_walk.cu's.


#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHashMult = 2654435761u;

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float draw(uint2 step_key, uint32_t w) {
    return srw::uniform_at(step_key, w);
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
  }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  // jax.random.uniform(key, shape, float64): the 64-bit word (o0 << 32) | o1,
  // its top 52 bits as the mantissa of a double in [1, 2), minus 1.
  static __device__ __forceinline__ double draw(uint2 step_key, uint32_t w) {
    const uint2 o = srw::threefry(step_key.x, step_key.y, 0u, w);
    const uint64_t bits = (static_cast<uint64_t>(o.x) << 32) | o.y;
    return __longlong_as_double(
               static_cast<long long>((bits >> 12) | 0x3FF0000000000000ull)) -
           1.0;
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double neg_inf() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
  }
};

// The bias inputs of a second-order step: the previous vertex and its
// neighbor set's bucket rows.
struct Prev {
  int id, bucket_base, bucket_mask;
};

template <typename T, bool kSecond>
__device__ __forceinline__ T weigh(int2 e, const Prev& pv,
                                   const int4* __restrict__ buckets, T inv_p,
                                   T inv_q) {
  const T w = static_cast<T>(__int_as_float(e.y));
  if (!kSecond) return w;
  T f;
  if (e.x == pv.id) {
    f = inv_p;
  } else {
    const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;
    const int4 b = __ldg(&buckets[pv.bucket_base +
                                  static_cast<int>(h & pv.bucket_mask)]);
    f = (b.x == e.x || b.y == e.x || b.z == e.x || b.w == e.x) ? T(1) : inv_q;
  }
  return Ops<T>::mul(w, f);
}

// The chunked form's lane sums joined by the xor butterfly: every lane
// gets the row's total (each level adds the same two values on both
// lanes of a pair).
template <typename T>
__device__ __forceinline__ T butterfly(T acc) {
  for (int off = 16; off; off >>= 1)
    acc = Ops<T>::add(acc, __shfl_xor_sync(kFull, acc, off));
  return acc;
}

// The Kogge-Stone inclusive scan of one 32-entry piece over the lanes.
template <typename T>
__device__ __forceinline__ T piece_scan(T v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = Ops<T>::add(v, y);
  }
  return v;
}

// Index of the picked entry in the row [s, s + d), or -1 (the row head).
template <typename T, bool kChunked, bool kSecond>
__device__ int pick(const int2* __restrict__ rows, int s, int d, T u,
                    const Prev& pv, const int4* __restrict__ buckets, T inv_p,
                    T inv_q, int lane) {
  using O = Ops<T>;
  const int2* row = rows + s;
  if (kChunked) {
    T acc = T(0);
    for (int i = lane; i < d; i += 32)
      acc = O::add(acc, weigh<T, kSecond>(row[i], pv, buckets, inv_p, inv_q));
    const T thresh = O::mul(u, butterfly(acc));
    T cum = T(0);
    for (int base = 0; base < d; base += 32) {
      const int i = base + lane;
      const T v = piece_scan(
          i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p, inv_q) : T(0),
          lane);
      const T c = O::add(cum, v);
      const unsigned hit = __ballot_sync(kFull, i < d && c >= thresh);
      if (hit) return base + __ffs(hit) - 1;
      cum = __shfl_sync(kFull, c, 31);
    }
    return -1;
  }
  T total = T(0);
  for (int base = 0; base < d; base += 32) {
    const int i = base + lane;
    const T v =
        i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p, inv_q) : T(0);
    const int n = min(32, d - base);
    for (int k = 0; k < n; ++k) total = O::add(total, __shfl_sync(kFull, v, k));
  }
  const T div = total > T(0) ? total : T(1);
  T c = T(0);
  for (int base = 0; base < d; base += 32) {
    const int i = base + lane;
    const T v =
        i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p, inv_q) : T(0);
    const T x = O::div(v, div);
    const int n = min(32, d - base);
    T mine = T(0);
    for (int k = 0; k < n; ++k) {
      c = O::add(c, __shfl_sync(kFull, x, k));
      if (lane == k) mine = c;
    }
    const unsigned hit = __ballot_sync(kFull, i < d && mine >= u);
    if (hit) return base + __ffs(hit) - 1;
  }
  return -1;
}

// ---- The chunked pick with prev's neighbor set as a bitmap ----
//
// A second-order weight reads prev's bucket row (16 bytes) for every entry
// of cur's row, in both passes. pick_bits reads a bit instead: the warp's
// bitmap of the graph's vertices, set from the keys of prev's bucket rows
// before the pick and cleared after it (a key sits only in its own bucket,
// so the keys of prev's rows are its neighbor set, and a bit is set
// exactly where the bucket read finds the entry). The weight is weigh's,
// w * f rounded once, and the sums are pick's, in pick's order: the
// butterfly and the piece scan are the same text. So pick_bits picks what
// pick picks, bit for bit.

// Sets (set) or clears the bits of prev's neighbors in the warp's bitmap
// bm: the keys of its nb bucket rows, a row a lane at a time.
__device__ __forceinline__ void mark_neighbors(const Prev& pv,
                                               const int4* __restrict__ buckets,
                                               unsigned* bm, int lane,
                                               bool set) {
  for (int b = lane; b <= pv.bucket_mask; b += 32) {
    const int4 k = __ldg(&buckets[pv.bucket_base + b]);
    const int keys[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (keys[j] < 0) continue;
      if (set)
        atomicOr(&bm[keys[j] >> 5], 1u << (keys[j] & 31));
      else
        bm[keys[j] >> 5] = 0u;
    }
  }
  __syncwarp();
}

// weigh's second-order weight with the membership read from the bitmap.
template <typename T>
__device__ __forceinline__ T weigh_bits(int2 e, int prev,
                                        const unsigned* bm, T inv_p,
                                        T inv_q) {
  const T w = static_cast<T>(__int_as_float(e.y));
  const T f = e.x == prev                           ? inv_p
              : (bm[e.x >> 5] >> (e.x & 31)) & 1u ? T(1)
                                                  : inv_q;
  return Ops<T>::mul(w, f);
}

// pick's chunked second-order form over the row [s, s + d) with the
// warp's bitmap of prev's neighbors set (mark_neighbors).
template <typename T>
__device__ int pick_bits(const int2* __restrict__ rows, int s, int d, T u,
                         int prev, const unsigned* bm, T inv_p, T inv_q,
                         int lane) {
  using O = Ops<T>;
  const int2* row = rows + s;
  T acc = T(0);
  for (int i = lane; i < d; i += 32)
    acc = O::add(acc, weigh_bits(row[i], prev, bm, inv_p, inv_q));
  const T thresh = O::mul(u, butterfly(acc));
  T cum = T(0);
  for (int base = 0; base < d; base += 32) {
    const int i = base + lane;
    const T v = piece_scan(
        i < d ? weigh_bits(row[i], prev, bm, inv_p, inv_q) : T(0), lane);
    const T c = O::add(cum, v);
    const unsigned hit = __ballot_sync(kFull, i < d && thresh <= c);
    if (hit) return base + __ffs(hit) - 1;
    cum = __shfl_sync(kFull, c, 31);
  }
  return -1;  // the row head
}

}  // namespace
#include "threefry.cuh"
#include "walk_trial.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kEmitThreads = 512;                 // walkers a tile
constexpr int kEmitWarps = kEmitThreads / 32;
constexpr int kMaxDevices = 256;                  // D the emit takes
constexpr int kServeThreads = 128;
constexpr int kCdfServeThreads = 256;   // 8 warps a block
constexpr int kMaxHeavy = 1024;         // rows of a shard's heavy table
constexpr int kBitmapWords = 2048;      // a warp's bitmap: V <= 65,536
// the CDF serve's workspace: counters and the heavy rows' counts, then
// kWorkInts ints a request (light and heavy records, keys, order)
constexpr int kWorkHead = 1032;
constexpr int kWorkInts = 19;

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
  int E;               // entries of cdf_rows
  const int4* buckets;
  const int* heavy;    // a row's rank in the heavy table, else -1
  int n_heavy;
  int words;           // a warp's bitmap of the vertices (0: none)
  int segments;        // > 0: m / segments requests a bucket, prefix filled
  int* work;           // kWorkHead + kWorkInts * cap ints, counters at 0
  int cap;
  uint32_t k0, k1, round_offset;
  int t, first, W_pad, W_total;
};

// The workspace's parts.
struct CdfWork {
  int* ctr;        // [0] light requests, [1] heavy, [2] the next to serve
  int* count;      // [kMaxHeavy]: requests at each heavy row
  int4* light;     // [2 cap]: the light requests' records
  int4* heavy;     // [2 cap]: the heavy requests' records
  int2* key;       // [cap]: a heavy record's (row rank, place at its row)
  int* order;      // [cap]: heavy records by row
};

__device__ __forceinline__ CdfWork cdf_work(int* w, int cap) {
  static_assert(8 + kMaxHeavy <= kWorkHead && kWorkHead % 4 == 0,
                "the workspace's head");
  static_assert(kWorkInts == 8 + 8 + 2 + 1, "a request's ints");
  CdfWork k;
  k.ctr = w;
  k.count = w + 8;
  k.light = reinterpret_cast<int4*>(w + kWorkHead);
  k.heavy = k.light + 2 * (size_t)cap;
  k.key = reinterpret_cast<int2*>(k.heavy + 2 * (size_t)cap);
  k.order = reinterpret_cast<int*>(k.key + cap);
  return k;
}

// A servable request's record: (dst index, row start, degree, prev id),
// (prev's bucket base, mask, u's bits).
template <typename T>
__device__ __forceinline__ int2 u_bits(T u) {
  if (sizeof(T) == 8) {
    const double x = static_cast<double>(u);
    return make_int2(__double2loint(x), __double2hiint(x));
  }
  return make_int2(__float_as_int(static_cast<float>(u)), 0);
}

template <typename T>
__device__ __forceinline__ T u_of(int4 b) {
  if (sizeof(T) == 8) return static_cast<T>(__hiloint2double(b.w, b.z));
  return static_cast<T>(__int_as_float(b.z));
}

// Exclusive scan of one int a thread over a block of kCdfServeThreads;
// *total gets the sum.
__device__ __forceinline__ int block_scan_serve(int v, int* total) {
  constexpr int kWarps = kCdfServeThreads / 32;
  __shared__ int warp_sums[kWarps];
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
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Dynamic shared memory: (b)'s row bases, then (c)'s bitmaps, a warp's
// `words` each.
__host__ __forceinline__ size_t cdf_serve_smem(int words) {
  const size_t bases = (kMaxHeavy + 1) * sizeof(int);
  const size_t bits = (size_t)(kCdfServeThreads / 32) * words * sizeof(int);
  return bases > bits ? bases : bits;
}

// The CDF serve: (a) classify, (b) the heavy requests ordered by row, (c)
// every request a warp, the heavy ones first (see the note at the top).
// One step's u: element w of uniform(fold_in(fold_in(seed_key,
// round_offset + r), t), (n_stream,)) in T, r = gid / W_pad, w = gid %
// W_pad, the step key made here as cdf_walk_kernel makes it; a
// second-order step weighs by prev's neighbor set on this shard (an owned
// or a halo bucket row).
template <typename T, bool kChunked>
__global__ void __launch_bounds__(kCdfServeThreads)
shard_cdf_serve_kernel(const CdfServe a, T inv_p, T inv_q) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int seg_count[kMaxDevices];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31;
  const CdfWork w = cdf_work(a.work, a.cap);
  const int nh = kChunked && a.heavy != nullptr ? a.n_heavy : 0;

  // (a) classify. A bucket's filled prefix: its first gid < 0.
  const int seg_len = a.segments > 0 ? a.m / a.segments : 0;
  for (int b = tid; b < a.segments; b += kCdfServeThreads) {
    int lo = 0, hi = seg_len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.gid[(size_t)(b * seg_len + mid) * a.stride] >= 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    seg_count[b] = lo;
  }
  __syncthreads();
  for (int base = blockIdx.x * kCdfServeThreads; base < a.m;
       base += gridDim.x * kCdfServeThreads) {
    const int i = base + tid;
    int cls = 0, hr = -1;   // 0 none, 1 light, 2 heavy
    int4 ra = make_int4(0, 0, 0, 0), rb = ra;
    if (i < a.m) {
      bool in = true;
      if (seg_len > 0) {
        const int b = i / seg_len;
        in = i - b * seg_len < seg_count[b];
      }
      const size_t at = (size_t)i * a.stride;
      const int g = !in ? -1 : a.gid != nullptr ? a.gid[at] : a.gid_base + i;
      if (g >= 0 && (a.valid == nullptr || a.valid[i] != 0)) {
        const int gc = min(g, a.W_total - 1);
        const int r = gc / a.W_pad;
        const uint32_t wl = (uint32_t)(gc - r * a.W_pad);
        const int fprev = a.prev[at];
        const int2 rw = request_rows(a.rt, a.my, a.halo, a.halo_nb,
                                     a.glob2loc, a.cur[at], fprev);
        const int4 cm = a.vmeta[rw.x];
        if (cm.y > 0) {
          const uint2 rk =
              srw::threefry(a.k0, a.k1, 0u, a.round_offset + (uint32_t)r);
          const T u = Ops<T>::draw(
              srw::threefry(rk.x, rk.y, 0u, static_cast<uint32_t>(a.t)), wl);
          int4 pm = make_int4(0, 0, 0, 0);
          if (!a.first) pm = a.vmeta[rw.y];
          const int2 ub = u_bits(u);
          ra = make_int4(i, cm.x, cm.y, a.first ? 0 : fprev);
          rb = make_int4(pm.z, pm.w, ub.x, ub.y);
          hr = nh > 0 ? a.heavy[rw.x] : -1;
          cls = hr >= 0 ? 2 : 1;
        }
      }
      if (cls == 0) a.dst[i] = -1;
    }
    const unsigned lt = (1u << lane) - 1u;
    const unsigned light = __ballot_sync(kFull, cls == 1);
    if (light) {
      const int lead = __ffs(light) - 1;
      int at = 0;
      if (lane == lead) at = atomicAdd(w.ctr, __popc(light));
      at = __shfl_sync(kFull, at, lead) + __popc(light & lt);
      if (cls == 1) {
        w.light[2 * (size_t)at] = ra;
        w.light[2 * (size_t)at + 1] = rb;
      }
    }
    const unsigned heavy = __ballot_sync(kFull, cls == 2);
    if (heavy) {
      const int lead = __ffs(heavy) - 1;
      int at = 0;
      if (lane == lead) at = atomicAdd(w.ctr + 1, __popc(heavy));
      at = __shfl_sync(kFull, at, lead) + __popc(heavy & lt);
      const unsigned peers = __match_any_sync(kFull, cls == 2 ? hr : -1);
      if (cls == 2) {
        const int first = __ffs(peers) - 1;
        int place = 0;
        if (lane == first) place = atomicAdd(w.count + hr, __popc(peers));
        place = __shfl_sync(peers, place, first) + __popc(peers & lt);
        w.heavy[2 * (size_t)at] = ra;
        w.heavy[2 * (size_t)at + 1] = rb;
        w.key[at] = make_int2(hr, place);
      }
    }
  }
  grid.sync();

  // (b) every block: the heavy rows' bases; the heavy requests placed by
  // row, heaviest first
  const int n_light = w.ctr[0], n_heavy_req = w.ctr[1];
  int* rbase = reinterpret_cast<int*>(dyn);
  constexpr int kPer = (kMaxHeavy + kCdfServeThreads - 1) / kCdfServeThreads;
  int mine = 0, cnt[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int h = tid * kPer + k;
    cnt[k] = h < nh ? w.count[h] : 0;
    mine += cnt[k];
  }
  int total;
  int run = block_scan_serve(mine, &total);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int h = tid * kPer + k;
    if (h < nh) rbase[h] = run;
    run += cnt[k];
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid == 0) w.ctr[2] = 0;
  for (int q = blockIdx.x * kCdfServeThreads + tid; q < n_heavy_req;
       q += gridDim.x * kCdfServeThreads) {
    const int2 k = w.key[q];
    w.order[rbase[k.x] + k.y] = q;
  }
  grid.sync();
  // every block has read the counts: the next launch's start at 0
  if (blockIdx.x == 0) {
    for (int h = tid; h < nh; h += kCdfServeThreads) w.count[h] = 0;
    if (tid == 0) w.ctr[0] = w.ctr[1] = 0;
  }

  // (c) every request a warp, taken from a counter: the heavy ones by row,
  // heaviest first, then the light ones. A second-order step of the
  // chunked form reads prev's neighbors from the warp's bitmap where the
  // vertices fit one (words) and prev has no more bucket rows than cur
  // has entries: marking them costs less than the bucket reads it saves.
  unsigned* bm = nullptr;
  if constexpr (kChunked) {
    if (a.words > 0) {
      bm = reinterpret_cast<unsigned*>(dyn) + (tid >> 5) * a.words;
      __syncthreads();   // (b)'s bases are read
      for (int j = lane; j < a.words; j += 32) bm[j] = 0u;
      __syncwarp();
    }
  }
  for (const int n = n_heavy_req + n_light;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(w.ctr + 2, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n) break;
    const int4* rec = k < n_heavy_req ? w.heavy + 2 * (size_t)w.order[k]
                                      : w.light + 2 * (size_t)(k - n_heavy_req);
    const int4 ra = rec[0], rb = rec[1];
    const T u = u_of<T>(rb);
    const Prev pv{ra.w, rb.x, rb.y};
    int j;
    if (a.first) {
      j = pick<T, kChunked, false>(a.rows, ra.y, ra.z, u, pv, a.buckets,
                                   inv_p, inv_q, lane);
    } else if (bm != nullptr && pv.bucket_mask < ra.z) {
      mark_neighbors(pv, a.buckets, bm, lane, true);
      j = pick_bits<T>(a.rows, ra.y, ra.z, u, pv.id, bm, inv_p, inv_q, lane);
      mark_neighbors(pv, a.buckets, bm, lane, false);
    } else {
      j = pick<T, kChunked, true>(a.rows, ra.y, ra.z, u, pv, a.buckets,
                                  inv_p, inv_q, lane);
    }
    if (lane == 0) a.dst[ra.x] = a.rows[ra.y + max(j, 0)].x;
  }
}

// Blocks of the CDF serve's cooperative grid: as many as the card holds
// at once with this launch's shared memory, at most a warp a request.
template <typename T, bool kChunked>
cudaError_t launch_cdf_serve(const CdfServe& a, double inv_p, double inv_q,
                             cudaStream_t stream) {
  static int sms = 0, resident = 0;
  static size_t sized = 0;   // the shared memory `resident` is for
  auto kernel = shard_cdf_serve_kernel<T, kChunked>;
  const size_t smem = cdf_serve_smem(kChunked ? a.words : 0);
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(cdf_serve_smem(kBitmapWords)));
    if (err != cudaSuccess) return err;
  }
  if (resident == 0 || sized != smem) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kCdfServeThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
    sized = smem;
  }
  const long long want = (static_cast<long long>(a.m) + 7) / 8;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  T ip = static_cast<T>(inv_p), iq = static_cast<T>(inv_q);
  CdfServe args = a;
  void* params[] = {&args, &ip, &iq};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(blocks), dim3(kCdfServeThreads), params, smem,
      stream);
  cudaGetLastError();  // a refused launch leaves no error for later calls
  return err;
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
// srw_shard_serve_launch) on the shard's cdf_rows (E entries): dst [m],
// -1 for a dead end, an invalid request or gid -1. heavy: the shard's
// heavy-row table (a row's rank, else -1; n_heavy <= kMaxHeavy ranks;
// null: none); segments > 0: the requests are that many buckets of m /
// segments, each its requests then fills (gid < 0); work: the workspace
// of cap >= m requests (kWorkHead + kWorkInts * cap ints, counters at 0,
// as each launch leaves them). inv_p, inv_q come rounded to the
// accumulation type (f32: the f32 quotients, exact in a double); f64 draws
// and sums in double. One cooperative launch: no key table comes before
// it. Returns the CUDA error of the launch (a refused launch included).
extern "C" int srw_shard_cdf_serve_launch(
    const int* cur, const int* prev, const int* gid, int stride,
    const int* valid, int gid_base, int m, int* dst, const int* route,
    int route_mode, int S, int rbits, int my, const int* halo, int halo_nb,
    const int* glob2loc, const int* vmeta, const int* rows, int E,
    const int* buckets, const int* heavy, int n_heavy, int words,
    int segments, int* work, int cap, unsigned k0, unsigned k1,
    unsigned round_offset,
    int t, int first, int W_pad, int W_total, double inv_p, double inv_q,
    int chunked, int f64, void* stream) {
  if (m <= 0) return 0;
  if (m > cap || n_heavy < 0 || n_heavy > kMaxHeavy || words < 0 ||
      words > kBitmapWords || segments < 0 ||
      segments > kMaxDevices || (segments > 0 && (gid == nullptr ||
                                                  m % segments != 0)))
    return (int)cudaErrorInvalidValue;
  const CdfServe a{cur, prev, gid, stride, valid, gid_base, m, dst,
                   Route{route, route_mode, S, rbits}, my,
                   reinterpret_cast<const int4*>(halo), halo_nb, glob2loc,
                   reinterpret_cast<const int4*>(vmeta),
                   reinterpret_cast<const int2*>(rows), E,
                   reinterpret_cast<const int4*>(buckets), heavy, n_heavy,
                   words, segments, work, cap, k0, k1, round_offset, t, first,
                   W_pad, W_total};
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
