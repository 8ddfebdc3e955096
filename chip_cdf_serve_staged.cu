// The CDF serve's second redesign, kept outside the package as a
// variant of chip_cdf_serve_parts.py: csrc/shard_walk.cu as it stood, with
// csrc/cdf_pick.cuh written in. A heavy row's requests in groups of 8, a
// thread block a group and a warp a request, over the row staged once a
// pass for the group in shared memory (cp.async.bulk on two mbarriers,
// chunks of 2,048 entries, one block barrier a chunk), pick's loop per
// warp; sparse weighing where prev has at most 128 bucket slots. Bit for
// bit cdf_serve_ref, but 1.67 ms at chip_smoke phase 25 (a)'s hash
// superstep against the one-warp-a-request serve's 1.09-1.12 (VCut
// 0.27 against 0.19; PERF.md): the warps of a group wait for its slowest
// at every chunk and for its last crossing, at four blocks an SM. Its
// entry point is the one chip_cdf_serve_parts.py::kept_serve launches
// (`words` unused).

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
// crossing, with a 16-byte bucket row for a second-order weight), as K7.
// At a superstep those entries are almost all a few heavy rows' (a walker
// stands on a vertex in proportion to its degree, so the entries go as the
// sum of deg^2): thousands of requests rescan the same hub row, and one
// warp a request leaves each of them a chain of deg/32 dependent turns. So
// the serve is one cooperative launch of persistent blocks in phases:
//   (a) classify, a thread a request: validity, rows (request_rows),
//       deg(cur), u, kept in a record; a request at a row of the shard's
//       heavy table (owned rows of at least the table's degree, numbered
//       by degree, largest first; chunked form only) is counted at its
//       row, any other servable one appended to the light list (warp-
//       aggregated atomics; the list's order is free: each request writes
//       only its own dst). A received buffer of D equal buckets is read
//       only as far as each bucket's filled prefix (entries past a
//       bucket's count carry gid -1), found in the kernel;
//   (b) after a grid barrier, every block scans the heavy rows' counts
//       (request and group bases); the heavy requests are placed by row;
//   (c) after a second barrier, blocks take groups of up to kGroup
//       requests at one heavy row from a counter, heaviest rows first:
//       cdf_pick.cuh's pick_group stages the row through shared memory
//       once per pass for the group and weighs it with the whole block;
//   (d) then warps take light requests from a counter: cdf_pick.cuh's
//       pick, one warp a request, as K7.
// Every sum is pick's in pick's order, each operation rounded on its own:
// bit for bit its plain version on any input. It reads no key table (its
// one draw a step is made from the seed key). The workspace's counters
// end each launch at 0.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

// K7's row scan as __device__ code: the exact inverse-CDF pick over one
// row by a warp, shared by cdf_walk.cu's cdf_walk_kernel (whole walks, a
// warp a walker) and shard_walk.cu's shard_cdf_serve (one step of a
// request on its owner shard: a warp a light request), so that both
// compile the same text and pick the same entry. Beside it the staged
// form (pick_group), the chunked pick of a group of requests at one row
// by a thread block, which the CDF serve runs for its heavy rows: the
// same weigh, butterfly and piece scan, so the three round alike.
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

// ---- The staged form: the chunked pick of a group of requests at one row,
// a thread block a group, a warp a request ----
//
// The row's entries go through shared memory a chunk of kChunk entries (a
// multiple of 32) at a time, copied by one thread's cp.async.bulk that
// completes on an mbarrier, two chunks in flight: the block reads the row
// from device memory once a pass for the whole group, where one warp a
// request reads it once a request. Each warp runs pick's chunked form
// over the staged chunks for its own request, in pick's order: lane l adds
// entries l, l + 32, ... chunk after chunk, then butterfly; then the find
// pass, chunk by chunk again, each piece's piece_scan added to cum until a
// lane reaches thresh. One block barrier a chunk frees its buffer; the
// find pass stops at the chunk where the group's last request crossed.
//
// A second-order weight reads prev's bucket row for every entry. A
// request whose prev has at most kSlots bucket slots weighs sparsely
// instead: its exceptions, the entries whose column is prev (f = 1/p) or
// one of prev's neighbors (f = 1), are found once a group by a binary
// search of the row (a row's columns are sorted) for prev and for each key
// of prev's bucket rows (a key sits only in its own bucket, so a key of
// the rows is a neighbor, and an entry that matches one is one the bucket
// read finds); at most kExceptions of them, held two a lane. Every other
// entry takes f = 1/q. The product is weigh's, w * f rounded once. So the
// staged form picks what pick picks, bit for bit.

constexpr int kExceptions = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: entries [lo, hi) of rows (E entries) into buf, whose entry 0
// is entry lo & ~1 (16-byte aligned copies); the copy completes on `bar`.
// An odd last entry of the table is stored by hand.
__device__ __forceinline__ void stage_issue(int2* buf, unsigned long long* bar,
                                            const int2* __restrict__ rows,
                                            int E, int lo, int hi) {
  const int a = lo & ~1;
  int b = (hi + 1) & ~1;
  int tail = -1;
  if (b > E) {
    b -= 2;
    tail = b;
  }
  const uint32_t bytes = static_cast<uint32_t>(b - a) * 8u;
  const uint32_t bs = smem_addr(bar);
  // the block's reads of the buffer (generic proxy) come before the copy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bs), "r"(bytes) : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf)), "l"(rows + a), "r"(bytes), "r"(bs)
        : "memory");
  if (tail >= 0) buf[tail - a] = rows[tail];
}

__device__ __forceinline__ void stage_wait(unsigned long long* bar,
                                           uint32_t parity) {
  const uint32_t bs = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(bs), "r"(parity) : "memory");
  } while (!done);
}

// A group's shared memory (carved by the caller).
template <typename T>
struct GroupShared {
  int2* stage[2];            // kChunk + 2 entries each, 16-byte aligned
  unsigned long long* bar;   // two mbarriers, one a buffer
  int* exc_pos;              // [warps][kExceptions]: a request's exceptions
  T* exc_f;                  // [warps][kExceptions]: their factors
};

// A request's exceptions for the sparse weighing (see above), two a lane:
// (position in the row, factor), position -1 where none. Returns false
// (and none) where prev has more than kSlots bucket slots or the row more
// than kExceptions such entries.
template <typename T, int kSlots>
__device__ bool exceptions(const int2* __restrict__ row, int d, Prev pv,
                           const int4* __restrict__ buckets,
                           T inv_p, int lane, int* pos, T* fac, int2& ep,
                           T& ef0, T& ef1) {
  ep = make_int2(-1, -1);
  const int slots = 4 * (pv.bucket_mask + 1);
  if (slots > kSlots) return false;
  int count = 0;
  for (int s0 = 0; s0 <= slots; s0 += 32) {
    const int slot = s0 + lane;
    int key = -1;
    T f = T(1);
    if (slot < slots) {
      const int4 b4 = __ldg(&buckets[pv.bucket_base + (slot >> 2)]);
      const int k = slot & 3;
      key = k == 0 ? b4.x : k == 1 ? b4.y : k == 2 ? b4.z : b4.w;
      if (key == pv.id) key = -1;   // prev's entries take 1/p, below
    } else if (slot == slots) {
      key = pv.id;
      f = inv_p;
    }
    int lo = 0, n = 0;
    if (key >= 0) {
      int hi = d;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(&row[mid].x) < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      while (lo + n < d && __ldg(&row[lo + n].x) == key) ++n;
    }
    int at = n;   // inclusive scan of the counts over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, at, o);
      if (lane >= o) at += y;
    }
    const int total = __shfl_sync(kFull, at, 31);
    if (count + total > kExceptions) return false;
    for (int k = 0; k < n; ++k) {
      pos[count + at - n + k] = lo + k;
      fac[count + at - n + k] = f;
    }
    count += total;
  }
  __syncwarp();
  if (lane < count) {
    ep.x = pos[lane];
    ef0 = fac[lane];
  }
  if (lane + 32 < count) {
    ep.y = pos[lane + 32];
    ef1 = fac[lane + 32];
  }
  __syncwarp();
  return true;
}

// Weight of the lane's entry e (row position at), a piece of 32 at row
// positions [at0, at0 + 32): weigh's, or with the request's exceptions
// (sparse) w * 1/q but at an exception's position w * its factor. The
// whole warp calls it.
template <typename T, bool kSecond>
__device__ __forceinline__ T group_weight(int2 e, bool in, int at0, int lane,
                                          bool sparse, int2 ep, T ef0, T ef1,
                                          const Prev& pv,
                                          const int4* __restrict__ buckets,
                                          T inv_p, T inv_q) {
  if (!kSecond || !sparse)
    return in ? weigh<T, kSecond>(e, pv, buckets, inv_p, inv_q) : T(0);
  T f = inv_q;
  unsigned hit = __ballot_sync(kFull, ep.x >= at0 && ep.x < at0 + 32);
  while (hit) {
    const int j = __ffs(hit) - 1;
    hit &= hit - 1;
    const int p = __shfl_sync(kFull, ep.x, j);
    const T fj = __shfl_sync(kFull, ef0, j);
    if (lane == p - at0) f = fj;
  }
  hit = __ballot_sync(kFull, ep.y >= at0 && ep.y < at0 + 32);
  while (hit) {
    const int j = __ffs(hit) - 1;
    hit &= hit - 1;
    const int p = __shfl_sync(kFull, ep.y, j);
    const T fj = __shfl_sync(kFull, ef1, j);
    if (lane == p - at0) f = fj;
  }
  return in ? Ops<T>::mul(static_cast<T>(__int_as_float(e.y)), f) : T(0);
}

// The staged pick of a group at the row [s, s + d) of rows (E entries): a
// warp a request (has: the warp holds one: its output index req, bias
// inputs pv, uniform u); dst[req] gets the picked entry's column (the row
// head where none crosses). All kThreads threads of the block call it;
// `parity` is the buffers' mbarrier phases, carried from group to group.
template <typename T, bool kSecond, int kChunk, int kThreads, int kSlots>
__device__ void pick_group(const int2* __restrict__ rows, int E, int s, int d,
                           bool has, int req, Prev pv, T u,
                           const int4* __restrict__ buckets, T inv_p, T inv_q,
                           int* __restrict__ dst, const GroupShared<T>& sm,
                           uint32_t& parity) {
  static_assert(kChunk % 32 == 0, "a chunk holds whole pieces");
  using O = Ops<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (d + kChunk - 1) / kChunk;
  const int2* row = rows + s;
  // the chunk sequence: the total pass's nch, then the find pass's
  auto issue = [&](int p) {
    const int c = p < nch ? p : p - nch;
    stage_issue(sm.stage[p & 1], sm.bar + (p & 1), rows, E, s + c * kChunk,
                s + min(c * kChunk + kChunk, d));
  };
  if (tid == 0) {
    issue(0);
    issue(1);   // nch >= 1: the second is the find pass's first at worst
  }
  int2 ep = make_int2(-1, -1);
  T ef0 = T(0), ef1 = T(0);
  bool sparse = false;
  if (kSecond && has)
    sparse = exceptions<T, kSlots>(row, d, pv, buckets, inv_p, lane,
                                   sm.exc_pos + warp * kExceptions,
                                   sm.exc_f + warp * kExceptions, ep, ef0,
                                   ef1);
  T acc = T(0), thresh = T(0), cum = T(0);
  bool looking = has;
  int out = -1;
  int p = 0;   // position in the chunk sequence
  for (;; ++p) {
    const int b = p & 1;
    stage_wait(sm.bar + b, (parity >> b) & 1u);
    parity ^= 1u << b;
    const bool find = p >= nch;
    const int c0 = (find ? p - nch : p) * kChunk;
    const int n = min(kChunk, d - c0);
    const int2* ent = sm.stage[b] + ((s + c0) & 1);
    if (!find && has) {
      for (int base = 0; base < n; base += 32) {
        const int e = base + lane;
        const T v = group_weight<T, kSecond>(
            e < n ? ent[e] : make_int2(0, 0), e < n, c0 + base, lane, sparse,
            ep, ef0, ef1, pv, buckets, inv_p, inv_q);
        if (e < n) acc = O::add(acc, v);
      }
      if (p == nch - 1) thresh = O::mul(u, butterfly(acc));
    } else if (find && looking) {
      for (int base = 0; base < n; base += 32) {
        const int e = base + lane;
        const T v = piece_scan(
            group_weight<T, kSecond>(e < n ? ent[e] : make_int2(0, 0), e < n,
                                     c0 + base, lane, sparse, ep, ef0, ef1,
                                     pv, buckets, inv_p, inv_q),
            lane);
        const T cv = O::add(cum, v);
        const unsigned hit = __ballot_sync(kFull, e < n && cv >= thresh);
        if (hit) {
          out = ent[base + __ffs(hit) - 1].x;
          looking = false;
          break;
        }
        cum = __shfl_sync(kFull, cv, 31);
      }
    }
    // the buffer is free once every warp is done with it; the find pass
    // ends with the group's last crossing or the row
    const bool more = __syncthreads_or(looking) && p + 1 < 2 * nch;
    if (!more) {
      // the copy in flight lands before the buffers are used again
      if (p + 1 < 2 * nch) {
        stage_wait(sm.bar + (b ^ 1), (parity >> (b ^ 1)) & 1u);
        parity ^= 1u << (b ^ 1);
      }
      break;
    }
    if (tid == 0 && p + 2 < 2 * nch) issue(p + 2);
  }
  if (has && lane == 0) dst[req] = looking ? row[0].x : out;
  __syncthreads();
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
constexpr int kGroup = 8;               // a heavy group: a warp a request
static_assert(kGroup * 32 == kCdfServeThreads, "a warp a request");
constexpr int kStageEntries = 2048;     // a chunk of a heavy row staged
constexpr int kMaxHeavy = 1024;         // rows of a shard's heavy table
constexpr int kSparseSlots = 128;       // prev's bucket slots, sparse weighs
// the CDF serve's workspace: counters, the heavy rows' counts and bases,
// then kWorkInts ints a request (light and heavy records, keys, order)
constexpr int kWorkHead = 3084;
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
  int segments;        // > 0: m / segments requests a bucket, prefix filled
  int* work;           // kWorkHead + kWorkInts * cap ints, counters at 0
  int cap;
  uint32_t k0, k1, round_offset;
  int t, first, W_pad, W_total;
};

// The workspace's parts.
struct CdfWork {
  int* ctr;        // [0] light requests, [1] heavy, [2] next group, [3] next
                   // light request
  int* count;      // [kMaxHeavy]: requests at each heavy row
  int* row_base;   // [kMaxHeavy + 1]: their first place in `order`
  int* grp_base;   // [kMaxHeavy + 1]: each row's first group
  int4* light;     // [2 cap]: the light requests' records
  int4* heavy;     // [2 cap]: the heavy requests' records
  int2* key;       // [cap]: a heavy record's (row rank, place at its row)
  int* order;      // [cap]: heavy records by row
};

__device__ __forceinline__ CdfWork cdf_work(int* w, int cap) {
  static_assert(8 + kMaxHeavy + 2 * (kMaxHeavy + 1) <= kWorkHead &&
                    kWorkHead % 4 == 0,
                "the workspace's head");
  static_assert(kWorkInts == 8 + 8 + 2 + 1, "a request's ints");
  CdfWork k;
  k.ctr = w;
  k.count = w + 8;
  k.row_base = k.count + kMaxHeavy;
  k.grp_base = k.row_base + kMaxHeavy + 1;
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

// Exclusive scan of one int2 a thread over a block of kCdfServeThreads;
// *total gets the sums.
__device__ __forceinline__ int2 block_scan2(int2 v, int2* total) {
  constexpr int kWarps = kCdfServeThreads / 32;
  __shared__ int2 warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yx = __shfl_up_sync(0xffffffffu, x.x, o);
    const int yy = __shfl_up_sync(0xffffffffu, x.y, o);
    if (lane >= o) {
      x.x += yx;
      x.y += yy;
    }
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int2 before = make_int2(0, 0), all = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) {
      before.x += s.x;
      before.y += s.y;
    }
    all.x += s.x;
    all.y += s.y;
  }
  __syncthreads();
  *total = all;
  return make_int2(before.x + x.x - v.x, before.y + x.y - v.y);
}

// Dynamic shared memory of the chunked form: the two stage buffers and
// the warps' exception lists; (b)'s row and group bases share it.
template <typename T>
constexpr size_t cdf_group_smem() {
  constexpr size_t stage = ((kStageEntries + 2) * 8 + 15) / 16 * 16;
  constexpr size_t group =
      2 * stage + kGroup * kExceptions * (sizeof(int) + sizeof(T));
  constexpr size_t bases = 2 * (kMaxHeavy + 1) * sizeof(int);
  return group > bases ? group : bases;
}

// The CDF serve: (a) classify, (b) the heavy rows' bases and order, (c)
// the heavy groups, (d) the light requests (see the note at the top).
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
  __shared__ __align__(8) unsigned long long bars[2];
  __shared__ int s_next;
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

  // (b) every block: the heavy rows' request and group bases
  const int n_light = w.ctr[0], n_heavy_req = w.ctr[1];
  int* rbase = reinterpret_cast<int*>(dyn);
  int* gbase = rbase + nh + 1;
  constexpr int kPer = (kMaxHeavy + kCdfServeThreads - 1) / kCdfServeThreads;
  int2 mine = make_int2(0, 0), cnt[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int h = tid * kPer + k;
    const int c = h < nh ? w.count[h] : 0;
    cnt[k] = make_int2(c, (c + kGroup - 1) / kGroup);
    mine.x += cnt[k].x;
    mine.y += cnt[k].y;
  }
  int2 total;
  int2 run = block_scan2(mine, &total);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int h = tid * kPer + k;
    if (h < nh) {
      rbase[h] = run.x;
      gbase[h] = run.y;
    }
    run.x += cnt[k].x;
    run.y += cnt[k].y;
  }
  if (tid == 0) {
    rbase[nh] = total.x;
    gbase[nh] = total.y;
  }
  __syncthreads();
  const int n_groups = total.y;
  if (blockIdx.x == 0) {
    for (int h = tid; h <= nh; h += kCdfServeThreads) {
      w.row_base[h] = rbase[h];
      w.grp_base[h] = gbase[h];
    }
    if (tid == 0) w.ctr[2] = w.ctr[3] = 0;
  }
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

  // (c) the heavy groups, heaviest rows first, a warp a request
  if constexpr (kChunked) {
    if (n_groups > 0) {
      constexpr size_t kStage = ((kStageEntries + 2) * 8 + 15) / 16 * 16;
      GroupShared<T> sm;
      sm.stage[0] = reinterpret_cast<int2*>(dyn);
      sm.stage[1] = reinterpret_cast<int2*>(dyn + kStage);
      sm.exc_f = reinterpret_cast<T*>(dyn + 2 * kStage);
      sm.exc_pos = reinterpret_cast<int*>(sm.exc_f + kGroup * kExceptions);
      sm.bar = bars;
      if (tid == 0) {
        const uint32_t b0 = smem_addr(bars), b1 = smem_addr(bars + 1);
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b0)
                     : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b1)
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncthreads();
      uint32_t parity = 0;
      const int warp = tid >> 5;
      for (;;) {
        if (tid == 0) s_next = atomicAdd(w.ctr + 2, 1);
        __syncthreads();
        const int g = s_next;
        __syncthreads();
        if (g >= n_groups) break;
        // the group's row: the last with grp_base <= g
        int lo = 0, hi = nh;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (w.grp_base[mid] <= g)
            lo = mid;
          else
            hi = mid;
        }
        const int first = w.row_base[lo] + (g - w.grp_base[lo]) * kGroup;
        const int gn = min(kGroup, w.row_base[lo + 1] - first);
        const bool has = warp < gn;
        const int q = w.order[first + (has ? warp : 0)];
        const int4 ra = w.heavy[2 * (size_t)q];
        const int4 rb = w.heavy[2 * (size_t)q + 1];
        const Prev pv{ra.w, rb.x, rb.y};
        if (a.first)
          pick_group<T, false, kStageEntries, kCdfServeThreads, kSparseSlots>(
              a.rows, a.E, ra.y, ra.z, has, ra.x, pv, u_of<T>(rb), a.buckets,
              inv_p, inv_q, a.dst, sm, parity);
        else
          pick_group<T, true, kStageEntries, kCdfServeThreads, kSparseSlots>(
              a.rows, a.E, ra.y, ra.z, has, ra.x, pv, u_of<T>(rb), a.buckets,
              inv_p, inv_q, a.dst, sm, parity);
      }
    }
  }

  // (d) the light requests, a warp each
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(w.ctr + 3, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n_light) break;
    const int4 ra = w.light[2 * (size_t)k], rb = w.light[2 * (size_t)k + 1];
    const T u = u_of<T>(rb);
    const Prev pv{ra.w, rb.x, rb.y};
    const int j =
        a.first ? pick<T, kChunked, false>(a.rows, ra.y, ra.z, u, pv,
                                           a.buckets, inv_p, inv_q, lane)
                : pick<T, kChunked, true>(a.rows, ra.y, ra.z, u, pv,
                                          a.buckets, inv_p, inv_q, lane);
    if (lane == 0) a.dst[ra.x] = a.rows[ra.y + max(j, 0)].x;
  }
}

// Blocks of the CDF serve's cooperative grid: as many as the card holds
// at once, at most a warp a request.
template <typename T, bool kChunked>
cudaError_t launch_cdf_serve(const CdfServe& a, double inv_p, double inv_q,
                             cudaStream_t stream) {
  constexpr size_t smem = kChunked ? cdf_group_smem<T>()
                                   : 2 * (kMaxHeavy + 1) * sizeof(int);
  static int resident = 0;
  auto kernel = shard_cdf_serve_kernel<T, kChunked>;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
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
  if (m > cap || n_heavy < 0 || n_heavy > kMaxHeavy || segments < 0 ||
      segments > kMaxDevices || (segments > 0 && (gid == nullptr ||
                                                  m % segments != 0)))
    return (int)cudaErrorInvalidValue;
  const CdfServe a{cur, prev, gid, stride, valid, gid_base, m, dst,
                   Route{route, route_mode, S, rbits}, my,
                   reinterpret_cast<const int4*>(halo), halo_nb, glob2loc,
                   reinterpret_cast<const int4*>(vmeta),
                   reinterpret_cast<const int2*>(rows), E,
                   reinterpret_cast<const int4*>(buckets), heavy, n_heavy,
                   segments, work, cap, k0, k1, round_offset, t, first, W_pad,
                   W_total};
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
