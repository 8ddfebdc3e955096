// K7's row scan as __device__ code: the exact inverse-CDF pick over one
// row by a warp, shared by cdf_walk.cu's cdf_walk_kernel (whole walks, a
// warp a walker) and shard_walk.cu's shard_cdf_serve (one step of a
// request on its owner shard, a warp a request), so that both compile
// the same text and pick the same entry. Beside it pick_bits, the chunked
// second-order pick with prev's neighbor set read from a bitmap, which both
// run where the graph's vertices fit one: the same butterfly and piece
// scan, and weigh's product, so the two round alike.
//
// The semantics and the summation order are cdf_walk.cu's note: padded
// form left to right, entry by entry; chunked form as lane sums joined by a
// butterfly and a Kogge-Stone scan of each 32-entry piece; every product,
// sum and quotient rounded on its own (_rn intrinsics, no FMA
// contraction). Build without --use_fast_math.
//
// The definitions sit in an unnamed namespace: each source that includes
// the header gets its own copy, as it had when they were cdf_walk.cu's.

#pragma once

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
// bitmap of the graph's vertices, zeroed and set from the keys of prev's
// bucket rows before the pick (a key sits only in its own bucket, so the
// keys of prev's rows are its neighbor set, and a bit is set exactly where
// the bucket read finds the entry). The weight is weigh's,
// w * f rounded once, and the sums are pick's, in pick's order: the
// butterfly and the piece scan are the same text. So pick_bits picks what
// pick picks, bit for bit.

// Sets the bits of prev's neighbors in the warp's zeroed bitmap bm: the
// keys of its bucket rows, a row a lane at a time.
__device__ __forceinline__ void mark_neighbors(const Prev& pv,
                                               const int4* __restrict__ buckets,
                                               unsigned* bm, int lane) {
  for (int b = lane; b <= pv.bucket_mask; b += 32) {
    const int4 k = __ldg(&buckets[pv.bucket_base + b]);
    const int keys[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keys[j] >= 0) atomicOr(&bm[keys[j] >> 5], 1u << (keys[j] & 31));
  }
  __syncwarp();
}

// Zeroes the bitmap again after a pick by mark_neighbors's bits: the word
// of each key of prev's bucket rows is stored 0 (every set bit came from
// these keys), nb(prev) rows where zeroing the whole bitmap is V/32 words.
__device__ __forceinline__ void clear_neighbors(
    const Prev& pv, const int4* __restrict__ buckets, unsigned* bm,
    int lane) {
  __syncwarp();   // the lanes' reads of the bitmap are done
  for (int b = lane; b <= pv.bucket_mask; b += 32) {
    const int4 k = __ldg(&buckets[pv.bucket_base + b]);
    const int keys[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keys[j] >= 0) bm[keys[j] >> 5] = 0u;
  }
  __syncwarp();   // no lane marks the next step's bits before the clear
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
