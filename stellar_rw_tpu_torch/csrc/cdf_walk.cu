// Whole node2vec walks by the exact inverse CDF, one warp a walker.
//
// Replaces the JAX package's exact-CDF walk (stellar_rw_tpu/walk/engine.py,
// walk_corpus's cdf branch, :226-275, over ops/sampling.py:361-518:
// cdf_sample_first_order / _second_order and their _chunked forms), which
// XLA lowers to padded gathers or a while loop of chunk-wide slices. Here a
// warp runs one walk: the first-order draw, then walk_length second-order
// steps, its lanes striding the current vertex's row.
//
//   * u for step t of round r, walker w, is element w of
//     uniform(fold_in(fold_in(seed_key, round_offset + r), t), (W,)) in the
//     accumulation type (f64: the 64-bit threefry word);
//   * b = w * f with f = 1/p for the previous vertex, 1 for a neighbor of
//     it (the bucket tables), 1/q otherwise; first-order b = w;
//   * padded form: the first entry whose running sum of b / total reaches u;
//     chunked form: the first whose running sum of b reaches u * total. If
//     none does, the row head. Dead walkers write -1 from then on.
//
// The sums run in the order of the plain version (ops/sampling.py): padded
// left to right, entry by entry (a serial broadcast over the lanes); chunked
// as lane sums joined by a butterfly, and a Kogge-Stone scan of each
// 32-entry piece added to the running sum. Every product, sum and quotient
// is rounded on its own (__fmul_rn and kin: no FMA contraction), so the
// kernel equals the plain version bit for bit on any input.
//
// What bounds it: the row entries scanned, sum over steps of deg(cur),
// each read twice (the total, then the find pass up to the crossing): 8
// bytes of (col, weight) and, for a second-order step, a 16-byte bucket
// row of the previous vertex's neighbor set. On power-law graphs a hub's
// row is tens of thousands of entries; one warp a walker keeps a hub step
// to deg/32 turns of coalesced reads instead of one thread's deg serial
// reads stalling its warp, and the find pass stops at the first crossing.

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
    for (int off = 16; off; off >>= 1)
      acc = O::add(acc, __shfl_xor_sync(kFull, acc, off));
    const T thresh = O::mul(u, acc);
    T cum = T(0);
    for (int base = 0; base < d; base += 32) {
      const int i = base + lane;
      T v =
          i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p, inv_q) : T(0);
      for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v = O::add(v, y);
      }
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

template <typename T, bool kChunked>
__global__ void __launch_bounds__(256)
    cdf_walk_kernel(const int* __restrict__ starts,
                    const int4* __restrict__ vmeta,
                    const int2* __restrict__ rows,
                    const int4* __restrict__ buckets, int* __restrict__ out,
                    int W, int N, int L, uint32_t k0, uint32_t k1,
                    uint32_t round_offset, T inv_p, T inv_q) {
  const int walker = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (walker >= N) return;  // a whole warp leaves together
  const int r = walker / W;
  const uint32_t w = static_cast<uint32_t>(walker - r * W);
  const uint2 rk = srw::threefry(k0, k1, 0u, round_offset + r);
  int* corpus = out + static_cast<size_t>(walker) * (L + 2);
  const int start = starts[w];
  int4 pm = vmeta[start];  // (row start, degree, bucket base, nb - 1)
  const Prev none{0, 0, 0};
  int cur = -1;
  if (pm.y > 0) {
    const T u = Ops<T>::draw(srw::threefry(rk.x, rk.y, 0u, 0u), w);
    const int j = pick<T, kChunked, false>(rows, pm.x, pm.y, u, none,
                                           buckets, inv_p, inv_q, lane);
    cur = rows[pm.x + max(j, 0)].x;
  }
  if (lane == 0) {
    corpus[0] = start;
    corpus[1] = cur;
  }
  int prev = start;
  for (int t = 1; t <= L; ++t) {
    const int4 cm = cur >= 0 ? vmeta[cur] : make_int4(0, 0, 0, 0);
    if (cm.y <= 0) {  // dead: -1 from here on
      for (int c = t + 1 + lane; c < L + 2; c += 32) corpus[c] = -1;
      return;
    }
    const T u = Ops<T>::draw(
        srw::threefry(rk.x, rk.y, 0u, static_cast<uint32_t>(t)), w);
    const Prev pv{prev, pm.z, pm.w};
    const int j = pick<T, kChunked, true>(rows, cm.x, cm.y, u, pv, buckets,
                                          inv_p, inv_q, lane);
    const int dst = rows[cm.x + max(j, 0)].x;
    if (lane == 0) corpus[t + 1] = dst;
    prev = cur;
    pm = cm;
    cur = dst;
  }
}

template <typename T, bool kChunked>
cudaError_t launch(const void* starts, const void* vmeta, const void* rows,
                   const void* buckets, void* out, int W, int N, int L,
                   uint32_t k0, uint32_t k1, uint32_t round_offset,
                   double inv_p, double inv_q, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 walkers a block
  const long long threads = static_cast<long long>(N) * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cdf_walk_kernel<T, kChunked><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(starts), static_cast<const int4*>(vmeta),
      static_cast<const int2*>(rows), static_cast<const int4*>(buckets),
      static_cast<int*>(out), W, N, L, k0, k1, round_offset,
      static_cast<T>(inv_p), static_cast<T>(inv_q));
  return cudaGetLastError();
}

}  // namespace

// R = N / W rounds of walks from starts[W] into out[N, L + 2] (row r*W + w
// is round r of walker w). inv_p, inv_q come rounded to the accumulation
// type (f32: the f32 quotients, exact in a double). Returns the CUDA error
// of the launch.
extern "C" int srw_cdf_walk_launch(const void* starts, const void* vmeta,
                                   const void* rows, const void* buckets,
                                   void* out, int W, int N, int L,
                                   unsigned k0, unsigned k1,
                                   unsigned round_offset, double inv_p,
                                   double inv_q, int chunked, int f64,
                                   void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f64)
    err = chunked ? launch<double, true>(starts, vmeta, rows, buckets, out, W,
                                         N, L, k0, k1, round_offset, inv_p,
                                         inv_q, s)
                  : launch<double, false>(starts, vmeta, rows, buckets, out,
                                          W, N, L, k0, k1, round_offset,
                                          inv_p, inv_q, s);
  else
    err = chunked ? launch<float, true>(starts, vmeta, rows, buckets, out, W,
                                        N, L, k0, k1, round_offset, inv_p,
                                        inv_q, s)
                  : launch<float, false>(starts, vmeta, rows, buckets, out, W,
                                         N, L, k0, k1, round_offset, inv_p,
                                         inv_q, s);
  return static_cast<int>(err);
}
