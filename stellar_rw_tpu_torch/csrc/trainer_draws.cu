// The skip-gram trainer's per-block random draws for a chunk of blocks:
// each block's dynamic windows and its negatives, bit for bit the streams of
// jax.random (sm_90a).
//
// Replaces what XLA lowers inside the JAX package's epoch scan
// (stellar_rw_tpu/models/word2vec.py:500-548): for block i,
// kb = fold_in(key, i) and
//   cwin = randint(kb, (B, T), 1, w + 1)              (word2vec.py:116),
//     two bit streams from fold_in(kb, 0) and fold_in(kb, 1) reduced modulo
//     the span as jax/_src/random.py::_randint does in uint32;
//   negs = _draw_negatives(fold_in(kb, 2), shape, keep, alias)
//                                                      (word2vec.py:146-151),
//     u1 = uniform(kn), u2 = uniform(fold_in(kn, 1)),
//     j = min(int(u1 * n), n - 1), pick j if u2 < keep[j] else alias[j].
// Element e of a stream is threefry of (its key, e) for the row-major flat
// index e (threefry.cuh), so every element is drawn by its own thread with
// no order between them.
//
// What bounds it: two threefry blocks an element (about 83 integer
// operations each) against 4 bytes written an element and the alias
// table's reads (8 bytes a vocabulary row, from L2 after the first): the
// operations, by some 20x. A block's four stream keys are made once a
// thread block, by four threads, and shared through shared memory, not once
// an element; each thread draws kPerThread elements of one block.

#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ uint2 fold(uint2 k, uint32_t d) {
  return srw::threefry(k.x, k.y, 0u, d);
}

__device__ __forceinline__ uint32_t bits_at(uint2 k, uint32_t idx) {
  const uint2 o = srw::threefry(k.x, k.y, 0u, idx);
  return o.x ^ o.y;
}

// blockIdx.y (and on in steps of gridDim.y): block c0 + y of the epoch;
// blockIdx.x: a run of elements of its cwin [BT] followed by its negs [M]
__global__ void __launch_bounds__(kThreads)
    trainer_draws(const long long* __restrict__ key, int c0, int n, int BT,
                  int M, uint32_t span, const float* __restrict__ keep,
                  const int* __restrict__ alias, int n_vocab,
                  int* __restrict__ cwin, int* __restrict__ negs) {
  __shared__ uint2 keys[4];  // fold_in(kb, 0), (kb, 1), kn, fold_in(kn, 1)
  // randint's multiplier: (2^16 mod span)^2 mod span, in uint32
  const uint32_t m16 = 65536u % span;
  const uint32_t mult = (m16 * m16) % span;
  const float fn = static_cast<float>(n_vocab);
  const long long total = static_cast<long long>(BT) + M;
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kPerThread;
  for (int y = blockIdx.y; y < n; y += gridDim.y) {
    __syncthreads();           // the previous block's keys are read
    if (threadIdx.x < 4) {
      const uint2 k = make_uint2(static_cast<uint32_t>(key[0]),
                                 static_cast<uint32_t>(key[1]));
      const uint2 kb = fold(k, static_cast<uint32_t>(c0 + y));
      const int t = threadIdx.x;
      keys[t] = t < 3 ? fold(kb, static_cast<uint32_t>(t))
                      : fold(fold(kb, 2u), 1u);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long e = base + u * kThreads + threadIdx.x;
      if (e >= total) break;
      if (e < BT) {
        const uint32_t i = static_cast<uint32_t>(e);
        const uint32_t hi = bits_at(keys[0], i), lo = bits_at(keys[1], i);
        const uint32_t off = ((hi % span) * mult + lo % span) % span;
        cwin[static_cast<long long>(y) * BT + e] = 1 + static_cast<int>(off);
      } else {
        const uint32_t i = static_cast<uint32_t>(e - BT);
        const float u1 = __uint_as_float((bits_at(keys[2], i) >> 9) |
                                         0x3F800000u) - 1.0f;
        const float u2 = __uint_as_float((bits_at(keys[3], i) >> 9) |
                                         0x3F800000u) - 1.0f;
        const int j = min(static_cast<int>(__fmul_rn(u1, fn)), n_vocab - 1);
        negs[static_cast<long long>(y) * M + i] = u2 < keep[j] ? j : alias[j];
      }
    }
  }
}

}  // namespace

// Draws of blocks c0 .. c0 + n - 1 of the epoch key `key` (two int64 words
// on the device, each a uint32): cwin i32 [n, BT] in [1, window] and negs
// i32 [n, M] from the alias table (keep f32 [n_vocab], alias i32
// [n_vocab]). Returns the CUDA error of the launch.
extern "C" int srw_trainer_draws_launch(const void* key, int c0, int n,
                                        int BT, int M, int window,
                                        const void* keep, const void* alias,
                                        int n_vocab, void* cwin, void* negs,
                                        void* stream) {
  if (n <= 0 || BT + static_cast<long long>(M) <= 0) return 0;
  if (window < 1 || n_vocab < 1 || BT < 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(BT) + M;
  const long long per = static_cast<long long>(kThreads) * kPerThread;
  const dim3 grid(static_cast<unsigned>((total + per - 1) / per),
                  static_cast<unsigned>(n < 65535 ? n : 65535));
  trainer_draws<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), c0, n, BT, M,
      static_cast<uint32_t>(window), static_cast<const float*>(keep),
      static_cast<const int*>(alias), n_vocab, static_cast<int*>(cwin),
      static_cast<int*>(negs));
  return static_cast<int>(cudaGetLastError());
}
