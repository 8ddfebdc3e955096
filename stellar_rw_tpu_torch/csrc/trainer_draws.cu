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
// What bounds it: two threefry blocks an element (about 75 integer
// operations each) against 4 bytes written an element and the alias
// table's reads (8 bytes a vocabulary row, from L2 after the first): the
// operations, by some 20x. The integer work is what the design is about
// (each part measured against its absence by chip_draws_parts.py on a
// conv chunk; PERF.md, section 6, has the times):
//   * randint's three reductions modulo the span (the window, known only at
//     run time) are exact divisions by an invariant integer (Granlund and
//     Montgomery: a 32-bit magic multiplier and two shifts, made once a
//     launch on the host by ops/trainer_draws.py::span_magic);
//   * the threefry adds are written y * one + x with one == 1 a kernel
//     argument, so they issue as IMAD on the FMA pipe beside the rotates
//     and xors of the INT32 lanes (block_fn, a copy of threefry.cuh's
//     block; the walk kernels keep theirs). ptxas already moves part of
//     threefry.cuh's adds there: a threefry block with no memory traffic
//     runs 5% faster in this form, not 2x;
//   * a block's elements are cut into runs of the same number of strides
//     (launch_plan: 6 strides of 256, runs of 1,536 and 1,216 elements for
//     a conv block, not 2,048 and 704), one run a thread block;
//   * a thread block's four stream keys (a chain of up to three threefry
//     blocks) are made at its start by warp 0's lanes in turn, five
//     threefry blocks in place of the nine that four threads making a
//     chain each ran, while the other warps wait, which the SM's other
//     blocks hide (the four chains, and persistent blocks that make the
//     next item's keys ahead, measured slower: chip_draws_parts.py).

#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;      // most elements a thread draws an item

// x + y issued as an IMAD: the product by a runtime 1 cannot be folded away
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y,
                                        uint32_t one) {
  return y * one + x;
}

// threefry.cuh's block for the counter (0, c1), bit for bit, its adds
// through add()
__device__ __forceinline__ uint2 block_fn(uint2 k, uint32_t c1,
                                          uint32_t one) {
  const uint32_t k0 = k.x, k1 = k.y;
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0, x1 = add(c1, k1, one);
#define SRW_MIX(r) x0 = add(x0, x1, one); x1 = srw::rotl(x1, r) ^ x0;
  SRW_MIX(13) SRW_MIX(15) SRW_MIX(26) SRW_MIX(6)
  x0 = add(x0, k1, one); x1 = add(x1, ks2 + 1u, one);
  SRW_MIX(17) SRW_MIX(29) SRW_MIX(16) SRW_MIX(24)
  x0 = add(x0, ks2, one); x1 = add(x1, k0 + 2u, one);
  SRW_MIX(13) SRW_MIX(15) SRW_MIX(26) SRW_MIX(6)
  x0 = add(x0, k0, one); x1 = add(x1, k1 + 3u, one);
  SRW_MIX(17) SRW_MIX(29) SRW_MIX(16) SRW_MIX(24)
  x0 = add(x0, k1, one); x1 = add(x1, ks2 + 4u, one);
  SRW_MIX(13) SRW_MIX(15) SRW_MIX(26) SRW_MIX(6)
  x0 = add(x0, ks2, one); x1 = add(x1, k0 + 5u, one);
#undef SRW_MIX
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t bits_at(uint2 k, uint32_t idx,
                                            uint32_t one) {
  const uint2 o = block_fn(k, idx, one);
  return o.x ^ o.y;
}

// randint's span and its reciprocal: v mod span for every uint32 v
struct Span {
  uint32_t span;
  uint32_t mult;     // (2^16 mod span)^2 mod span
  uint32_t magic;    // floor(2^32 (2^l - span) / span) + 1, l = ceil(log2)
  int sh1, sh2;      // min(l, 1), max(l - 1, 0)
};

__device__ __forceinline__ uint32_t mod_span(uint32_t v, const Span& s) {
  const uint32_t t = __umulhi(s.magic, v);
  const uint32_t q = (t + ((v - t) >> s.sh1)) >> s.sh2;
  return v - q * s.span;
}

// The four stream keys of epoch block i, kb = fold_in(key, i): fold_in(kb,
// 0), (kb, 1), kn = (kb, 2) and fold_in(kn, 1), made by warp 0's lanes in
// turn (kb on lane 0, its three fold_ins on lanes 0-2, then lane 3's, each
// handed on by shuffles: five threefry blocks, three deep). Called by the
// whole of warp 0.
__device__ __forceinline__ void make_keys(const long long* key, uint32_t i,
                                          uint2* keys) {
  const uint32_t lane = threadIdx.x;
  uint2 k = make_uint2(0u, 0u);
  if (lane == 0)
    k = srw::threefry(static_cast<uint32_t>(key[0]),
                      static_cast<uint32_t>(key[1]), 0u, i);
  const uint32_t bx = __shfl_sync(0xffffffffu, k.x, 0),
                 by = __shfl_sync(0xffffffffu, k.y, 0);
  if (lane < 3) k = srw::threefry(bx, by, 0u, lane);
  const uint32_t nx = __shfl_sync(0xffffffffu, k.x, 2),
                 ny = __shfl_sync(0xffffffffu, k.y, 2);
  if (lane == 3) k = srw::threefry(nx, ny, 0u, 1u);
  if (lane < 4) keys[lane] = k;
}

// Thread block q = blockIdx.x of the n * runs: epoch block c0 + q / runs,
// and run q % runs of its elements, cwin [BT] followed by negs [M]; a run
// is `per` strides of kThreads elements.
__global__ void __launch_bounds__(kThreads)
    trainer_draws(const long long* __restrict__ key, int c0, int BT, int M,
                  int runs, int per, Span sp, uint32_t one,
                  const float* __restrict__ keep,
                  const int* __restrict__ alias, int n_vocab,
                  int* __restrict__ cwin, int* __restrict__ negs) {
  __shared__ uint2 keys[4];
  const float fn = static_cast<float>(n_vocab);
  const long long total = static_cast<long long>(BT) + M;
  const int y = blockIdx.x / runs;
  if (threadIdx.x < 32) make_keys(key, static_cast<uint32_t>(c0 + y), keys);
  __syncthreads();
  const uint2 kh = keys[0], kl = keys[1], kn = keys[2], kn1 = keys[3];
  const long long base =
      static_cast<long long>(blockIdx.x - y * runs) * per * kThreads;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long e = base + u * kThreads + threadIdx.x;
    if (u >= per || e >= total) break;
    if (e < BT) {
      const uint32_t i = static_cast<uint32_t>(e);
      const uint32_t hi = bits_at(kh, i, one), lo = bits_at(kl, i, one);
      const uint32_t off =
          mod_span(mod_span(hi, sp) * sp.mult + mod_span(lo, sp), sp);
      cwin[static_cast<long long>(y) * BT + e] = 1 + static_cast<int>(off);
    } else {
      const uint32_t i = static_cast<uint32_t>(e - BT);
      const float u1 = __uint_as_float((bits_at(kn, i, one) >> 9) |
                                       0x3F800000u) - 1.0f;
      const float u2 = __uint_as_float((bits_at(kn1, i, one) >> 9) |
                                       0x3F800000u) - 1.0f;
      const int j = min(static_cast<int>(__fmul_rn(u1, fn)), n_vocab - 1);
      negs[static_cast<long long>(y) * M + i] = u2 < keep[j] ? j : alias[j];
    }
  }
}

}  // namespace

// Draws of blocks c0 .. c0 + n - 1 of the epoch key `key` (two int64 words
// on the device, each a uint32): cwin i32 [n, BT] in [1, window] and negs
// i32 [n, M] from the alias table (keep f32 [n_vocab], alias i32
// [n_vocab]). The plan (ops/trainer_draws.py::launch_plan): `runs` runs of
// `per` * kThreads elements a block, one thread block a run; (magic, sh1,
// sh2) the window's reciprocal (span_magic). Returns the CUDA error of the
// launch.
extern "C" int srw_trainer_draws_launch(
    const void* key, int c0, int n, int BT, int M, int window,
    unsigned magic, int sh1, int sh2, int runs, int per, const void* keep,
    const void* alias, int n_vocab, void* cwin, void* negs, void* stream) {
  const long long total = static_cast<long long>(BT) + M;
  if (n <= 0 || total <= 0) return 0;
  if (window < 1 || n_vocab < 1 || BT < 0 || M < 0 || runs < 1 || per < 1 ||
      per > kPerThread || sh1 < 0 || sh1 > 1 || sh2 < 0 || sh2 > 31 ||
      static_cast<long long>(runs) * per * kThreads < total ||
      static_cast<long long>(n) * runs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Span sp;
  sp.span = static_cast<uint32_t>(window);
  const uint32_t m16 = 65536u % sp.span;
  sp.mult = (m16 * m16) % sp.span;
  sp.magic = magic;
  sp.sh1 = sh1;
  sp.sh2 = sh2;
  trainer_draws<<<n * runs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), c0, BT, M, runs, per, sp, 1u,
      static_cast<const float*>(keep), static_cast<const int*>(alias),
      n_vocab, static_cast<int*>(cwin), static_cast<int*>(negs));
  return static_cast<int>(cudaGetLastError());
}
