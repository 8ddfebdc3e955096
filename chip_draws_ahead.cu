// The trainer draws kernel in persistent blocks that make the next item's
// stream keys ahead: a design of csrc/trainer_draws.cu that measured slower
// than one run a thread block (PERF.md, section 6). Not a kernel of the
// port: chip_draws_parts.py appends this file to a copy of
// stellar_rw_tpu_torch/csrc/trainer_draws.cu under build/ and builds the
// two together, so it draws with that source's Span, mod_span and
// bits_at, and is held bit for bit to trainer_draws_ref like the kernel.
//
// A block takes items blockIdx.x, + gridDim.x, ... of the chunk's n * runs
// (block, run) items. Four lanes of the last warp make the next item's four
// keys into the other half of a double buffer while the block draws this
// item's elements, so only a block's first item waits on its keys.

namespace {

// Stream key t of epoch block i: fold_in(kb, 0), (kb, 1), kn = (kb, 2) and
// fold_in(kn, 1), kb = fold_in(key, i), each key a chain of its own
__device__ __forceinline__ uint2 stream_key(const long long* key, uint32_t i,
                                            int t) {
  const uint2 kb = srw::threefry(static_cast<uint32_t>(key[0]),
                                 static_cast<uint32_t>(key[1]), 0u, i);
  const uint2 k = srw::threefry(kb.x, kb.y, 0u, t < 3 ? t : 2u);
  return t < 3 ? k : srw::threefry(k.x, k.y, 0u, 1u);
}

__global__ void __launch_bounds__(kThreads)
    trainer_draws_ahead(const long long* __restrict__ key, int c0, int BT,
                        int M, int runs, int per, int items, Span sp,
                        uint32_t one, const float* __restrict__ keep,
                        const int* __restrict__ alias, int n_vocab,
                        int* __restrict__ cwin, int* __restrict__ negs) {
  __shared__ uint2 ahead[2][4];
  const float fn = static_cast<float>(n_vocab);
  const long long total = static_cast<long long>(BT) + M;
  const int maker = static_cast<int>(threadIdx.x) - (kThreads - 4);
  if (maker >= 0 && static_cast<int>(blockIdx.x) < items)
    ahead[0][maker] = stream_key(
        key, static_cast<uint32_t>(c0 + blockIdx.x / runs), maker);
  int b = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, b ^= 1) {
    const int y = item / runs;
    __syncthreads();   // ahead[b] made, ahead[b ^ 1] read
    const int next = item + gridDim.x;
    if (maker >= 0 && next < items)
      ahead[b ^ 1][maker] = stream_key(
          key, static_cast<uint32_t>(c0 + next / runs), maker);
    const uint2 kh = ahead[b][0], kl = ahead[b][1], kn = ahead[b][2],
                kn1 = ahead[b][3];
    const long long base =
        static_cast<long long>(item - y * runs) * per * kThreads;
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
}

}  // namespace

// srw_trainer_draws_launch's arguments and `blocks`, the persistent thread
// blocks over the n * runs items (at most n * runs are launched).
extern "C" int srw_trainer_draws_ahead_launch(
    const void* key, int c0, int n, int BT, int M, int window,
    unsigned magic, int sh1, int sh2, int runs, int per, int blocks,
    const void* keep, const void* alias, int n_vocab, void* cwin,
    void* negs, void* stream) {
  const long long total = static_cast<long long>(BT) + M;
  if (n <= 0 || total <= 0) return 0;
  if (window < 1 || n_vocab < 1 || BT < 0 || M < 0 || runs < 1 || per < 1 ||
      per > kPerThread || blocks < 1 || sh1 < 0 || sh1 > 1 || sh2 < 0 ||
      sh2 > 31 ||
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
  const int items = n * runs;
  trainer_draws_ahead<<<blocks < items ? blocks : items, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), c0, BT, M, runs, per, items, sp, 1u,
      static_cast<const float*>(keep), static_cast<const int*>(alias),
      n_vocab, static_cast<int*>(cwin), static_cast<int*>(negs));
  return static_cast<int>(cudaGetLastError());
}
