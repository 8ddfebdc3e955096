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
// The row scan (pick, pick_bits) is cdf_pick.cuh's, which shard_walk.cu's
// CDF serve compiles too.
//
// What bounds it: the row entries scanned, sum over steps of deg(cur),
// each read twice (the total, then the find pass up to the crossing): 8
// bytes of (col, weight) and, for a second-order step, the membership of
// the entry in the previous vertex's neighbor set. On power-law graphs a
// hub's row is tens of thousands of entries; one warp a walker keeps a hub
// step to deg/32 turns of coalesced reads instead of one thread's deg
// serial reads stalling its warp, and the find pass stops at the first
// crossing.
//
// The membership: a second-order step of the chunked form at a row of
// kBitmapMinEntries entries or more, whose previous vertex has no more
// bucket rows than the row has entries, reads it from the warp's bitmap of
// the graph's vertices in shared memory (a bit an entry, pick_bits) where
// the bucket form reads a 16-byte bucket row an entry in each pass. The
// bitmap lives for the whole walk: zeroed once, marked from prev's bucket
// keys before such a step (mark_neighbors) and cleared after it by the
// same keys (clear_neighbors) or, where the bitmap has fewer than
// kClearByWords words a bucket row of prev, word by word: a step pays at
// most nb(prev) bucket rows twice. First-order steps and steps under the
// gate take pick's bucket branch.
//
// One body (walk) runs both forms: cdf_walk_bitmap_kernel, launched where
// the wrapper passes words > 0, with the bitmap branch, and
// cdf_walk_kernel, the bucket form alone (V past kBitmapWords words, the
// padded form, or no row that reaches the gate). The bitmap form's 32
// registers come from __launch_bounds__ (8 blocks an SM, as the bucket
// form has): the bitmap branch would take 40 and 6 blocks, 7% slower; the
// bucket form under that cap ran 6% slower on short rows. Bitmaps past 768
// words leave fewer than 8 blocks an SM (1,024 words: 6 blocks, slower
// than the bucket form).
//
// Each kernel has a recording instantiation (kRecord, the chunked form
// only) that also writes which branch each second-order step took, for
// the checks that hold the gate to its mirror; the walks launch the other.

#include <cstdint>

#include <cuda_runtime.h>

#include "cdf_pick.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;             // 8 walkers a block
constexpr int kBitmapWords = 768;         // a warp's bitmap: V <= 24,576
constexpr int kBitmapMinEntries = 1024;   // rows whose steps read it
// a step clears by zeroing every word where the words are fewer than this
// many times prev's bucket rows, else by prev's keys
constexpr int kClearByWords = 4;
// the bitmap form's blocks an SM: 32 registers, the bucket form's
// occupancy (the bitmap branch took it to 40, 6 blocks); at kBitmapWords
// words the bitmaps of 8 blocks take 192 KB of an SM's shared memory
constexpr int kBitmapBlocks = 8;
// a block's bitmaps fit the 48 KB a launch gets without opting in
static_assert(kThreads / 32 * kBitmapWords * sizeof(unsigned) <= 48 * 1024,
              "a block's bitmaps past 48 KB of shared memory");
// what the recording form writes for a second-order step
constexpr unsigned char kByBuckets = 1, kByBitmap = 2;

// Zeroes the warp's bitmap of `words` words.
__device__ __forceinline__ void zero_bitmap(unsigned* bm, int words,
                                            int lane) {
  __syncwarp();   // the lanes' reads of the bitmap are done
  for (int k = lane; k < words; k += 32) bm[k] = 0u;
  __syncwarp();
}

// One walker's walk by the calling warp. kBitmap (chunked only): bm, the
// warp's bitmap of `words` words, and the bitmap branch; without it the
// walk is the bucket form alone. kRecord: branch[walker][t + 1] is
// kByBitmap or kByBuckets for each second-order step t.
template <typename T, bool kChunked, bool kBitmap, bool kRecord>
__device__ __forceinline__ void walk(const int* __restrict__ starts,
                                     const int4* __restrict__ vmeta,
                                     const int2* __restrict__ rows,
                                     const int4* __restrict__ buckets,
                                     int* __restrict__ out,
                                     unsigned char* __restrict__ branch,
                                     int W, int N, int L, unsigned* bm,
                                     int words,
                                     uint32_t k0, uint32_t k1,
                                     uint32_t round_offset, T inv_p,
                                     T inv_q) {
  const int walker = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (walker >= N) return;  // a whole warp leaves together
  if (kBitmap) zero_bitmap(bm, words, lane);
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
    int j;
    const bool by_bits =
        kBitmap && cm.y >= kBitmapMinEntries && pv.bucket_mask < cm.y;
    if (by_bits) {
      mark_neighbors(pv, buckets, bm, lane);
      j = pick_bits<T>(rows, cm.x, cm.y, u, prev, bm, inv_p, inv_q, lane);
      if (words < kClearByWords * (pv.bucket_mask + 1))
        zero_bitmap(bm, words, lane);
      else
        clear_neighbors(pv, buckets, bm, lane);
    } else {
      j = pick<T, kChunked, true>(rows, cm.x, cm.y, u, pv, buckets, inv_p,
                                  inv_q, lane);
    }
    const int dst = rows[cm.x + max(j, 0)].x;
    if (lane == 0) corpus[t + 1] = dst;
    if (kRecord && lane == 0)
      branch[static_cast<size_t>(walker) * (L + 2) + t + 1] =
          by_bits ? kByBitmap : kByBuckets;
    prev = cur;
    pm = cm;
    cur = dst;
  }
}

// The bucket form: the padded form, V past the bitmap, or no row that
// reaches the gate.
template <typename T, bool kChunked, bool kRecord>
__global__ void __launch_bounds__(kThreads)
    cdf_walk_kernel(const int* __restrict__ starts,
                    const int4* __restrict__ vmeta,
                    const int2* __restrict__ rows,
                    const int4* __restrict__ buckets, int* __restrict__ out,
                    unsigned char* __restrict__ branch, int W, int N, int L,
                    uint32_t k0, uint32_t k1, uint32_t round_offset, T inv_p,
                    T inv_q) {
  walk<T, kChunked, false, kRecord>(starts, vmeta, rows, buckets, out,
                                    branch, W, N, L, nullptr, 0, k0, k1,
                                    round_offset, inv_p, inv_q);
}

// The bitmap form (chunked): a warp's bitmap of `words` words a walker in
// dynamic shared memory.
template <typename T, bool kRecord>
__global__ void __launch_bounds__(kThreads, kBitmapBlocks)
    cdf_walk_bitmap_kernel(const int* __restrict__ starts,
                           const int4* __restrict__ vmeta,
                           const int2* __restrict__ rows,
                           const int4* __restrict__ buckets,
                           int* __restrict__ out,
                           unsigned char* __restrict__ branch, int W, int N,
                           int L, int words, uint32_t k0, uint32_t k1,
                           uint32_t round_offset, T inv_p, T inv_q) {
  extern __shared__ unsigned bits[];
  walk<T, true, true, kRecord>(starts, vmeta, rows, buckets, out, branch, W,
                               N, L, bits + (threadIdx.x >> 5) * words,
                               words, k0, k1, round_offset, inv_p, inv_q);
}

template <typename T, bool kChunked, bool kRecord>
cudaError_t launch(const void* starts, const void* vmeta, const void* rows,
                   const void* buckets, void* out, void* branch, int W,
                   int N, int L, int words, uint32_t k0, uint32_t k1,
                   uint32_t round_offset, double inv_p, double inv_q,
                   cudaStream_t stream) {
  const long long threads = static_cast<long long>(N) * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto s = static_cast<const int*>(starts);
  const auto vm = static_cast<const int4*>(vmeta);
  const auto rw = static_cast<const int2*>(rows);
  const auto bk = static_cast<const int4*>(buckets);
  const auto o = static_cast<int*>(out);
  const auto br = static_cast<unsigned char*>(branch);
  if (kChunked && words > 0) {
    const size_t smem = static_cast<size_t>(kThreads / 32) * words *
                        sizeof(unsigned);
    cdf_walk_bitmap_kernel<T, kRecord><<<blocks, kThreads, smem, stream>>>(
        s, vm, rw, bk, o, br, W, N, L, words, k0, k1, round_offset,
        static_cast<T>(inv_p), static_cast<T>(inv_q));
  } else {
    cdf_walk_kernel<T, kChunked, kRecord><<<blocks, kThreads, 0, stream>>>(
        s, vm, rw, bk, o, br, W, N, L, k0, k1, round_offset,
        static_cast<T>(inv_p), static_cast<T>(inv_q));
  }
  return cudaGetLastError();
}

// The padded form, or the chunked form, recording where branch is given.
template <typename T>
cudaError_t dispatch(const void* starts, const void* vmeta, const void* rows,
                     const void* buckets, void* out, void* branch, int W,
                     int N, int L, int words, uint32_t k0, uint32_t k1,
                     uint32_t round_offset, double inv_p, double inv_q,
                     bool chunked, cudaStream_t stream) {
  if (!chunked)
    return launch<T, false, false>(starts, vmeta, rows, buckets, out,
                                   nullptr, W, N, L, 0, k0, k1, round_offset,
                                   inv_p, inv_q, stream);
  if (branch)
    return launch<T, true, true>(starts, vmeta, rows, buckets, out, branch,
                                 W, N, L, words, k0, k1, round_offset, inv_p,
                                 inv_q, stream);
  return launch<T, true, false>(starts, vmeta, rows, buckets, out, nullptr,
                                W, N, L, words, k0, k1, round_offset, inv_p,
                                inv_q, stream);
}

}  // namespace

// R = N / W rounds of walks from starts[W] into out[N, L + 2] (row r*W + w
// is round r of walker w). inv_p, inv_q come rounded to the accumulation
// type (f32: the f32 quotients, exact in a double). words: a warp's bitmap
// of the graph's vertices, ceil(V / 32) words for the chunked form where
// that is at most kBitmapWords, else 0 (the bucket rows throughout).
// branch (the chunked form; null for the walks): u8 [N, L + 2], zeroed by
// the caller, gets kByBitmap or kByBuckets at column t + 1 for each
// second-order step t. Returns the CUDA error of the launch.
extern "C" int srw_cdf_walk_launch(const void* starts, const void* vmeta,
                                   const void* rows, const void* buckets,
                                   void* out, void* branch, int W, int N,
                                   int L, int words, unsigned k0, unsigned k1,
                                   unsigned round_offset, double inv_p,
                                   double inv_q, int chunked, int f64,
                                   void* stream) {
  if (N <= 0) return 0;
  if (words < 0 || words > kBitmapWords || (words > 0 && !chunked) ||
      (branch && !chunked))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? dispatch<double>(starts, vmeta, rows, buckets, out, branch, W, N,
                             L, words, k0, k1, round_offset, inv_p, inv_q,
                             chunked != 0, s)
          : dispatch<float>(starts, vmeta, rows, buckets, out, branch, W, N,
                            L, words, k0, k1, round_offset, inv_p, inv_q,
                            chunked != 0, s));
}
