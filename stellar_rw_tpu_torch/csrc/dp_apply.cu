// The data-parallel trainer's merged update (sm_90a): every row of both
// tables moves by lr times the mean of the gradients that the update's
// slots summed into the reduction buffer, and the buffer is left empty.
//
// Replaces the tail of the JAX package's psum-merged steps
// (stellar_rw_tpu/models/word2vec.py:200-201 in _sgns_apply, :485-486 in
// _sgns_apply_shared_conv), which XLA lowers to a dense pass over [V, D]:
//   w_in  = w_in  - lr * acc_in  / max(cnt_in, 1)[:, None]
//   w_out = w_out - lr * acc_out / max(cnt_out, 1)[:, None]
// The reduction buffer comes as acc_in and acc_out [V, D] and the counts
// cnt [2V], cnt_in then cnt_out (views of one flat tensor: ops/dp_apply.py
// holds the layout), filled by the steps' accumulate modes (sgns_exact.cu,
// sgns_conv.cu) and, across ranks, by one all-reduce.
//
// A row whose count is 0 has acc exactly 0: every gradient that reaches a
// row comes with a count of at least 1 (a pair's or a negative's), and the
// accumulate modes add nothing where the count is 0. Such a row moves by
// (lr * 0) / 1 = 0, so the kernel leaves it as it is, unread and unwritten:
// it reads the 2·V counts (cnt_in's, then cnt_out's: one array, as the
// buffer holds them) and moves only the rows they mark. The rows are cut
// into sectors of kSector consecutive rows (16 bytes of counts, one load),
// dealt to the grid's warps in turn, so that the touched rows, which crowd
// at the low token ids of a power-law corpus, spread over many warps. A
// lane reads one sector's counts a round, kAhead - 1 rounds ahead of the
// round whose rows move; the warp lists its touched rows in shared memory by
// ballots and moves them kBatch at a time (their acc and w rows by 16-byte
// loads where D and the pointers allow, all in flight before the first
// store), writing each row's new w and the zeros of its acc; the lane that
// read a nonzero count zeroes it. The grid is one wave of resident blocks
// at most (ops/dp_apply.py::launch_plan): at V 10,000 a warp holds two
// sectors, at V 1,000,000 it reads some 190 in rounds of 32.
//
// Each element is computed in the JAX expression's order with one rounding
// an operation, (lr * acc) / max(cnt, 1) and then the difference, by the
// _rn intrinsics (no FMA across the division), so the kernel equals its
// plain version (ops/dp_apply.py::dp_apply_ref) bit for bit on any buffer
// with acc 0 where the count is 0.
//
// What bounds it: bytes. The counts, 8·V bytes, read; a touched row's acc
// and w read and w and the zeros written, 16·D bytes, and its count zeroed:
// at walk_10k's merged update of two slots a few thousand of the 20,000
// rows. Every row touched is the dense pass, 41 MB at V 10,000, D 128.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSector = 4;   // rows a lane's count load covers
constexpr int kBatch = 4;    // touched rows a warp moves at once
// rounds whose counts are in flight: this one's and the next ones'
constexpr int kAhead = 2;
// blocks an SM the registers must allow (ops/dp_apply.py::BLOCKS_PER_SM)
constexpr int kBlocksPerSm = 5;

__device__ __forceinline__ float moved(float w, float a, float lr, float c) {
  return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, a), c));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    dp_apply(float* __restrict__ w_in, float* __restrict__ w_out,
             float* __restrict__ acc_in, float* __restrict__ acc_out,
             float* __restrict__ cnt, int V, int D, float lr) {
  // a warp's touched rows of a round and their counts
  __shared__ int s_row[kWarps][32 * kSector];
  __shared__ float s_cnt[kWarps][32 * kSector];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int warps = gridDim.x * kWarps;
  const int warp = blockIdx.x * kWarps + wb;
  const int R = 2 * V;                       // the rows of both tables
  const int sectors = (R + kSector - 1) / kSector;
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_out) % 16 == 0;
  const bool vec_cnt = reinterpret_cast<uintptr_t>(cnt) % 16 == 0;
  int* rows = s_row[wb];
  float* cnts = s_cnt[wb];
  // this lane's sector of round m (the warp's sectors are warp, warp +
  // warps, ...; round m takes its 32 m-th to 32 m + 31-st), or -1
  const auto sector = [&](int m) -> int {
    const long long sec = warp + (32LL * m + lane) * warps;
    return sec < sectors ? static_cast<int>(sec) : -1;
  };
  const auto read = [&](int sec) {
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    const int q = sec * kSector;
    if (sec < 0) return c;
    if (vec_cnt && q + kSector <= R) {
      c = *reinterpret_cast<const float4*>(cnt + q);
    } else {
      c.x = cnt[q];
      if (q + 1 < R) c.y = cnt[q + 1];
      if (q + 2 < R) c.z = cnt[q + 2];
      if (q + 3 < R) c.w = cnt[q + 3];
    }
    return c;
  };
  const auto w_of = [&](int q) {
    return (q < V ? w_in : w_out) + static_cast<size_t>(q < V ? q : q - V) * D;
  };
  const auto a_of = [&](int q) {
    return (q < V ? acc_in : acc_out) +
           static_cast<size_t>(q < V ? q : q - V) * D;
  };
  int secs[kAhead];
  float4 counts[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) counts[a] = read(secs[a] = sector(a));
  for (int m = 0; warp + 32LL * m * warps < sectors; ++m) {
    const int sec = secs[0];
    const float4 c = counts[0];
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a)
      secs[a] = secs[a + 1], counts[a] = counts[a + 1];
    counts[kAhead - 1] = read(secs[kAhead - 1] = sector(m + kAhead));
    // the touched rows listed in shared memory, their counts zeroed
    const float mine[kSector] = {c.x, c.y, c.z, c.w};
    int n = 0;
#pragma unroll
    for (int k = 0; k < kSector; ++k) {
      const unsigned mask = __ballot_sync(kFull, mine[k] != 0.f);
      if (mine[k] != 0.f) {
        const int at = n + __popc(mask & ((1u << lane) - 1));
        rows[at] = sec * kSector + k;
        cnts[at] = fmaxf(mine[k], 1.f);
        cnt[sec * kSector + k] = 0.f;
      }
      n += __popc(mask);
    }
    __syncwarp();
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      const int nb = min(kBatch, n - j0);
      int row[kBatch];
      float div[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        row[j] = j < nb ? rows[j0 + j] : 0;
        div[j] = j < nb ? cnts[j0 + j] : 1.f;
      }
      if (vec) {
        for (int i = 4 * lane; i < D; i += 128) {
          float4 wv[kBatch], av[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (j >= nb) break;
            wv[j] = *reinterpret_cast<const float4*>(w_of(row[j]) + i);
            av[j] = *reinterpret_cast<const float4*>(a_of(row[j]) + i);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (j >= nb) break;
            wv[j].x = moved(wv[j].x, av[j].x, lr, div[j]);
            wv[j].y = moved(wv[j].y, av[j].y, lr, div[j]);
            wv[j].z = moved(wv[j].z, av[j].z, lr, div[j]);
            wv[j].w = moved(wv[j].w, av[j].w, lr, div[j]);
            *reinterpret_cast<float4*>(w_of(row[j]) + i) = wv[j];
            *reinterpret_cast<float4*>(a_of(row[j]) + i) =
                make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {
        for (int i = lane; i < D; i += 32) {
          float wv[kBatch], av[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (j >= nb) break;
            wv[j] = w_of(row[j])[i];
            av[j] = a_of(row[j])[i];
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (j >= nb) break;
            w_of(row[j])[i] = moved(wv[j], av[j], lr, div[j]);
            a_of(row[j])[i] = 0.f;
          }
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// The merged update of tables w_in, w_out [V, D] from the reduction
// buffer's acc_in, acc_out [V, D] and its counts cnt [2V] (cnt_in, then
// cnt_out) at learning rate lr: `blocks` blocks of kThreads
// (ops/dp_apply.py::launch_plan), the sectors of kSector rows dealt to
// their warps in turn. Returns the CUDA error of the launch.
extern "C" int srw_dp_apply_launch(void* w_in, void* w_out, void* acc_in,
                                   void* acc_out, void* cnt, int V, int D,
                                   float lr, int blocks, void* stream) {
  if (V <= 0 || D <= 0) return 0;
  if (blocks < 1 || V > 0x3fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  dp_apply<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w_in), static_cast<float*>(w_out),
      static_cast<float*>(acc_in), static_cast<float*>(acc_out),
      static_cast<float*>(cnt), V, D, lr);
  return static_cast<int>(cudaGetLastError());
}
