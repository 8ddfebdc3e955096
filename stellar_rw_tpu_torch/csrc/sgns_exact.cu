// One exact-negative SGNS step (skip-gram, k negatives a pair), in two
// kernels.
//
// Replaces the JAX package's _sgns_apply over _pairs_for_block
// (stellar_rw_tpu/models/word2vec.py:154-210, 60-94), which XLA lowers to
// gathers of P = B*T*2w pair rows and (1 + k) target rows, two einsums and
// two scatter-adds: at B = 32, T = 82, w = 10, k = 5, D = 128 a step builds
// a [52,480, 6, 128] f32 target tensor (161 MB) and its gradient.
//
//   (a) sgns_exact_grads: one warp a center position (b, t). It walks the
//       2w offsets and, for each valid pair, the context and its k
//       negatives, D spread over the lanes (NV floats each). A logit is a
//       warp reduction, g = (sigmoid - label); the center's gradient sums
//       in registers and goes out as one atomic row per position, each
//       target's g * vi as an atomic row into a delta table, with its
//       count. The first touch of a row flags it and appends it to a list.
//       The tables are only read: every gradient comes from the tables as
//       they were before the step, as in the functional JAX step.
//   (b) sgns_exact_apply: over the touched rows only (the list length is
//       read on the device: no host sync), w += (-lr * delta) / max(cnt, 1),
//       then delta, count and flag back to zero for the next step.
//
// The pair enumeration, dynamic window and negatives are the JAX package's
// (the block, its window draws cwin and the negative draws come in). Sums
// run in another order than JAX's (a warp reduction for the logit; atomics
// in no fixed order; the scatter-mean as sum-then-divide instead of
// divide-then-sum), so a step agrees with it to rounding, not bit for bit.
//
// What bounds it: the rows it moves. A step reads each valid pair's 1 + k
// target rows and adds as many gradient rows (about 2 * 4 * D bytes a
// target, in L2 when the tables fit there), and 2 * P * (1 + k) * D * 3
// flops (logit, center gradient, target gradient). The apply pass moves
// only the touched rows, so no pass over the whole [V, D] table happens,
// however large the vocabulary.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // center positions a block

__device__ __forceinline__ void mark(int* flag, int* list, int* count,
                                     int row) {
  if (atomicCAS(&flag[row], 0, 1) == 0) list[atomicAdd(count, 1)] = row;
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    sgns_exact_grads(const float* __restrict__ w_in,
                     const float* __restrict__ w_out,
                     const int* __restrict__ block,
                     const int* __restrict__ cwin,
                     const int* __restrict__ negs, float* d_in, float* d_out,
                     int* cnt_in, int* cnt_out, int* flag_in, int* flag_out,
                     int* list_in, int* list_out, int* counts, int BT, int T,
                     int window, int k, int D) {
  const int pos = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pos >= BT) return;  // a whole warp leaves together
  const int center = block[pos];
  if (center < 0) return;
  const int t = pos % T;
  const int row0 = pos - t;  // the walk's first position
  const int win = cwin[pos];
  float vi[NV], dvi[NV];
  const float* src = w_in + static_cast<size_t>(center) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    vi[j] = c < D ? src[c] : 0.f;
    dvi[j] = 0.f;
  }
  int nvalid = 0;
  for (int o = 0; o < 2 * window; ++o) {
    const int off = o < window ? o - window : o - window + 1;
    if (abs(off) > win) continue;
    const int tc = t + off;
    if (tc < 0 || tc >= T) continue;
    const int ctx = block[row0 + tc];
    if (ctx < 0) continue;
    ++nvalid;
    const int* ng = negs + (static_cast<size_t>(pos) * 2 * window + o) * k;
    for (int j = 0; j <= k; ++j) {
      const int tgt = j == 0 ? ctx : ng[j - 1];
      const float* vrow = w_out + static_cast<size_t>(tgt) * D;
      float vo[NV];
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int c = lane + 32 * m;
        vo[m] = c < D ? vrow[c] : 0.f;
        dot = fmaf(vi[m], vo[m], dot);
      }
      for (int s = 16; s; s >>= 1) dot += __shfl_xor_sync(kFull, dot, s);
      const float g = 1.f / (1.f + expf(-dot)) - (j == 0 ? 1.f : 0.f);
      float* drow = d_out + static_cast<size_t>(tgt) * D;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int c = lane + 32 * m;
        dvi[m] = fmaf(g, vo[m], dvi[m]);
        if (c < D) atomicAdd(&drow[c], g * vi[m]);
      }
      if (lane == 0) {
        atomicAdd(&cnt_out[tgt], 1);
        mark(flag_out, list_out, &counts[1], tgt);
      }
    }
  }
  if (nvalid == 0) return;
  float* drow = d_in + static_cast<size_t>(center) * D;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = lane + 32 * m;
    if (c < D) atomicAdd(&drow[c], dvi[m]);
  }
  if (lane == 0) {
    atomicAdd(&cnt_in[center], nvalid);
    mark(flag_in, list_in, &counts[0], center);
  }
}

__global__ void __launch_bounds__(256)
    sgns_exact_apply(float* w_in, float* w_out, float* d_in, float* d_out,
                     int* cnt_in, int* cnt_out, int* flag_in, int* flag_out,
                     const int* __restrict__ list_in,
                     const int* __restrict__ list_out,
                     const int* __restrict__ counts, int D, float lr) {
  const int n_in = counts[0];
  const int n = n_in + counts[1];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       item < n; item += warps) {
    const bool in = item < n_in;
    const int row = in ? list_in[item] : list_out[item - n_in];
    float* w = (in ? w_in : w_out) + static_cast<size_t>(row) * D;
    float* d = (in ? d_in : d_out) + static_cast<size_t>(row) * D;
    int* cnt = in ? cnt_in : cnt_out;
    const float c = static_cast<float>(max(cnt[row], 1));
    for (int i = lane; i < D; i += 32) {
      w[i] += (-lr * d[i]) / c;
      d[i] = 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      cnt[row] = 0;
      (in ? flag_in : flag_out)[row] = 0;
    }
  }
}

template <int NV>
cudaError_t launch_grads(void* const* p, int BT, int T, int window, int k,
                         int D, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((BT + kWarps - 1) / kWarps);
  sgns_exact_grads<NV><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
      static_cast<const int*>(p[4]), static_cast<float*>(p[5]),
      static_cast<float*>(p[6]), static_cast<int*>(p[7]),
      static_cast<int*>(p[8]), static_cast<int*>(p[9]),
      static_cast<int*>(p[10]), static_cast<int*>(p[11]),
      static_cast<int*>(p[12]), static_cast<int*>(p[13]), BT, T, window, k,
      D);
  return cudaGetLastError();
}

}  // namespace

// Kernel (a) for one block of B*T center positions: zeroes the two list
// lengths, then launches. D <= 512. Returns the CUDA error.
extern "C" int srw_sgns_exact_grads_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, void* d_in, void* d_out, void* cnt_in, void* cnt_out,
    void* flag_in, void* flag_out, void* list_in, void* list_out,
    void* counts, int BT, int T, int window, int k, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess || BT <= 0) return static_cast<int>(err);
  void* const p[] = {const_cast<void*>(w_in), const_cast<void*>(w_out),
                     const_cast<void*>(block), const_cast<void*>(cwin),
                     const_cast<void*>(negs), d_in, d_out, cnt_in, cnt_out,
                     flag_in, flag_out, list_in, list_out, counts};
  const int nv = (D + 31) / 32;
  if (nv <= 1) err = launch_grads<1>(p, BT, T, window, k, D, s);
  else if (nv <= 2) err = launch_grads<2>(p, BT, T, window, k, D, s);
  else if (nv <= 4) err = launch_grads<4>(p, BT, T, window, k, D, s);
  else if (nv <= 8) err = launch_grads<8>(p, BT, T, window, k, D, s);
  else if (nv <= 16) err = launch_grads<16>(p, BT, T, window, k, D, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Kernel (b): `blocks` blocks of 8 warps stride over the touched rows.
extern "C" int srw_sgns_exact_apply_launch(
    void* w_in, void* w_out, void* d_in, void* d_out, void* cnt_in,
    void* cnt_out, void* flag_in, void* flag_out, const void* list_in,
    const void* list_out, const void* counts, int D, int blocks, float lr,
    void* stream) {
  sgns_exact_apply<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w_in), static_cast<float*>(w_out),
      static_cast<float*>(d_in), static_cast<float*>(d_out),
      static_cast<int*>(cnt_in), static_cast<int*>(cnt_out),
      static_cast<int*>(flag_in), static_cast<int*>(flag_out),
      static_cast<const int*>(list_in), static_cast<const int*>(list_out),
      static_cast<const int*>(counts), D, lr);
  return static_cast<int>(cudaGetLastError());
}
