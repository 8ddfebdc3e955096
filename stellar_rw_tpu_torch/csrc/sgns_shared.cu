// Shared-negative SGNS gradients, sgns_shared_grads (sm_90a, f32).
//
// Replaces the Pallas kernel stellar_rw_tpu/ops/pallas/sgns.py::
// sgns_shared_grads / _sgns_kernel. Per row p of P and shared negative k:
//   g_neg[p, k] = sigmoid(vi[p] . wn[k]) * mask[p]
//   d_vi[p]     = g_pos[p] * vo[p] + sum_k g_neg[p, k] * wn[k]
//   d_vo[p]     = g_pos[p] * vi[p]
//   d_wn[k]     = sum_p g_neg[p, k] * vi[p]
// The [rows, kB] logit tile never leaves shared memory.
//
// What bounds it on this card: f32 FMA (3 * P * kB * D of them, no TF32: the
// result is held to 1e-5 against a full-f32 product) and the bytes of vi and
// vo, read once. The design, changed from the TPU layout:
//   * a block owns ROWS rows of P at a time and streams wn through shared
//     memory in chunks of KC negatives, so shared memory stays bounded for
//     any kB (wn whole would be 128 KB at kB = 256, D = 128);
//   * TPU grid steps run in order and carry d_wn in their output; Hopper
//     blocks do not, so each block keeps its own d_wn partial [kB, D] in
//     global scratch and a second kernel sums the partials in block order,
//     with no atomics, so d_wn is deterministic;
//   * ragged P, D and kB edges are masked in the kernel, no padding;
//   * shared rows are padded to D + 1 floats so the dot-product reads of a
//     warp fall in distinct banks.
// Plain FMA loops; wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;     // rows of P per tile
constexpr int KC = 32;       // shared negatives per chunk
constexpr int NT = 256;      // threads per block
constexpr int GS = KC + 1;   // row stride of the g tile in shared memory

__global__ void __launch_bounds__(NT)
sgns_shared_kernel(const float* __restrict__ vi, const float* __restrict__ vo,
                   const float* __restrict__ wn,
                   const float* __restrict__ g_pos,
                   const float* __restrict__ mask, float* __restrict__ d_vi,
                   float* __restrict__ d_vo, float* __restrict__ part, int P,
                   int D, int kB) {
  extern __shared__ float sm[];
  const int DS = D + 1;
  float* s_vi = sm;                   // [ROWS, DS]
  float* s_wn = s_vi + ROWS * DS;     // [KC, DS]
  float* s_g = s_wn + KC * DS;        // [ROWS, GS]
  float* s_acc = s_g + ROWS * GS;     // [ROWS, D]
  float* my_part = part + (size_t)blockIdx.x * kB * D;
  const int tid = threadIdx.x;
  bool first_tile = true;
  for (int tile = blockIdx.x; tile * ROWS < P; tile += gridDim.x) {
    const int r0 = tile * ROWS;
    for (int e = tid; e < ROWS * D; e += NT) {
      const int r = e / D, d = e - r * D, p = r0 + r;
      s_vi[r * DS + d] = p < P ? vi[(size_t)p * D + d] : 0.f;
      s_acc[e] = 0.f;
    }
    for (int k0 = 0; k0 < kB; k0 += KC) {
      __syncthreads();  // s_vi ready; previous chunk's readers done
      for (int e = tid; e < KC * D; e += NT) {
        const int k = e / D, d = e - k * D;
        s_wn[k * DS + d] = k0 + k < kB ? wn[(size_t)(k0 + k) * D + d] : 0.f;
      }
      __syncthreads();
      // logits -> g_neg for the [ROWS, KC] tile
      for (int e = tid; e < ROWS * KC; e += NT) {
        const int r = e / KC, k = e - r * KC, p = r0 + r;
        float a = 0.f;
        for (int d = 0; d < D; ++d)
          a = fmaf(s_vi[r * DS + d], s_wn[k * DS + d], a);
        float g = 0.f;
        if (p < P && k0 + k < kB) g = (1.f / (1.f + expf(-a))) * mask[p];
        s_g[r * GS + k] = g;
      }
      __syncthreads();
      // d_vi += g_neg @ wn
      for (int e = tid; e < ROWS * D; e += NT) {
        const int r = e / D, d = e - r * D;
        float a = s_acc[e];
        for (int k = 0; k < KC; ++k)
          a = fmaf(s_g[r * GS + k], s_wn[k * DS + d], a);
        s_acc[e] = a;
      }
      // this block's d_wn partial += g_neg^T @ vi
      for (int e = tid; e < KC * D; e += NT) {
        const int k = e / D, d = e - k * D;
        if (k0 + k >= kB) continue;
        float a = 0.f;
        for (int r = 0; r < ROWS; ++r)
          a = fmaf(s_g[r * GS + k], s_vi[r * DS + d], a);
        float* dst = my_part + (size_t)(k0 + k) * D + d;
        *dst = first_tile ? a : *dst + a;
      }
    }
    __syncthreads();
    for (int e = tid; e < ROWS * D; e += NT) {
      const int r = e / D, d = e - r * D, p = r0 + r;
      if (p < P) {
        const size_t o = (size_t)p * D + d;
        const float gp = g_pos[p];
        d_vi[o] = gp * vo[o] + s_acc[e];
        d_vo[o] = gp * s_vi[r * DS + d];
      }
    }
    first_tile = false;
    __syncthreads();  // s_vi / s_acc are rewritten by the next tile
  }
}

// d_wn[i] = sum over blocks b, in order, of part[b][i]
__global__ void reduce_partials(const float* __restrict__ part,
                                float* __restrict__ d_wn, int nblk, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int b = 0; b < nblk; ++b) a += part[(size_t)b * n + i];
  d_wn[i] = a;
}

}  // namespace

extern "C" int srw_sgns_shared_launch(const float* vi, const float* vo,
                                      const float* wn, const float* g_pos,
                                      const float* mask, float* d_vi,
                                      float* d_vo, float* d_wn, float* part,
                                      int P, int D, int kB, int nblk,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem =
      sizeof(float) * ((size_t)(ROWS + KC) * (D + 1) + ROWS * GS + ROWS * D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (nblk > 0)
    sgns_shared_kernel<<<nblk, NT, smem, s>>>(vi, vo, wn, g_pos, mask, d_vi,
                                              d_vo, part, P, D, kB);
  const int n = kB * D;
  if (n > 0)
    reduce_partials<<<(n + 255) / 256, 256, 0, s>>>(part, d_wn, nblk, n);
  return (int)cudaGetLastError();
}
