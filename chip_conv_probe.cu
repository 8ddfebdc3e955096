// The gather-and-store probe of the conv step's accumulate kernel
// (csrc/sgns_conv.cu, sgns_conv_accumulate): the card's own floor for that
// kernel's traffic and launch on a block [B, T]. Each position's ein and
// eout rows are gathered once by token (no halo, zero at padding) and
// written as the kernel's three outputs, with no arithmetic: ein as ein,
// the eout row as acc_in, the ein row again as acc_out; and the kB
// negatives' rows of w_out are copied to wn. A thread four columns of a
// (position, table row) item, 16-byte loads and stores (D % 4 == 0), a
// grid-stride loop over the items, blocks of 256 threads.
//
// Built by chip_conv_parts.py from this file alone; the entry point is
// srw_conv_probe_launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
    conv_gather_store_probe(const float* __restrict__ w_in,
                            const float* __restrict__ w_out,
                            const int* __restrict__ block,
                            const int* __restrict__ negs, int kB, int N,
                            int D, float* __restrict__ ein,
                            float* __restrict__ acc_in,
                            float* __restrict__ acc_out,
                            float* __restrict__ wn) {
  const int G = D / 4;
  const long long items = static_cast<long long>(N + kB) * G;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < items; i += stride) {
    const int p = static_cast<int>(i / G);
    const int c = static_cast<int>(i - static_cast<long long>(p) * G) * 4;
    if (p < N) {
      const int t = block[p];
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (t >= 0) {
        const size_t o = static_cast<size_t>(t) * D + c;
        a = __ldg(reinterpret_cast<const float4*>(w_in + o));
        b = __ldg(reinterpret_cast<const float4*>(w_out + o));
      }
      const size_t e = static_cast<size_t>(p) * D + c;
      *reinterpret_cast<float4*>(ein + e) = a;
      *reinterpret_cast<float4*>(acc_in + e) = b;
      *reinterpret_cast<float4*>(acc_out + e) = a;
    } else {
      const int n = p - N;
      *reinterpret_cast<float4*>(wn + static_cast<size_t>(n) * D + c) =
          __ldg(reinterpret_cast<const float4*>(
              w_out + static_cast<size_t>(negs[n]) * D + c));
    }
  }
}

}  // namespace

// The probe on a block of N positions (block [N]) with kB negatives at dim
// D (a multiple of 4, the tables 16-byte aligned), `blocks` blocks of 256
// threads; outputs ein, acc_in, acc_out [N, D] and wn [kB, D]. Returns the
// CUDA error of the launch.
extern "C" int srw_conv_probe_launch(const void* w_in, const void* w_out,
                                     const void* block, const void* negs,
                                     int kB, int N, int D, void* ein,
                                     void* acc_in, void* acc_out, void* wn,
                                     int blocks, void* stream) {
  if (N < 0 || kB < 0 || D < 4 || D % 4 != 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  conv_gather_store_probe<<<blocks, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_in), static_cast<const float*>(w_out),
      static_cast<const int*>(block), static_cast<const int*>(negs), kB, N, D,
      static_cast<float*>(ein), static_cast<float*>(acc_in),
      static_cast<float*>(acc_out), static_cast<float*>(wn));
  return static_cast<int>(cudaGetLastError());
}
