// The rate of mma.sync.m16n8k8 with TF32 operands on this card, with no
// memory traffic: the ceiling of csrc/sgns_shared.cu's products, which run
// three of these for each 16 x 8 x 8 step (3xTF32). Built on its own by
// chip_sgns_parts.py (ops/_build.py's nvcc flags) and timed with CUDA
// events: each warp runs `chains` independent accumulators through `iters`
// rounds, so the issue rate, not the latency of a chain, is what is read
// when chains are many.
//
//   srw_mma_probe(blocks, threads, chains, iters, out, stream)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS>
__global__ void mma_probe(float* out, int iters) {
  const uint32_t x = __float_as_uint(1.f + threadIdx.x * 1e-3f);
  const uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  const uint32_t b[2] = {x ^ 4u, x ^ 5u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_tf32(c[j], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1234.5f) out[0] = s;   // keeps the products; never true
}

}  // namespace

extern "C" int srw_mma_probe(int blocks, int threads, int chains, int iters,
                             float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1: mma_probe<1><<<blocks, threads, 0, s>>>(out, iters); break;
    case 2: mma_probe<2><<<blocks, threads, 0, s>>>(out, iters); break;
    case 4: mma_probe<4><<<blocks, threads, 0, s>>>(out, iters); break;
    case 8: mma_probe<8><<<blocks, threads, 0, s>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
