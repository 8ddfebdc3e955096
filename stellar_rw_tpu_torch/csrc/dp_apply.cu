// The data-parallel trainer's merged update (sm_90a): every row of both
// tables moves by lr times the mean of the gradients that the update's
// slots summed into the reduction buffer, and the buffer is left empty.
//
// Replaces the tail of the JAX package's psum-merged steps
// (stellar_rw_tpu/models/word2vec.py:200-201 in _sgns_apply, :485-486 in
// _sgns_apply_shared_conv), which XLA lowers to a dense pass over [V, D]:
//   w_in  = w_in  - lr * acc_in  / max(cnt_in, 1)[:, None]
//   w_out = w_out - lr * acc_out / max(cnt_out, 1)[:, None]
// The reduction buffer comes as its four arrays, acc_in and acc_out [V, D],
// cnt_in and cnt_out [V] (views of one flat tensor: ops/dp_apply.py holds
// the layout), filled by the steps' accumulate modes (sgns_exact.cu,
// sgns_conv.cu) and, across ranks, by one all-reduce.
//
// Each element is computed in the JAX expression's order with one rounding
// an operation, (lr * acc) / max(cnt, 1) and then the difference, by the
// _rn intrinsics (no FMA across the division), so the kernel equals its
// plain version (ops/dp_apply.py::dp_apply_ref) bit for bit. The same pass
// zeroes acc and cnt: the next merged update finds the buffer empty with
// no memset.
//
// What bounds it: bytes. Each of the 2·V·D elements reads acc and w and
// writes w and the zero, 16 bytes, against three flops: at V 10,000, D 128
// 41 MB, 0.012 ms at 3.35 TB/s. A warp takes a row (its count read once by
// lane 0 and shuffled, then zeroed by lane 0 after the shuffle), its
// columns by 16-byte loads where D and the pointers allow, a grid-stride
// loop over the 2·V rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float moved(float w, float a, float lr, float c) {
  return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, a), c));
}

__global__ void __launch_bounds__(kThreads)
    dp_apply(float* __restrict__ w_in, float* __restrict__ w_out,
             float* __restrict__ acc_in, float* __restrict__ acc_out,
             float* __restrict__ cnt_in, float* __restrict__ cnt_out, int V,
             int D, float lr) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_out) % 16 == 0;
  for (int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       r < 2 * V; r += warps) {
    const int t = r < V ? 0 : 1;
    const size_t row = static_cast<size_t>(r - t * V);
    float* w = (t == 0 ? w_in : w_out) + row * D;
    float* a = (t == 0 ? acc_in : acc_out) + row * D;
    float* cnt = (t == 0 ? cnt_in : cnt_out) + row;
    float c = 0.f;
    if (lane == 0) c = *cnt;
    c = fmaxf(__shfl_sync(kFull, c, 0), 1.f);
    if (lane == 0) *cnt = 0.f;
    if (vec) {
      for (int i = 4 * lane; i < D; i += 128) {
        float4 wv = *reinterpret_cast<float4*>(w + i);
        const float4 av = *reinterpret_cast<const float4*>(a + i);
        wv.x = moved(wv.x, av.x, lr, c);
        wv.y = moved(wv.y, av.y, lr, c);
        wv.z = moved(wv.z, av.z, lr, c);
        wv.w = moved(wv.w, av.w, lr, c);
        *reinterpret_cast<float4*>(w + i) = wv;
        *reinterpret_cast<float4*>(a + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = lane; i < D; i += 32) {
        w[i] = moved(w[i], a[i], lr, c);
        a[i] = 0.f;
      }
    }
  }
}

}  // namespace

// The merged update of tables w_in, w_out [V, D] from the reduction
// buffer's acc_in, acc_out [V, D] and cnt_in, cnt_out [V] at learning rate
// lr: `blocks` blocks of kThreads, a warp a row. Returns the CUDA error of
// the launch.
extern "C" int srw_dp_apply_launch(void* w_in, void* w_out, void* acc_in,
                                   void* acc_out, void* cnt_in, void* cnt_out,
                                   int V, int D, float lr, int blocks,
                                   void* stream) {
  if (V <= 0 || D <= 0) return 0;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  dp_apply<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w_in), static_cast<float*>(w_out),
      static_cast<float*>(acc_in), static_cast<float*>(acc_out),
      static_cast<float*>(cnt_in), static_cast<float*>(cnt_out), V, D, lr);
  return static_cast<int>(cudaGetLastError());
}
