// The row-stream probe of the exact-CDF walk kernel (csrc/cdf_walk.cu):
// the card's own floor for reading the rows that a corpus's walks scan, in
// the kernel's order and its layout (one warp a walker, blocks of 8 warps),
// with no weighing. For each step t of walker w (cur = corpus[w][t], the
// vertex picked dst = corpus[w][t + 1], until dst is -1) the warp reads
// cur's whole row of (col, weight bits) pairs a lane an entry, as the total
// pass does, then its pieces of 32 again up to the first whose columns hold
// dst, as the find pass does up to its crossing (the first entry of dst in
// the row: on a row with multi-arcs the crossing may lie at a later copy,
// so the probe reads no more than the kernel). The weights are summed as
// integers and written a walker, which keeps the loads alive.
//
// Built by chip_smoke.py (phase 10) and chip_cdf_parts.py from this file
// alone; the entry point is srw_cdf_row_probe_launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 walkers a block, as cdf_walk_kernel

__global__ void __launch_bounds__(kThreads)
    cdf_row_probe(const int* __restrict__ corpus,
                  const int4* __restrict__ vmeta,
                  const int2* __restrict__ rows, unsigned* __restrict__ out,
                  int N, int L) {
  const int walker = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (walker >= N) return;
  const int* walk = corpus + static_cast<size_t>(walker) * (L + 2);
  unsigned acc = 0;
  for (int t = 0; t <= L; ++t) {
    const int cur = walk[t], dst = walk[t + 1];
    if (dst < 0) break;
    const int4 cm = vmeta[cur];
    const int2* row = rows + cm.x;
    const int d = cm.y;
    for (int i = lane; i < d; i += 32) acc += static_cast<unsigned>(row[i].y);
    for (int base = 0; base < d; base += 32) {
      const int i = base + lane;
      const int2 e = i < d ? row[i] : make_int2(-1, 0);
      acc += static_cast<unsigned>(e.y);
      if (__ballot_sync(0xffffffffu, e.x == dst)) break;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (lane == 0) out[walker] = acc;
}

}  // namespace

// corpus i32 [N, L + 2] (as cdf_walk_kernel writes it), vmeta i32 [V, 4],
// rows i32 [E, 2]; out u32 [N]. Returns the CUDA error of the launch.
extern "C" int srw_cdf_row_probe_launch(const void* corpus, const void* vmeta,
                                        const void* rows, void* out, int N,
                                        int L, void* stream) {
  if (N <= 0) return 0;
  const long long threads = static_cast<long long>(N) * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cdf_row_probe<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(corpus), static_cast<const int4*>(vmeta),
      static_cast<const int2*>(rows), static_cast<unsigned*>(out), N, L);
  return static_cast<int>(cudaGetLastError());
}
