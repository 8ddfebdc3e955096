// The scatter in accumulate mode with runs of positions: a design that
// measured slower than a position a thread at walk_10k's slot block on the
// H100 (PERF.md, section 6), kept for chip_conv_parts.py, which appends
// this file to stellar_rw_tpu_torch/csrc/sgns_conv.cu and launches it
// through srw_sgns_conv_scatter_accumulate_runs_launch. A thread takes four
// columns of a run of `run` positions of one table (in `order` where one is
// given, the block's positions sorted by token by
// ops/sgns_conv.py::group_blocks; else in position order), loads the rows
// of the positions that count, all in flight, sums consecutive positions of
// one token in registers and adds once a token (one 16-byte vector
// reduction) with their counts. The negatives as in sgns_conv.cu's kernel
// (c). The same function as kernel (c), summed in another order.

namespace {

constexpr int kRunMax = 8;   // positions a run at most

__global__ void __launch_bounds__(kThreads)
    sgns_conv_scatter_accumulate_runs(
        const int* __restrict__ block, const int* __restrict__ order,
        const float* __restrict__ d_in, const float* __restrict__ acc_out,
        const int* __restrict__ cnt, const float* __restrict__ d_wn,
        const int* __restrict__ negs, int kB, const int* __restrict__ valid,
        int nvalid, float neg_weight, int N, int D, int run,
        float* acc_in_buf, float* acc_out_buf, float* cnt_in_buf,
        float* cnt_out_buf) {
  __shared__ int s_total;
  const int G = (D + 3) / 4;              // a thread's four columns
  const int neg_items = kB * G;   // the launch checks that items fit an int
  const int items = neg_items + (N + run - 1) / run * 2 * G;
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(d_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_wn) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_in_buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_out_buf) % 16 == 0;
  const int first = blockIdx.x * blockDim.x;
  const int stride = gridDim.x * blockDim.x;
  float cnt_n = 1.f, scale = 0.f;
  if (first < neg_items) {   // uniform in the block: it holds a negative
    int v = 0;
    for (int i = threadIdx.x; i < nvalid; i += blockDim.x) v += valid[i];
    v = warp_sum(v);
    if (threadIdx.x == 0) s_total = 0;
    __syncthreads();
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&s_total, v);
    __syncthreads();
    const float vsum = static_cast<float>(s_total) * neg_weight;
    cnt_n = fmaxf(vsum, 1.f);
    scale = vsum / cnt_n;
  }
  for (int i = first + threadIdx.x; i < items; i += stride) {
    if (i < neg_items) {
      const int n = i / G, c = 4 * (i - n * G);
      float4 g = load4<false>(d_wn + static_cast<size_t>(n) * D, c, D, vec);
      g.x *= scale, g.y *= scale, g.z *= scale, g.w *= scale;
      const int row = negs[n];
      add4(acc_out_buf + static_cast<size_t>(row) * D, c, D, g, vec);
      if (c == 0) atomicAdd(cnt_out_buf + row, cnt_n);
      continue;
    }
    const int r = i - neg_items, rest = r / G, c = 4 * (r - rest * G);
    const int t = rest & 1, p0 = (rest >> 1) * run;
    const int m = min(run, N - p0);
    const float* src = t ? acc_out : d_in;
    const int* c_t = cnt + static_cast<size_t>(t) * N;
    float* acc = t ? acc_out_buf : acc_in_buf;
    float* cnt_buf = t ? cnt_out_buf : cnt_in_buf;
    // the run's tokens and counts, then the rows of the positions that
    // count, all loads in flight before the first add
    int pos[kRunMax], tok[kRunMax], num[kRunMax];
    float4 v[kRunMax];
#pragma unroll
    for (int j = 0; j < kRunMax; ++j) {
      pos[j] = tok[j] = -1, num[j] = 0;
      if (j >= m) continue;
      pos[j] = order ? order[p0 + j] : p0 + j;
      tok[j] = block[pos[j]];
      num[j] = tok[j] >= 0 ? c_t[pos[j]] : 0;
    }
#pragma unroll
    for (int j = 0; j < kRunMax; ++j)
      v[j] = num[j] ? load4<false>(src + static_cast<size_t>(pos[j]) * D, c,
                                   D, vec)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    // consecutive positions of one token summed, one add a token
    int cur = -1, total = 0;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    const auto flush = [&]() {
      add4(acc + static_cast<size_t>(cur) * D, c, D, sum, vec);
      if (c == 0) atomicAdd(cnt_buf + cur, static_cast<float>(total));
    };
#pragma unroll
    for (int j = 0; j < kRunMax; ++j) {
      if (num[j] == 0) continue;
      if (tok[j] != cur) {
        if (cur >= 0) flush();
        cur = tok[j], total = 0, sum = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      total += num[j];
      sum.x += v[j].x, sum.y += v[j].y, sum.z += v[j].z, sum.w += v[j].w;
    }
    if (cur >= 0) flush();
  }
}

}  // namespace

// `blocks` blocks of kThreads over the kB * ceil(D / 4) negatives' threads
// and the ceil(N / run) * 2 * ceil(D / 4) runs' threads; order [N] or null
// (position order); run in 1..kRunMax; the other arguments as
// srw_sgns_conv_scatter_accumulate_launch's. Returns the CUDA error of the
// launch.
extern "C" int srw_sgns_conv_scatter_accumulate_runs_launch(
    const void* block, const void* order, const void* d_in,
    const void* acc_out, const void* cnt, const void* d_wn, const void* negs,
    int kB, const void* valid, int nvalid, float neg_weight, int N, int D,
    int run, int blocks, void* acc_in_buf, void* acc_out_buf,
    void* cnt_in_buf, void* cnt_out_buf, void* stream) {
  if (N + kB <= 0 || D <= 0) return 0;
  const long long G = (D + 3) / 4;
  if (run < 1 || run > kRunMax || blocks < 1 || kB < 0 || N < 0 ||
      (kB + (N + run - 1LL) / run * 2) * G +
          static_cast<long long>(blocks) * kThreads > INT_MAX ||
      !acc_in_buf || !acc_out_buf || !cnt_in_buf || !cnt_out_buf)
    return static_cast<int>(cudaErrorInvalidValue);
  sgns_conv_scatter_accumulate_runs<<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block), static_cast<const int*>(order),
      static_cast<const float*>(d_in), static_cast<const float*>(acc_out),
      static_cast<const int*>(cnt), static_cast<const float*>(d_wn),
      static_cast<const int*>(negs), kB, static_cast<const int*>(valid),
      nvalid, neg_weight, N, D, run, static_cast<float*>(acc_in_buf),
      static_cast<float*>(acc_out_buf), static_cast<float*>(cnt_in_buf),
      static_cast<float*>(cnt_out_buf));
  return static_cast<int>(cudaGetLastError());
}
