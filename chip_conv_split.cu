// The accumulate kernel as a thread-block cluster a walk that splits the
// columns (form (a) of chip_conv_parts.py, which appends this file to
// stellar_rw_tpu_torch/csrc/sgns_conv.cu and launches it through
// srw_sgns_conv_accumulate_split_launch). The C thread blocks (ranks) of a
// walk's cluster each hold every position of the walk, but only columns
// [rank * span, (rank + 1) * span) of its ein and eout rows (cp.async,
// 16 bytes a copy where D % 4 == 0, rows unpadded): each row is read from
// device memory once, and no rank needs another's rows. A rank's partial
// dots of every pair over its columns: G lanes a position, four columns a
// lane, the partials of G offsets summed over the G lanes by one
// transposed butterfly. The only exchange is the partial dots, T * 2w
// floats a rank: after a cluster barrier rank r sums the pairs it owns (i
// = r, r + C, ...) from every rank's partials in rank order 0..C-1, forms
// g_pos = sigmoid(dot) - 1 on a valid pair (0 elsewhere) and writes it into
// every rank's g (kReduceScatter; false: every rank sums every pair itself,
// in the same order), so every rank holds the same g_pos bit for bit and
// each dot is taken once. After a second barrier no rank touches another's
// shared memory, and each accumulates acc_in and acc_out of its columns:
// a group of G lanes a position, a float4 a lane, stores a slice of a row
// at a time. Rows wider than the shared memory holds go in column slices.
// Its outputs are sgns_conv_accumulate's; `valid` holds a rank's share of
// its walk's valid pairs (the centers t = rank mod C).
#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;      // the portable cluster size
// threads a block: one block an SM at walk_10k's block, so its warps alone
// hide the shared loads' latency
constexpr int kSplitThreads = 512;
constexpr int kSplitWnRegs = 4;     // floats of a negative's row a thread holds
// rank r sums the pairs r, r + C, ... and writes g_pos into every rank;
// false: every rank sums every pair from every rank's partials
constexpr bool kReduceScatter = true;

__device__ __forceinline__ void split_cp_async16(void* dst, const void* src,
                                                 bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void split_cp_async4(void* dst, const void* src,
                                                bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void split_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void split_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 split_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 split_fma4(float g, float4 v, float4 a) {
  return make_float4(fmaf(g, v.x, a.x), fmaf(g, v.y, a.y), fmaf(g, v.z, a.z),
                     fmaf(g, v.w, a.w));
}

// (center t, context x) of a walk's positions is a valid pair
__device__ __forceinline__ bool split_pair_ok(const int* tok, const int* win,
                                              int t, int x, int T) {
  return t >= 0 && t < T && x >= 0 && x < T && tok[t] >= 0 && tok[x] >= 0 &&
         abs(x - t) <= win[t];
}

// The transposed butterfly's steps H, H / 2, ..., 1 over a group of 2H
// lanes: each lane holds the shares s[k] of 2H sums; after the steps s[0]
// of the group's lane r is sum r over the group's lanes.
template <int H, int N>
__device__ __forceinline__ void split_fold(float (&s)[N], int r) {
  const bool up = r & H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? s[k] : s[k + H];
    const float keep = up ? s[k + H] : s[k];
    s[k] = keep + __shfl_xor_sync(kFull, send, H);
  }
  if constexpr (H > 1) split_fold<H / 2>(s, r);
}

// columns [c0, c0 + w) of every position's ein and eout rows into s_in and
// s_out (rows of `cols` floats): zero at padding and beyond w
__device__ void split_gather(float* s_in, float* s_out, const int* s_tok,
                             const float* __restrict__ w_in,
                             const float* __restrict__ w_out, int T, int D,
                             int cols, int c0, int w, bool vec) {
  const int g = vec ? 4 : 1, per = cols / g, n = T * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = i / per, c = (i - t * per) * g;
    const int tok = s_tok[t];
    const bool ok = tok >= 0 && c < w;
    const size_t src = ok ? static_cast<size_t>(tok) * D + c0 + c : 0;
    float* di = s_in + t * cols + c;
    float* dout = s_out + t * cols + c;
    if (vec) {
      split_cp_async16(di, w_in + src, ok);
      split_cp_async16(dout, w_out + src, ok);
    } else {
      split_cp_async4(di, w_in + src, ok);
      split_cp_async4(dout, w_out + src, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int G>
__global__ void __launch_bounds__(kSplitThreads)
    sgns_conv_accumulate_split(const float* __restrict__ w_in,
                               const float* __restrict__ w_out,
                               const int* __restrict__ block,
                               const int* __restrict__ cwin,
                               const int* __restrict__ negs, int kB,
                               ConvOut o, int T, int D, int window, int span,
                               int cols, float neg_weight) {
  constexpr int P = 32 / G;                 // positions a warp at once
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float sm[];
  const int C = gridDim.x;                  // a cluster spans the grid's x
  const int rank = static_cast<int>(cl.block_rank());
  const int W2 = 2 * window, n = T * W2;
  float* s_in = sm;                         // [T, cols] ein, this rank's slice
  float* s_out = s_in + T * cols;           // [T, cols] eout
  float* s_part = s_out + T * cols;         // [T, 2w] partial dots
  float* s_g = s_part + n;                  // [T, 2w] g_pos
  int* s_tok = reinterpret_cast<int*>(s_g + n);   // [T] the walk
  int* s_win = s_tok + T;                         // [T] its windows
  __shared__ int s_valid;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane / G, r = lane % G;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int nctas = gridDim.x * gridDim.y;
  const size_t N = static_cast<size_t>(gridDim.y) * T;
  const int col0 = rank * span, col1 = min(D, col0 + span);
  const int slices = max(1, (col1 - col0 + cols - 1) / cols);
  const int chunks = cols / (4 * G);        // float4s a lane of a row slice

  // the negatives' rows: this block's first read now, into registers,
  // written once the first slice has arrived
  const bool wn_early =
      cta < kB && D <= kSplitWnRegs * static_cast<int>(blockDim.x);
  float wv[kSplitWnRegs];
  if (wn_early) {
    const float* src = w_out + static_cast<size_t>(negs[cta]) * D;
#pragma unroll
    for (int j = 0; j < kSplitWnRegs; ++j) {
      const int c = threadIdx.x + j * blockDim.x;
      wv[j] = c < D ? __ldg(src + c) : 0.f;
    }
  }
  if (threadIdx.x == 0) s_valid = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    s_tok[t] = block[static_cast<size_t>(b) * T + t];
    s_win[t] = cwin[static_cast<size_t>(b) * T + t];
  }
  __syncthreads();

  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(w_in) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  // the partial dots, slice by slice: a group of G lanes a position (the
  // whole warp in step, for the butterfly), G offsets at a time
  for (int s = 0; s < slices; ++s) {
    const int c0 = col0 + s * cols, w = max(0, min(cols, col1 - c0));
    if (s > 0) __syncthreads();
    split_gather(s_in, s_out, s_tok, w_in, w_out, T, D, cols, c0, w, vec);
    __syncthreads();
    if (s == 0 && wn_early) {
#pragma unroll
      for (int j = 0; j < kSplitWnRegs; ++j) {
        const int c = threadIdx.x + j * blockDim.x;
        if (c < D) o.wn[static_cast<size_t>(cta) * D + c] = wv[j];
      }
    }
    for (int tb = warp * P; tb < T; tb += nwarps * P) {
      // a lane past the walk or an offset past it reads a row of the walk
      // (its partial is never read: such a pair is not valid)
      const int t = tb + sub;
      const bool live = t < T;
      const int tc = min(t, T - 1);
      for (int o0 = 0; o0 < W2; o0 += G) {
        float v[G];
#pragma unroll
        for (int k = 0; k < G; ++k) v[k] = 0.f;
        for (int ch = 0; ch < chunks; ++ch) {
          const int c = 4 * (ch * G + r);
          const float4 a = split_ld4(s_in + tc * cols + c);
#pragma unroll
          for (int k = 0; k < G; ++k) {
            const int x = min(max(tc + offset_of(o0 + k, window), 0), T - 1);
            const float4 e = split_ld4(s_out + x * cols + c);
            v[k] = fmaf(a.x, e.x, v[k]);
            v[k] = fmaf(a.y, e.y, v[k]);
            v[k] = fmaf(a.z, e.z, v[k]);
            v[k] = fmaf(a.w, e.w, v[k]);
          }
        }
        split_fold<G / 2>(v, r);
        const int oi = o0 + r;
        if (live && oi < W2) {
          float* p = s_part + t * W2 + oi;
          *p = s == 0 ? v[0] : *p + v[0];
        }
      }
    }
  }
  cl.sync();   // every rank's partials are final
  if (kReduceScatter) {
    // the pairs this rank owns: every rank's partial in rank order, g_pos
    // written into every rank
    for (int i = rank + C * threadIdx.x; i < n; i += C * blockDim.x) {
      float p[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) p[q] = *cl.map_shared_rank(s_part + i, q);
      float dot = p[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < C) dot += p[q];
      const int t = i / W2, x = t + offset_of(i - t * W2, window);
      const float g = split_pair_ok(s_tok, s_win, t, x, T)
                          ? 1.f / (1.f + expf(-dot)) - 1.f
                          : 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) *cl.map_shared_rank(s_g + i, q) = g;
    }
    cl.sync();   // g_pos complete in every rank; no remote access after it
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float p[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) p[q] = *cl.map_shared_rank(s_part + i, q);
      float dot = p[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < C) dot += p[q];
      const int t = i / W2, x = t + offset_of(i - t * W2, window);
      s_g[i] = split_pair_ok(s_tok, s_win, t, x, T)
                   ? 1.f / (1.f + expf(-dot)) - 1.f
                   : 0.f;
    }
    split_cluster_arrive_relaxed();   // the last read of another rank
    __syncthreads();
  }

  // the pair counts of the centers t = rank mod C, and their valid pairs:
  // a warp a position, a lane an offset, the counts by ballots
  int my_valid = 0;
  for (int t = rank + C * warp; t < T; t += C * nwarps) {
    int vc = 0, vx = 0;
    for (int o0 = 0; o0 < W2; o0 += 32) {
      const int d = o0 + lane < W2 ? offset_of(o0 + lane, window) : T;
      vc += __popc(__ballot_sync(kFull, split_pair_ok(s_tok, s_win, t,
                                                      t + d, T)));
      vx += __popc(__ballot_sync(kFull, split_pair_ok(s_tok, s_win, t - d,
                                                      t, T)));
    }
    if (lane == 0) {
      const size_t p = static_cast<size_t>(b) * T + t;
      o.cnt[p] = vc;
      o.cnt[N + p] = vx;
      o.mask[p] = neg_weight * static_cast<float>(vc);
      my_valid += vc;
    }
  }
  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);

  // the accumulations, slice by slice (the last slice gathered first): a
  // group of G lanes a position, a float4 a lane; g_pos is zero off the
  // valid pairs, as the rows are at padding
  for (int s = slices - 1; s >= 0; --s) {
    const int c0 = col0 + s * cols, w = max(0, min(cols, col1 - c0));
    if (s < slices - 1) {
      __syncthreads();
      split_gather(s_in, s_out, s_tok, w_in, w_out, T, D, cols, c0, w, vec);
      __syncthreads();
    }
    for (int t = warp * P + sub; t < T; t += nwarps * P) {
      const float* gt = s_g + t * W2;
      for (int ch = 0; ch < chunks; ++ch) {
        const int c = 4 * (ch * G + r);
        if (c >= w) break;
        float4 ai = make_float4(0.f, 0.f, 0.f, 0.f), ao = ai;
#pragma unroll 4
        for (int oi = 0; oi < W2; ++oi) {
          // g_pos is zero off the valid pairs; a context past the walk
          // reads a row of it, and a center past it weighs 0
          const int d = offset_of(oi, window);
          const int x = min(max(t + d, 0), T - 1), y = t - d;
          const int yc = min(max(y, 0), T - 1);
          const float gy = y == yc ? s_g[yc * W2 + oi] : 0.f;
          ai = split_fma4(gt[oi], split_ld4(s_out + x * cols + c), ai);
          ao = split_fma4(gy, split_ld4(s_in + yc * cols + c), ao);
        }
        const float4 ei = split_ld4(s_in + t * cols + c);
        const size_t e = (static_cast<size_t>(b) * T + t) * D + c0 + c;
        if (vec) {
          *reinterpret_cast<float4*>(o.acc_in + e) = ai;
          *reinterpret_cast<float4*>(o.acc_out + e) = ao;
          *reinterpret_cast<float4*>(o.ein + e) = ei;
        } else {
          const float a4[4] = {ai.x, ai.y, ai.z, ai.w};
          const float o4[4] = {ao.x, ao.y, ao.z, ao.w};
          const float e4[4] = {ei.x, ei.y, ei.z, ei.w};
          for (int j = 0; j < 4 && c + j < w; ++j) {
            o.acc_in[e + j] = a4[j];
            o.acc_out[e + j] = o4[j];
            o.ein[e + j] = e4[j];
          }
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) o.valid[cta] = s_valid;
  for (int k = wn_early ? cta + nctas : cta; k < kB; k += nctas) {
    const float* src = w_out + static_cast<size_t>(negs[k]) * D;
    float* dst = o.wn + static_cast<size_t>(k) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) dst[c] = __ldg(src + c);
  }
  if (!kReduceScatter) split_cluster_wait();   // no rank leaves while read
}

template <int G>
cudaError_t split_attributes(int smem) {
  return cudaFuncSetAttribute(sgns_conv_accumulate_split<G>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

cudaLaunchConfig_t split_config(int cluster, int B, int smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(kSplitThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The split cluster kernel on a block [B, T]: B clusters of `cluster` thread
// blocks of kSplitThreads, `span` columns a rank (a multiple of 4), `cols`
// columns a slice (a multiple of 32: 8 lanes a position; else of 16: 4),
// `smem` bytes of dynamic shared memory; the arguments and outputs of
// srw_sgns_conv_accumulate_launch. Returns the CUDA error of the launch (a
// cluster the card cannot place is refused here).
extern "C" int srw_sgns_conv_accumulate_split_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, int kB, void* const* out, int B, int T, int D,
    int window, int span, int cluster, int cols, int smem, float neg_weight,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || window < 1 || span < 4 || span % 4 != 0 || cluster < 1 ||
      cluster > kMaxCluster || cols < 16 || cols % 16 != 0 || kB < 0 ||
      static_cast<long long>(cluster) * span < D || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvOut o;
  o.ein = static_cast<float*>(out[0]);
  o.acc_in = static_cast<float*>(out[1]);
  o.acc_out = static_cast<float*>(out[2]);
  o.mask = static_cast<float*>(out[3]);
  o.cnt = static_cast<int*>(out[4]);
  o.valid = static_cast<int*>(out[5]);
  o.wn = static_cast<float*>(out[6]);
  const bool eight = cols % 32 == 0;
  cudaError_t err = eight ? split_attributes<8>(smem)
                          : split_attributes<4>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = split_config(
      cluster, B, smem, static_cast<cudaStream_t>(stream), &attr);
  const float* wi = static_cast<const float*>(w_in);
  const float* wo = static_cast<const float*>(w_out);
  const int* bl = static_cast<const int*>(block);
  const int* cw = static_cast<const int*>(cwin);
  const int* ng = static_cast<const int*>(negs);
  err = eight ? cudaLaunchKernelEx(&cfg, sgns_conv_accumulate_split<8>, wi,
                                   wo, bl, cw, ng, kB, o, T, D, window, span,
                                   cols, neg_weight)
              : cudaLaunchKernelEx(&cfg, sgns_conv_accumulate_split<4>, wi,
                                   wo, bl, cw, ng, kB, o, T, D, window, span,
                                   cols, neg_weight);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` thread blocks with `smem` bytes each (and
// `cols` columns a slice) the card can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means a launch would be refused.
// Returns the CUDA error of the query.
extern "C" int srw_sgns_conv_split_clusters(int cluster, int cols, int smem,
                                            int* out) {
  const bool eight = cols % 32 == 0;
  cudaError_t err = eight ? split_attributes<8>(smem)
                          : split_attributes<4>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = split_config(cluster, 1, smem, 0, &attr);
  err = cudaOccupancyMaxActiveClusters(
      out,
      eight ? reinterpret_cast<const void*>(sgns_conv_accumulate_split<8>)
            : reinterpret_cast<const void*>(sgns_conv_accumulate_split<4>),
      &cfg);
  return static_cast<int>(err);
}
