// The accumulate kernel as a thread-block cluster a walk: a design that
// measured slower than the halo tiles at walk_10k's blocks on the H100
// (PERF.md, section 6), kept for chip_conv_parts.py, which appends this
// file to stellar_rw_tpu_torch/csrc/sgns_conv.cu and launches it through
// srw_sgns_conv_accumulate_cluster_launch. Each of its thread blocks
// (ranks) holds `P` consecutive positions of the walk and gathers only
// their ein and eout rows from device memory into its shared memory
// (cp.async, 16 bytes a copy where D % 4 == 0): no row is read twice from
// device memory. The window's rows that the neighbours hold are copied once
// into a local halo through distributed shared memory
// (cluster.map_shared_rank), a thread's reads all in flight at once
// (kCopyHalo false: read in place). A rank takes the dot of each pair whose
// center it holds, once (kDotLanes lanes a pair, 16-byte shared loads, a
// shuffle sum), and keeps g_pos; the context side's acc_out reads the
// centers' g_pos, copied into the halo the same way, and recomputes no dot.
// Accumulations: a thread a float4 of a row. Its outputs are
// sgns_conv_accumulate's. Rows wider than the shared memory holds go
// in column slices, as the tiles'. No rank leaves while another may still
// read its shared memory: a relaxed arrive after its last remote read, a
// wait at its end.
#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kDotLanes = 4;        // lanes that share one dot
constexpr int kWnRegs = 4;          // floats of a negative's row a thread holds
// the window's rows and g_pos that the neighbours hold copied once into a
// local halo (distributed shared memory answers slowly); false reads them
// in place
constexpr bool kCopyHalo = true;
// row gathers by cp.async; false stages them through registers
constexpr bool kAsync = true;

// (center c, context x) of walk positions is a valid pair
__device__ __forceinline__ bool walk_pair_ok(const int* tok, const int* win,
                                             int c, int x, int T) {
  return c >= 0 && c < T && x >= 0 && x < T && tok[c] >= 0 && tok[x] >= 0 &&
         abs(x - c) <= win[c];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 fma4(float g, float4 v, float4 a) {
  return make_float4(fmaf(g, v.x, a.x), fmaf(g, v.y, a.y), fmaf(g, v.z, a.z),
                     fmaf(g, v.w, a.w));
}

// barrier.cluster in two halves: arrive, relaxed (no memory ordering), and
// wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// row `x` of a walk in a rank's shared array `base` (rows `stride` floats,
// each rank's own rows from row `hw`): in this rank's memory or, through
// distributed shared memory, in the rank that holds it
__device__ __forceinline__ float* held(cg::cluster_group& cl, float* base,
                                       int x, int P, int hw, int stride,
                                       int rank) {
  const int q = x / P;
  float* p = base + (hw + x - q * P) * stride;
  return q == rank ? p : cl.map_shared_rank(p, q);
}

struct Rank {
  int rank, t0, nt, P, hw, T, D, cols;
};

// row `x` as the dots and the accumulations read it: from the halo copied
// into this rank, or in place where some rank of the cluster holds it
__device__ __forceinline__ const float* row_at(cg::cluster_group& cl,
                                               const Rank& k, float* base,
                                               int x, int stride) {
  return kCopyHalo ? base + (x - k.t0 + k.hw) * stride
                   : held(cl, base, x, k.P, 0, stride, k.rank);
}

// columns [c0, c0 + w) of the rank's own rows of both tables into shared
// memory (rows of `cols` floats from row hw); a row beyond the walk, at
// padding, or a column beyond w is zero
__device__ void load_rows(const Rank& k, float* s_in, float* s_out,
                          const int* s_tok, const float* __restrict__ w_in,
                          const float* __restrict__ w_out, int c0, int w,
                          bool vec) {
  const int g = vec ? 4 : 1;
  const int per = k.cols / g, n = k.P * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i / per, c = (i - l * per) * g;
    const int t = l < k.nt ? s_tok[k.t0 + l] : -1;
    const bool ok = t >= 0 && c < w;
    const size_t o = ok ? static_cast<size_t>(t) * k.D + c0 + c : 0;
    float* di = s_in + (k.hw + l) * k.cols + c;
    float* dout = s_out + (k.hw + l) * k.cols + c;
    if (kAsync) {
      if (vec) {
        cp_async16(di, w_in + o, ok);
        cp_async16(dout, w_out + o, ok);
      } else {
        cp_async4(di, w_in + o, ok);
        cp_async4(dout, w_out + o, ok);
      }
    } else if (vec) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(di) =
          ok ? __ldg(reinterpret_cast<const float4*>(w_in + o)) : z;
      *reinterpret_cast<float4*>(dout) =
          ok ? __ldg(reinterpret_cast<const float4*>(w_out + o)) : z;
    } else {
      *di = ok ? __ldg(w_in + o) : 0.f;
      *dout = ok ? __ldg(w_out + o) : 0.f;
    }
  }
  if (kAsync) cp_async_wait_all();
}

// the window's rows of both tables (b given) or g_pos (b null) that the
// neighbours hold, hw each side, copied into this rank's halo rows; zero
// beyond the walk. Distributed shared memory answers slowly: each thread's
// reads (a float4 each where the rows allow) all go out before its first
// store.
template <int kReads>
__device__ void copy_halo(cg::cluster_group& cl, const Rank& k, float* a,
                          float* b, int stride) {
  const int g = stride % 4 == 0 ? 4 : 1, per = stride / g;
  const int rows = 2 * k.hw, n = (b ? 2 : 1) * rows * per;
  for (int i0 = threadIdx.x; i0 < n; i0 += blockDim.x * kReads) {
    float4 v[kReads];
    float* dst[kReads];
#pragma unroll
    for (int u = 0; u < kReads; ++u) {
      const int i = i0 + u * blockDim.x;
      dst[u] = nullptr;
      if (i >= n) continue;
      const int tab = i / (rows * per), r = i - tab * rows * per;
      const int h = r / per, c = (r - h * per) * g;
      const int x = h < k.hw ? k.t0 - k.hw + h : k.t0 + k.P + h - k.hw;
      const int l = h < k.hw ? h : k.P + h;
      float* base = tab ? b : a;
      dst[u] = base + l * stride + c;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (x < 0 || x >= k.T) continue;
      const float* src = held(cl, base, x, k.P, k.hw, stride, k.rank) + c;
      if (g == 4)
        v[u] = *reinterpret_cast<const float4*>(src);
      else
        v[u].x = *src;
    }
#pragma unroll
    for (int u = 0; u < kReads; ++u) {
      if (!dst[u]) continue;
      if (g == 4)
        *reinterpret_cast<float4*>(dst[u]) = v[u];
      else
        *dst[u] = v[u].x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sgns_conv_accumulate_cluster(const float* __restrict__ w_in,
                                 const float* __restrict__ w_out,
                                 const int* __restrict__ block,
                                 const int* __restrict__ cwin,
                                 const int* __restrict__ negs, int kB,
                                 ConvOut o, int T, int D, int window, int P,
                                 int cols, float neg_weight) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float sm[];
  Rank k;
  k.rank = static_cast<int>(cl.block_rank());
  k.t0 = k.rank * P;
  k.nt = max(0, min(P, T - k.t0));
  k.P = P;
  k.hw = kCopyHalo ? window : 0;
  k.T = T;
  k.D = D;
  k.cols = cols;
  const int b = blockIdx.y, W2 = 2 * window, R = P + 2 * k.hw;
  float* s_in = sm;                          // [R, cols] ein rows
  float* s_out = s_in + R * cols;            // [R, cols] eout rows
  float* s_g = s_out + R * cols;             // [R, 2w] g_pos of the centers
  int* s_tok = reinterpret_cast<int*>(s_g + R * W2);  // [T] the walk
  int* s_win = s_tok + T;                              // [T] its windows
  int* s_cnt = s_win + T;            // [2, P] vcnt, cnt_out_pos of its own
  __shared__ int s_valid;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int nctas = gridDim.x * gridDim.y;
  const size_t N = static_cast<size_t>(gridDim.y) * T;

  if (threadIdx.x == 0) s_valid = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    s_tok[t] = block[static_cast<size_t>(b) * T + t];
    s_win[t] = cwin[static_cast<size_t>(b) * T + t];
  }
  for (int i = threadIdx.x; i < P * W2; i += blockDim.x)
    s_g[k.hw * W2 + i] = 0.f;
  for (int i = threadIdx.x; i < 2 * P; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();

  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(w_in) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  const int slices = (D + cols - 1) / cols;
  // a slice's rows in every rank of the cluster, and (kCopyHalo) the
  // window's rows of the neighbours in this one. With one slice no global
  // store comes before a cluster barrier: its release would wait for them.
  auto stage = [&](int s) {
    const int c0 = s * cols;
    load_rows(k, s_in, s_out, s_tok, w_in, w_out, c0, min(cols, D - c0),
              vec);
    cl.sync();
    if (kCopyHalo) {
      copy_halo<4>(cl, k, s_in, s_out, cols);
      __syncthreads();
    }
  };

  // the dots, slice by slice: kDotLanes lanes a pair (center held here),
  // 16-byte shared loads, a shuffle sum
  const int items = k.nt * W2;
  const int grp = lane / kDotLanes, q = lane % kDotLanes;
  const int per_warp = 32 / kDotLanes;
  for (int s = 0; s < slices; ++s) {
    const int w = min(cols, D - s * cols);
    if (s > 0) cl.sync();   // every rank done with the last slice
    stage(s);
    for (int base = warp * per_warp; base < items;
         base += nwarps * per_warp) {
      const int it = base + grp;
      const int tl = it / W2, oi = it - tl * W2;
      const int t = k.t0 + tl, x = t + offset_of(oi, window);
      const bool live = it < items && walk_pair_ok(s_tok, s_win, t, x, T);
      float sum = 0.f;
      if (live) {
        const float* a = s_in + (k.hw + tl) * cols;
        const float* e = row_at(cl, k, s_out, x, cols);
        for (int c = 4 * q; c < w; c += 4 * kDotLanes) {
          const float4 av = *reinterpret_cast<const float4*>(a + c);
          const float4 ev = *reinterpret_cast<const float4*>(e + c);
          sum = fmaf(av.x, ev.x, sum);
          sum = fmaf(av.y, ev.y, sum);
          sum = fmaf(av.z, ev.z, sum);
          sum = fmaf(av.w, ev.w, sum);
        }
      }
      for (int sh = kDotLanes / 2; sh; sh >>= 1)
        sum += __shfl_xor_sync(kFull, sum, sh);
      if (live && q == 0) s_g[(k.hw + tl) * W2 + oi] += sum;
    }
  }
  __syncthreads();
  // g_pos of the valid pairs, zero elsewhere, and the pair counts: a
  // thread an (own position, offset) item, each side counted by a shared
  // atomic
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int tl = i / W2, oi = i - tl * W2, t = k.t0 + tl;
    const int d = offset_of(oi, window);
    float* g = s_g + (k.hw + tl) * W2 + oi;
    const bool center = walk_pair_ok(s_tok, s_win, t, t + d, T);
    *g = center ? 1.f / (1.f + expf(-*g)) - 1.f : 0.f;
    if (center) atomicAdd(s_cnt + tl, 1);
    if (walk_pair_ok(s_tok, s_win, t - d, t, T)) atomicAdd(s_cnt + P + tl, 1);
  }
  cl.sync();   // every rank's g_pos is final
  if (kCopyHalo) {
    copy_halo<2>(cl, k, s_g, nullptr, W2);
    __syncthreads();
  }
  // with the halo copied and one slice, the last read of another rank's
  // shared memory: this rank may leave once every rank has arrived here
  if (kCopyHalo && slices == 1) cluster_arrive_relaxed();
  int my_valid = 0;
  for (int tl = threadIdx.x; tl < k.nt; tl += blockDim.x) {
    const int vc = s_cnt[tl];
    const size_t p = static_cast<size_t>(b) * T + k.t0 + tl;
    o.cnt[p] = vc;
    o.cnt[N + p] = s_cnt[P + tl];
    o.mask[p] = neg_weight * static_cast<float>(vc);
    my_valid += vc;
  }
  for (int sh = 16; sh; sh >>= 1)
    my_valid += __shfl_xor_sync(kFull, my_valid, sh);
  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);

  // the negatives' rows: this block's first read now, into registers, and
  // written after the accumulations, so that the reads' latency hides
  // behind them
  const bool wn_early = cta < kB && D <= kWnRegs * static_cast<int>(blockDim.x);
  float wv[kWnRegs];
  if (wn_early) {
    const float* src = w_out + static_cast<size_t>(negs[cta]) * D;
#pragma unroll
    for (int j = 0; j < kWnRegs; ++j) {
      const int c = threadIdx.x + j * blockDim.x;
      wv[j] = c < D ? __ldg(src + c) : 0.f;
    }
  }

  // the accumulations, a thread a float4 of a row of a slice; the last
  // slice loaded is still in shared memory. g_pos is zero off the valid
  // pairs, as the rows are at padding and in the halo beyond the walk: no
  // branch on it
  for (int s = slices - 1; s >= 0; --s) {
    const int c0 = s * cols, w = min(cols, D - c0);
    if (s < slices - 1) {
      cl.sync();   // every rank done with the slice after this one
      stage(s);
      if (kCopyHalo && s == 0) cluster_arrive_relaxed();
    }
    const int per = (w + 3) / 4;
    for (int i = threadIdx.x; i < k.nt * per; i += blockDim.x) {
      const int tl = i / per, c = (i - tl * per) * 4, t = k.t0 + tl;
      const float* gc = s_g + (k.hw + tl) * W2;
      float4 ai = make_float4(0.f, 0.f, 0.f, 0.f), ao = ai;
#pragma unroll 4
      for (int oi = 0; oi < W2; ++oi) {
        const int d = offset_of(oi, window), x = t + d, y = t - d;
        if (kCopyHalo || (x >= 0 && x < T))
          ai = fma4(gc[oi], *reinterpret_cast<const float4*>(
                                row_at(cl, k, s_out, x, cols) + c), ai);
        if (kCopyHalo || (y >= 0 && y < T))
          ao = fma4(row_at(cl, k, s_g, y, W2)[oi],
                    *reinterpret_cast<const float4*>(
                        row_at(cl, k, s_in, y, cols) + c), ao);
      }
      const float4 ei = *reinterpret_cast<const float4*>(
          s_in + (k.hw + tl) * cols + c);
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
  __syncthreads();
  if (threadIdx.x == 0) o.valid[cta] = s_valid;
  if (wn_early) {
#pragma unroll
    for (int j = 0; j < kWnRegs; ++j) {
      const int c = threadIdx.x + j * blockDim.x;
      if (c < D) o.wn[static_cast<size_t>(cta) * D + c] = wv[j];
    }
  }
  for (int n = wn_early ? cta + nctas : cta; n < kB; n += nctas) {
    const float* src = w_out + static_cast<size_t>(negs[n]) * D;
    float* dst = o.wn + static_cast<size_t>(n) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) dst[c] = __ldg(src + c);
  }
  if (!kCopyHalo) cluster_arrive_relaxed();   // read in place until here
  cluster_wait();   // no rank leaves while another may read its memory
}

cudaLaunchConfig_t cluster_config(int cluster, int B, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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

cudaError_t set_attributes(int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      sgns_conv_accumulate_cluster,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)   // beyond the portable 8
    err = cudaFuncSetAttribute(
        sgns_conv_accumulate_cluster,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace

// The cluster kernel on a block [B, T] under chip_conv_parts.py's
// cluster_plan: B clusters of `cluster` thread blocks of kThreads, `P`
// positions a thread block, `cols` columns a slice, `smem` bytes of dynamic
// shared memory; the arguments and outputs of
// srw_sgns_conv_accumulate_launch. Returns the CUDA error of the launch (a
// cluster the card cannot place is refused here).
extern "C" int srw_sgns_conv_accumulate_cluster_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, int kB, void* const* out, int B, int T, int D,
    int window, int P, int cluster, int cols, int smem, float neg_weight,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || window < 1 || P < 1 || cluster < 1 || cluster > 16 ||
      cols < 32 || cols % 32 != 0 || kB < 0 ||
      static_cast<long long>(cluster) * P < T || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvOut o;
  o.ein = static_cast<float*>(out[0]);
  o.acc_in = static_cast<float*>(out[1]);
  o.acc_out = static_cast<float*>(out[2]);
  o.mask = static_cast<float*>(out[3]);
  o.cnt = static_cast<int*>(out[4]);
  o.valid = static_cast<int*>(out[5]);
  o.wn = static_cast<float*>(out[6]);
  cudaError_t err = set_attributes(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      cluster, B, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, sgns_conv_accumulate_cluster,
                           static_cast<const float*>(w_in),
                           static_cast<const float*>(w_out),
                           static_cast<const int*>(block),
                           static_cast<const int*>(cwin),
                           static_cast<const int*>(negs), kB, o, T, D,
                           window, P, cols, neg_weight);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` thread blocks with `smem` bytes each the
// card can hold at once (cudaOccupancyMaxActiveClusters): 0 means a launch
// would be refused. Returns the CUDA error of the query.
extern "C" int srw_sgns_conv_max_clusters(int cluster, int smem, int* out) {
  cudaError_t err = set_attributes(cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, smem, 0, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(sgns_conv_accumulate_cluster),
      &cfg));
}
