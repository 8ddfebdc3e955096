// The GNN-feed primitives over a CSR graph: segment sums, SDDMM and the
// row softmax (ops/spmm.py).
//
// Replaces the JAX package's stellar_rw_tpu/ops/spmm.py:44-92 (spmm,
// spmm_mean, sddmm, sddmm_softmax, scatter_add_rows and, through autograd,
// their gradients), which XLA lowers to a gather of one feature row an arc
// and a segment sum or segment max over the sorted source rows.
//
//   segment_sum: Y[s] = scale_s * sum_{e in seg(s)} w[widx_e] * X[idx_e]
//       over the segments of one order of the arcs (the CSR order: segments
//       by source; the transposed order: arcs stably sorted by destination),
//       idx, w and widx optional (identity, 1, identity), scale_s =
//       1 / max(deg_s, 1) for the mean. A persistent grid (the blocks an SM
//       holds, ops/spmm.py::segment_grid) whose warps stride over the items
//       (runs of at most `chunk` arcs of one segment, ops/spmm.py::
//       segment_items). A warp takes an item's arcs kRun at a time: its
//       lanes stage the run's (index, weight) pairs in shared memory, then
//       the warp gathers the rows, a row G lanes wide (W floats a lane: one
//       16-byte load where D % 4 == 0 and x is 16-byte aligned, else one
//       float), so 32 / G arcs at once and kRows a lane in flight, each
//       element summed in double (the weight staged as a double: one
//       conversion an element); at the item's end the warp's 32 / G partial
//       rows are summed in double by a fixed butterfly. An item that
//       covers its whole segment stores its row; the items of a split
//       segment (a hub row longer than `chunk`) store their partial sums
//       and are combined by a tree of two levels: the item of each group
//       of kFan that arrives last sums the group's partials in item order,
//       and the group that arrives last sums the groups' sums in group
//       order and stores the row (arrival counters zeroed for each launch:
//       a group's at its first partial row, the segment's at its second).
//       No float atomics, the same result every run; and no partial waits
//       on a chain longer than kFan + ceil(items / kFan) (the bench graph's
//       hub row: 307 items, 16 + 20), where one warp summing all 307 in
//       turn was the kernel's tail.
//   sddmm_rows: s_e = <x[row_e], y[col_e]> over the CSR order's items: the
//       warp holds its row's x in registers (one slice) while the arcs'
//       y rows stream, a warp reduction (in double) a dot.
//   row_softmax: a warp a source row: its scores read once for the running
//       max and the sum of exps (rescaled when the max grows), then each
//       a_e = exp(s_e - max) / max(sum, 1e-30) written; in backward mode
//       sum_row a * dA, then dS_e = a_e * (dA_e - that sum).
//
// What bounds them: the bytes. At the bench's shape (10,000 vertices,
// ~668K arcs, D = 128) the unique bytes are ~16 MB (x read, Y written, the
// arcs' indices and weights), ~0.005 ms at the card's 3.35 TB/s; the per-arc
// row gathers move ~340 MB, which L2 (50 MB) serves since x is 5 MB. So the
// segment sum is a gather at L2's rate: a row is one 16-byte load a lane,
// a run's indices and weights one broadcast read of shared memory an arc,
// and an element's conversion to double and its double FMA (the
// conversions, 16 a clock an SM, take ~0.02 ms of issue at this shape).
// Sums in float are not within rtol 1e-5 atol 1e-5 of float64 here: all in
// float, the bench graph's largest row (39,303 rows) came out 6.6e-3 off;
// float runs of 32 arcs folded into double, 1.1e-3; float pairs of pairs
// of 8 rows folded into double, 3.8e-5 on a sum of N(0, 1) messages near
// zero (H100). The SDDMM's dots are taken in double too.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;   // segment_sum: rows a lane has in flight
constexpr int kRun = 32;   // segment_sum: arcs whose indices a warp stages
constexpr int kSegBlocks = 3;  // segment_sum: blocks an SM (ops/spmm.py)
constexpr int kFan = 16;   // segment_sum: partials a split segment's group

// an arc of a staged run: the row it gathers and its weight
struct Arc {
  int row;
  int pad;
  double w;
};

// a row's W floats at column c: one 16-byte load, or one float
template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = __ldg(p + k);
  }
}

// Partial rows first, first + stride, ... (n of them) of a split segment
// summed in that order, column by column, kFan loads in flight a lane: into
// the first of them (y null) or, scaled for the mean, into the segment's
// row y. They were written by other warps: read at L2.
__device__ __forceinline__ void sum_partials(double* partials, int D,
                                             int first, int n, int stride,
                                             int lane, float* y, int mean,
                                             double deg) {
  for (int c = lane; c < D; c += 32) {
    const double* src = partials + static_cast<size_t>(first) * D + c;
    double tot = 0.0;
    for (int i = 0; i < n; i += kFan) {
      double v[kFan];
#pragma unroll
      for (int q = 0; q < kFan; ++q)
        v[q] = i + q < n
                   ? __ldcg(src + static_cast<size_t>(i + q) * stride * D)
                   : 0.0;
#pragma unroll
      for (int q = 0; q < kFan; ++q) tot += v[q];
    }
    if (y)
      y[c] = static_cast<float>(mean ? tot / deg : tot);
    else
      partials[static_cast<size_t>(first) * D + c] = tot;
  }
}

// G lanes a row, W floats a lane: slices of G * W columns, 32 / G arcs of a
// run gathered at once. Columns of a lane: c0 + W * (lane % G) + k.
template <int G, int W>
__global__ void __launch_bounds__(kThreads, kSegBlocks)
    segment_sum(float* __restrict__ out, const float* __restrict__ x, int D,
                const int* __restrict__ offsets, int n_items,
                const int* __restrict__ item_seg,
                const int* __restrict__ item_start,
                const int* __restrict__ item_part, int chunk,
                const int* __restrict__ idx, const float* __restrict__ w,
                const int* __restrict__ widx, int mean,
                double* __restrict__ partials, int* __restrict__ arrive) {
  constexpr int P = 32 / G;       // arcs gathered at once
  constexpr int kSlice = G * W;
  __shared__ Arc stage_all[kWarps][kRun];
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int col = W * (lane % G);
  Arc* stage = stage_all[threadIdx.x >> 5];
  const int warps = gridDim.x * kWarps;
  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); it < n_items;
       it += warps) {
    const int s = item_seg[it];
    const int e0 = item_start[it];
    const int part = item_part[it];  // -1: the item is its whole segment
    const int seg0 = offsets[s], seg1 = offsets[s + 1];
    const int e1 = min(e0 + chunk, seg1);
    const double deg = static_cast<double>(max(seg1 - seg0, 1));
    float* y = out + static_cast<size_t>(s) * D;
    for (int c0 = 0; c0 < D; c0 += kSlice) {
      const int c = c0 + col;
      const bool on_col = c < D;   // all W of them (W = 4 needs D % 4 == 0)
      double acc[W];
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = 0.0;
      for (int b = e0; b < e1; b += kRun) {
        const int n = min(kRun, e1 - b);
        __syncwarp();  // the last run's pairs are read
        if (lane < n) {
          const int e = b + lane;
          stage[lane] = {idx ? idx[e] : e, 0,
                         static_cast<double>(w ? w[widx ? widx[e] : e] : 1.f)};
        }
        __syncwarp();
        // this lane's arcs of the run (sub, sub + P, ...) kRows at a time,
        // their rows read before any is summed so the loads overlap
        for (int j = sub; j < n; j += P * kRows) {
          float v[kRows][W];
          double wv[kRows];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const int jj = j + q * P;
            wv[q] = 0.0;
#pragma unroll
            for (int k = 0; k < W; ++k) v[q][k] = 0.f;
            if (jj < n && on_col) {
              const Arc a = stage[jj];
              wv[q] = a.w;
              load_row<W>(x + static_cast<size_t>(a.row) * D + c, v[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < kRows; ++q)
#pragma unroll
            for (int k = 0; k < W; ++k)
              acc[k] = fma(wv[q], static_cast<double>(v[q][k]), acc[k]);
        }
      }
      // the warp's P partial rows, summed by a fixed butterfly
#pragma unroll
      for (int sh = 16; sh >= G; sh >>= 1)
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc[k] += __shfl_xor_sync(kFull, acc[k], sh);
      if (sub == 0 && on_col) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (part < 0)
            y[c + k] = static_cast<float>(mean ? acc[k] / deg : acc[k]);
          else
            partials[static_cast<size_t>(part) * D + c + k] = acc[k];
        }
      }
    }
    if (part < 0) continue;
    // a split segment: its items in groups of kFan; the item of a group
    // that arrives last sums the group's partials in item order into the
    // group's first partial row, and the group that arrives last sums the
    // groups' rows in group order and writes the segment's row
    const int n_seg = (seg1 - seg0 + chunk - 1) / chunk;
    const int k = (e0 - seg0) / chunk;        // the item's place in it
    const int p0 = part - k;                  // its first partial row
    const int n_grp = (n_seg + kFan - 1) / kFan;
    const int g0 = p0 + (k / kFan) * kFan;    // the group's first row
    const int g_n = min(kFan, p0 + n_seg - g0);
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(arrive + g0, 1) == g_n - 1;
    if (!__shfl_sync(kFull, last, 0)) continue;
    __threadfence();
    sum_partials(partials, D, g0, g_n, 1, lane, n_grp == 1 ? y : nullptr,
                 mean, deg);
    if (n_grp == 1) continue;
    __threadfence();
    __syncwarp();
    // the segment's counter: its second partial row's (no group's first)
    if (lane == 0) last = atomicAdd(arrive + p0 + 1, 1) == n_grp - 1;
    if (!__shfl_sync(kFull, last, 0)) continue;
    __threadfence();
    sum_partials(partials, D, p0, n_grp, kFan, lane, y, mean, deg);
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
    sddmm_rows(float* __restrict__ out, const float* __restrict__ x,
               const float* __restrict__ y, int D,
               const int* __restrict__ offsets, int n_items,
               const int* __restrict__ item_seg,
               const int* __restrict__ item_start, int chunk,
               const int* __restrict__ col) {
  constexpr int kSlice = 32 * NV;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const bool one_slice = D <= kSlice;
  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); it < n_items;
       it += warps) {
    const int u = item_seg[it];
    const int e0 = item_start[it];
    const int e1 = min(e0 + chunk, offsets[u + 1]);
    const float* xu = x + static_cast<size_t>(u) * D;
    float xv[NV];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int c = lane + 32 * m;
      xv[m] = c < D ? __ldg(xu + c) : 0.f;
    }
    for (int b = e0; b < e1; b += 32) {
      const int my_v = b + lane < e1 ? col[b + lane] : 0;
      const int n = min(32, e1 - b);
      float mine = 0.f;  // lane j keeps arc b + j's dot
      for (int j = 0; j < n; ++j) {
        const float* yv =
            y + static_cast<size_t>(__shfl_sync(kFull, my_v, j)) * D;
        double dot = 0.0;
        for (int c0 = 0; c0 < D; c0 += kSlice) {
#pragma unroll
          for (int m = 0; m < NV; ++m) {
            const int c = c0 + lane + 32 * m;
            if (c < D)
              dot = fma(static_cast<double>(one_slice ? xv[m] : __ldg(xu + c)),
                        static_cast<double>(__ldg(yv + c)), dot);
          }
        }
#pragma unroll
        for (int sh = 16; sh; sh >>= 1) dot += __shfl_xor_sync(kFull, dot, sh);
        if (lane == j) mine = static_cast<float>(dot);
      }
      if (lane < n) out[b + lane] = mine;
    }
  }
}

// mode 0: out = the row softmax of a (scores); mode 1: out = a * (da -
// sum_row a * da) for the softmax a
__global__ void __launch_bounds__(kThreads)
    row_softmax(float* __restrict__ out, const float* __restrict__ a,
                const float* __restrict__ da,
                const int* __restrict__ offsets, int V, int mode) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int u = blockIdx.x * kWarps + (threadIdx.x >> 5); u < V; u += warps) {
    const int e0 = offsets[u], e1 = offsets[u + 1];
    if (e0 == e1) continue;
    if (mode == 0) {
      float mx = -INFINITY, sum = 0.f;
      for (int e = e0 + lane; e < e1; e += 32) {
        const float v = a[e];
        if (v > mx) {
          sum = sum * expf(mx - v) + 1.f;
          mx = v;
        } else {
          sum += expf(v - mx);
        }
      }
#pragma unroll
      for (int sh = 16; sh; sh >>= 1) {
        const float om = __shfl_xor_sync(kFull, mx, sh);
        const float os = __shfl_xor_sync(kFull, sum, sh);
        const float nm = fmaxf(mx, om);
        sum = (mx == -INFINITY ? 0.f : sum * expf(mx - nm)) +
              (om == -INFINITY ? 0.f : os * expf(om - nm));
        mx = nm;
      }
      const float denom = fmaxf(sum, 1e-30f);
      for (int e = e0 + lane; e < e1; e += 32) out[e] = expf(a[e] - mx) / denom;
    } else {
      float dot = 0.f;
      for (int e = e0 + lane; e < e1; e += 32) dot = fmaf(a[e], da[e], dot);
#pragma unroll
      for (int sh = 16; sh; sh >>= 1) dot += __shfl_xor_sync(kFull, dot, sh);
      for (int e = e0 + lane; e < e1; e += 32) out[e] = a[e] * (da[e] - dot);
    }
  }
}

}  // namespace

// Y [S, D] (zeroed by the caller: empty segments stay 0) from x [*, D] over
// `n_items` items of one order (offsets [S + 1], item_seg / item_start /
// item_part, `chunk` arcs an item); idx, w, widx may be null; mean != 0
// divides by the segment's length. partials: double [split items, D];
// arrive: int [split items], zero (each launch its own), both null when no
// item is split. `blocks` blocks of kThreads (at most kSegBlocks an SM are
// resident: ops/spmm.py::segment_grid).
// Returns the CUDA error of the launch.
extern "C" int srw_segment_sum_launch(
    void* out, const void* x, int D, const void* offsets, int n_items,
    const void* item_seg, const void* item_start, const void* item_part,
    int chunk, const void* idx, const void* w, const void* widx, int mean,
    void* partials, void* arrive, int blocks, void* stream) {
  if (n_items <= 0 || D <= 0) return 0;
  if (chunk < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* xx = static_cast<const float*>(x);
  const int* off = static_cast<const int*>(offsets);
  const int* sg = static_cast<const int*>(item_seg);
  const int* sa = static_cast<const int*>(item_start);
  const int* pt = static_cast<const int*>(item_part);
  const int* ix = static_cast<const int*>(idx);
  const float* ww = static_cast<const float*>(w);
  const int* wi = static_cast<const int*>(widx);
  double* pa = static_cast<double*>(partials);
  int* ar = static_cast<int*>(arrive);
  // 16-byte row loads where every row starts 16-byte aligned
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(xx) % 16 == 0;
#define SRW_SEGMENT_SUM(G, W)                                              \
  segment_sum<G, W><<<blocks, kThreads, 0, st>>>(                          \
      o, xx, D, off, n_items, sg, sa, pt, chunk, ix, ww, wi, mean, pa, ar)
  if (!vec)
    SRW_SEGMENT_SUM(32, 1);
  else if (D <= 32)
    SRW_SEGMENT_SUM(8, 4);
  else if (D <= 64)
    SRW_SEGMENT_SUM(16, 4);
  else
    SRW_SEGMENT_SUM(32, 4);
#undef SRW_SEGMENT_SUM
  return static_cast<int>(cudaGetLastError());
}

// s [E] = <x[row_e], y[col_e]> over the CSR order's items (the item's
// segment is the row). Returns the CUDA error of the launch.
extern "C" int srw_sddmm_launch(void* out, const void* x, const void* y,
                                int D, const void* offsets, int n_items,
                                const void* item_seg, const void* item_start,
                                int chunk, const void* col, int blocks,
                                void* stream) {
  if (n_items <= 0) return 0;
  if (D < 1 || chunk < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* xx = static_cast<const float*>(x);
  const float* yy = static_cast<const float*>(y);
  const int* off = static_cast<const int*>(offsets);
  const int* sg = static_cast<const int*>(item_seg);
  const int* sa = static_cast<const int*>(item_start);
  const int* cl = static_cast<const int*>(col);
  if (D <= 32)
    sddmm_rows<1><<<blocks, kThreads, 0, st>>>(o, xx, yy, D, off, n_items, sg,
                                               sa, chunk, cl);
  else if (D <= 64)
    sddmm_rows<2><<<blocks, kThreads, 0, st>>>(o, xx, yy, D, off, n_items, sg,
                                               sa, chunk, cl);
  else
    sddmm_rows<4><<<blocks, kThreads, 0, st>>>(o, xx, yy, D, off, n_items, sg,
                                               sa, chunk, cl);
  return static_cast<int>(cudaGetLastError());
}

// The row softmax over the CSR order's rows (mode 0: out = softmax(a);
// mode 1: out = a * (da - sum_row a * da)). Returns the CUDA error.
extern "C" int srw_row_softmax_launch(void* out, const void* a,
                                      const void* da, const void* offsets,
                                      int V, int mode, int blocks,
                                      void* stream) {
  if (V <= 0) return 0;
  if (blocks < 1 || (mode != 0 && mode != 1) || (mode == 1 && !da))
    return static_cast<int>(cudaErrorInvalidValue);
  row_softmax<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(a),
      static_cast<const float*>(da), static_cast<const int*>(offsets), V,
      mode);
  return static_cast<int>(cudaGetLastError());
}
