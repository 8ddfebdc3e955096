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
//       1 / max(deg_s, 1) for the mean. A warp takes an item (a run of at
//       most `chunk` arcs of one segment, ops/spmm.py::segment_items): its
//       lanes read the run's indices and weights 32 at a time, then the
//       warp streams the rows, kRows in flight, each lane summing NV
//       columns of a slice of 32 * NV in double. An item that covers its whole segment stores its
//       row; the items of a split segment (a hub row longer than `chunk`)
//       store their partial sums, and the one that arrives last (an
//       arrival counter a split segment, zeroed for each launch, at the
//       segment's first partial row) sums them in item order and stores
//       the row: no float atomics, the same result every run.
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
// row gathers move ~340 MB, which L2 (50 MB) serves since x is 5 MB.
// The sums are taken in double, which costs nothing at these rates: the
// bench graph's largest row sums 39,303 rows, and summed in f32 (as JAX
// and the plain version sum) its result came out 6.6e-3 off the float64
// sum on the H100. So the kernels agree with a float64 reference to the
// final rounding.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // gathered rows a lane has in flight

template <int NV>
__global__ void __launch_bounds__(kThreads)
    segment_sum(float* __restrict__ out, const float* __restrict__ x, int D,
                const int* __restrict__ offsets, int n_items,
                const int* __restrict__ item_seg,
                const int* __restrict__ item_start,
                const int* __restrict__ item_part, int chunk,
                const int* __restrict__ idx, const float* __restrict__ w,
                const int* __restrict__ widx, int mean,
                double* __restrict__ partials, int* __restrict__ arrive) {
  constexpr int kSlice = 32 * NV;
  const int lane = threadIdx.x & 31;
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
      double acc[NV];
#pragma unroll
      for (int m = 0; m < NV; ++m) acc[m] = 0.0;
      for (int b = e0; b < e1; b += 32) {
        const int e = b + lane;
        int my_r = 0;
        float my_w = 0.f;
        if (e < e1) {
          my_r = idx ? idx[e] : e;
          my_w = w ? w[widx ? widx[e] : e] : 1.f;
        }
        const int n = min(32, e1 - b);
        // kRows rows read before any is summed, so their loads overlap;
        // the sum keeps the arcs' order
        for (int j = 0; j < n; j += kRows) {
          float v[kRows][NV];
          double wv[kRows];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const bool on = j + q < n;
            const int r = __shfl_sync(kFull, my_r, on ? j + q : 0);
            wv[q] = __shfl_sync(kFull, my_w, on ? j + q : 0);
            const float* xr = x + static_cast<size_t>(r) * D;
#pragma unroll
            for (int m = 0; m < NV; ++m) {
              const int c = c0 + lane + 32 * m;
              v[q][m] = on && c < D ? __ldg(xr + c) : 0.f;
            }
          }
#pragma unroll
          for (int q = 0; q < kRows; ++q)
#pragma unroll
            for (int m = 0; m < NV; ++m)
              acc[m] = fma(wv[q], static_cast<double>(v[q][m]), acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int c = c0 + lane + 32 * m;
        if (c < D) {
          if (part < 0)
            y[c] = static_cast<float>(mean ? acc[m] / deg : acc[m]);
          else
            partials[static_cast<size_t>(part) * D + c] = acc[m];
        }
      }
    }
    if (part < 0) continue;
    // a split segment: the item that arrives last sums the segment's
    // partials in item order and writes its row
    const int n_seg = (seg1 - seg0 + chunk - 1) / chunk;
    const int p0 = part - (e0 - seg0) / chunk;  // its first partial row
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(arrive + p0, 1) == n_seg - 1;
    if (__shfl_sync(kFull, last, 0)) {
      __threadfence();
      for (int c = lane; c < D; c += 32) {
        double tot = 0.0;
        for (int p = p0; p < p0 + n_seg; ++p)
          tot += __ldcg(partials + static_cast<size_t>(p) * D + c);
        y[c] = static_cast<float>(mean ? tot / deg : tot);
      }
    }
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
// item is split. `blocks` blocks of kThreads.
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
  if (D <= 32)
    segment_sum<1><<<blocks, kThreads, 0, st>>>(
        o, xx, D, off, n_items, sg, sa, pt, chunk, ix, ww, wi, mean, pa, ar);
  else if (D <= 64)
    segment_sum<2><<<blocks, kThreads, 0, st>>>(
        o, xx, D, off, n_items, sg, sa, pt, chunk, ix, ww, wi, mean, pa, ar);
  else
    segment_sum<4><<<blocks, kThreads, 0, st>>>(
        o, xx, D, off, n_items, sg, sa, pt, chunk, ix, ww, wi, mean, pa, ar);
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
