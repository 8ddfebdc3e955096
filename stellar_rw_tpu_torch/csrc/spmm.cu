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
//   sddmm_rows: s_e = <x[row_e], y[col_e]> over the CSR order's items of
//       at most 64 arcs (ops/spmm.py::SDDMM_CHUNK), on the same kind of
//       persistent grid (kDotBlocks an SM). A warp takes an item's arcs a
//       run of 32 at a time, their columns one load and then a shuffle an
//       arc, and gathers the y rows as segment_sum gathers (G lanes a row,
//       16-byte loads, kDotRows rows in flight a lane) against the item's
//       x row held in registers. A lane sums its columns' products of an
//       arc in float; the G lanes' shares of the run's arcs are summed in
//       double by one transposed butterfly, which leaves each lane one
//       finished dot (31 shuffles a run at G = 32, where a butterfly an
//       arc took 160), stored by one coalesced write. The first design
//       took the arcs one at a time: a row's scalar loads, conversions and
//       a five-level butterfly of a double before the next row was asked
//       for, 31x its bound.
//   row_softmax: a warp an item of at most 32 * kPer = 128 arcs of a row
//       (the CSR order's items), its scores (and, backward, da) read once
//       into registers. A row of one item: its max and sum of exps (or,
//       backward, sum a * dA) by butterflies, then its quotients: one read
//       and one write an arc. A split row: each item stores (its max, its
//       sum of exps) or its dot in a partial row; a second pass over the
//       split items, launched programmatically (griddepcontrol: its blocks
//       start as the first pass's leave, read their arcs, then wait for
//       the first grid), has each combine its row's partials in one fixed
//       order (the sum in double), so every item of the row and every run
//       get the same bits, and write its own quotients. The first design
//       was a warp a row: the bench graph's hub row of 39,303 arcs was one
//       warp's serial walk of 2,458 strides, 213x the bound.
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
// zero (H100). The SDDMM gathers the same rows; its dots: a lane's few
// products in float, the lanes' shares in double (products in double made
// it 1.5x slower). The softmax moves 5.3 MB; its time is two launches and
// its chains of dependent loads (PERF.md).

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
constexpr int kDotRows = 4;    // sddmm_rows: rows a lane has in flight
constexpr int kDotBlocks = 3;  // sddmm_rows: blocks an SM (ops/spmm.py)
using Part = float;            // sddmm_rows: a lane's share of a dot
using Sum = double;            // sddmm_rows: the shares summed across lanes
constexpr int kPer = 4;        // row_softmax: arcs a lane holds
constexpr int kSoftBlocks = 6;  // row_softmax: blocks an SM (ops/spmm.py)
constexpr int kLoads = 4;      // row_softmax: partials a lane has in flight

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

// The transposed butterfly's later steps over lane groups of 2H lanes: each
// lane holds H sums s[k], the share of its group's arc k (or k + H); after
// the steps H, H / 2, ..., 1, s[0] of the group's lane r is the sum of arc
// r over the group's lanes, each pair of lanes added as a full butterfly
// would add them.
template <int H, int N>
__device__ __forceinline__ void fold(Sum (&s)[N], int r) {
  const bool up = r & H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const Sum send = up ? s[k] : s[k + H];
    const Sum keep = up ? s[k + H] : s[k];
    s[k] = keep + __shfl_xor_sync(kFull, send, H);
  }
  if constexpr (H > 1) fold<H / 2>(s, r);
}

// G lanes a row, W floats a lane, as segment_sum gathers: a run of 32 arcs,
// the arc j of the run in lane group j % P (P = 32 / G arcs at once), so a
// lane takes G of the run's arcs, kDotRows rows in flight. Each lane sums
// its columns' products of an arc in Part (float), the G lanes' shares are
// summed in Sum (double) by the transposed butterfly, which leaves arc
// sub + P * r finished in lane r of group sub: 31 shuffles a run at G = 32
// where a butterfly an arc took 160, and one coalesced store of 32 dots.
template <int G, int W>
__global__ void __launch_bounds__(kThreads, kDotBlocks)
    sddmm_rows(float* __restrict__ out, const float* __restrict__ x,
               const float* __restrict__ y, int D, int n_items,
               const int* __restrict__ item_seg,
               const int* __restrict__ item_start,
               const int* __restrict__ col) {
  constexpr int P = 32 / G;
  constexpr int kSlice = G * W;
  constexpr int R = G < kDotRows ? G : kDotRows;
  constexpr int H = G / 2;
  const int lane = threadIdx.x & 31;
  const int sub = lane / G;
  const int r = lane % G;
  const int warps = gridDim.x * kWarps;
  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); it < n_items;
       it += warps) {
    const int u = item_seg[it];
    const int e0 = item_start[it];
    const int e1 = item_start[it + 1];  // an item ends where the next begins
    const float* xu = x + static_cast<size_t>(u) * D;
    for (int b = e0; b < e1; b += 32) {
      const int n = min(32, e1 - b);
      const int my_col = lane < n ? col[b + lane] : 0;
      Part p[G];  // p[k]: this lane's share of the run's arc sub + P * k
#pragma unroll
      for (int k = 0; k < G; ++k) p[k] = 0;
      for (int c0 = 0; c0 < D; c0 += kSlice) {
        const int c = c0 + W * r;
        const bool on_col = c < D;
        float xv[W];  // the item's row slice
#pragma unroll
        for (int w = 0; w < W; ++w) xv[w] = 0.f;
        if (on_col) load_row<W>(xu + c, xv);
#pragma unroll
        for (int k0 = 0; k0 < G; k0 += R) {
          if (P * k0 >= n) break;  // the run's arcs are all taken
          float v[R][W];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int j = sub + P * (k0 + q);
            const int row = __shfl_sync(kFull, my_col, j);
#pragma unroll
            for (int w = 0; w < W; ++w) v[q][w] = 0.f;
            if (j < n && on_col)
              load_row<W>(y + static_cast<size_t>(row) * D + c, v[q]);
          }
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int w = 0; w < W; ++w)
              p[k0 + q] += static_cast<Part>(xv[w]) *
                           static_cast<Part>(v[q][w]);
        }
      }
      // the first step in Part's shuffles, the rest in Sum
      Sum s[H];
      const bool up = r & H;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const Part send = up ? p[k] : p[k + H];
        const Part keep = up ? p[k + H] : p[k];
        s[k] = static_cast<Sum>(keep) +
               static_cast<Sum>(__shfl_xor_sync(kFull, send, H));
      }
      if constexpr (H > 1) fold<H / 2>(s, r);
      const int j = sub + P * r;
      if (j < n) out[b + j] = static_cast<float>(s[0]);
    }
  }
}

// a row's arcs of one item, kPer a lane (arc e0 + lane + 32 k): the scores
// (-inf past the item's end) and, for the backward mode, da (0 there)
__device__ __forceinline__ void load_arcs(const float* a, const float* da,
                                          int e0, int e1, int lane, int mode,
                                          float (&v)[kPer], float (&w)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = e0 + lane + 32 * k;
    const bool in = e < e1;
    v[k] = in ? __ldg(a + e) : (mode == 0 ? -INFINITY : 0.f);
    w[k] = in && mode ? __ldg(da + e) : 0.f;
  }
}

// exp of a score less a max (__expf gained 0-6% in chip_spmm_parts.py's
// turns, within their spread)
__device__ __forceinline__ float exp_of(float v) { return expf(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int sh = 16; sh; sh >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, sh));
  return v;
}

// a split row's partials i0, i0 + 32, ... (kLoads of them; -inf past the
// row's last), read at L2
__device__ __forceinline__ void load_partials(const float2* row, int i0,
                                              int n, float2 (&q)[kLoads]) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = i0 + 32 * j;
    q[j] = i < n ? __ldcg(row + i) : make_float2(-INFINITY, 0.f);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int sh = 16; sh; sh >>= 1) v += __shfl_xor_sync(kFull, v, sh);
  return v;
}

// mode 0: out = the row softmax of the scores a; mode 1: out = a * (da -
// sum_row a * da) for the softmax a. A warp an item of at most 32 * kPer
// arcs of a row (the CSR order's items, each ending where the next begins),
// its arcs read once into registers.
// An item that is its whole row: its max and sum of exps (mode 1: its dot)
// by butterflies, then its quotients. A split row's items: pass 1 stores
// each item's (max, sum of exps) or dot in its partial row; pass 2, once
// every partial is stored, has each split item combine its row's partials
// (lane l takes the partials l, l + 32, ... in turn, then a butterfly; the
// sum in double), the same order in every item, so the row's max and sum
// are the same bits in each; then the item writes its own quotients.
// pass: bit 1 the items, bit 2 the split items (two launches: 1, then 2).
__global__ void __launch_bounds__(kThreads, kSoftBlocks)
    row_softmax(float* __restrict__ out, const float* __restrict__ a,
                const float* __restrict__ da, int n_items,
                const int* __restrict__ item_start,
                const int* __restrict__ item_part,
                const int4* __restrict__ part_desc, int parts,
                float* __restrict__ partials, int mode, int pass) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int warps = gridDim.x * kWarps;
  float v[kPer], w[kPer];
  // a second launch may start now: its blocks take the SMs as this one's
  // leave, read their arcs and wait for this grid (griddepcontrol.wait)
  if (pass == 1) asm volatile("griddepcontrol.launch_dependents;");
  if (pass & 1) {
    for (int it = warp; it < n_items; it += warps) {
      const int e0 = item_start[it];
      const int e1 = item_start[it + 1];
      if (e0 == e1) continue;  // an isolate: no arcs
      const int part = item_part[it];
      load_arcs(a, da, e0, e1, lane, mode, v, w);
      if (mode == 0) {
        float m = v[0];
#pragma unroll
        for (int k = 1; k < kPer; ++k) m = fmaxf(m, v[k]);
        m = warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          v[k] = exp_of(v[k] - m);
          sum += v[k];
        }
        sum = warp_sum(sum);
        if (part < 0) {
          const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int e = e0 + lane + 32 * k;
            if (e < e1) out[e] = v[k] / denom;
          }
        } else if (lane == 0) {
          partials[2 * part] = m;
          partials[2 * part + 1] = sum;
        }
      } else {
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) dot = fmaf(v[k], w[k], dot);
        dot = warp_sum(dot);
        if (part < 0) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int e = e0 + lane + 32 * k;
            if (e < e1) out[e] = v[k] * (w[k] - dot);
          }
        } else if (lane == 0) {
          partials[2 * part] = dot;
        }
      }
    }
  }
  if (!(pass & 2)) return;
  for (int p = warp; p < parts; p += warps) {
    // the split item's arcs, its row's first partial and its row's items
    const int4 d = part_desc[p];
    const int e0 = d.x, e1 = d.y, n_seg = d.w;
    const float2* row = reinterpret_cast<const float2*>(partials) + d.z;
    load_arcs(a, da, e0, e1, lane, mode, v, w);
    // the partials: written by the last launch once it has ended (a no-op
    // after an ordinary launch), read at L2, kLoads a lane in flight; lane
    // l takes the partials l, l + 32, ...
    asm volatile("griddepcontrol.wait;" ::: "memory");
    float2 q[kLoads];
    if (mode == 0) {
      float m = -INFINITY;
      for (int i0 = lane; i0 < n_seg; i0 += 32 * kLoads) {
        load_partials(row, i0, n_seg, q);
#pragma unroll
        for (int j = 0; j < kLoads; ++j) m = fmaxf(m, q[j].x);
      }
      m = warp_max(m);
      double tot = 0.0;
      for (int i0 = lane; i0 < n_seg; i0 += 32 * kLoads) {
        load_partials(row, i0, n_seg, q);
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          if (i0 + 32 * j < n_seg)
            tot += static_cast<double>(q[j].y) *
                   static_cast<double>(exp_of(q[j].x - m));
      }
      const float denom = fmaxf(static_cast<float>(warp_sum(tot)), 1e-30f);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = e0 + lane + 32 * k;
        if (e < e1) out[e] = exp_of(v[k] - m) / denom;
      }
    } else {
      double tot = 0.0;
      for (int i0 = lane; i0 < n_seg; i0 += 32 * kLoads) {
        load_partials(row, i0, n_seg, q);
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          if (i0 + 32 * j < n_seg) tot += static_cast<double>(q[j].x);
      }
      const float dot = static_cast<float>(warp_sum(tot));
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = e0 + lane + 32 * k;
        if (e < e1) out[e] = v[k] * (w[k] - dot);
      }
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

// s [E] = <x[row_e], y[col_e]> over the CSR order's items (item_seg: the
// item's row; item_start [n_items + 1]: its first arc, then E: an item ends
// where the next begins), `blocks` blocks of kThreads (at most kDotBlocks
// an SM are resident: ops/spmm.py::segment_grid). Returns the CUDA error
// of the launch.
extern "C" int srw_sddmm_launch(void* out, const void* x, const void* y,
                                int D, int n_items, const void* item_seg,
                                const void* item_start, const void* col,
                                int blocks, void* stream) {
  if (n_items <= 0) return 0;
  if (D < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* xx = static_cast<const float*>(x);
  const float* yy = static_cast<const float*>(y);
  const int* sg = static_cast<const int*>(item_seg);
  const int* sa = static_cast<const int*>(item_start);
  const int* cl = static_cast<const int*>(col);
  // 16-byte row loads where every row of x and y starts 16-byte aligned
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(xx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(yy) % 16 == 0;
#define SRW_SDDMM(G, W)                                                  \
  sddmm_rows<G, W><<<blocks, kThreads, 0, st>>>(o, xx, yy, D, n_items, sg, \
                                                 sa, cl)
  if (!vec)
    SRW_SDDMM(32, 1);
  else if (D <= 32)
    SRW_SDDMM(8, 4);
  else if (D <= 64)
    SRW_SDDMM(16, 4);
  else
    SRW_SDDMM(32, 4);
#undef SRW_SDDMM
  return static_cast<int>(cudaGetLastError());
}

// The row softmax over the CSR order's items of at most `chunk` <= 32 *
// kPer arcs (mode 0: out = softmax(a); mode 1: out = a * (da - sum_row a *
// da)). item_start [n_items + 1] as for srw_sddmm_launch; item_part: the
// item's partial row, -1 for a whole row; part_desc int4 [parts]: a split
// item's first arc, its end, its row's first partial row and its row's
// items, in the order of their partial rows; partials: float [2 * parts];
// both null when no row is split. `blocks` blocks of kThreads (at most
// kSoftBlocks an SM are resident: ops/spmm.py::segment_grid): pass 1
// over the items, then, where a row is split, pass 2 over the split items
// in a second, programmatic launch. Returns the CUDA error.
extern "C" int srw_row_softmax_launch(void* out, const void* a,
                                      const void* da, int n_items,
                                      const void* item_start,
                                      const void* item_part, int chunk,
                                      const void* part_desc, int parts,
                                      void* partials, int mode, int blocks,
                                      void* stream) {
  if (n_items <= 0) return 0;
  if (blocks < 1 || chunk < 1 || chunk > 32 * kPer || parts < 0 ||
      (mode != 0 && mode != 1) || (mode == 1 && !da) ||
      (parts > 0 && (!part_desc || !partials)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* aa = static_cast<const float*>(a);
  const float* dd = static_cast<const float*>(da);
  const int* sa = static_cast<const int*>(item_start);
  const int* pt = static_cast<const int*>(item_part);
  const int4* pd = static_cast<const int4*>(part_desc);
  float* pa = static_cast<float*>(partials);
  row_softmax<<<blocks, kThreads, 0, st>>>(o, aa, dd, n_items, sa, pt, pd,
                                           parts, pa, mode, 1);
  if (parts == 0) return static_cast<int>(cudaGetLastError());
  // pass 2 as a programmatic dependent launch: it starts before pass 1
  // ends and waits in the kernel, so the launch's latency and its arcs'
  // loads overlap pass 1's last items
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(blocks, (parts + kWarps - 1) / kWarps));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, row_softmax, o, aa, dd,
                                             n_items, sa, pt, pd, parts, pa,
                                             mode, 2));
}
