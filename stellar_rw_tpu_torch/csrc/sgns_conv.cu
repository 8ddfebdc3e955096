// The shared-negative SGNS step in the shifted-window ("conv") form: its
// positive half and its scatter-mean with the update, in two kernels
// (sm_90a). The negative half between them is sgns_shared_grads
// (sgns_shared.cu).
//
// Replaces the non-band, single-replica branch of the JAX package's
// _sgns_apply_shared_conv (stellar_rw_tpu/models/word2vec.py:364-493). On a
// block [B, T] with dynamic windows cwin, a pair is (center t, context
// t + d) for 1 <= |d| <= cwin[t], both in the row and neither padding (-1):
//   g_pos(t, d)    = sigmoid(ein[t] . eout[t + d]) - 1 on a valid pair
//   acc_in[t]      = sum_d g_pos(t, d) * eout[t + d]     (+ the negative term)
//   acc_out[x]     = sum_d g_pos(x - d, d) * ein[x - d]
//   vcnt[t]        = valid pairs with center t
//   cnt_out_pos[x] = valid pairs with context x
// and each row of a table moves by -lr times the sum of its positions'
// accumulations over the sum of their counts (the negatives' rows by
// -lr * d_wn / cnt_n, cnt_n = max(valid pairs * neg_weight, 1)). XLA runs
// the 2w offsets as 2w shifted passes over dense [B, T, D] buffers and the
// scatter-mean over the vocabulary.
//
//   (a) sgns_conv_accumulate: a block of threads takes one walk b and a tile
//       of `tile` positions of it. It gathers the ein and eout rows of the
//       tile and of its halo (window positions on each side) by token into
//       shared memory, once for all 2w offsets (kTileReads loads in flight
//       a thread), and forms validity itself from the tokens, cwin and the
//       bounds (no [B, T, 2w] mask). Each pair's dot is taken twice, once by
//       its center's tile and once by its context's tile, so no block needs
//       another's g_pos; a thread takes a dot whole, lanes on neighbouring
//       offsets, rows padded to one bank apart. It writes ein (the negative
//       half's input, zero at padding), acc_in, acc_out, the two counts,
//       neg_weight * vcnt (the negative half's mask), each block's valid
//       pairs and the kB negative rows of w_out (wn). Rows wider than the
//       shared memory holds go in column slices: the dots summed over every
//       slice first, then the accumulations slice by slice. (A thread-block
//       cluster a walk, each row read once and each dot taken once, measured
//       slower at walk_10k's blocks on the H100: chip_conv_parts.py keeps it
//       as a variant.)
//   (b) sgns_conv_scatter: the scatter-mean and the update in one pass, by
//       token groups. ops/sgns_conv.py::group_blocks sorts each corpus
//       block's positions by token once a run (`order`) and cuts the groups
//       into units of at most `hub` positions (`units`: a unit's first
//       sorted index, bit 31 set where it continues its group). A warp
//       takes 128 columns of a unit and table and sums its positions'
//       d_in = acc_in + d_neg (w_in) or acc_out (w_out) in group order
//       (kBatch reads in flight, then their adds in order). A group of one
//       unit adds -lr * sum / count into its table row at once. A group
//       split over several units writes each unit's sum and count to
//       scratch (`part`, `unit_cnt`); the warp that arrives last at the
//       group's counter (`arrive`) sums them in unit order and adds once, so
//       a row takes one add whatever its group's size, and leaves the
//       counter at zero for the next step.
//       The adds are atomic: the negatives' rows (a warp a negative:
//       -lr * d_wn[k] / cnt_n) can repeat and can be rows of the block. No
//       delta slots, no row-to-slot map, no apply kernel.
//   In accumulate mode (srw_sgns_conv_scatter_accumulate_launch: one slot's
//   step of the data-parallel trainer's merged update) (b) adds a group's
//   sum into acc[tok] and its count into cnt[tok] of the merged update's
//   reduction buffer (its acc_in, acc_out, cnt_in and cnt_out arrays)
//   in place of -lr * sum / count into the table, and each negative's
//   d_wn * (valid pairs * neg_weight / cnt_n) into acc_out[negs[n]] with
//   cnt_n into cnt_out[negs[n]]: the negatives' counts merge with the
//   context rows' (the JAX package's psum'd step,
//   stellar_rw_tpu/models/word2vec.py:475-484), where one device divides
//   them on their own. These adds can meet a group's row, so they stay
//   atomic; csrc/dp_apply.cu moves the tables.
// Every gradient comes from the tables as they were before the step: (a)
// and the negative half only read them, (b) only adds into them. Sums run
// in another order than XLA's (a thread's dot in four partial sums,
// sum-then-divide for the scatter-mean, atomics between a group's add and
// its negatives'), so a step agrees with it to rounding.
//
// What bounds it: the row gathers (two rows a halo position) and the
// accumulations written, then read back with the table rows they update,
// against 2 * D flops a dot and a multiply-add an element and offset:
// bytes. At walk_10k's block the card's time goes to latency instead: the
// launch and two dependent reads from device memory. The tile is cut so
// that the grid fills the SMs (ops/sgns_conv.py::launch_plan mirrors it).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLow = 0x7fffffff;    // a unit's first sorted index
constexpr int kBatch = 8;           // rows a warp of (b) reads before adding
constexpr int kTileReads = 4;       // a thread's row loads in flight, (a)

// In accumulate mode, the merged update's reduction buffer: acc [2] the
// tables' [V, D] sums, cnt [2] their [V] counts. acc[0] null: the scatter
// updates the tables.
struct Merge {
  float* acc[2];
  float* cnt[2];
  // table t's arrays (a select, not an index: a parameter indexed by a
  // value known only at run time would be copied to local memory)
  __device__ float* acct(int t) const { return t == 0 ? acc[0] : acc[1]; }
  __device__ float* cntt(int t) const { return t == 0 ? cnt[0] : cnt[1]; }
};

struct ConvOut {
  float* ein;      // [N, D]
  float* acc_in;   // [N, D]
  float* acc_out;  // [N, D]
  float* mask;     // [N] neg_weight * vcnt
  int* cnt;        // [2, N] vcnt, cnt_out_pos
  int* valid;      // [blocks of (a)] valid pairs of a block's centers
  float* wn;       // [kB, D] w_out's rows of the negatives
};

// offset index o in [0, 2w) -> d in -w..-1, 1..w (the JAX package's order)
__device__ __forceinline__ int offset_of(int o, int window) {
  return o < window ? o - window : o - window + 1;
}

// halo rows hc (center) and hx (context) form a valid pair
__device__ __forceinline__ bool pair_ok(const int* tok, const int* win,
                                        int hc, int hx) {
  const int d = hx - hc;
  return tok[hc] >= 0 && tok[hx] >= 0 && abs(d) <= win[hc];
}

// columns [c0, c0 + w) of the halo's ein and eout rows into shared memory
// (rows of ld floats); a row outside the walk or at padding is zero. A
// thread's loads go out kTileReads at a time, all before the first is
// stored.
__device__ void load_halo(float* s_in, float* s_out, const int* tok,
                          const float* __restrict__ w_in,
                          const float* __restrict__ w_out, int H, int ld,
                          int D, int c0, int w, bool vec) {
  const int g = vec ? 4 : 1;         // floats a load: 4 when D, c0 and w
  const int wg = w / g, n = H * wg;  // are multiples of 4
  for (int i0 = threadIdx.x; i0 < n; i0 += blockDim.x * kTileReads) {
    float4 a[kTileReads], b[kTileReads];
#pragma unroll
    for (int u = 0; u < kTileReads; ++u) {
      const int i = i0 + u * blockDim.x;
      a[u] = b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int h = i / wg, c = (i - h * wg) * g;
      const int t = i < n ? tok[h] : -1;
      if (t < 0) continue;
      const size_t o = static_cast<size_t>(t) * D + c0 + c;
      if (vec) {
        a[u] = __ldg(reinterpret_cast<const float4*>(w_in + o));
        b[u] = __ldg(reinterpret_cast<const float4*>(w_out + o));
      } else {
        a[u].x = __ldg(w_in + o);
        b[u].x = __ldg(w_out + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kTileReads; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n) break;
      const int h = i / wg, c = (i - h * wg) * g;
      float* di = s_in + h * ld + c;
      float* dout = s_out + h * ld + c;
      di[0] = a[u].x;
      dout[0] = b[u].x;
      if (vec) {
        di[1] = a[u].y, di[2] = a[u].z, di[3] = a[u].w;
        dout[1] = b[u].y, dout[2] = b[u].z, dout[3] = b[u].w;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sgns_conv_accumulate(const float* __restrict__ w_in,
                         const float* __restrict__ w_out,
                         const int* __restrict__ block,
                         const int* __restrict__ cwin,
                         const int* __restrict__ negs, int kB, ConvOut o,
                         int T, int D, int window, int tile, int cols,
                         float neg_weight) {
  extern __shared__ __align__(16) float sm[];
  const int W2 = 2 * window, H = tile + W2;
  // rows ld = cols + 1 floats apart: the lanes of a warp that read 32
  // different rows at one column hit 32 different banks
  const int ld = cols + 1;
  float* s_in = sm;                         // [H, ld] ein rows
  float* s_out = s_in + H * ld;             // [H, ld] eout rows
  float* s_gc = s_out + H * ld;             // [tile, 2w] center-side dots
  float* s_gx = s_gc + tile * W2;           // [tile, 2w] context-side dots
  int* s_tok = reinterpret_cast<int*>(s_gx + tile * W2);  // [H]
  int* s_win = s_tok + H;                                 // [H]
  int* s_cnt = s_win + H;                   // [2, tile] vcnt, cnt_out_pos
  __shared__ int s_valid;

  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int nt = min(tile, T - t0);         // the tile's positions
  const int hb = t0 - window;               // halo row 0's position
  const int lane = threadIdx.x & 31;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int nctas = gridDim.x * gridDim.y;
  const size_t N = static_cast<size_t>(gridDim.y) * T;

  if (threadIdx.x == 0) s_valid = 0;
  for (int k = cta; k < kB; k += nctas) {   // the negatives' rows
    const float* src = w_out + static_cast<size_t>(negs[k]) * D;
    float* dst = o.wn + static_cast<size_t>(k) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) dst[c] = __ldg(src + c);
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int t = hb + h;
    const bool in = t >= 0 && t < T;
    s_tok[h] = in ? block[static_cast<size_t>(b) * T + t] : -1;
    s_win[h] = in ? cwin[static_cast<size_t>(b) * T + t] : 0;
  }
  for (int i = threadIdx.x; i < 2 * tile * W2; i += blockDim.x) s_gc[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();

  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(w_in) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  const int slices = (D + cols - 1) / cols;
  const int items = nt * W2;
  // the dots, slice by slice; a thread an item (side, position, offset),
  // neighbouring lanes on neighbouring offsets; the pair counts with the
  // first slice
  for (int s = 0; s < slices; ++s) {
    const int c0 = s * cols, w = min(cols, D - c0);
    if (s > 0) __syncthreads();
    load_halo(s_in, s_out, s_tok, w_in, w_out, H, ld, D, c0, w, vec);
    __syncthreads();
    for (int it = threadIdx.x; it < 2 * items; it += blockDim.x) {
      const int side = it >= items, r = it - side * items;
      const int tl = r / W2, d = offset_of(r - tl * W2, window);
      // side 0: center tl, context tl + d; side 1: context tl, center tl - d
      const int hc = window + tl - side * d, hx = hc + d;
      if (!pair_ok(s_tok, s_win, hc, hx)) continue;
      const float* a = s_in + hc * ld;
      const float* e = s_out + hx * ld;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int c = 0;
      for (; c + 4 <= w; c += 4) {
        s0 = fmaf(a[c], e[c], s0);
        s1 = fmaf(a[c + 1], e[c + 1], s1);
        s2 = fmaf(a[c + 2], e[c + 2], s2);
        s3 = fmaf(a[c + 3], e[c + 3], s3);
      }
      for (; c < w; ++c) s0 = fmaf(a[c], e[c], s0);
      (side ? s_gx : s_gc)[r] += (s0 + s1) + (s2 + s3);
      if (s == 0) atomicAdd(s_cnt + side * tile + tl, 1);
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < 2 * items; it += blockDim.x) {
    const int side = it >= items, r = it - side * items;
    const int tl = r / W2, d = offset_of(r - tl * W2, window);
    const int hc = window + tl - side * d;
    float* g = (side ? s_gx : s_gc) + r;
    *g = pair_ok(s_tok, s_win, hc, hc + d) ? 1.f / (1.f + expf(-*g)) - 1.f
                                           : 0.f;
  }
  int my_valid = 0;
  for (int tl = threadIdx.x; tl < nt; tl += blockDim.x) {
    const int vc = s_cnt[tl];
    const size_t p = static_cast<size_t>(b) * T + t0 + tl;
    o.cnt[p] = vc;
    o.cnt[N + p] = s_cnt[tile + tl];
    o.mask[p] = neg_weight * static_cast<float>(vc);
    my_valid += vc;
  }
  for (int sh = 16; sh; sh >>= 1)
    my_valid += __shfl_xor_sync(kFull, my_valid, sh);
  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);
  __syncthreads();
  if (threadIdx.x == 0) o.valid[cta] = s_valid;

  // the accumulations, a thread an element (position, column) of a slice;
  // the last slice loaded is still in shared memory
  for (int s = slices - 1; s >= 0; --s) {
    const int c0 = s * cols, w = min(cols, D - c0);
    if (s < slices - 1) {
      __syncthreads();
      load_halo(s_in, s_out, s_tok, w_in, w_out, H, ld, D, c0, w, vec);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nt * w; i += blockDim.x) {
      const int tl = i / w, c = i - tl * w, h = window + tl;
      const float* gc = s_gc + tl * W2;
      const float* gx = s_gx + tl * W2;
      float ai = 0.f, ao = 0.f;
#pragma unroll 4
      for (int oi = 0; oi < W2; ++oi) {
        const int d = offset_of(oi, window);
        ai = fmaf(gc[oi], s_out[(h + d) * ld + c], ai);
        ao = fmaf(gx[oi], s_in[(h - d) * ld + c], ao);
      }
      const size_t e = (static_cast<size_t>(b) * T + t0 + tl) * D + c0 + c;
      o.acc_in[e] = ai;
      o.acc_out[e] = ao;
      o.ein[e] = s_in[h * ld + c];
    }
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int sh = 16; sh; sh >>= 1) v += __shfl_xor_sync(kFull, v, sh);
  return v;
}

// the units [u0, u1) of unit u's token group: back to the unit that starts
// it, on to the unit after its last (a unit without bit 31, or the end)
__device__ void group_units(const int* __restrict__ units, int N, int u,
                            int lane, int* u0, int* u1) {
  int v = u;
  for (;;) {
    const int i = v - lane;
    const unsigned m = __ballot_sync(kFull, i >= 0 && units[i] >= 0);
    if (m) {
      v -= __ffs(m) - 1;
      break;
    }
    v -= 32;
  }
  *u0 = v;
  for (v = u + 1; v < N; v += 32) {
    const int i = v + lane;
    const unsigned m = __ballot_sync(kFull, i >= N || units[i] >= 0);
    if (m) {
      v += __ffs(m) - 1;
      break;
    }
  }
  *u1 = min(v, N);
}

// four floats of a row at column c (zero beyond D): through L1, or from L2
// alone (kL2: data another block of this launch wrote)
template <bool kL2>
__device__ __forceinline__ float4 load4(const float* row, int c, int D,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(row + c);
    if (c < D) v = kL2 ? __ldcg(p) : *p;
  } else {
    const float* p = row + c;
    if (c < D) v.x = kL2 ? __ldcg(p) : p[0];
    if (c + 1 < D) v.y = kL2 ? __ldcg(p + 1) : p[1];
    if (c + 2 < D) v.z = kL2 ? __ldcg(p + 2) : p[2];
    if (c + 3 < D) v.w = kL2 ? __ldcg(p + 3) : p[3];
  }
  return v;
}

// the sum of `rows` rows of `src` picked by rows_at(j), 0 <= j < rows, in
// order, at a lane's four columns c..c+3 (zero beyond D): kBatch reads in
// flight, then their adds in order. `ld`: the rows' stride in floats.
template <bool kL2, typename RowAt>
__device__ float4 sum_rows(const float* src, RowAt rows_at, int rows,
                           int lane, int c, int D, size_t ld, bool vec) {
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < rows; j0 += 32) {
    const int pj = j0 + lane < rows ? rows_at(j0 + lane) : 0;
    const int m = min(32, rows - j0);
    for (int j1 = 0; j1 < m; j1 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int p = __shfl_sync(kFull, pj, min(j1 + j, 31));
        v[j] = j1 + j < m
                   ? load4<kL2>(src + static_cast<size_t>(p) * ld, c, D, vec)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j1 + j >= m) break;
        sum.x += v[j].x, sum.y += v[j].y, sum.z += v[j].z, sum.w += v[j].w;
      }
    }
  }
  return sum;
}

// the counts of sorted positions [s, e) of one table, summed by a warp
__device__ __forceinline__ int group_count(const int* c_t, const int* order,
                                           int s, int e, int lane) {
  int total = 0;
  for (int j = s + lane; j < e; j += 32) total += c_t[order[j]];
  return warp_sum(total);
}

__global__ void __launch_bounds__(kThreads)
    sgns_conv_scatter(const int* __restrict__ block,
                      const int* __restrict__ order,
                      const int* __restrict__ units_of,
                      const float* __restrict__ d_in,
                      const float* __restrict__ acc_out,
                      const int* __restrict__ cnt,
                      const float* __restrict__ d_wn,
                      const int* __restrict__ negs, int kB,
                      const int* __restrict__ valid, int nvalid,
                      float neg_weight, float lr, float* w_in, float* w_out,
                      float* part, int* unit_cnt, int* arrive, int N,
                      int D, Merge merge) {
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x >> 5);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(d_in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc_out) % 16 == 0;
  const int chunks = (D + 127) / 128;   // 128 columns a warp: a float4 a lane
  const size_t ld = static_cast<size_t>(chunks) * 128;   // a part row
  const int unit_items = 2 * N * chunks;
  for (int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       item < unit_items + kB; item += nwarps) {
    if (item < unit_items) {
      // 128 columns of a unit of a token group, for one table
      const int u = item / (2 * chunks), r = item - u * 2 * chunks;
      const int tb = r / chunks, ch = r - tb * chunks;
      const int c = ch * 128 + 4 * lane;
      const int a = units_of[u] & kLow;
      const int b = u + 1 < N ? units_of[u + 1] & kLow : N;
      if (a >= b) continue;
      const int tok = block[order[a]];
      if (tok < 0) continue;   // the padding, sorted last
      const float* src = tb ? acc_out : d_in;
      const int* c_t = cnt + static_cast<size_t>(tb) * N;
      const auto at = [&](int j) { return order[a + j]; };
      float4 sum;
      int total;
      if (units_of[u] >= 0 && (u + 1 >= N || units_of[u + 1] >= 0)) {
        // a group of one unit
        total = group_count(c_t, order, a, b, lane);
        if (total == 0) continue;
        sum = sum_rows<false>(src, at, b - a, lane, c, D, D, vec);
      } else {
        // a split group: this unit's sum and count to scratch; the last
        // unit to arrive sums every unit's in unit order
        const int mine_cnt = group_count(c_t, order, a, b, lane);
        sum = sum_rows<false>(src, at, b - a, lane, c, D, D, vec);
        int u0, u1;
        group_units(units_of, N, u, lane, &u0, &u1);
        float* mine = part + (static_cast<size_t>(tb) * N + u) * ld + c;
        *reinterpret_cast<float4*>(mine) = sum;
        if (lane == 0) unit_cnt[static_cast<size_t>(tb) * N + u] = mine_cnt;
        __threadfence();
        __syncwarp();
        int* counter = arrive + (static_cast<size_t>(tb) * N + u0) * chunks
                       + ch;
        int last = 0;
        if (lane == 0) last = atomicAdd(counter, 1) == u1 - u0 - 1;
        if (!__shfl_sync(kFull, last, 0)) continue;
        __threadfence();
        if (lane == 0) *counter = 0;
        total = 0;
        for (int v = u0 + lane; v < u1; v += 32)
          total += __ldcg(unit_cnt + static_cast<size_t>(tb) * N + v);
        total = warp_sum(total);
        if (total == 0) continue;
        sum = sum_rows<true>(part + static_cast<size_t>(tb) * N * ld,
                             [&](int j) { return u0 + j; }, u1 - u0, lane, c,
                             D, ld, true);
      }
      if (merge.acc[0]) {  // accumulate mode: the group's sum and count
        float* acc = merge.acct(tb) + static_cast<size_t>(tok) * D;
        if (c < D) atomicAdd(acc + c, sum.x);
        if (c + 1 < D) atomicAdd(acc + c + 1, sum.y);
        if (c + 2 < D) atomicAdd(acc + c + 2, sum.z);
        if (c + 3 < D) atomicAdd(acc + c + 3, sum.w);
        if (ch == 0 && lane == 0)
          atomicAdd(merge.cntt(tb) + tok, static_cast<float>(total));
        continue;
      }
      const float div = static_cast<float>(total);
      float* dst = (tb ? w_out : w_in) + static_cast<size_t>(tok) * D;
      if (c < D) atomicAdd(dst + c, (-lr * sum.x) / div);
      if (c + 1 < D) atomicAdd(dst + c + 1, (-lr * sum.y) / div);
      if (c + 2 < D) atomicAdd(dst + c + 2, (-lr * sum.z) / div);
      if (c + 3 < D) atomicAdd(dst + c + 3, (-lr * sum.w) / div);
    } else {
      const int n = item - unit_items;
      int total = 0;
      for (int i = lane; i < nvalid; i += 32) total += valid[i];
      total = warp_sum(total);
      const float cnt_n = fmaxf(static_cast<float>(total) * neg_weight, 1.f);
      const float* g = d_wn + static_cast<size_t>(n) * D;
      if (merge.acc[0]) {  // accumulate mode: into acc_out and cnt_out
        const float scale = static_cast<float>(total) * neg_weight / cnt_n;
        float* acc = merge.acc[1] + static_cast<size_t>(negs[n]) * D;
        for (int j = lane; j < D; j += 32) atomicAdd(acc + j, g[j] * scale);
        if (lane == 0) atomicAdd(merge.cnt[1] + negs[n], cnt_n);
        continue;
      }
      float* w = w_out + static_cast<size_t>(negs[n]) * D;
      for (int j = lane; j < D; j += 32) atomicAdd(w + j, (-lr * g[j]) / cnt_n);
    }
  }
}

}  // namespace

// Kernel (a) on a block [B, T] under ops/sgns_conv.py::launch_plan: a grid
// of (tiles, B) blocks of kThreads, `tile` positions a block, `cols` columns
// a slice, `smem` bytes of dynamic shared memory. out: ein, acc_in, acc_out,
// mask, cnt, valid, wn. Returns the CUDA error of the launch.
extern "C" int srw_sgns_conv_accumulate_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, int kB, void* const* out, int B, int T, int D,
    int window, int tile, int tiles, int cols, int smem, float neg_weight,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || window < 1 || tile < 1 || cols < 1 || kB < 0 ||
      static_cast<long long>(tile) * tiles < T || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvOut o;
  o.ein = static_cast<float*>(out[0]);
  o.acc_in = static_cast<float*>(out[1]);
  o.acc_out = static_cast<float*>(out[2]);
  o.mask = static_cast<float*>(out[3]);
  o.cnt = static_cast<int*>(out[4]);
  o.valid = static_cast<int*>(out[5]);
  o.wn = static_cast<float*>(out[6]);
  cudaError_t err = cudaFuncSetAttribute(
      sgns_conv_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sgns_conv_accumulate<<<dim3(tiles, B), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_in), static_cast<const float*>(w_out),
      static_cast<const int*>(block), static_cast<const int*>(cwin),
      static_cast<const int*>(negs), kB, o, T, D, window, tile, cols,
      neg_weight);
  return static_cast<int>(cudaGetLastError());
}

// Kernel (b): `blocks` blocks of kThreads over the 2N (unit, table) items
// and the kB negatives. order, units [N]: the block's grouping
// (ops/sgns_conv.py::group_blocks); d_in = acc_in + d_neg [N, D]; acc_out
// [N, D]; cnt [2, N]; d_wn [kB, D]; valid [nvalid] (kernel (a)'s counts);
// part [2, N, ceil(D / 128) * 128] and unit_cnt [2, N] the split groups'
// unit sums and counts; arrive [2, N, ceil(D / 128)] their counters, zero
// before and after. Adds into w_in and w_out, or, through the accumulate
// entry point, into the reduction buffer's acc_in, acc_out [V, D] and
// cnt_in, cnt_out [V] (lr is not read). Returns the CUDA error of the
// launch.
namespace {

int run_scatter(const void* block, const void* order, const void* units,
                const void* d_in, const void* acc_out, const void* cnt,
                const void* d_wn, const void* negs, int kB,
                const void* valid, int nvalid, float neg_weight, float lr,
                void* w_in, void* w_out, void* part, void* unit_cnt,
                void* arrive, int N, int D, int blocks, Merge merge,
                void* stream) {
  if (2 * N + kB <= 0) return 0;
  sgns_conv_scatter<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block), static_cast<const int*>(order),
      static_cast<const int*>(units), static_cast<const float*>(d_in),
      static_cast<const float*>(acc_out), static_cast<const int*>(cnt),
      static_cast<const float*>(d_wn), static_cast<const int*>(negs), kB,
      static_cast<const int*>(valid), nvalid, neg_weight, lr,
      static_cast<float*>(w_in), static_cast<float*>(w_out),
      static_cast<float*>(part), static_cast<int*>(unit_cnt),
      static_cast<int*>(arrive), N, D, merge);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srw_sgns_conv_scatter_launch(
    const void* block, const void* order, const void* units,
    const void* d_in, const void* acc_out, const void* cnt, const void* d_wn,
    const void* negs, int kB, const void* valid, int nvalid,
    float neg_weight, float lr, void* w_in, void* w_out, void* part,
    void* unit_cnt, void* arrive, int N, int D, int blocks, void* stream) {
  return run_scatter(block, order, units, d_in, acc_out, cnt, d_wn, negs, kB,
                     valid, nvalid, neg_weight, lr, w_in, w_out, part,
                     unit_cnt, arrive, N, D, blocks, Merge{}, stream);
}

extern "C" int srw_sgns_conv_scatter_accumulate_launch(
    const void* block, const void* order, const void* units,
    const void* d_in, const void* acc_out, const void* cnt, const void* d_wn,
    const void* negs, int kB, const void* valid, int nvalid,
    float neg_weight, float lr, void* w_in, void* w_out, void* part,
    void* unit_cnt, void* arrive, int N, int D, int blocks, void* acc_in,
    void* acc_out_buf, void* cnt_in, void* cnt_out, void* stream) {
  if (!acc_in || !acc_out_buf || !cnt_in || !cnt_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const Merge merge{{static_cast<float*>(acc_in),
                     static_cast<float*>(acc_out_buf)},
                    {static_cast<float*>(cnt_in),
                     static_cast<float*>(cnt_out)}};
  return run_scatter(block, order, units, d_in, acc_out, cnt, d_wn, negs, kB,
                     valid, nvalid, neg_weight, lr, w_in, w_out, part,
                     unit_cnt, arrive, N, D, blocks, merge, stream);
}
