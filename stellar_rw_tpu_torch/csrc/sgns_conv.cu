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
//       shared memory by cp.async (16 bytes a copy through L1 where D % 4 ==
//       0, rows unpadded), once for all 2w offsets, and forms validity
//       itself from the tokens, cwin and the bounds (no [B, T, 2w] mask). A
//       warp takes a tile position x, a lane four columns of each 128-column
//       chunk: the 2w dots of x as a center (ein[x] . eout[x + d]) and as a
//       context (ein[x - d] . eout[x]), each side's lane shares of 32
//       offsets summed by one transposed butterfly, g_pos formed by the
//       lane of each offset, the pair counts by ballots, then acc_in and
//       acc_out of x from the rows around it. Each pair's dot is taken
//       twice, by its center's tile and by its context's, so no block needs
//       another's g_pos. It writes ein (the negative half's input, zero at
//       padding), acc_in, acc_out, the two counts, neg_weight * vcnt (the
//       negative half's mask), each block's valid pairs and the kB negative
//       rows of w_out (wn). Rows wider than the shared memory holds go in
//       column slices of a multiple of 32 columns: the dots summed over
//       every slice first, then the accumulations slice by slice. (Three
//       forms measured slower at walk_10k's blocks on the H100: the halo
//       tiles a thread a dot, this kernel's first design; a thread-block
//       cluster a walk that splits its positions, chip_conv_cluster.cu; one
//       that splits its columns, chip_conv_split.cu, which is faster at
//       D 768. The last two stay variants of chip_conv_parts.py.)
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
//   (c) sgns_conv_scatter_accumulate (srw_sgns_conv_scatter_accumulate_launch:
//       one slot's step of the data-parallel trainer's merged update) adds
//       into the merged update's reduction buffer (acc_in, acc_out [V, D],
//       cnt_in, cnt_out [V]) in place of (b)'s update of the tables, with no
//       token groups: nothing is divided by a row's count here
//       (csrc/dp_apply.cu divides the summed buffer), so each position adds
//       its d_in row into acc_in[tok] and its acc_out row into acc_out[tok]
//       and its two counts into cnt_in[tok] and cnt_out[tok]; a thread takes
//       four columns of a (position, table) item and adds them by one
//       16-byte vector reduction (atomicAdd on float4, sm_90). A position
//       whose count in a table is 0 adds nothing there: its row is exactly 0
//       (g_pos masked, the negative term weighted by neg_weight * vcnt), so a
//       row with count 0 keeps acc 0, which csrc/dp_apply.cu relies on to
//       skip it. (Runs of positions summed in registers before their add
//       measured slower at walk_10k's block: chip_conv_runs.cu, a variant
//       of chip_conv_parts.py.) Each negative adds d_wn * (valid pairs * neg_weight /
//       cnt_n) into acc_out[negs[n]] and cnt_n into cnt_out[negs[n]], beside
//       the context rows' (the JAX package's psum'd step,
//       stellar_rw_tpu/models/word2vec.py:475-484), where one device divides
//       them on their own; the valid pairs are summed once a thread block that
//       holds a negative, and the negatives come first in the thread order,
//       so those are the grid's first blocks.
// Every gradient comes from the tables as they were before the step: (a)
// and the negative half only read them, (b) only adds into them. Sums run
// in another order than XLA's (a dot in lane shares and a butterfly,
// sum-then-divide for the scatter-mean, atomics between a group's add and
// its negatives'), so a step agrees with it to rounding.
//
// What bounds it: the row gathers (two rows a halo position) and the
// accumulations written, then read back with the table rows they update,
// against 2 * D flops a dot and a multiply-add an element and offset:
// bytes. At walk_10k's block the card's time goes to latency and issue
// instead: the launch, two dependent reads from device memory and the
// shared loads of the dots and sums, which a warp a position takes as
// 16-byte loads and butterflies. The tile is cut so that the grid fills the
// SMs (ops/sgns_conv.py::launch_plan mirrors it).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLow = 0x7fffffff;    // a unit's first sorted index
constexpr int kBatch = 8;           // rows a warp of (b) reads before adding
// threads a block of (a) at one chunk of 128 columns a slice (a warp takes
// two of a tile's 8 positions); twice as many at more chunks
constexpr int kAccThreads = 128;
// blocks an SM that ptxas must fit (a) in at kAccThreads threads: walk_10k's
// 352 blocks in one wave on 132 SMs (at 2, 169 registers, it takes two)
constexpr int kAccBlocks = 3;

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

__device__ __forceinline__ void acc_cp_async16(void* dst, const void* src,
                                                bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void acc_cp_async4(void* dst, const void* src,
                                              bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ float4 acc_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float acc_dot4(float4 a, float4 e, float v) {
  v = fmaf(a.x, e.x, v);
  v = fmaf(a.y, e.y, v);
  v = fmaf(a.z, e.z, v);
  return fmaf(a.w, e.w, v);
}

__device__ __forceinline__ float4 acc_fma4(float g, float4 v, float4 a) {
  return make_float4(fmaf(g, v.x, a.x), fmaf(g, v.y, a.y), fmaf(g, v.z, a.z),
                     fmaf(g, v.w, a.w));
}

// The transposed butterfly's steps H, H / 2, ..., 1 over the lanes: each
// lane holds its shares s[k] of 2H sums; after the steps s[0] of lane r is
// sum r over the lanes (in a fixed tree: each pair of lanes added as a full
// butterfly would add them).
template <int H, int N>
__device__ __forceinline__ void acc_fold(float (&s)[N], int r) {
  const bool up = r & H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? s[k] : s[k + H];
    const float keep = up ? s[k + H] : s[k];
    s[k] = keep + __shfl_xor_sync(kFull, send, H);
  }
  if constexpr (H > 1) acc_fold<H / 2>(s, r);
}

// columns [c0, c0 + w) of the halo's ein and eout rows (rows of `cols`
// floats): zero outside the walk, at padding and beyond w
__device__ void acc_gather(float* s_in, float* s_out, const int* s_tok,
                           const float* __restrict__ w_in,
                           const float* __restrict__ w_out, int H, int D,
                           int cols, int c0, int w, bool vec) {
  const int g = vec ? 4 : 1, per = cols / g, n = H * per;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / per, c = (i - h * per) * g;
    const int tok = s_tok[h];
    const bool ok = tok >= 0 && c < w;
    const size_t src = ok ? static_cast<size_t>(tok) * D + c0 + c : 0;
    float* di = s_in + h * cols + c;
    float* dout = s_out + h * cols + c;
    if (vec) {
      acc_cp_async16(di, w_in + src, ok);
      acc_cp_async16(dout, w_out + src, ok);
    } else {
      acc_cp_async4(di, w_in + src, ok);
      acc_cp_async4(dout, w_out + src, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kBlock>
__global__ void __launch_bounds__(kBlock,
                                  kBlock == kAccThreads ? kAccBlocks : 1)
    sgns_conv_accumulate(const float* __restrict__ w_in,
                         const float* __restrict__ w_out,
                         const int* __restrict__ block,
                         const int* __restrict__ cwin,
                         const int* __restrict__ negs, int kB, ConvOut o,
                         int T, int D, int window, int tile, int cols,
                         float neg_weight) {
  extern __shared__ __align__(16) float sm[];
  const int W2 = 2 * window, H = tile + W2;
  float* s_in = sm;                         // [H, cols] ein rows
  float* s_out = s_in + H * cols;           // [H, cols] eout rows
  float* s_dot = s_out + H * cols;          // [2, tile, 2w] dots, then g_pos
  int* s_tok = reinterpret_cast<int*>(s_dot + 2 * tile * W2);  // [H]
  int* s_win = s_tok + H;                                      // [H]
  __shared__ int s_valid;

  const int b = blockIdx.y, t0 = blockIdx.x * tile;
  const int nt = min(tile, T - t0);
  const int hb = t0 - window;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int nctas = gridDim.x * gridDim.y;
  const size_t N = static_cast<size_t>(gridDim.y) * T;
  const int slices = (D + cols - 1) / cols;
  const int chunks = (cols + 127) / 128;

  if (threadIdx.x == 0) s_valid = 0;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int t = hb + h;
    const bool in = t >= 0 && t < T;
    s_tok[h] = in ? block[static_cast<size_t>(b) * T + t] : -1;
    s_win[h] = in ? cwin[static_cast<size_t>(b) * T + t] : 0;
  }
  __syncthreads();

  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(w_in) % 16 == 0
                   && reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  // the dots, slice by slice: a warp a position, each side's 32 offsets of
  // a round summed over the lanes by one transposed butterfly
  for (int s = 0; s < slices; ++s) {
    const int c0 = s * cols, w = min(cols, D - c0);
    if (s > 0) __syncthreads();
    acc_gather(s_in, s_out, s_tok, w_in, w_out, H, D, cols, c0, w, vec);
    __syncthreads();
    for (int tl = warp; tl < nt; tl += nwarps) {
      const int h = window + tl;
      for (int o0 = 0; o0 < W2; o0 += 32) {
        float vc[32], vx[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) vc[k] = vx[k] = 0.f;
        for (int ch = 0; ch < chunks; ++ch) {
          const int c = 4 * (ch * 32 + lane);
          if (c >= cols) break;   // a slice narrower than its chunks
          const float4 ai = acc_ld4(s_in + h * cols + c);
          const float4 ao = acc_ld4(s_out + h * cols + c);
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            if (o0 + k >= W2) break;
            const int d = offset_of(o0 + k, window);
            vc[k] = acc_dot4(ai, acc_ld4(s_out + (h + d) * cols + c), vc[k]);
            vx[k] = acc_dot4(acc_ld4(s_in + (h - d) * cols + c), ao, vx[k]);
          }
        }
        acc_fold<16>(vc, lane);
        acc_fold<16>(vx, lane);
        const int oi = o0 + lane;
        if (oi < W2) {
          float* pc = s_dot + tl * W2 + oi;
          float* px = pc + tile * W2;
          *pc = s == 0 ? vc[0] : *pc + vc[0];
          *px = s == 0 ? vx[0] : *px + vx[0];
        }
      }
    }
  }
  // g_pos of both sides by the lane of each offset, the pair counts by
  // ballots; each warp reads back only its own positions' dots
  __syncwarp();
  int my_valid = 0;
  for (int tl = warp; tl < nt; tl += nwarps) {
    const int h = window + tl;
    int vc = 0, vx = 0;
    for (int o0 = 0; o0 < W2; o0 += 32) {
      const int oi = o0 + lane;
      bool okc = false, okx = false;
      if (oi < W2) {
        const int d = offset_of(oi, window);
        okc = s_tok[h] >= 0 && s_tok[h + d] >= 0 && abs(d) <= s_win[h];
        okx = s_tok[h - d] >= 0 && s_tok[h] >= 0 && abs(d) <= s_win[h - d];
        float* pc = s_dot + tl * W2 + oi;
        float* px = pc + tile * W2;
        *pc = okc ? 1.f / (1.f + expf(-*pc)) - 1.f : 0.f;
        *px = okx ? 1.f / (1.f + expf(-*px)) - 1.f : 0.f;
      }
      vc += __popc(__ballot_sync(kFull, okc));
      vx += __popc(__ballot_sync(kFull, okx));
    }
    if (lane == 0) {
      const size_t p = static_cast<size_t>(b) * T + t0 + tl;
      o.cnt[p] = vc;
      o.cnt[N + p] = vx;
      o.mask[p] = neg_weight * static_cast<float>(vc);
      my_valid += vc;
    }
  }
  if (lane == 0 && my_valid) atomicAdd(&s_valid, my_valid);
  __syncwarp();

  // the accumulations, slice by slice (the last slice gathered first): a
  // warp a position, a float4 a lane
  for (int s = slices - 1; s >= 0; --s) {
    const int c0 = s * cols, w = min(cols, D - c0);
    if (s < slices - 1) {
      __syncthreads();
      acc_gather(s_in, s_out, s_tok, w_in, w_out, H, D, cols, c0, w, vec);
      __syncthreads();
    }
    for (int tl = warp; tl < nt; tl += nwarps) {
      const int h = window + tl;
      const float* gc = s_dot + tl * W2;
      const float* gx = gc + tile * W2;
      for (int ch = 0; ch < chunks; ++ch) {
        const int c = 4 * (ch * 32 + lane);
        if (c >= w) break;
        float4 ai = make_float4(0.f, 0.f, 0.f, 0.f), ao = ai;
        for (int oi = 0; oi < W2; ++oi) {
          const int d = offset_of(oi, window);
          ai = acc_fma4(gc[oi], acc_ld4(s_out + (h + d) * cols + c), ai);
          ao = acc_fma4(gx[oi], acc_ld4(s_in + (h - d) * cols + c), ao);
        }
        const float4 ei = acc_ld4(s_in + h * cols + c);
        const size_t e = (static_cast<size_t>(b) * T + t0 + tl) * D + c0 + c;
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
  for (int k = cta; k < kB; k += nctas) {
    const float* src = w_out + static_cast<size_t>(negs[k]) * D;
    float* dst = o.wn + static_cast<size_t>(k) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) dst[c] = __ldg(src + c);
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

// Two resident blocks an SM asked of ptxas: with the block size alone it
// builds this kernel in 64 registers and an 8-byte stack frame, 2% slower
// at walk_10k's block (chip_conv_parts.py); with two, 76 and none.
__global__ void __launch_bounds__(kThreads, 2)
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
                      int D) {
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
      float* w = w_out + static_cast<size_t>(negs[n]) * D;
      const float* g = d_wn + static_cast<size_t>(n) * D;
      for (int j = lane; j < D; j += 32) atomicAdd(w + j, (-lr * g[j]) / cnt_n);
    }
  }
}


// a 16-byte vector reduction: four floats added at p (p 16-byte aligned)
__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// four floats of a row added at column c of `row` (none beyond D): one
// vector reduction where the row allows it, else one add a float
__device__ __forceinline__ void add4(float* row, int c, int D, float4 v,
                                     bool vec) {
  if (vec) {
    red4(row + c, v);
    return;
  }
  if (c < D) atomicAdd(row + c, v.x);
  if (c + 1 < D) atomicAdd(row + c + 1, v.y);
  if (c + 2 < D) atomicAdd(row + c + 2, v.z);
  if (c + 3 < D) atomicAdd(row + c + 3, v.w);
}

__global__ void __launch_bounds__(kThreads)
    sgns_conv_scatter_accumulate(const int* __restrict__ block,
                                 const float* __restrict__ d_in,
                                 const float* __restrict__ acc_out,
                                 const int* __restrict__ cnt,
                                 const float* __restrict__ d_wn,
                                 const int* __restrict__ negs, int kB,
                                 const int* __restrict__ valid, int nvalid,
                                 float neg_weight, int N, int D,
                                 float* acc_in_buf, float* acc_out_buf,
                                 float* cnt_in_buf, float* cnt_out_buf) {
  __shared__ int s_total;
  const int G = (D + 3) / 4;              // a thread's four columns
  const int neg_items = kB * G;   // the launch checks that items fit an int
  const int items = neg_items + N * 2 * G;
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
    const int t = rest & 1, p = rest >> 1;
    const int tok = block[p];
    if (tok < 0) continue;   // padding
    const int num = cnt[static_cast<size_t>(t) * N + p];
    if (num == 0) continue;  // its row is exactly 0
    const float4 v = load4<false>((t ? acc_out : d_in) +
                                      static_cast<size_t>(p) * D, c, D, vec);
    add4((t ? acc_out_buf : acc_in_buf) + static_cast<size_t>(tok) * D, c, D,
         v, vec);
    if (c == 0)
      atomicAdd((t ? cnt_out_buf : cnt_in_buf) + tok, static_cast<float>(num));
  }
}

}  // namespace

// Kernel (a) on a block [B, T] under ops/sgns_conv.py::launch_plan: a grid
// of (tiles, B) blocks, `tile` positions a block, `cols` columns a slice (a
// multiple of 32), `smem` bytes of dynamic shared memory; kAccThreads
// threads a block at one 128-column chunk a slice, twice as many at more.
// out: ein, acc_in, acc_out, mask, cnt, valid, wn. Returns the CUDA error
// of the launch.
extern "C" int srw_sgns_conv_accumulate_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, int kB, void* const* out, int B, int T, int D,
    int window, int tile, int tiles, int cols, int smem, float neg_weight,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || window < 1 || tile < 1 || cols < 32 || cols % 32 != 0 ||
      kB < 0 || static_cast<long long>(tile) * tiles < T || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvOut o;
  o.ein = static_cast<float*>(out[0]);
  o.acc_in = static_cast<float*>(out[1]);
  o.acc_out = static_cast<float*>(out[2]);
  o.mask = static_cast<float*>(out[3]);
  o.cnt = static_cast<int*>(out[4]);
  o.valid = static_cast<int*>(out[5]);
  o.wn = static_cast<float*>(out[6]);
  const auto kernel = cols > 128 ? sgns_conv_accumulate<2 * kAccThreads>
                                  : sgns_conv_accumulate<kAccThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = cols > 128 ? 2 * kAccThreads : kAccThreads;
  kernel<<<dim3(tiles, B), threads, smem,
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
// before and after. Adds into w_in and w_out. Returns the CUDA error of the
// launch.
extern "C" int srw_sgns_conv_scatter_launch(
    const void* block, const void* order, const void* units,
    const void* d_in, const void* acc_out, const void* cnt, const void* d_wn,
    const void* negs, int kB, const void* valid, int nvalid,
    float neg_weight, float lr, void* w_in, void* w_out, void* part,
    void* unit_cnt, void* arrive, int N, int D, int blocks, void* stream) {
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
      static_cast<int*>(arrive), N, D);
  return static_cast<int>(cudaGetLastError());
}

// Kernel (c): `blocks` blocks of kThreads over the kB * ceil(D / 4)
// negatives' threads and the N * 2 * ceil(D / 4) positions' threads.
// d_in = acc_in + d_neg [N, D]; acc_out [N, D]; cnt [2, N]; d_wn [kB, D];
// valid [nvalid] (kernel (a)'s counts). Adds into
// the reduction buffer's acc_in, acc_out [V, D] and cnt_in, cnt_out [V].
// Returns the CUDA error of the launch.
extern "C" int srw_sgns_conv_scatter_accumulate_launch(
    const void* block, const void* d_in, const void* acc_out,
    const void* cnt, const void* d_wn, const void* negs, int kB,
    const void* valid, int nvalid, float neg_weight, int N, int D,
    int blocks, void* acc_in_buf, void* acc_out_buf, void* cnt_in_buf,
    void* cnt_out_buf, void* stream) {
  if (N + kB <= 0 || D <= 0) return 0;
  const long long G = (D + 3) / 4;
  if (blocks < 1 || kB < 0 || N < 0 ||
      (kB + 2LL * N) * G +
          static_cast<long long>(blocks) * kThreads > INT_MAX ||
      !acc_in_buf || !acc_out_buf || !cnt_in_buf || !cnt_out_buf)
    return static_cast<int>(cudaErrorInvalidValue);
  sgns_conv_scatter_accumulate<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block), static_cast<const float*>(d_in),
      static_cast<const float*>(acc_out), static_cast<const int*>(cnt),
      static_cast<const float*>(d_wn), static_cast<const int*>(negs), kB,
      static_cast<const int*>(valid), nvalid, neg_weight, N, D,
      static_cast<float*>(acc_in_buf), static_cast<float*>(acc_out_buf),
      static_cast<float*>(cnt_in_buf), static_cast<float*>(cnt_out_buf));
  return static_cast<int>(cudaGetLastError());
}
