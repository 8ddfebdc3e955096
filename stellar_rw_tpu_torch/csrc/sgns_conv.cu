// The shared-negative SGNS step in the shifted-window ("conv") form: its
// positive half and its scatter-mean, in two kernels (sm_90a). The negative
// half between them is sgns_shared_grads (sgns_shared.cu), and the update of
// the touched rows is sgns_exact.cu's apply kernel.
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
//       shared memory, once for all 2w offsets, and forms validity itself
//       from the tokens, cwin and the bounds (no [B, T, 2w] mask). Each
//       pair's dot is taken twice, once by its center's tile and once by its
//       context's tile, so no block needs another's g_pos; a thread takes a
//       dot whole, lanes on neighbouring offsets, rows padded to one bank
//       apart. It writes ein
//       (the negative half's input, zero at padding), acc_in, acc_out, the
//       two counts, neg_weight * vcnt (the negative half's mask) and its
//       valid-pair count; it also gathers the kB negative rows of w_out
//       (wn) and zeroes the workspace's two slot counts for (b). Rows wider
//       than the shared memory holds go in column slices: the dots summed
//       over every slice first, then the accumulations slice by slice.
//   (b) sgns_conv_scatter: a warp a position adds acc_in + d_neg and acc_out
//       into the compact delta slots of its token's rows (delta_slots.cuh),
//       with the integer counts; the apply kernel then does w[row] +=
//       -lr * sum / max(count, 1) over the listed rows. A warp a negative
//       adds -lr * d_wn[k] / cnt_n into its row of w_out, atomically (a
//       negative can repeat): that update is not normalised per row, so it
//       cannot share a slot with the counted ones.
// Every gradient comes from the tables as they were before the step: (a)
// and the negative half only read them, (b) writes the negatives' rows
// after both, and the apply kernel the rest. Sums run in another order
// than XLA's (a warp reduction for the dots, sum-then-divide for the
// scatter-mean, atomics), so a step agrees with it to rounding.
//
// What bounds it: the row gathers (two rows a halo position) and the
// accumulations written and read back, against 2 * D flops a dot and a
// multiply-add an element and offset: bytes. The tile is cut so that the
// grid fills the SMs (ops/sgns_conv.py::launch_plan mirrors it).

#include <cstdint>

#include <cuda_runtime.h>

#include "delta_slots.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBatch = 4;   // a thread's row loads in flight at once

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
// thread's loads go out kBatch at a time, all before the first is stored.
__device__ void load_halo(float* s_in, float* s_out, const int* tok,
                          const float* __restrict__ w_in,
                          const float* __restrict__ w_out, int H, int ld,
                          int D, int c0, int w, bool vec) {
  const int g = vec ? 4 : 1;         // floats a load: 4 when D, c0 and w
  const int wg = w / g, n = H * wg;  // are multiples of 4
  for (int i0 = threadIdx.x; i0 < n; i0 += blockDim.x * kBatch) {
    float4 a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
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
    for (int u = 0; u < kBatch; ++u) {
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
                         int* slot_counts, int T, int D, int window,
                         int tile, int cols, float neg_weight) {
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

  if (cta == 0 && threadIdx.x < 2) slot_counts[threadIdx.x] = 0;
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

__global__ void __launch_bounds__(kThreads)
    sgns_conv_scatter(const int* __restrict__ block,
                      const float* __restrict__ d_in,
                      const float* __restrict__ acc_out,
                      const int* __restrict__ cnt,
                      const float* __restrict__ d_wn,
                      const int* __restrict__ negs, int kB,
                      const int* __restrict__ valid, int nvalid,
                      float neg_weight, float lr, float* w_out, srw::Scratch s,
                      int N, int D) {
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x >> 5);
  for (int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       item < N + kB; item += nwarps) {
    if (item < N) {
      const int tok = block[item];
      if (tok < 0) continue;
      for (int t = 0; t < 2; ++t) {
        const int c = cnt[static_cast<size_t>(t) * N + item];
        if (c == 0) continue;
        int slot = 0;
        if (lane == 0) {
          slot = srw::claim(s, t, tok);
          atomicAdd(s.cntt(t) + slot, c);
        }
        slot = __shfl_sync(kFull, slot, 0);
        const float* src = (t == 0 ? d_in : acc_out) +
                           static_cast<size_t>(item) * D;
        float* dst = s.dt(t) + static_cast<size_t>(slot) * D;
        for (int j = lane; j < D; j += 32) atomicAdd(dst + j, src[j]);
      }
    } else {
      const int k = item - N;
      int total = 0;
      for (int i = lane; i < nvalid; i += 32) total += valid[i];
      for (int sh = 16; sh; sh >>= 1)
        total += __shfl_xor_sync(kFull, total, sh);
      const float cnt_n = fmaxf(static_cast<float>(total) * neg_weight, 1.f);
      float* w = w_out + static_cast<size_t>(negs[k]) * D;
      const float* g = d_wn + static_cast<size_t>(k) * D;
      for (int j = lane; j < D; j += 32) atomicAdd(w + j, (-lr * g[j]) / cnt_n);
    }
  }
}

}  // namespace

// Kernel (a) on a block [B, T] under ops/sgns_conv.py::launch_plan: a grid
// of (tiles, B) blocks of kThreads, `tile` positions a block, `cols` columns
// a slice, `smem` bytes of dynamic shared memory. out: ein, acc_in, acc_out,
// mask, cnt, valid, wn. slot_counts: the workspace's two slot counts,
// zeroed here for kernel (b). Returns the CUDA error of the launch.
extern "C" int srw_sgns_conv_accumulate_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, int kB, void* const* out, void* slot_counts, int B,
    int T, int D, int window, int tile, int tiles, int cols, int smem,
    float neg_weight, void* stream) {
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
      static_cast<const int*>(negs), kB, o, static_cast<int*>(slot_counts),
      T, D, window, tile, cols, neg_weight);
  return static_cast<int>(cudaGetLastError());
}

// Kernel (b): `blocks` blocks of kThreads over the N positions and the kB
// negatives. d_in = acc_in + d_neg [N, D]; acc_out [N, D]; cnt [2, N];
// d_wn [kB, D]; valid [nvalid] (kernel (a)'s counts); scratch as
// sgns_exact.cu's. Returns the CUDA error of the launch.
extern "C" int srw_sgns_conv_scatter_launch(
    const void* block, const void* d_in, const void* acc_out,
    const void* cnt, const void* d_wn, const void* negs, int kB,
    const void* valid, int nvalid, float neg_weight, float lr, void* w_out,
    void* const* scratch_ptrs, int N, int D, int blocks, void* stream) {
  if (N + kB <= 0) return 0;
  sgns_conv_scatter<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block), static_cast<const float*>(d_in),
      static_cast<const float*>(acc_out), static_cast<const int*>(cnt),
      static_cast<const float*>(d_wn), static_cast<const int*>(negs), kB,
      static_cast<const int*>(valid), nvalid, neg_weight, lr,
      static_cast<float*>(w_out), srw::scratch(scratch_ptrs), N, D);
  return static_cast<int>(cudaGetLastError());
}
