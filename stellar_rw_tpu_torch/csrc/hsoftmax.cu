// One hierarchical-softmax skip-gram step as one cooperative kernel launch.
//
// Replaces the JAX package's _hs_epoch scan body
// (stellar_rw_tpu/models/hsoftmax.py:95-158), which XLA lowers to a gather
// of every position's path rows vo = syn1[points[tok]] as [B, T, L, D], a
// gradient d_vo of the same shape, 2w einsum passes and two scatter-adds:
// at B = 256, T = 82, D = 128 and a tree of L ~ 30 levels each such tensor
// is ~0.3 GB a block. This kernel holds none of them.
//
// Skip-gram with hierarchical softmax (word2vec.c's loop): for each valid
// pair (center c, context c + d) and each live level l of the center's
// Huffman path, g = sigmoid(<x_{c+d}, vo_l>) - label_l; the path node gains
// g * x_{c+d} and the context's syn0 row gains g * vo_l. Each row then
// moves by lr times the mean of its gradients (a node's count: the valid
// pairs of the centers on whose path it lies; a token's: the valid pairs
// in which it is the context), all from the tables as they were before the
// step.
//
// The step runs in three phases, all of its blocks resident at once (a
// cooperative launch: at most two blocks an SM, ops/hsoftmax.py::
// launch_plan):
//   (a) gradients: persistent blocks stride over tiles of `tile`
//       consecutive centers of one walk. A tile's halo (its positions and
//       `window` more a side) is read once: the tokens, and the syn0 rows
//       into shared memory beside a gradient sum a halo row. A warp takes
//       a center, counts its valid pairs (each context's pair count is
//       added to its halo row), and walks the center's live path levels
//       kGroup at a time: the group's syn1 rows are read once and held in
//       registers while the warp streams the center's valid contexts from
//       shared memory (a dot a level, reduced across the warp, then
//       d_vo_l += g * x in registers and the context's gradient sum +=
//       sum_l g * vo_l by shared-memory atomics). A level group's d_vo rows
//       are added once each, into their nodes' compact delta slots in
//       device memory (delta_slots.cuh, a row-to-slot map), the root's and
//       the other top levels' included: a per-block table of those nodes
//       in shared memory measured slower on the corpus's blocks. After
//       each tile the halo rows' gradient sums go to their tokens' delta
//       slots, one row of device atomics a halo position with pairs.
//   (b) a grid barrier, then the update: the grid's warps stride over the
//       listed slots of both tables, a row a warp, w[row] += (-lr * delta)
//       / max(cnt, 1), and put the slot, its count and the row's map entry
//       back to their empty values.
//   (c) a second grid barrier, then block 0 zeroes the slot counts, so the
//       next step finds the workspace empty with no memset.
// Rows wider than one register slice of 32 * NV columns (D > 128) take two
// passes over a level group's contexts: the dots over every slice, their
// g kept in shared memory, then the gradients slice by slice.
//
// What bounds it: 6 * D flops a (pair, live level) (the dot, d_vo and the
// context's gradient) at the f32 rate, against the block's distinct rows of
// both tables read and written once. Shared memory carries the contexts'
// rows and their gradient sums (a row read and a row added a pair and
// level group), so a group of kGroup levels amortises them; the device
// atomics are a node row a (center, level) and a token row a halo
// position. Sums run in another order than JAX's
// (warp reductions, atomics in no fixed order, sum-then-divide), so a step
// agrees with it to rounding.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "delta_slots.cuh"

namespace {

namespace cg = cooperative_groups;
using srw::Scratch;
using srw::claim;
using srw::scratch;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;      // blocks of kThreads an SM holds
constexpr int kGroup = 4;          // path levels a warp holds at once
constexpr int kEmpty = -1;         // a row with no delta slot

// shared memory of a block in 4-byte words (ops/hsoftmax.py::smem_bytes)
__host__ __device__ inline long long smem_words(int tile, int window,
                                                int D) {
  const long long H = tile + 2 * window;
  const long long dpad = (D + 31) & ~31;
  return 2 * H * dpad + 2 * H +
         static_cast<long long>(kWarps) * 2 * window * kGroup;
}

// a row slice by plain loads: the tables are written in phase (b)
template <int NV>
__device__ __forceinline__ void load_slice(const float* row, int c0, int D,
                                           int lane, float (&v)[NV]) {
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = c0 + lane + 32 * m;
    v[m] = c < D ? row[c] : 0.f;
  }
}

// A node row's slice into its delta slot.
template <int NV>
__device__ __forceinline__ void add_node(const Scratch& s, int slot, int c0,
                                         int D, int lane,
                                         const float (&v)[NV]) {
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = c0 + lane + 32 * m;
    if (c < D) atomicAdd(s.dt(1) + static_cast<size_t>(slot) * D + c, v[m]);
  }
}

// Phase (b): the listed slots of both tables, a row a warp of the grid. The
// workspace was written by other blocks' atomics and stores: read at L2.
__device__ __forceinline__ void apply_slots(float* syn0, float* syn1,
                                            const Scratch& s, int D,
                                            float lr) {
  const int n0 = __ldcg(s.counts);
  const int n = n0 + __ldcg(s.counts + 1);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < n;
       item += warps) {
    const int t = item < n0 ? 0 : 1;
    const int slot = t == 0 ? item : item - n0;
    const int row = __ldcg(s.listt(t) + slot);
    float* w = (t == 0 ? syn0 : syn1) + static_cast<size_t>(row) * D;
    float* d = s.dt(t) + static_cast<size_t>(slot) * D;
    const float c = static_cast<float>(max(__ldcg(s.cntt(t) + slot), 1));
    for (int i = lane; i < D; i += 32) {
      w[i] += (-lr * __ldcg(d + i)) / c;
      d[i] = 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      s.cntt(t)[slot] = 0;
      s.mapt(t)[row] = kEmpty;
    }
  }
}

// The g of up to kGroup levels from each lane's partial dots: a reduction
// across the warp that halves the dots a lane holds twice (after the
// xor-16 step a lane keeps dots 0-1 or 2-3, after the xor-8 step one of
// them: six shuffles for four dots, not twenty), so that lanes 8g..8g+7
// hold level g's dot and each lane takes one sigmoid, not four (by the
// fast __expf and __fdividef: 1e-7 off the exact sigmoid, which the step's
// rtol 1e-5 leaves far behind); then the four g are handed on.
__device__ __forceinline__ void grads(float (&dot)[kGroup],
                                      const float (&lab)[kGroup], int nt,
                                      float (&gr)[kGroup]) {
  static_assert(kGroup == 4, "the halving reduction takes 4 levels");
  const int lane = threadIdx.x & 31;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float a0 = hi16 ? dot[2] : dot[0], a1 = hi16 ? dot[3] : dot[1];
  a0 += __shfl_xor_sync(kFull, hi16 ? dot[0] : dot[2], 16);
  a1 += __shfl_xor_sync(kFull, hi16 ? dot[1] : dot[3], 16);
  float v = hi8 ? a1 : a0;
  v += __shfl_xor_sync(kFull, hi8 ? a0 : a1, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  const float lb = hi16 ? (hi8 ? lab[3] : lab[2]) : (hi8 ? lab[1] : lab[0]);
  const float mine = __fdividef(1.f, 1.f + __expf(-v)) - lb;
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
    gr[g] = g < nt ? __shfl_sync(kFull, mine, 8 * g) : 0.f;
}

template <int NV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hs_step(float* syn0, float* syn1, const int* __restrict__ block,
            const int* __restrict__ cwin, const int* __restrict__ points,
            const float* __restrict__ labels,
            const float* __restrict__ pmask, Scratch s, int B, int T,
            int window, int L, int D, int tile, float lr) {
  constexpr int kSlice = 32 * NV;
  extern __shared__ int smem[];
  const int dpad = (D + 31) & ~31;
  const int H = tile + 2 * window;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* xh = reinterpret_cast<float*>(smem);
  float* dxh = xh + static_cast<size_t>(H) * dpad;
  int* tokh = reinterpret_cast<int*>(dxh + static_cast<size_t>(H) * dpad);
  int* cnth = tokh + H;
  float* gbuf = reinterpret_cast<float*>(cnth + H) +
                static_cast<size_t>(warp) * 2 * window * kGroup;

  const bool one_slice = D <= kSlice;
  const int per_walk = (T + tile - 1) / tile;
  const int n_tiles = B * per_walk;
  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const int b = ti / per_walk;
    const int t0 = (ti - b * per_walk) * tile;
    const int* walk = block + static_cast<size_t>(b) * T;
    __syncthreads();  // the last tile's halo flushed
    for (int h = threadIdx.x; h < H; h += kThreads) {
      const int t = t0 - window + h;
      tokh[h] = t >= 0 && t < T ? walk[t] : -1;
      cnth[h] = 0;
    }
    __syncthreads();
    for (int h = warp; h < H; h += kWarps) {
      const int tk = tokh[h];
      const float* src = syn0 + static_cast<size_t>(max(tk, 0)) * D;
      for (int c = lane; c < dpad; c += 32) {
        xh[static_cast<size_t>(h) * dpad + c] = tk >= 0 && c < D ? src[c] : 0.f;
        dxh[static_cast<size_t>(h) * dpad + c] = 0.f;
      }
    }
    __syncthreads();

    for (int ci = warp; ci < tile && t0 + ci < T; ci += kWarps) {
      const int hc = ci + window;  // the center's halo row
      const int center = tokh[hc];
      if (center < 0) continue;
      const int win = min(cwin[static_cast<size_t>(b) * T + t0 + ci], window);
      // the center's valid pairs, each counted on its context's halo row
      int mine = 0;
      for (int j = lane; j < 2 * win; j += 32) {
        const int h = hc + (j < win ? j - win : j - win + 1);
        if (tokh[h] >= 0) {
          ++mine;
          atomicAdd(cnth + h, 1);
        }
      }
      const int vcnt = __reduce_add_sync(kFull, mine);
      if (vcnt == 0) continue;
      const size_t pbase = static_cast<size_t>(center) * L;
      for (int l0 = 0; l0 < L; l0 += 32) {
        const int lv = l0 + lane;
        const bool live = lv < L && pmask[pbase + lv] != 0.f;
        const int my_node = live ? points[pbase + lv] : 0;
        const float my_lab = live ? labels[pbase + lv] : 0.f;
        unsigned rem = __ballot_sync(kFull, live);
        while (rem) {
          // the next kGroup live levels: their nodes, labels, delta slots
          int lvl[kGroup], node[kGroup], nt = 0;
          float lab[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            lvl[g] = 0;
            if (rem) {
              lvl[g] = __ffs(rem) - 1;
              rem &= rem - 1;
              nt = g + 1;
            }
            node[g] = __shfl_sync(kFull, my_node, lvl[g]);
            lab[g] = __shfl_sync(kFull, my_lab, lvl[g]);
          }
          // lane g < nt claims level g's delta slot and adds its count
          int nd = 0, my_slot = 0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (lane == g) nd = node[g];
          if (lane < nt) {
            my_slot = claim(s, 1, nd);
            atomicAdd(s.cntt(1) + my_slot, vcnt);
          }
          int dst[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            dst[g] = __shfl_sync(kFull, my_slot, g);

          float vo[kGroup][NV], dvo[kGroup][NV];
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
#pragma unroll
            for (int m = 0; m < NV; ++m) vo[g][m] = dvo[g][m] = 0.f;
          if (one_slice) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (g < nt)
                load_slice<NV>(syn1 + static_cast<size_t>(node[g]) * D, 0, D,
                               lane, vo[g]);
          }
          // the contexts: dots (every slice), g, and with one slice the
          // gradients at once; with more, g kept for the second pass
          int np = 0;
          for (int d = -win; d <= win; ++d) {
            const int h = hc + d;
            if (d == 0 || tokh[h] < 0) continue;
            const float* xr = xh + static_cast<size_t>(h) * dpad;
            float dot[kGroup], x[NV];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) dot[g] = 0.f;
            for (int c0 = 0; c0 < D; c0 += kSlice) {
              load_slice<NV>(xr, c0, D, lane, x);
#pragma unroll
              for (int g = 0; g < kGroup; ++g) {
                if (g < nt) {
                  if (!one_slice)
                    load_slice<NV>(syn1 + static_cast<size_t>(node[g]) * D,
                                   c0, D, lane, vo[g]);
#pragma unroll
                  for (int m = 0; m < NV; ++m)
                    dot[g] = fmaf(x[m], vo[g][m], dot[g]);
                }
              }
            }
            float gr[kGroup];
            grads(dot, lab, nt, gr);
            if (one_slice) {
              float* dr = dxh + static_cast<size_t>(h) * dpad;
#pragma unroll
              for (int m = 0; m < NV; ++m) {
                float dx = 0.f;
#pragma unroll
                for (int g = 0; g < kGroup; ++g) {
                  dvo[g][m] = fmaf(gr[g], x[m], dvo[g][m]);
                  dx = fmaf(gr[g], vo[g][m], dx);
                }
                const int c = lane + 32 * m;
                if (c < D) atomicAdd(dr + c, dx);
              }
            } else if (lane == 0) {
#pragma unroll
              for (int g = 0; g < kGroup; ++g) gbuf[np * kGroup + g] = gr[g];
            }
            ++np;
          }
          if (one_slice) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (g < nt) add_node<NV>(s, dst[g], 0, D, lane, dvo[g]);
            continue;
          }
          __syncwarp();
          // more than one slice: the gradients slice by slice
          for (int c0 = 0; c0 < D; c0 += kSlice) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
#pragma unroll
              for (int m = 0; m < NV; ++m) dvo[g][m] = 0.f;
              if (g < nt)
                load_slice<NV>(syn1 + static_cast<size_t>(node[g]) * D, c0,
                               D, lane, vo[g]);
            }
            int j = 0;
            for (int d = -win; d <= win; ++d) {
              const int h = hc + d;
              if (d == 0 || tokh[h] < 0) continue;
              float x[NV];
              load_slice<NV>(xh + static_cast<size_t>(h) * dpad, c0, D, lane,
                             x);
              float* dr = dxh + static_cast<size_t>(h) * dpad;
#pragma unroll
              for (int m = 0; m < NV; ++m) {
                float dx = 0.f;
#pragma unroll
                for (int g = 0; g < kGroup; ++g) {
                  const float gg = gbuf[j * kGroup + g];
                  dvo[g][m] = fmaf(gg, x[m], dvo[g][m]);
                  dx = fmaf(gg, vo[g][m], dx);
                }
                const int c = c0 + lane + 32 * m;
                if (c < D) atomicAdd(dr + c, dx);
              }
              ++j;
            }
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (g < nt)
                add_node<NV>(s, dst[g], c0, D, lane, dvo[g]);
          }
          __syncwarp();  // gbuf is read before the next group writes it
        }
      }
    }
    __syncthreads();
    // the halo rows' gradient sums to their tokens' delta slots
    for (int h = warp; h < H; h += kWarps) {
      const int n = cnth[h];
      if (n == 0) continue;
      int g = 0;
      if (lane == 0) {
        g = claim(s, 0, tokh[h]);
        atomicAdd(s.cntt(0) + g, n);
      }
      g = __shfl_sync(kFull, g, 0);
      float* dst = s.dt(0) + static_cast<size_t>(g) * D;
      const float* src = dxh + static_cast<size_t>(h) * dpad;
      for (int c = lane; c < D; c += 32) atomicAdd(dst + c, src[c]);
    }
  }

  // (b) every block's rows are in the delta slots: the update
  cg::this_grid().sync();
  apply_slots(syn0, syn1, s, D, lr);
  // (c) every block has read the slot counts: zero them for the next step
  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.counts[0] = 0;
    s.counts[1] = 0;
  }
}

template <int NV>
cudaError_t launch_step(float* syn0, float* syn1, const int* block,
                        const int* cwin, const int* points,
                        const float* labels, const float* pmask, Scratch s,
                        int B, int T, int window, int L, int D, int tile,
                        int blocks, size_t smem, float lr,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hs_step<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&syn0, &syn1, &block,  &cwin, &points, &labels, &pmask,
                  &s,    &B,    &T,      &window, &L,     &D,     &tile,
                  &lr};
  // refused (cudaErrorCooperativeLaunchTooLarge) if the blocks cannot all
  // be resident at once: never run as an ordinary launch
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hs_step<NV>), dim3(blocks),
      dim3(kThreads), args, smem, stream);
}

}  // namespace

// One step for a block [B, T] under a launch plan (ops/hsoftmax.py::
// launch_plan): `blocks` persistent blocks of kThreads threads (all
// resident), tiles of `tile` centers, `smem_bytes` of dynamic shared
// memory (checked against the layout here). points i32 / labels f32
// / pmask f32 [V, L]; the tables move in place by lr. scratch: d_syn0,
// d_syn1, cnt_syn0, cnt_syn1, map_syn0, map_syn1, list_syn0, list_syn1,
// counts[2], all empty (zero, map -1) before the step and again after it.
// Returns the CUDA error of the launch (a refused cooperative launch
// included).
extern "C" int srw_hs_step_launch(
    void* syn0, void* syn1, const void* block, const void* cwin,
    const void* points, const void* labels, const void* pmask,
    void* const* scratch_ptrs, int B, int T, int window, int L, int D,
    int tile, int blocks, int smem_bytes, float lr, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || window < 1 || L < 1 || tile < 1 || blocks < 1 ||
      4 * smem_words(tile, window, D) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = scratch(scratch_ptrs);
  float* a = static_cast<float*>(syn0);
  float* b = static_cast<float*>(syn1);
  const int* blk = static_cast<const int*>(block);
  const int* cw = static_cast<const int*>(cwin);
  const int* pt = static_cast<const int*>(points);
  const float* lb = static_cast<const float*>(labels);
  const float* pm = static_cast<const float*>(pmask);
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err;
  if (D <= 32)
    err = launch_step<1>(a, b, blk, cw, pt, lb, pm, s, B, T, window, L, D,
                         tile, blocks, smem, lr, st);
  else if (D <= 64)
    err = launch_step<2>(a, b, blk, cw, pt, lb, pm, s, B, T, window, L, D,
                         tile, blocks, smem, lr, st);
  else
    err = launch_step<4>(a, b, blk, cw, pt, lb, pm, s, B, T, window, L, D,
                         tile, blocks, smem, lr, st);
  cudaGetLastError();  // a refused launch leaves no error for later calls
  return static_cast<int>(err);
}
