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
//   (a) gradients: persistent blocks take tiles of consecutive centers of
//       one walk (ceil(T / tile) a walk, of near equal sizes: a walk of 82
//       in tiles of 32 at most is cut 28 + 27 + 27) from a counter in the
//       workspace, one at a time, so blocks whose tiles ran short take
//       more. A tile's halo (its positions and `window` more a side, H
//       rows) is read once into shared memory: the tokens and the syn0
//       rows X [H, D]. Its valid pairs become a bit mask of centers a halo
//       row. Its centers' live path levels are de-duplicated into the
//       tile's distinct nodes U (a node's first center, in (center, level)
//       order; a node of the top levels lies on many centers' paths), each
//       with the masks of the centers on whose path it lies and of those
//       whose label there is 1; each node's delta slot is claimed and
//       counted once a tile. The step over the tile is then three products
//       over U in chunks of kChunk nodes, a barrier after each:
//         S = X VO_U^T and G[h, u] = sum over the centers c that pair with
//           halo row h and hold u on their path of sigmoid(S[h, u]) -
//           label(c, u) (counts of the two masks' bits), with d_VO_U =
//           G^T X: a warp takes kGroup nodes (their syn1 rows in
//           registers) against the halo rows that pair with their centers,
//           kDotRows rows at a time: 16 dots reduced across the warp at
//           once, their G handed to every lane, which adds G x to its
//           nodes' rows from the slices the dots read; each node's row then
//           goes once into its delta slot (device memory, delta_slots.cuh);
//         d_X = G VO_U: a warp a halo row, over the chunk's nonzero G of
//           the row, kBatch node rows at a time from shared memory, into
//           the tile's gradient rows dX [H, D] in shared memory (each row
//           written by one warp: no atomics).
//       After each tile the halo rows' gradient rows go to their tokens'
//       delta slots, one row of device atomics a halo position with pairs.
//   (b) a grid barrier, then the update: the grid's warps stride over the
//       listed slots of both tables, kApply rows a warp at a time,
//       w[row] += (-lr * delta) / max(cnt, 1), and put the slot, its count
//       and the row's map entry back to their empty values.
//   (c) a second grid barrier, then block 0 zeroes the slot counts, so the
//       next step finds the workspace empty with no memset.
// Rows wider than one register slice of 32 * NV columns (D > 128) read the
// node rows' slices again for each halo row's dots, and d_VO (in a pass of
// its own over G) and d_X run slice by slice.
//
// What bounds it: 6 * D flops a distinct (context token, path node) pair of
// the block (the dot, d_vo and the context's gradient: every read is of the
// tables before the step, so all pairs of one context token with centers
// that hold one node share them) at the f32 rate, against the block's
// distinct rows of both tables read and written once. The first design (a
// warp a center's path, four levels at a time, its contexts' gradients
// summed by shared-memory atomics, a delta-slot claim and a row of device
// atomics a (center, level)) was bound by the latency of those chains at
// 16 warps an SM. Here a node's claim and row of device atomics come once
// a tile, the halo's gradient rows take no atomics, and the products skip
// the halo rows and nodes that share no pair; the update takes kApply rows
// at once. What is left is latency still: the warp reductions of S, the
// per-chunk barriers, and the update's table rows from device memory
// (chip_hsoftmax_parts.py). Sums run in another order than JAX's (warp
// reductions, device atomics in no fixed order, sum-then-divide), so a
// step agrees with it to rounding.

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
constexpr int kGroup = 4;          // nodes a warp takes at once
constexpr int kChunk = kWarps * kGroup;  // nodes a chunk of U
constexpr int kDotRows = 4;        // halo rows whose dots are reduced at once
constexpr int kBatch = 4;          // d_X: node rows a warp reads at once
constexpr int kApply = 4;          // the update: rows a warp takes at once
constexpr int kEmpty = -1;         // a row with no delta slot

// shared memory of a block in 4-byte words (ops/hsoftmax.py::smem_bytes):
// X and dX [H, dpad], a chunk's node rows [kChunk, vcols] (one slice), G
// [H, kChunk], the halo's tokens, pair counts and center masks, a center's
// pair count and first-occurrence count, the path entries [tile, L] (node,
// label, owner, node index) and the nodes [tile * L] (node, center mask,
// label-1 mask, slot), the block's next tile
__host__ __device__ inline long long smem_words(int tile, int window, int D,
                                                int L) {
  const long long H = tile + 2 * window;
  const long long dpad = (D + 31) & ~31;
  const long long vcols = dpad < 128 ? dpad : 128;
  const long long E = static_cast<long long>(tile) * L;
  return 2 * H * dpad + kChunk * vcols + H * kChunk + 3 * H + 2 * tile +
         8 * E + 1;
}

// a cache line toward L1 (a hint: nothing waits for it)
__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// A float copied from device to shared memory without the registers, or a
// zero where `on` is false (cp.async's zero fill: no byte is read), so
// that a thread's copies are all in flight at once; cp_async_wait waits for
// the thread's own.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Phase (b): the listed slots of both tables, kApply rows a warp of the
// grid at a time (their loads in flight together). The workspace was
// written by other blocks' atomics and stores: read at L2.
__device__ __forceinline__ void apply_slots(float* syn0, float* syn1,
                                            const Scratch& s, int D,
                                            float lr) {
  const int n0 = __ldcg(s.counts);
  const int n = n0 + __ldcg(s.counts + 1);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kApply;
       first < n; first += warps * kApply) {
    float* w[kApply];
    float* d[kApply];
    float c[kApply];
    int tq[kApply], slot[kApply], row[kApply];
#pragma unroll
    for (int q = 0; q < kApply; ++q) {
      const int item = first + q;
      tq[q] = item < n0 ? 0 : 1;
      slot[q] = tq[q] == 0 ? item : item - n0;
      row[q] = item < n ? __ldcg(s.listt(tq[q]) + slot[q]) : -1;
      w[q] = (tq[q] == 0 ? syn0 : syn1) +
             static_cast<size_t>(max(row[q], 0)) * D;
      d[q] = s.dt(tq[q]) + static_cast<size_t>(slot[q]) * D;
      c[q] = item < n ? static_cast<float>(
                            max(__ldcg(s.cntt(tq[q]) + slot[q]), 1))
                      : 1.f;
    }
    for (int i = lane; i < D; i += 32) {
      float wv[kApply], dv[kApply];
#pragma unroll
      for (int q = 0; q < kApply; ++q)
        if (row[q] >= 0) {
          wv[q] = w[q][i];
          dv[q] = __ldcg(d[q] + i);
        }
#pragma unroll
      for (int q = 0; q < kApply; ++q)
        if (row[q] >= 0) {
          w[q][i] = wv[q] + (-lr * dv[q]) / c[q];
          d[q][i] = 0.f;
        }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kApply; ++q)
      if (lane == q && row[q] >= 0) {
        s.cntt(tq[q])[slot[q]] = 0;
        s.mapt(tq[q])[row[q]] = kEmpty;
      }
  }
}

// One halving step of reduce_dots and the steps after it: lanes with bit
// `sh` set keep the upper half of the n values, the others the lower half,
// each adding the partner lane's copy of the half it keeps.
template <int N, int n, int sh>
__device__ __forceinline__ void halve(float (&a)[N], int lane) {
  if constexpr (n > 1) {
    const bool hi = lane & sh;
#pragma unroll
    for (int i = 0; i < n / 2; ++i)
      a[i] = (hi ? a[n / 2 + i] : a[i]) +
             __shfl_xor_sync(kFull, hi ? a[i] : a[n / 2 + i], sh);
    halve<N, n / 2, sh / 2>(a, lane);
  }
}

// N dots from each lane's partial sums, reduced across the warp by halving
// the values a lane holds at each step (N / 2 shuffles at xor 16, N / 4 at
// xor 8, ... down to one), then the last steps of one shuffle each: for
// N = 16, sixteen shuffles for sixteen dots. Lanes k * 32 / N ... (k + 1) *
// 32 / N - 1 return dot k.
template <int N>
__device__ __forceinline__ float reduce_dots(float (&a)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: 1, 2, ..., 32");
  const int lane = threadIdx.x & 31;
  halve<N, N, 16>(a, lane);
  float v = a[0];
#pragma unroll
  for (int sh = 16 / N; sh; sh /= 2) v += __shfl_xor_sync(kFull, v, sh);
  return v;
}

// The halo rows in [lo, hi] that pair with a center of `mask`, 32 at a
// time: a lane's row and the warp's ballot of them.
__device__ __forceinline__ unsigned pairing_rows(const unsigned* pairm,
                                                 int hb, int hi,
                                                 unsigned mask, int lane) {
  const int h = hb + lane;
  return __ballot_sync(kFull, h <= hi && (pairm[h] & mask) != 0u);
}

template <int NV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hs_step(float* syn0, float* syn1, const int* __restrict__ block,
            const int* __restrict__ cwin, const int* __restrict__ points,
            const float* __restrict__ labels,
            const float* __restrict__ pmask, Scratch s, int B, int T,
            int window, int L, int D, int tile, float lr) {
  constexpr int kSlice = 32 * NV;
  extern __shared__ __align__(16) float smem[];
  const int dpad = (D + 31) & ~31;
  const int vcols = min(dpad, 128);
  const int H = tile + 2 * window;
  const int E = tile * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* X = smem;
  float* dX = X + static_cast<size_t>(H) * dpad;
  float* VOc = dX + static_cast<size_t>(H) * dpad;
  float* G = VOc + static_cast<size_t>(kChunk) * vcols;
  int* tokh = reinterpret_cast<int*>(G + static_cast<size_t>(H) * kChunk);
  int* cnth = tokh + H;
  unsigned* pairm = reinterpret_cast<unsigned*>(cnth + H);
  int* vcnt = reinterpret_cast<int*>(pairm + H);
  int* ccount = vcnt + tile;
  int* enode = ccount + tile;
  float* elab = reinterpret_cast<float*>(enode + E);
  int* eown = reinterpret_cast<int*>(elab + E);
  int* euid = eown + E;
  int* unode = euid + E;
  unsigned* umask = reinterpret_cast<unsigned*>(unode + E);
  unsigned* ulab = umask + E;
  int* uslot = reinterpret_cast<int*>(ulab + E);
  int* tile_next = uslot + E;   // the tile this block takes next

  const bool one_slice = D <= kSlice;
  // a walk's tiles: ceil(T / tile) of as near equal sizes as may be, so
  // that no block's tiles are all short ones
  const int per_walk = (T + tile - 1) / tile;
  const int n_tiles = B * per_walk;
  const int t_base = T / per_walk, t_extra = T % per_walk;
  for (int round = 0;; ++round) {
    __syncthreads();  // the last tile's halo flushed, its index read
    if (threadIdx.x == 0) *tile_next = atomicAdd(s.counts + 2, 1);
    __syncthreads();
    const int ti = *tile_next;
    if (ti >= n_tiles) break;
    const int b = ti / per_walk;
    const int j = ti - b * per_walk;
    const int t0 = j * t_base + min(j, t_extra);
    const int tc = t_base + (j < t_extra ? 1 : 0);  // its centers
    const int* walk = block + static_cast<size_t>(b) * T;
    for (int h = threadIdx.x; h < H; h += kThreads) {
      const int t = t0 - window + h;
      tokh[h] = t >= 0 && t < T && h < tc + 2 * window ? walk[t] : -1;
      cnth[h] = 0;
      pairm[h] = 0u;
    }
    for (int c = threadIdx.x; c < tile; c += kThreads) vcnt[c] = 0;
    __syncthreads();
    for (int h = warp; h < H; h += kWarps) {
      const int tk = tokh[h];
      const float* src = syn0 + static_cast<size_t>(max(tk, 0)) * D;
      for (int c = lane; c < dpad; c += 32) {
        cp_async4(X + static_cast<size_t>(h) * dpad + c,
                  src + (c < D ? c : 0), tk >= 0 && c < D);
        dX[static_cast<size_t>(h) * dpad + c] = 0.f;
      }
    }
    // the valid pairs: a center's bit on its context's halo row
    for (int e = threadIdx.x; e < tile * 2 * window; e += kThreads) {
      const int ci = e / (2 * window);
      const int j = e - ci * 2 * window;
      const int hc = ci + window;
      if (ci >= tc || tokh[hc] < 0) continue;
      const int win = min(cwin[static_cast<size_t>(b) * T + t0 + ci], window);
      const int d = j < window ? j - window : j - window + 1;
      if (d < -win || d > win || tokh[hc + d] < 0) continue;
      atomicOr(pairm + hc + d, 1u << ci);
      atomicAdd(cnth + hc + d, 1);
      atomicAdd(vcnt + ci, 1);
    }
    cp_async_wait();   // this thread's copies of the halo rows
    __syncthreads();
    // the live path entries of the centers with pairs
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const int ci = e / L;
      const int l = e - ci * L;
      int node = -1;
      float lab = 0.f;
      if (ci < tc && vcnt[ci] > 0) {
        const size_t pb = static_cast<size_t>(tokh[ci + window]) * L + l;
        if (pmask[pb] != 0.f) {
          node = points[pb];
          lab = labels[pb];
        }
      }
      enode[e] = node;
      elab[e] = lab;
    }
    __syncthreads();
    // an entry's owner: the first center whose path holds its node (a node
    // lies at one level of the tree)
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const int node = enode[e];
      int own = -1;
      if (node >= 0) {
        const int ci = e / L;
        const int l = e - ci * L;
        own = ci;
        for (int c2 = 0; c2 < ci; ++c2)
          if (enode[c2 * L + l] == node) {
            own = c2;
            break;
          }
      }
      eown[e] = own;
    }
    __syncthreads();
    // the tile's nodes, numbered by their first entries in (center, level)
    // order
    for (int ci = warp; ci < tile; ci += kWarps) {
      int n = 0;
      for (int l0 = 0; l0 < L; l0 += 32) {
        const int l = l0 + lane;
        n += __popc(__ballot_sync(kFull, l < L && eown[ci * L + l] == ci));
      }
      if (lane == 0) ccount[ci] = n;
    }
    __syncthreads();
    for (int ci = warp; ci < tile; ci += kWarps) {
      int base = __reduce_add_sync(kFull, lane < ci ? ccount[lane] : 0);
      for (int l0 = 0; l0 < L; l0 += 32) {
        const int l = l0 + lane;
        const int e = ci * L + l;
        const bool first = l < L && eown[e] == ci;
        const unsigned bal = __ballot_sync(kFull, first);
        if (first) {
          const int u = base + __popc(bal & ((1u << lane) - 1u));
          euid[e] = u;
          unode[u] = enode[e];
          umask[u] = 0u;
          ulab[u] = 0u;
        }
        base += __popc(bal);
      }
    }
    __syncthreads();
    const int nU = __reduce_add_sync(kFull, lane < tile ? ccount[lane] : 0);
    // each node's centers and those whose label there is 1 (labels are 0
    // or 1: ops/hsoftmax.py::hs_step checks them)
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const int own = eown[e];
      if (own < 0) continue;
      const int ci = e / L;
      const int u = euid[own * L + (e - ci * L)];
      atomicOr(umask + u, 1u << ci);
      if (elab[e] == 1.f) atomicOr(ulab + u, 1u << ci);
    }
    __syncthreads();
    // each node's delta slot claimed and counted once a tile
    for (int u = threadIdx.x; u < nU; u += kThreads) {
      const int slot = claim(s, 1, unode[u]);
      uslot[u] = slot;
      int n = 0;
      for (unsigned m = umask[u]; m; m &= m - 1) n += vcnt[__ffs(m) - 1];
      atomicAdd(s.cntt(1) + slot, n);
    }
    __syncthreads();

    for (int u0 = 0; u0 < nU; u0 += kChunk) {
      const int ug = u0 + warp * kGroup;   // this warp's nodes
      const int nt = max(0, min(kGroup, nU - ug));
      float* Gw = G + warp * kGroup;       // their columns of G
      for (int i = lane; i < H * kGroup; i += 32)
        Gw[(i / kGroup) * kChunk + i % kGroup] = 0.f;
      {  // this warp's node rows of the next chunk, toward L1 meanwhile
        const int un = ug + kChunk + lane / 4;
        if (lane < 4 * kGroup && un < nU && 32 * (lane % 4) < D)
          prefetch_l1(syn1 + static_cast<size_t>(unode[un]) * D +
                      32 * (lane % 4));
      }
      if (nt > 0) {
        int node[kGroup];
        unsigned gm = 0u;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          node[g] = g < nt ? unode[ug + g] : 0;
          gm |= g < nt ? umask[ug + g] : 0u;
        }
        // the halo rows that pair with the group's centers lie in [lo, hi]
        const int lo = __ffs(gm) - 1;
        const int hi = min(H - 1, 31 - __clz(gm) + 2 * window);
        float vo[kGroup][NV];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
#pragma unroll
          for (int m = 0; m < NV; ++m) vo[g][m] = 0.f;
          if (one_slice && g < nt) {
            load_slice<NV>(syn1 + static_cast<size_t>(node[g]) * D, 0, D,
                           lane, vo[g]);
#pragma unroll
            for (int m = 0; m < NV; ++m) {
              const int c = lane + 32 * m;
              if (c < vcols)
                VOc[static_cast<size_t>(warp * kGroup + g) * vcols + c] =
                    vo[g][m];
            }
          }
        }
        __syncwarp();
        // G of the group's nodes: their dots with kDotRows halo rows at a
        // time, reduced together; lane group k of the reduction (kLanes
        // lanes) ends with row k / kGroup's dot with node k % kGroup
        constexpr int kLanes = 32 / (kDotRows * kGroup);
        const int my_r = lane / kLanes / kGroup;
        const int my_g = lane / kLanes % kGroup;
        const unsigned my_mask = my_g < nt ? umask[ug + my_g] : 0u;
        const unsigned my_lab = my_g < nt ? ulab[ug + my_g] : 0u;
        // with one slice, d_VO += G x as each batch's G is made, from the
        // rows' slices the dots read
        const bool fuse = one_slice;
        float dvo[kGroup][NV];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int m = 0; m < NV; ++m) dvo[g][m] = 0.f;
        for (int hb = lo; hb <= hi; hb += 32) {
          unsigned rows = pairing_rows(pairm, hb, hi, gm, lane);
          while (rows) {
            int hr[kDotRows];
#pragma unroll
            for (int r = 0; r < kDotRows; ++r) {
              hr[r] = -1;
              if (rows) {
                hr[r] = hb + __ffs(rows) - 1;
                rows &= rows - 1;
              }
            }
            // this lane's dot after the reduction: its row and node pair
            // with the centers of pm (read now, used after the dots)
            int h = -1;
#pragma unroll
            for (int r = 0; r < kDotRows; ++r)
              if (my_r == r) h = hr[r];
            const unsigned pm = h >= 0 ? pairm[h] & my_mask : 0u;
            float a[kDotRows * kGroup];
#pragma unroll
            for (int i = 0; i < kDotRows * kGroup; ++i) a[i] = 0.f;
            float x[kDotRows][NV];
            for (int c0 = 0; c0 < D; c0 += kSlice) {
#pragma unroll
              for (int r = 0; r < kDotRows; ++r)
                load_slice<NV>(X + static_cast<size_t>(max(hr[r], 0)) * dpad,
                               c0, D, lane, x[r]);
#pragma unroll
              for (int g = 0; g < kGroup; ++g) {
                if (!one_slice && g < nt)
                  load_slice<NV>(syn1 + static_cast<size_t>(node[g]) * D, c0,
                                 D, lane, vo[g]);
#pragma unroll
                for (int r = 0; r < kDotRows; ++r)
#pragma unroll
                  for (int m = 0; m < NV; ++m)
                    a[r * kGroup + g] =
                        fmaf(x[r][m], vo[g][m], a[r * kGroup + g]);
              }
            }
            const float dot = reduce_dots<kDotRows * kGroup>(a);
            float gv = 0.f;   // this lane group's G, on each of its lanes
            if (pm) {   // the centers of pm less those of label 1
              const float sig = __fdividef(1.f, 1.f + __expf(-dot));
              gv = static_cast<float>(__popc(pm)) * sig -
                   static_cast<float>(__popc(pm & my_lab));
              if (lane % kLanes == 0) Gw[h * kChunk + my_g] = gv;
            }
            if (fuse) {
#pragma unroll
              for (int k = 0; k < kDotRows * kGroup; ++k) {
                const float gk = __shfl_sync(kFull, gv, k * kLanes);
#pragma unroll
                for (int m = 0; m < NV; ++m)
                  dvo[k % kGroup][m] =
                      fmaf(gk, x[k / kGroup][m], dvo[k % kGroup][m]);
              }
            }
          }
        }
        if (fuse) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (g < nt) add_node<NV>(s, uslot[ug + g], 0, D, lane, dvo[g]);
        }
        __syncwarp();
        // d_VO of the group's nodes otherwise: G's columns against the halo
        // rows, slice by slice, into the nodes' delta slots
        for (int c0 = 0; c0 < D && !fuse; c0 += kSlice) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
#pragma unroll
            for (int m = 0; m < NV; ++m) dvo[g][m] = 0.f;
          for (int hb = lo; hb <= hi; hb += 32) {
            unsigned rows = pairing_rows(pairm, hb, hi, gm, lane);
            while (rows) {
              const int h = hb + __ffs(rows) - 1;
              rows &= rows - 1;
              float x[NV];
              load_slice<NV>(X + static_cast<size_t>(h) * dpad, c0, D, lane,
                             x);
              const float4 g4 =
                  *reinterpret_cast<const float4*>(Gw + h * kChunk);
              const float gg[kGroup] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
              for (int g = 0; g < kGroup; ++g)
#pragma unroll
                for (int m = 0; m < NV; ++m)
                  dvo[g][m] = fmaf(gg[g], x[m], dvo[g][m]);
            }
          }
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (g < nt) add_node<NV>(s, uslot[ug + g], c0, D, lane, dvo[g]);
        }
      }
      __syncthreads();
      // d_X of the halo rows that pair with the chunk's centers: a warp a
      // row, over the row's nonzero G, node rows from shared memory
      unsigned cm = 0u;
      for (int u = u0 + lane; u < min(u0 + kChunk, nU); u += 32)
        cm |= umask[u];
      cm = __reduce_or_sync(kFull, cm);
      const int lo = __ffs(cm) - 1;
      const int hi = min(H - 1, 31 - __clz(cm) + 2 * window);
      for (int c0 = 0; c0 < D; c0 += kSlice) {
        if (!one_slice) {
          // this slice of the chunk's node rows
          for (int i = threadIdx.x; i < kChunk * vcols; i += kThreads) {
            const int j = i / vcols;
            const int c = c0 + i - j * vcols;
            const bool on = u0 + j < nU && c < D;
            cp_async4(VOc + i,
                      syn1 + (on ? static_cast<size_t>(unode[u0 + j]) * D + c
                                 : 0),
                      on);
          }
          cp_async_wait();
          __syncthreads();
        }
        for (int h = lo + warp; h <= hi; h += kWarps) {
          if ((pairm[h] & cm) == 0u) continue;
          const float gj = G[h * kChunk + lane];
          unsigned nz = __ballot_sync(kFull, gj != 0.f);
          if (!nz) continue;
          float* dr = dX + static_cast<size_t>(h) * dpad;
          float dx[NV];
          load_slice<NV>(dr, c0, D, lane, dx);
          while (nz) {  // kBatch node rows read at once, summed in order
            int js[kBatch];
            float gs[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              js[q] = -1;
              if (nz) {
                js[q] = __ffs(nz) - 1;
                nz &= nz - 1;
              }
              gs[q] = __shfl_sync(kFull, gj, max(js[q], 0));
            }
            float v[kBatch][NV];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const float* vr = VOc + static_cast<size_t>(max(js[q], 0)) *
                                          vcols;
#pragma unroll
              for (int m = 0; m < NV; ++m) {
                const int c = lane + 32 * m;
                v[q][m] = js[q] >= 0 && c0 + c < D ? vr[c] : 0.f;
              }
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q)
#pragma unroll
              for (int m = 0; m < NV; ++m) dx[m] = fmaf(gs[q], v[q][m], dx[m]);
          }
#pragma unroll
          for (int m = 0; m < NV; ++m) {
            const int c = c0 + lane + 32 * m;
            if (c < D) dr[c] = dx[m];
          }
        }
        __syncthreads();  // G and the node rows are read before reuse
      }
    }
    // the halo rows' gradient rows to their tokens' delta slots
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
      const float* src = dX + static_cast<size_t>(h) * dpad;
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
    s.counts[2] = 0;
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
// resident), tiles of `tile` centers (at most 32: a center is a bit of a
// 32-bit mask), `smem_bytes` of dynamic shared memory (checked against the
// layout here). points i32 / labels f32 (each 0 or 1) / pmask f32 [V, L];
// the tables move in place by lr. scratch: d_syn0, d_syn1, cnt_syn0,
// cnt_syn1, map_syn0, map_syn1, list_syn0, list_syn1, counts[3] (slots
// taken in each table, tiles taken), all empty (zero, map -1) before the
// step and again after it.
// Returns the CUDA error of the launch (a refused cooperative launch
// included).
extern "C" int srw_hs_step_launch(
    void* syn0, void* syn1, const void* block, const void* cwin,
    const void* points, const void* labels, const void* pmask,
    void* const* scratch_ptrs, int B, int T, int window, int L, int D,
    int tile, int blocks, int smem_bytes, float lr, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || window < 1 || L < 1 || tile < 1 || tile > 32 ||
      blocks < 1 || 4 * smem_words(tile, window, D, L) != smem_bytes)
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
