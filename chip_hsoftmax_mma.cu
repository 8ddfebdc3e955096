// The hierarchical-softmax step of csrc/hsoftmax.cu (see its header) with
// the three products of a tile on the tensor cores: a measured variant for
// chip_hsoftmax_parts.py, never on the port's path. Rows of at most 128
// columns only (D > 128 is refused). Everything but the products and the
// shared-memory layout they need is csrc/hsoftmax.cu's: the tiles, the
// halo, the de-duplicated nodes and their delta slots, the update.
//
// The products, chunk by chunk of kChunk nodes (mma_chunks): S = X VO^T
// dense over the tile's halo rows (rounded up to 16) and the chunk's nodes,
// then G, d_VO = G^T X and d_X += G VO, each as mma.sync m16n8k8 with its
// TF32 operands split in three error-compensated passes (3xTF32, as
// csrc/sgns_shared.cu does: one TF32 pass fails the step's tolerance). S is
// dense where the pairs fill a part of it, so this form does more products
// than the f32 lanes' form, which skips the halo rows and nodes that share
// no pair.

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
constexpr int kChunk = 32;         // nodes a chunk of U (mma_chunks' tiles)
constexpr int kApply = 4;          // the update: rows a warp takes at once
constexpr int kEmpty = -1;         // a row with no delta slot

// shared memory of a block in 4-byte words (chip_hsoftmax_parts.py::
// mma_smem_bytes): X and dX [Hp, xs], the chunk's node rows [kChunk, xs], G
// [Hp, kChunk + 4] (Hp: H rounded up to 16; xs: D rounded up to 8, plus 4:
// conflict-free fragment reads), then as csrc/hsoftmax.cu: the halo's
// tokens, pair counts and center masks, a center's pair count and
// first-occurrence count, the path entries [tile, L] (node, label, owner,
// node index) and the nodes [tile * L] (node, center mask, label-1 mask,
// slot), the block's next tile
__host__ __device__ inline long long smem_words(int tile, int window, int D,
                                                int L) {
  const long long H = tile + 2 * window;
  const long long Hp = (H + 15) & ~15LL;
  const long long xs = ((D + 7) & ~7LL) + 4;
  const long long E = static_cast<long long>(tile) * L;
  return 2 * Hp * xs + kChunk * xs + Hp * (kChunk + 4) + 3 * H + 2 * tile +
         8 * E + 1;
}

// TF32 products to f32 accuracy, as csrc/sgns_shared.cu takes them:
// x = hi + lo with both representable in TF32 (lo to its own precision)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b to f32 accuracy: the two cross terms, then the main one
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
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

// The three products of a tile for rows of at most 128 columns, on the
// tensor cores (mma.sync m16n8k8, TF32 operands split in three error-
// compensated passes as csrc/sgns_shared.cu does: f32 accuracy), chunk by
// chunk of kChunk nodes: the chunk's node rows into VOc; S = X VO^T a warp
// 16 halo rows x 16 nodes (sums of 64 columns apart, then added) and G
// from it; then d_VO = G^T X a warp 16 nodes x 32 columns into the nodes'
// delta slots, and d_X += G VO a warp 16 halo rows x 64 columns on dX.
// Rows of X, dX and VOc are xs floats apart (D rounded up to 8, plus 4:
// conflict-free A-fragment reads), of G gs; halo rows up to Hp (H rounded
// up to 16) and columns up to D rounded up to 8 are zero.
//   Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4): A: (row g, k t),
//   (g + 8, t), (g, t + 4), (g + 8, t + 4); B: (k t, col g), (t + 4, g);
//   C: (row g, col 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ void mma_chunks(const float* X, float* dX, float* VOc, float* G,
                           const unsigned* pairm, const unsigned* umask,
                           const unsigned* ulab, const int* unode,
                           const int* uslot, const float* syn1,
                           const Scratch& s, int nU, int H, int Hp, int D,
                           int xs, int gs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, tig = lane & 3;
  const int dp8 = xs - 4;
  for (int u0 = 0; u0 < nU; u0 += kChunk) {
    for (int i = threadIdx.x; i < kChunk * dp8; i += kThreads) {
      const int j = i / dp8;
      const int c = i - j * dp8;
      const bool on = u0 + j < nU && c < D;
      cp_async4(VOc + j * xs + c,
                syn1 + (on ? static_cast<size_t>(unode[u0 + j]) * D + c : 0),
                on);
    }
    cp_async_wait();
    __syncthreads();
    // S and G: row tiles m0, node columns nb .. nb + 15
    const int nb = (warp & 1) * 16;
    for (int m0 = (warp >> 1) * 16; m0 < Hp; m0 += 64) {
      float acc[2][4] = {};
      for (int q0 = 0; q0 < dp8; q0 += 64) {
        float part[2][4] = {};
        for (int q = q0; q < min(q0 + 64, dp8); q += 8) {
          const float* a = X + (m0 + g8) * xs + q + tig;
          uint32_t ah[4], al[4];
          split_tf32(a[0], ah[0], al[0]);
          split_tf32(a[8 * xs], ah[1], al[1]);
          split_tf32(a[4], ah[2], al[2]);
          split_tf32(a[8 * xs + 4], ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* b = VOc + (nb + 8 * i + g8) * xs + q + tig;
            uint32_t bh[2], bl[2];
            split_tf32(b[0], bh[0], bl[0]);
            split_tf32(b[4], bh[1], bl[1]);
            mma_3xtf32(part[i], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = m0 + g8 + (j >> 1) * 8;
          const int u = nb + 8 * i + 2 * tig + (j & 1);
          float gv = 0.f;
          if (h < H && u0 + u < nU) {
            const unsigned pm = pairm[h] & umask[u0 + u];
            if (pm)   // the centers of pm less those of label 1
              gv = static_cast<float>(__popc(pm)) *
                       __fdividef(1.f, 1.f + __expf(-acc[i][j])) -
                   static_cast<float>(__popc(pm & ulab[u0 + u]));
          }
          G[h * gs + u] = gv;
        }
    }
    __syncthreads();
    {  // d_VO: nodes mn .. mn + 15, columns cb .. cb + 31
      const int mn = (warp >> 2) * 16, cb = (warp & 3) * 32;
      float acc[4][4] = {};
      for (int k0 = 0; k0 < Hp && cb < dp8; k0 += 8) {
        const float* a = G + (k0 + tig) * gs + mn + g8;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8], ah[1], al[1]);
        split_tf32(a[4 * gs], ah[2], al[2]);
        split_tf32(a[4 * gs + 8], ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cb + 8 * i >= dp8) continue;
          const float* b = X + (k0 + tig) * xs + cb + 8 * i + g8;
          uint32_t bh[2], bl[2];
          split_tf32(b[0], bh[0], bl[0]);
          split_tf32(b[4 * xs], bh[1], bl[1]);
          mma_3xtf32(acc[i], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = mn + g8 + (j >> 1) * 8;
          const int c = cb + 8 * i + 2 * tig + (j & 1);
          if (u0 + u < nU && c < D)
            atomicAdd(s.dt(1) + static_cast<size_t>(uslot[u0 + u]) * D + c,
                      acc[i][j]);
        }
    }
    // d_X: row tiles m0, columns cx .. cx + 63
    const int cx = (warp & 1) * 64;
    for (int m0 = (warp >> 1) * 16; m0 < Hp && cx < dp8; m0 += 64) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* c = dX + (m0 + g8) * xs + cx + 8 * i + 2 * tig;
        const bool on = cx + 8 * i < dp8;
        acc[i][0] = on ? c[0] : 0.f;
        acc[i][1] = on ? c[1] : 0.f;
        acc[i][2] = on ? c[8 * xs] : 0.f;
        acc[i][3] = on ? c[8 * xs + 1] : 0.f;
      }
#pragma unroll
      for (int k0 = 0; k0 < kChunk; k0 += 8) {
        const float* a = G + (m0 + g8) * gs + k0 + tig;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * gs], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * gs + 4], ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (cx + 8 * i >= dp8) continue;
          const float* b = VOc + (k0 + tig) * xs + cx + 8 * i + g8;
          uint32_t bh[2], bl[2];
          split_tf32(b[0], bh[0], bl[0]);
          split_tf32(b[4 * xs], bh[1], bl[1]);
          mma_3xtf32(acc[i], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (cx + 8 * i >= dp8) continue;
        float* c = dX + (m0 + g8) * xs + cx + 8 * i + 2 * tig;
        c[0] = acc[i][0];
        c[1] = acc[i][1];
        c[8 * xs] = acc[i][2];
        c[8 * xs + 1] = acc[i][3];
      }
    }
    __syncthreads();  // G and the node rows are read before reuse
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hs_step(float* syn0, float* syn1, const int* __restrict__ block,
            const int* __restrict__ cwin, const int* __restrict__ points,
            const float* __restrict__ labels,
            const float* __restrict__ pmask, Scratch s, int B, int T,
            int window, int L, int D, int tile, float lr) {
  extern __shared__ __align__(16) float smem[];
  const int H = tile + 2 * window;
  // the layout of smem_words: halo rows Hp, row strides of X, dX and the
  // chunk's node rows (xs) and of G (gs)
  const int Hp = (H + 15) & ~15;
  const int xs = ((D + 7) & ~7) + 4;
  const int gs = kChunk + 4;
  const int E = tile * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* X = smem;
  float* dX = X + static_cast<size_t>(Hp) * xs;
  float* VOc = dX + static_cast<size_t>(Hp) * xs;
  float* G = VOc + static_cast<size_t>(kChunk) * xs;
  int* tokh = reinterpret_cast<int*>(G + static_cast<size_t>(Hp) * gs);
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
    for (int h = warp; h < Hp; h += kWarps) {   // rows past H: zero
      const int tk = h < H ? tokh[h] : -1;
      const float* src = syn0 + static_cast<size_t>(max(tk, 0)) * D;
      for (int c = lane; c < xs; c += 32) {
        cp_async4(X + static_cast<size_t>(h) * xs + c,
                  src + (c < D ? c : 0), tk >= 0 && c < D);
        dX[static_cast<size_t>(h) * xs + c] = 0.f;
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

    mma_chunks(X, dX, VOc, G, pairm, umask, ulab, unode, uslot, syn1, s, nU,
               H, Hp, D, xs, gs);
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
      const float* src = dX + static_cast<size_t>(h) * xs;
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

cudaError_t launch_step(float* syn0, float* syn1, const int* block,
                        const int* cwin, const int* points,
                        const float* labels, const float* pmask, Scratch s,
                        int B, int T, int window, int L, int D, int tile,
                        int blocks, size_t smem, float lr,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hs_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&syn0, &syn1, &block,  &cwin, &points, &labels, &pmask,
                  &s,    &B,    &T,      &window, &L,     &D,     &tile,
                  &lr};
  // refused (cudaErrorCooperativeLaunchTooLarge) if the blocks cannot all
  // be resident at once: never run as an ordinary launch
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hs_step), dim3(blocks),
      dim3(kThreads), args, smem, stream);
}

}  // namespace

// One step for a block [B, T] of D <= 128 under a launch plan
// (chip_hsoftmax_parts.py::mma_plan): `blocks` persistent blocks of
// kThreads threads (all resident), tiles of `tile` centers (at most 32: a
// center is a bit of a 32-bit mask), `smem_bytes` of dynamic shared memory
// (checked against the layout here). points i32 / labels f32 (each 0 or 1)
// / pmask f32 [V, L]; the tables move in place by lr. scratch: d_syn0,
// d_syn1, cnt_syn0, cnt_syn1, map_syn0, map_syn1, list_syn0, list_syn1,
// counts[3] (slots taken in each table, tiles taken), all empty (zero, map
// -1) before the step and again after it.
// Returns the CUDA error of the launch (a refused cooperative launch
// included).
extern "C" int srw_hs_step_launch(
    void* syn0, void* syn1, const void* block, const void* cwin,
    const void* points, const void* labels, const void* pmask,
    void* const* scratch_ptrs, int B, int T, int window, int L, int D,
    int tile, int blocks, int smem_bytes, float lr, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (D < 1 || D > 128 || window < 1 || L < 1 || tile < 1 || tile > 32 ||
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
  const cudaError_t err = launch_step(a, b, blk, cw, pt, lb, pm, s, B, T,
                                      window, L, D, tile, blocks, smem, lr,
                                      st);
  cudaGetLastError();  // a refused launch leaves no error for later calls
  return static_cast<int>(err);
}
