// Shared-negative SGNS gradients, sgns_shared_grads (sm_90a, f32 in and out,
// the three products on the tensor cores).
//
// Replaces the Pallas kernel stellar_rw_tpu/ops/pallas/sgns.py::
// sgns_shared_grads / _sgns_kernel. Per row p of P and shared negative k:
//   g_neg[p, k] = sigmoid(vi[p] . wn[k]) * mask[p]
//   d_vi[p]     = g_pos[p] * vo[p] + sum_k g_neg[p, k] * wn[k]
//   d_vo[p]     = g_pos[p] * vi[p]
//   d_wn[k]     = sum_p g_neg[p, k] * vi[p]
// The [rows, kB] logit tile never leaves the SM.
//
// What bounds it on this card: 3 * P * kB * D multiply-adds are too few to
// fill the card for long (a block's tile is a few microseconds of tensor
// core work), so latency decides: the round trips that bring a block's
// tiles in, the shared-memory loads that feed the fragments, the write of
// the d_wn partials and the second launch that sums them. The design:
//   * products by mma.sync.m16n8k8 with TF32 operands and f32 accumulators,
//     each as three (error-compensated "3xTF32"): a = a_hi + a_lo with
//     a_hi = tf32(a), a_lo = tf32(a - a_hi), and acc += a_lo*b_hi +
//     a_hi*b_lo + a_hi*b_hi, the small terms first. One TF32 pass keeps
//     three decimal digits; the result is held to rtol 1e-5, atol 1e-5
//     against a full-f32 product, which the three passes meet
//     (ops/sgns.py::sgns_shared_grads_tf32 emulates both on the CPU);
//   * a block of 8 warps owns TM = 32 rows of P at a time. The logits come
//     out of the first product as accumulator fragments, become g_neg in
//     registers, and pass through a [32, KC] tile in shared memory to
//     become the A fragments of g_neg . wn and, read transposed, of
//     g_neg^T . vi;
//   * every operand is read as a fragment many times over (by 2 to 8 warps,
//     in two products), so the tiles are split into their TF32 parts once,
//     when they are loaded: a shared element is the pair (hi, lo), one
//     64-bit load a fragment register pair and no conversion in the loops.
//     Rows are padded to DP + 4 and KC + 4 elements, which keeps both the
//     row-major and the transposed fragment loads of a half-warp in
//     distinct banks. The pairs double the tiles' bytes, so the loads go
//     through registers (16-byte __ldg, LOAD_BATCH in flight a thread, a
//     scalar zero-filling path for a D that is no multiple of 4 and for the
//     ragged edges) and not through cp.async; the widest D (DP = 512) has
//     no room for pairs and splits at each fragment load instead;
//   * the wn chunk (KC negatives, all of wn when kB <= KC: 128 at D <= 128)
//     stays in shared memory while the block loops over its tiles, so wn is
//     read once a block and chunk, not once a tile; d_vo = g_pos * vi is
//     written from the registers that load the vi tile;
//   * blocks are persistent (grid = min(tiles, SMs)) and the chunk's d_wn
//     partial [KC, DP] stays in accumulator registers (at most 64 a thread)
//     over all the block's tiles; it is written once. A second kernel sums
//     the blocks' partials in a fixed order with no atomics, so d_wn is
//     bit-identical from call to call; it is launched as a programmatic
//     dependent of the first, so its launch overlaps the first's run.
//     Bytes of partials: blocks * kB * D * 4 written and read once (5.4 MB
//     at P = 2624, kB = D = 128);
//   * with more than one chunk (kB > KC) d_vi accumulates through device
//     memory between chunks: each thread adds to the elements it wrote
//     itself, so the order is fixed.
//   * any D: above D = 512 a second kernel runs the three products over
//     column slices of 256 with 64 negatives a chunk (sgns_shared_sliced
//     below; at D 768 and 1536 that took three quarters of the time of
//     slices of 512 with 32 negatives a chunk, chip_sgns_parts.py), the
//     logits summed over every slice before the sigmoid.
// wgmma, TMA, a prefetch of the next tile and a cluster's sum of its
// partials through distributed shared memory are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;    // rows of P per tile
constexpr int NTHR = 256; // threads per block (8 warps)
constexpr int RS = 8;     // strided parts of the sum in reduce_partials

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

// An element of a shared tile: the f32 value itself, or its TF32 parts
// (hi, lo) split once when the tile is loaded.
template <bool PRE> struct Elem { using type = float; };
template <> struct Elem<true> { using type = float2; };

template <bool PRE>
__device__ __forceinline__ void frag(const typename Elem<PRE>::type* p,
                                     uint32_t& hi, uint32_t& lo) {
  if constexpr (PRE) {
    const float2 v = *p;
    hi = __float_as_uint(v.x);
    lo = __float_as_uint(v.y);
  } else {
    split_tf32(*p, hi, lo);
  }
}

// four consecutive elements of a tile from four values
template <bool PRE>
__device__ __forceinline__ void store4(typename Elem<PRE>::type* dst,
                                       float4 v) {
  if constexpr (PRE) {
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(h[0], l[0], h[1], l[1]);
    d[1] = make_uint4(h[2], l[2], h[3], l[3]);
  } else {
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// rows [0, total) of a [*, DP + 4] shared tile from the first D columns of
// src [valid, *] (rows ld floats apart); rows beyond `valid` and columns
// beyond D are zero. Loads go out LOAD_BATCH at a
// time for each thread, all before the first of them is used. With DVO the
// rows are vi's and the loaded values also give d_vo = g_pos * vi (scale
// and out point at the tile's first row).
constexpr int LOAD_BATCH = 8;
template <int DP, bool PRE, bool DVO>
__device__ __forceinline__ void load_rows(typename Elem<PRE>::type* dst,
                                          const float* __restrict__ src,
                                          int valid, int total, int D, int ld,
                                          bool vec,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out) {
  constexpr int SV = DP + 4, G4 = DP / 4;
  const int n = total * G4;
  for (int e0 = threadIdx.x; e0 < n; e0 += NTHR * LOAD_BATCH) {
    float4 v[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int e = e0 + u * NTHR;
      const int r = e / G4, c = (e - r * G4) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n && r < valid && c < D) {
        const float* s = src + (size_t)r * ld + c;
        if (vec) {                     // D % 4 == 0: the group is whole
          v[u] = __ldg(reinterpret_cast<const float4*>(s));
        } else {
          v[u].x = s[0];
          if (c + 1 < D) v[u].y = s[1];
          if (c + 2 < D) v[u].z = s[2];
          if (c + 3 < D) v[u].w = s[3];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int e = e0 + u * NTHR;
      const int r = e / G4, c = (e - r * G4) * 4;
      if (e < n) store4<PRE>(dst + r * SV + c, v[u]);
      if (DVO && e < n && r < valid && c < D) {
        const float gp = scale[r];
        float* o = out + (size_t)r * ld + c;
        if (vec) {                     // out's rows are aligned like src's
          *reinterpret_cast<float4*>(o) = make_float4(
              gp * v[u].x, gp * v[u].y, gp * v[u].z, gp * v[u].w);
        } else {
          o[0] = gp * v[u].x;
          if (c + 1 < D) o[1] = gp * v[u].y;
          if (c + 2 < D) o[2] = gp * v[u].z;
          if (c + 3 < D) o[3] = gp * v[u].w;
        }
      }
    }
  }
}

// Fragment layouts of mma.m16n8k8 (g = lane / 4, tig = lane % 4):
//   A: a0 (row g, k tig), a1 (row g+8, k tig), a2 (row g, k tig+4),
//      a3 (row g+8, k tig+4);  B: b0 (k tig, col g), b1 (k tig+4, col g);
//   C: c0 (row g, col 2tig), c1 (row g, col 2tig+1), c2 (row g+8, col 2tig),
//      c3 (row g+8, col 2tig+1).
// DP: D padded to the instantiation's width; KC: negatives a chunk; PRE:
// tiles hold (hi, lo) pairs.
template <int DP, int KC, bool PRE>
__global__ void __launch_bounds__(NTHR, 1)
sgns_shared_kernel(const float* __restrict__ vi, const float* __restrict__ vo,
                   const float* __restrict__ wn,
                   const float* __restrict__ g_pos,
                   const float* __restrict__ mask, float* __restrict__ d_vi,
                   float* __restrict__ d_vo, float* __restrict__ part, int P,
                   int D, int kB) {
  using E = typename Elem<PRE>::type;
  constexpr int SV = DP + 4;          // row stride of s_vi and s_wn
  constexpr int SG = KC + 4;          // row stride of s_g
  constexpr int NT = DP / 8;          // 8-column tiles across D
  constexpr int N1 = KC / 32;         // product 1: column tiles a warp
  constexpr int N2 = NT / 4;          // product 2: column tiles a warp
  constexpr int WM3 = KC / 16 < 8 ? KC / 16 : 8;  // product 3: warps along kB
  constexpr int WN3 = 8 / WM3;                    // and along D
  constexpr int N3 = NT / WN3;        // product 3: column tiles a warp
  static_assert(KC % 32 == 0 && DP % 32 == 0 && KC / 16 <= 8, "tile shape");
  extern __shared__ __align__(16) unsigned char sm_raw[];
  E* s_vi = reinterpret_cast<E*>(sm_raw);   // [TM, SV]
  E* s_wn = s_vi + TM * SV;                 // [KC, SV]
  E* s_g = s_wn + KC * SV;                  // [TM, SG]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mt = warp & 1, wq = warp >> 1;        // products 1 and 2
  const int m3 = (warp % WM3) * 16, wn3 = warp / WM3;  // product 3
  const int ntiles = (P + TM - 1) / TM;
  // 16-byte loads need rows that start on 16 bytes; 8-byte stores an even D
  const bool vec_vi = D % 4 == 0 && (uintptr_t)vi % 16 == 0 &&
                      (uintptr_t)d_vo % 16 == 0;
  const bool vec_wn = D % 4 == 0 && (uintptr_t)wn % 16 == 0;
  const bool pair = D % 2 == 0 && (uintptr_t)vo % 8 == 0 &&
                    (uintptr_t)d_vi % 8 == 0 && (uintptr_t)part % 8 == 0;
  float* my_part = part + (size_t)blockIdx.x * kB * D;
  // let the summing kernel's blocks take their places while this one runs;
  // they wait for this grid's end before they read
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  for (int k0 = 0; k0 < kB; k0 += KC) {
    const int kc_valid = min(KC, kB - k0);
    const int kc_lim = (kc_valid + 15) & ~15;   // columns of the chunk run
    load_rows<DP, PRE, false>(s_wn, wn + (size_t)k0 * D, kc_valid, kc_lim, D,
                              D, vec_wn, nullptr, nullptr);
    float acc3[N3][4];
#pragma unroll
    for (int i = 0; i < N3; ++i)
      acc3[i][0] = acc3[i][1] = acc3[i][2] = acc3[i][3] = 0.f;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int r0 = tile * TM;
      if (k0 == 0)   // the first pass over the tiles also writes d_vo
        load_rows<DP, PRE, true>(s_vi, vi + (size_t)r0 * D, min(TM, P - r0),
                                 TM, D, D, vec_vi, g_pos + r0,
                                 d_vo + (size_t)r0 * D);
      else
        load_rows<DP, PRE, false>(s_vi, vi + (size_t)r0 * D, min(TM, P - r0),
                                  TM, D, D, vec_vi, nullptr, nullptr);
      __syncthreads();

      // product 1: logits [TM, KC] = vi . wn^T over D, then g_neg -> s_g
      {
        float acc[N1][4];
#pragma unroll
        for (int i = 0; i < N1; ++i)
          acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        const E* a = s_vi + (mt * 16 + g) * SV + tig;
#pragma unroll 2
        for (int kk = 0; kk < DP; kk += 8) {
          uint32_t ah[4], al[4];
          frag<PRE>(a + kk, ah[0], al[0]);
          frag<PRE>(a + kk + 8 * SV, ah[1], al[1]);
          frag<PRE>(a + kk + 4, ah[2], al[2]);
          frag<PRE>(a + kk + 8 * SV + 4, ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < N1; ++i) {
            const int n0 = (wq + 4 * i) * 8;
            if (n0 < kc_lim) {
              const E* b = s_wn + (n0 + g) * SV + kk + tig;
              uint32_t bh[2], bl[2];
              frag<PRE>(b, bh[0], bl[0]);
              frag<PRE>(b + 4, bh[1], bl[1]);
              mma_3xtf32(acc[i], ah, al, bh, bl);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < N1; ++i) {
          const int n0 = (wq + 4 * i) * 8;
          if (n0 < kc_lim) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = mt * 16 + g + 8 * h, p = r0 + row;
              const float mk = p < P ? mask[p] : 0.f;
              const int col = n0 + 2 * tig;
              const float g0 =
                  (p < P && k0 + col < kB)
                      ? (1.f / (1.f + expf(-acc[i][2 * h]))) * mk : 0.f;
              const float g1 =
                  (p < P && k0 + col + 1 < kB)
                      ? (1.f / (1.f + expf(-acc[i][2 * h + 1]))) * mk : 0.f;
              E* dst = s_g + row * SG + col;
              if constexpr (PRE) {
                uint32_t h0, l0, h1, l1;
                split_tf32(g0, h0, l0);
                split_tf32(g1, h1, l1);
                *reinterpret_cast<uint4*>(dst) = make_uint4(h0, l0, h1, l1);
              } else {
                *reinterpret_cast<float2*>(dst) = make_float2(g0, g1);
              }
            }
          }
        }
      }
      __syncthreads();

      // product 2: d_vi tile [TM, DP] = g_neg . wn over the chunk
      {
        float acc[N2][4];
#pragma unroll
        for (int i = 0; i < N2; ++i)
          acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        const E* a = s_g + (mt * 16 + g) * SG + tig;
        for (int kk = 0; kk < kc_lim; kk += 8) {
          uint32_t ah[4], al[4];
          frag<PRE>(a + kk, ah[0], al[0]);
          frag<PRE>(a + kk + 8 * SG, ah[1], al[1]);
          frag<PRE>(a + kk + 4, ah[2], al[2]);
          frag<PRE>(a + kk + 8 * SG + 4, ah[3], al[3]);
          const E* b = s_wn + (kk + tig) * SV + g;
#pragma unroll
          for (int i = 0; i < N2; ++i) {
            const int n0 = (wq + 4 * i) * 8;
            uint32_t bh[2], bl[2];
            frag<PRE>(b + n0, bh[0], bl[0]);
            frag<PRE>(b + n0 + 4 * SV, bh[1], bl[1]);
            mma_3xtf32(acc[i], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int i = 0; i < N2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = r0 + mt * 16 + g + 8 * h;
            const int d = (wq + 4 * i) * 8 + 2 * tig;
            if (p < P && d < D) {
              const size_t o = (size_t)p * D + d;
              const float gp = k0 == 0 ? g_pos[p] : 0.f;
              if (pair) {              // D even: d + 1 < D too
                const float2 base =
                    k0 == 0 ? *reinterpret_cast<const float2*>(vo + o)
                            : *reinterpret_cast<const float2*>(d_vi + o);
                const float s = k0 == 0 ? gp : 1.f;
                *reinterpret_cast<float2*>(d_vi + o) =
                    make_float2(s * base.x + acc[i][2 * h],
                                s * base.y + acc[i][2 * h + 1]);
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (d + e < D) {
                    const float base = k0 == 0 ? gp * vo[o + e] : d_vi[o + e];
                    d_vi[o + e] = base + acc[i][2 * h + e];
                  }
                }
              }
            }
          }
        }
      }

      // product 3: the chunk's d_wn partial [KC, DP] += g_neg^T . vi over
      // the tile's rows
      if (m3 < kc_lim) {
#pragma unroll
        for (int kk = 0; kk < TM; kk += 8) {
          const E* a = s_g + (kk + tig) * SG + m3 + g;
          uint32_t ah[4], al[4];
          frag<PRE>(a, ah[0], al[0]);
          frag<PRE>(a + 8, ah[1], al[1]);
          frag<PRE>(a + 4 * SG, ah[2], al[2]);
          frag<PRE>(a + 4 * SG + 8, ah[3], al[3]);
          const E* b = s_vi + (kk + tig) * SV + g;
#pragma unroll
          for (int i = 0; i < N3; ++i) {
            const int n0 = (wn3 + WN3 * i) * 8;
            uint32_t bh[2], bl[2];
            frag<PRE>(b + n0, bh[0], bl[0]);
            frag<PRE>(b + n0 + 4 * SV, bh[1], bl[1]);
            mma_3xtf32(acc3[i], ah, al, bh, bl);
          }
        }
      }
      __syncthreads();  // s_vi and s_g are rewritten by the next tile
    }

    // the chunk's partial, once
#pragma unroll
    for (int i = 0; i < N3; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kb = k0 + m3 + g + 8 * h;
        const int d = (wn3 + WN3 * i) * 8 + 2 * tig;
        if (kb < kB && d < D) {
          float* dst = my_part + (size_t)kb * D + d;
          if (pair) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc3[i][2 * h], acc3[i][2 * h + 1]);
          } else {
            dst[0] = acc3[i][2 * h];
            if (d + 1 < D) dst[1] = acc3[i][2 * h + 1];
          }
        }
      }
    }
  }
}

// D above the widest instantiation (any D): the same three products over
// column slices of SW. A tile's logits must be complete over all of D before
// the sigmoid, so each tile passes over its slices twice: first the logits,
// summed slice after slice in the same accumulators; then, slice by slice,
// d_vi and the tile's share of d_wn. The block's d_wn partial [kB, D] is too
// wide for registers, so each tile's share is added to it in device memory,
// every element by the one thread that owns it (a fixed order, no atomics).
// Both passes load the wn chunk's slice again for each tile.
template <int SW, int KC>
__global__ void __launch_bounds__(NTHR, 1)
sgns_shared_sliced(const float* __restrict__ vi, const float* __restrict__ vo,
                   const float* __restrict__ wn,
                   const float* __restrict__ g_pos,
                   const float* __restrict__ mask, float* __restrict__ d_vi,
                   float* __restrict__ d_vo, float* __restrict__ part, int P,
                   int D, int kB) {
  constexpr int SV = SW + 4, SG = KC + 4, NT = SW / 8;
  constexpr int N1 = KC / 32, N2 = NT / 4;
  constexpr int WM3 = KC / 16 < 8 ? KC / 16 : 8, WN3 = 8 / WM3;
  constexpr int N3 = NT / WN3;
  static_assert(KC % 32 == 0 && SW % 64 == 0 && KC / 16 <= 8, "tile shape");
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* s_vi = reinterpret_cast<float*>(sm_raw);   // [TM, SV]
  float* s_wn = s_vi + TM * SV;                     // [KC, SV]
  float* s_g = s_wn + KC * SV;                      // [TM, SG]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mt = warp & 1, wq = warp >> 1;
  const int m3 = (warp % WM3) * 16, wn3 = warp / WM3;
  const int ntiles = (P + TM - 1) / TM;
  const bool vec_vi = D % 4 == 0 && (uintptr_t)vi % 16 == 0 &&
                      (uintptr_t)d_vo % 16 == 0;
  const bool vec_wn = D % 4 == 0 && (uintptr_t)wn % 16 == 0;
  const bool two = D % 2 == 0 && (uintptr_t)vo % 8 == 0 &&
                   (uintptr_t)d_vi % 8 == 0 && (uintptr_t)part % 8 == 0;
  float* my_part = part + (size_t)blockIdx.x * kB * D;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  for (int k0 = 0; k0 < kB; k0 += KC) {
    const int kc_valid = min(KC, kB - k0);
    const int kc_lim = (kc_valid + 15) & ~15;
    const float* wn_k = wn + (size_t)k0 * D;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int r0 = tile * TM, rows = min(TM, P - r0);
      const float* vi_t = vi + (size_t)r0 * D;
      float lg[N1][4];
#pragma unroll
      for (int i = 0; i < N1; ++i) lg[i][0] = lg[i][1] = lg[i][2] = lg[i][3] = 0.f;
      for (int c0 = 0; c0 < D; c0 += SW) {          // pass 1: the logits
        const int w = min(SW, D - c0);
        load_rows<SW, false, false>(s_wn, wn_k + c0, kc_valid, kc_lim, w, D,
                                    vec_wn, nullptr, nullptr);
        if (k0 == 0)   // d_vo = g_pos * vi with the first pass's loads
          load_rows<SW, false, true>(s_vi, vi_t + c0, rows, TM, w, D, vec_vi,
                                     g_pos + r0, d_vo + (size_t)r0 * D + c0);
        else
          load_rows<SW, false, false>(s_vi, vi_t + c0, rows, TM, w, D,
                                      vec_vi, nullptr, nullptr);
        __syncthreads();
        // the logits over D = 768 and more: each 64 columns in accumulators
        // of their own, added into lg in f32 (the tensor cores' f32
        // accumulation loses bits over long sums)
        const float* a = s_vi + (mt * 16 + g) * SV + tig;
        for (int q0 = 0; q0 < w; q0 += 64) {
          float part[N1][4];
#pragma unroll
          for (int i = 0; i < N1; ++i)
            part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
#pragma unroll 2
          for (int q = q0; q < q0 + 64; q += 8) {
            uint32_t ah[4], al[4];
            split_tf32(a[q], ah[0], al[0]);
            split_tf32(a[q + 8 * SV], ah[1], al[1]);
            split_tf32(a[q + 4], ah[2], al[2]);
            split_tf32(a[q + 8 * SV + 4], ah[3], al[3]);
#pragma unroll
            for (int i = 0; i < N1; ++i) {
              const int n0 = (wq + 4 * i) * 8;
              if (n0 < kc_lim) {
                const float* b = s_wn + (n0 + g) * SV + q + tig;
                uint32_t bh[2], bl[2];
                split_tf32(b[0], bh[0], bl[0]);
                split_tf32(b[4], bh[1], bl[1]);
                mma_3xtf32(part[i], ah, al, bh, bl);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < N1; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) lg[i][j] += part[i][j];
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < N1; ++i) {                // g_neg -> s_g
        const int n0 = (wq + 4 * i) * 8;
        if (n0 < kc_lim) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + g + 8 * h, p = r0 + row;
            const float mk = p < P ? mask[p] : 0.f;
            const int col = n0 + 2 * tig;
            const float g0 = (p < P && k0 + col < kB)
                ? (1.f / (1.f + expf(-lg[i][2 * h]))) * mk : 0.f;
            const float g1 = (p < P && k0 + col + 1 < kB)
                ? (1.f / (1.f + expf(-lg[i][2 * h + 1]))) * mk : 0.f;
            *reinterpret_cast<float2*>(s_g + row * SG + col) =
                make_float2(g0, g1);
          }
        }
      }
      for (int c0 = 0; c0 < D; c0 += SW) {          // pass 2: d_vi, d_wn
        const int w = min(SW, D - c0);
        load_rows<SW, false, false>(s_wn, wn_k + c0, kc_valid, kc_lim, w, D,
                                    vec_wn, nullptr, nullptr);
        load_rows<SW, false, false>(s_vi, vi_t + c0, rows, TM, w, D, vec_vi,
                                    nullptr, nullptr);
        __syncthreads();
        {
          float acc[N2][4];
#pragma unroll
          for (int i = 0; i < N2; ++i)
            acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
          const float* a = s_g + (mt * 16 + g) * SG + tig;
          for (int q = 0; q < kc_lim; q += 8) {
            uint32_t ah[4], al[4];
            split_tf32(a[q], ah[0], al[0]);
            split_tf32(a[q + 8 * SG], ah[1], al[1]);
            split_tf32(a[q + 4], ah[2], al[2]);
            split_tf32(a[q + 8 * SG + 4], ah[3], al[3]);
            const float* b = s_wn + (q + tig) * SV + g;
#pragma unroll
            for (int i = 0; i < N2; ++i) {
              const int n0 = (wq + 4 * i) * 8;
              uint32_t bh[2], bl[2];
              split_tf32(b[n0], bh[0], bl[0]);
              split_tf32(b[n0 + 4 * SV], bh[1], bl[1]);
              mma_3xtf32(acc[i], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int i = 0; i < N2; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = r0 + mt * 16 + g + 8 * h;
              const int d = (wq + 4 * i) * 8 + 2 * tig;
              if (p >= P || d >= w) continue;
              const size_t o = (size_t)p * D + c0 + d;
              const float gp = k0 == 0 ? g_pos[p] : 0.f;
              if (two) {               // D even: d + 1 < w too
                const float2 base =
                    k0 == 0 ? *reinterpret_cast<const float2*>(vo + o)
                            : *reinterpret_cast<const float2*>(d_vi + o);
                const float s = k0 == 0 ? gp : 1.f;
                *reinterpret_cast<float2*>(d_vi + o) =
                    make_float2(s * base.x + acc[i][2 * h],
                                s * base.y + acc[i][2 * h + 1]);
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (d + e < w) {
                    const float base = k0 == 0 ? gp * vo[o + e] : d_vi[o + e];
                    d_vi[o + e] = base + acc[i][2 * h + e];
                  }
                }
              }
            }
          }
        }
        if (m3 < kc_lim) {      // the tile's d_wn share of this slice
          float acc[N3][4];
#pragma unroll
          for (int i = 0; i < N3; ++i)
            acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
          for (int q = 0; q < TM; q += 8) {
            const float* a = s_g + (q + tig) * SG + m3 + g;
            uint32_t ah[4], al[4];
            split_tf32(a[0], ah[0], al[0]);
            split_tf32(a[8], ah[1], al[1]);
            split_tf32(a[4 * SG], ah[2], al[2]);
            split_tf32(a[4 * SG + 8], ah[3], al[3]);
            const float* b = s_vi + (q + tig) * SV + g;
#pragma unroll
            for (int i = 0; i < N3; ++i) {
              const int n0 = (wn3 + WN3 * i) * 8;
              uint32_t bh[2], bl[2];
              split_tf32(b[n0], bh[0], bl[0]);
              split_tf32(b[n0 + 4 * SV], bh[1], bl[1]);
              mma_3xtf32(acc[i], ah, al, bh, bl);
            }
          }
          const bool first = tile == (int)blockIdx.x;
#pragma unroll
          for (int i = 0; i < N3; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int kb = k0 + m3 + g + 8 * h;
              const int d = (wn3 + WN3 * i) * 8 + 2 * tig;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (kb < kB && d + e < w) {
                  float* dst = my_part + (size_t)kb * D + c0 + d + e;
                  *dst = (first ? 0.f : *dst) + acc[i][2 * h + e];
                }
              }
            }
          }
        }
        __syncthreads();  // s_vi, s_wn (and after the last slice s_g) reused
      }
    }
  }
}

// d_wn[i] = sum over blocks of part[b][i] in a fixed order: thread row y
// adds blocks y, y + RS, ... in order, then the RS sums are added in order.
__global__ void __launch_bounds__(32 * RS)
reduce_partials(const float* __restrict__ part, float* __restrict__ d_wn,
                int nblk, int n) {
  __shared__ float s[RS][32];
  const int x = threadIdx.x, y = threadIdx.y;
  const int i = blockIdx.x * 32 + x;
  // launched while the tiles' kernel still runs: wait for its end
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float a = 0.f;
  if (i < n)
    for (int b = y; b < nblk; b += RS) a += part[(size_t)b * n + i];
  s[y][x] = a;
  __syncthreads();
  if (y == 0 && i < n) {
    float t = s[0][x];
#pragma unroll
    for (int q = 1; q < RS; ++q) t += s[q][x];
    d_wn[i] = t;
  }
}

template <int DP, int KC, bool PRE>
cudaError_t launch_tiles(const float* vi, const float* vo, const float* wn,
                         const float* g_pos, const float* mask, float* d_vi,
                         float* d_vo, float* part, int P, int D, int kB,
                         int nblk, cudaStream_t s) {
  constexpr size_t smem = sizeof(typename Elem<PRE>::type) *
                          ((size_t)(TM + KC) * (DP + 4) + TM * (KC + 4));
  static bool raised = false;   // the limit is set once for each width
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_shared_kernel<DP, KC, PRE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  sgns_shared_kernel<DP, KC, PRE><<<nblk, NTHR, smem, s>>>(
      vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB);
  return cudaSuccess;
}

template <int SW, int KC>
cudaError_t launch_sliced(const float* vi, const float* vo, const float* wn,
                          const float* g_pos, const float* mask, float* d_vi,
                          float* d_vo, float* part, int P, int D, int kB,
                          int nblk, cudaStream_t s) {
  constexpr size_t smem =
      sizeof(float) * ((size_t)(TM + KC) * (SW + 4) + TM * (KC + 4));
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_shared_sliced<SW, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  sgns_shared_sliced<SW, KC><<<nblk, NTHR, smem, s>>>(
      vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB);
  return cudaSuccess;
}

}  // namespace

// The widths (DP, KC, PRE) and the slices above D = 512 mirror
// ops/sgns.py::launch_plan (WIDTHS, SLICED).
extern "C" int srw_sgns_shared_launch(const float* vi, const float* vo,
                                      const float* wn, const float* g_pos,
                                      const float* mask, float* d_vi,
                                      float* d_vo, float* d_wn, float* part,
                                      int P, int D, int kB, int nblk,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nblk > 0 && kB > 0 && D > 0) {
    cudaError_t err;
    if (D > 512)
      err = launch_sliced<256, 64>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    else if (D <= 64)
      err = launch_tiles<64, 128, true>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    else if (D <= 128)
      err = launch_tiles<128, 128, true>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    else if (D <= 256)
      err = launch_tiles<256, 64, true>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    else
      err = launch_tiles<512, 32, false>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int n = kB * D;
  if (n > 0) {
    // programmatic dependent launch: the launch overlaps the tiles' kernel
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + 31) / 32);
    cfg.blockDim = dim3(32, RS);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, reduce_partials,
                                         (const float*)part, d_wn, nblk, n);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
