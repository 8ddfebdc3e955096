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
// Two forms: the tile kernel for D <= 256 and the split form above (any D).
// What bounds both on this card: 3 * P * kB * D multiply-adds are too few to
// fill the card for long (a block's tile is a few microseconds of tensor
// core work), so latency decides: the round trips that bring a block's
// tiles in, the shared-memory loads that feed the fragments, the write of
// the d_wn partials and the launch that sums them. The tile kernel:
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
//     ragged edges) and not through cp.async;
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
// Its widest width (D <= 512 in 82 persistent blocks of one tile each at P
// 2624) lost to the plain f32 products from D 384 up (0.120 ms against
// 0.071 at D 384), and its D > 512 form, the three products over column
// slices of 256 in one block a tile, lost everywhere (0.214 ms against
// 0.102 at D 768): one block a tile left 50 SMs idle and each block passed
// over D twice in serial phases with no copy in flight. Both were replaced
// by the split form (below).

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

// A shared tile's element: its TF32 parts (hi, lo), split once when the
// tile is loaded.
__device__ __forceinline__ void frag(const float2* p, uint32_t& hi,
                                     uint32_t& lo) {
  const float2 v = *p;
  hi = __float_as_uint(v.x);
  lo = __float_as_uint(v.y);
}

// four consecutive elements of a tile from four values
__device__ __forceinline__ void store4(float2* dst, float4 v) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(h[0], l[0], h[1], l[1]);
  d[1] = make_uint4(h[2], l[2], h[3], l[3]);
}

// rows [0, total) of a [*, DP + 4] shared tile from the first D columns of
// src [valid, *] (rows ld floats apart); rows beyond `valid` and columns
// beyond D are zero. Loads go out LOAD_BATCH at a
// time for each thread, all before the first of them is used. With DVO the
// rows are vi's and the loaded values also give d_vo = g_pos * vi (scale
// and out point at the tile's first row).
constexpr int LOAD_BATCH = 8;
template <int DP, bool DVO>
__device__ __forceinline__ void load_rows(float2* dst,
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
      if (e < n) store4(dst + r * SV + c, v[u]);
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
// DP: D padded to the instantiation's width; KC: negatives a chunk.
template <int DP, int KC>
__global__ void __launch_bounds__(NTHR, 1)
sgns_shared_kernel(const float* __restrict__ vi, const float* __restrict__ vo,
                   const float* __restrict__ wn,
                   const float* __restrict__ g_pos,
                   const float* __restrict__ mask, float* __restrict__ d_vi,
                   float* __restrict__ d_vo, float* __restrict__ part, int P,
                   int D, int kB) {
  using E = float2;                   // an element's (hi, lo)
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
    load_rows<DP, false>(s_wn, wn + (size_t)k0 * D, kc_valid, kc_lim, D,
                              D, vec_wn, nullptr, nullptr);
    float acc3[N3][4];
#pragma unroll
    for (int i = 0; i < N3; ++i)
      acc3[i][0] = acc3[i][1] = acc3[i][2] = acc3[i][3] = 0.f;

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int r0 = tile * TM;
      if (k0 == 0 && d_vo != nullptr)  // the first pass also writes d_vo
        load_rows<DP, true>(s_vi, vi + (size_t)r0 * D, min(TM, P - r0),
                                 TM, D, D, vec_vi, g_pos + r0,
                                 d_vo + (size_t)r0 * D);
      else
        load_rows<DP, false>(s_vi, vi + (size_t)r0 * D, min(TM, P - r0),
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
          frag(a + kk, ah[0], al[0]);
          frag(a + kk + 8 * SV, ah[1], al[1]);
          frag(a + kk + 4, ah[2], al[2]);
          frag(a + kk + 8 * SV + 4, ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < N1; ++i) {
            const int n0 = (wq + 4 * i) * 8;
            if (n0 < kc_lim) {
              const E* b = s_wn + (n0 + g) * SV + kk + tig;
              uint32_t bh[2], bl[2];
              frag(b, bh[0], bl[0]);
              frag(b + 4, bh[1], bl[1]);
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
              uint32_t h0, l0, h1, l1;
              split_tf32(g0, h0, l0);
              split_tf32(g1, h1, l1);
              *reinterpret_cast<uint4*>(s_g + row * SG + col) =
                  make_uint4(h0, l0, h1, l1);
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
          frag(a + kk, ah[0], al[0]);
          frag(a + kk + 8 * SG, ah[1], al[1]);
          frag(a + kk + 4, ah[2], al[2]);
          frag(a + kk + 8 * SG + 4, ah[3], al[3]);
          const E* b = s_wn + (kk + tig) * SV + g;
#pragma unroll
          for (int i = 0; i < N2; ++i) {
            const int n0 = (wq + 4 * i) * 8;
            uint32_t bh[2], bl[2];
            frag(b + n0, bh[0], bl[0]);
            frag(b + n0 + 4 * SV, bh[1], bl[1]);
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
          frag(a, ah[0], al[0]);
          frag(a + 8, ah[1], al[1]);
          frag(a + 4 * SG, ah[2], al[2]);
          frag(a + 4 * SG + 8, ah[3], al[3]);
          const E* b = s_vi + (kk + tig) * SV + g;
#pragma unroll
          for (int i = 0; i < N3; ++i) {
            const int n0 = (wn3 + WN3 * i) * 8;
            uint32_t bh[2], bl[2];
            frag(b + n0, bh[0], bl[0]);
            frag(b + n0 + 4 * SV, bh[1], bl[1]);
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

// ---- D above SPLIT_D (any D): the split form ------------------------------
//
// The logits need all of D before the sigmoid, and d_vi and d_wn need all of
// the logits, so the three products go to two kernels with g between them:
//   sgns_logits: a block a (tile of LTM rows, chunk of LKC negatives), so
//     that the grid fills the card. It streams the tile's vi rows and the
//     chunk's wn rows over D in stages of LKS columns through a ring of
//     LSTAGES cp.async copies (the next stages' copies in flight while a
//     stage's products run), and writes g = sigmoid(logit) * mask to g's
//     scratch [rows, ldg] (zero beyond P and kB; 1.3 MB at P 2624, kB 128,
//     which stays in L2);
//   sgns_grads: a block a (column slice of GSW, row group of tiles of GTM
//     rows), GMINB blocks an SM. The slice of wn (GKB negatives at a time)
//     stays in shared memory while the block passes over its tiles, whose
//     g, vi and vo rows come through a ring of GSTAGES cp.async copies:
//     d_vi = g_pos * vo + g . wn (each half of the pass's negatives by
//     half the warps) and d_vo = g_pos * vi for the slice, and
//     the group's d_wn partial [GKB, GSW] += g^T . vi in registers over its
//     tiles, written once. Its blocks are launched as programmatic
//     dependents of sgns_logits: they copy wn and their first tiles' vi
//     and vo rows before they wait for g (griddepcontrol.wait);
//   reduce_partials sums the groups' partials (groups * kB * D floats: 8.3
//     MB at P 2624, D 768, kB 128 in 21 groups; the persistent form wrote
//     32.2 MB).
// Elements are split into TF32 parts at the fragment load, once a warp that
// reads them, by a bit-and and a subtraction (split_fast): cvt.rna.tf32
// runs at a fraction of the ALU rate and costs this form about 30% more
// time (chip_sgns_parts.py). Long sums keep their precision as in the tile
// kernel: the logits each 64 columns in accumulators of their own, d_vi
// each 64 negatives, a tile's d_wn share; each sum added into the total in
// f32. What bounds it (chip_sgns_parts.py, each kernel alone): sgns_logits
// waits on its copies (one stage in flight a block; the copies alone take
// two thirds of its time), sgns_grads on issue (d_vi's product takes three
// loads or splits an mma); the whole runs at about 4x the card's mma.sync
// floor for its 3xTF32 products (chip_mma_probe.cu). What lost there, and
// is not here: deeper rings or 128-column stages for the logits, logit
// blocks of 4 warps, 16 or 64 rows or 64 negatives, one gradient block an
// SM (rings of 3, tiles of 64 rows, slices of 128), slices of 32, passes
// of 64 negatives, other row groups, launches that wait for the kernel
// before, the shifts in the aligned instantiation, the three TF32 passes in
// accumulators apart (the gradient kernel spilled at 128 registers), vo
// read into registers, and each logit stage's columns split between the
// warp halves. wgmma, TMA multicast of the shared rows to a
// cluster's blocks and the partials' sum folded into the gradient kernel
// are untried.

constexpr int SPLIT_D = 256;    // D above this runs the split form
constexpr int LTM = 32;         // sgns_logits: rows a tile
constexpr int LKC = 32;         // negatives a block (the columns of ldg)
constexpr int LKS = 64;         // columns a stage of the ring
constexpr int LSTAGES = 2;      // stages of the ring
constexpr int LTHR = 256;       // threads a block (8 warps)
constexpr int GTM = 32;         // sgns_grads: rows a tile
constexpr int GSW = 64;         // columns a slice
constexpr int GKB = 128;        // negatives a pass over the tiles
constexpr int GSTAGES = 2;      // tiles in the ring
constexpr int GMINB = 2;        // blocks an SM
constexpr int GTHR = 256;       // threads a block (8 warps)

// x = hi + lo with hi = x's top 10 mantissa bits (a TF32 value) and lo = x
// - hi exactly; the tensor cores read the top 10 mantissa bits of lo, so
// x is kept to 2^-21 of itself (the cvt.rna split keeps 2^-22)
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the first n floats (0-4) of 16 bytes from device to shared memory
// without the registers, zeros for the rest (cp.async's zero fill)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(4 * n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows are copied in 16-byte chunks aligned in device memory, so a row whose
// first element lies sh floats past a 16-byte boundary starts sh floats
// into its shared row: element c of it is at [sh + c]. That serves a D
// that is no multiple of 4 (its rows shift by turns) and views that start
// off 16 bytes with 16-byte copies; such inputs run the kernels' SHIFTED
// instantiation, the others one with no shift in it.
__device__ __forceinline__ int row_shift(const float* row) {
  return (int)(((uintptr_t)row >> 2) & 3);
}

// A ROWS x COLS tile (row stride ST >= COLS + 4) from src (rows ld floats
// apart, src and the tile's columns a multiple of 4 floats from a row's
// start): row r where r < rmax and c < cmax, zeros elsewhere. Unless
// SHIFTED, every row lies on 16 bytes (ld % 4 == 0, src on 16 bytes) and
// takes COLS / 4 chunks; SHIFTED rows are shifted by their row_shift, and
// the chunk before a row's first element reads up to 3 floats of the row
// before it (or of its allocation before a view's start), which land
// before the row and are never read.
template <int ROWS, int COLS, int ST, int NT, bool SHIFTED>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int ld, int rmax, int cmax) {
  static_assert(COLS % 4 == 0 && ST >= COLS + 4, "tile shape");
  constexpr int G = COLS / 4 + (SHIFTED ? 1 : 0);   // chunks a row
  for (int e = threadIdx.x; e < ROWS * G; e += NT) {
    const int r = e / G, j = e - r * G;
    const float* row = src + (size_t)r * ld;
    const int sh = SHIFTED ? row_shift(row) : 0;
    if (SHIFTED && j == G - 1 && sh == 0) continue;   // the row ended
    const int n = r < rmax ? min(max(cmax + sh - 4 * j, 0), 4) : 0;
    cp_async16(dst + r * ST + 4 * j, n ? row - sh + 4 * j : src, n);
  }
}

// a fragment row's shift in a staged tile (0 unless SHIFTED)
template <bool SHIFTED>
__device__ __forceinline__ int shift_of(const float* row) {
  return SHIFTED ? row_shift(row) : 0;
}

// g [LTM rows, KC negatives] of one block: logits over all of D, then the
// sigmoid and the mask; g's rows are ldg floats apart.
template <int KC, bool SHIFTED>
__global__ void __launch_bounds__(LTHR)
sgns_logits(const float* __restrict__ vi, const float* __restrict__ wn,
            const float* __restrict__ mask, float* __restrict__ g, int P,
            int D, int kB, int ldg) {
  constexpr int SS = LKS + 4;              // row stride of a stage
  constexpr int STAGE = (LTM + KC) * SS;   // floats of a stage
  constexpr int WM = LTM / 16, WN = (LTHR / 32) / WM;  // warps along rows
  constexpr int N1 = KC / 8 / WN;          // 8-column tiles a warp
  static_assert(LTM % 16 == 0 && (LTHR / 32) % WM == 0 && N1 >= 1 &&
                KC % (8 * WN) == 0 && LKS % 64 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* ring = reinterpret_cast<float*>(sm_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, tig = lane & 3;
  const int mt = warp % WM, nq = warp / WM;
  const int r0 = blockIdx.x * LTM, k0 = blockIdx.y * KC;
  const int kc_lim = min(KC, (kB - k0 + 15) & ~15);   // columns the mma run
  const float* vi_t = vi + (size_t)r0 * D;
  const float* wn_c = wn + (size_t)k0 * D;
  const int nst = (D + LKS - 1) / LKS;
  // where this thread's fragment rows start in a stage: stages begin a
  // multiple of 4 columns into the rows, and rows 8 apart start 8 * D
  // floats apart, so one shift holds for the A rows and one for the B rows
  const int a0 = (mt * 16 + g8) * SS + tig +
                 shift_of<SHIFTED>(vi_t + (size_t)(mt * 16 + g8) * D);
  const int a1 = a0 + 8 * SS;
  const int b0 = (LTM + g8) * SS + tig +
                 shift_of<SHIFTED>(wn_c + (size_t)g8 * D);
  // let sgns_grads' blocks take their places and copy their inputs
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  auto issue = [&](int s) {
    float* st = ring + (s % LSTAGES) * STAGE;
    const int c0 = s * LKS;
    copy_tile<LTM, LKS, SS, LTHR, SHIFTED>(st, vi_t + c0, D, P - r0,
                                           D - c0);
    copy_tile<KC, LKS, SS, LTHR, SHIFTED>(st + LTM * SS, wn_c + c0, D,
                                          kB - k0, D - c0);
  };
#pragma unroll
  for (int s = 0; s < LSTAGES - 1; ++s) {
    if (s < nst) issue(s);
    cp_commit();
  }
  float lg[N1][4], sub[N1][4];
#pragma unroll
  for (int i = 0; i < N1; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) lg[i][j] = sub[i][j] = 0.f;
  for (int s = 0; s < nst; ++s) {
    cp_wait<LSTAGES - 2>();   // stage s has landed (this thread's copies)
    __syncthreads();          // ... everyone's; stage s - 1 is free again
    if (s + LSTAGES - 1 < nst) issue(s + LSTAGES - 1);
    cp_commit();              // an empty group keeps the count
    const float* st = ring + (s % LSTAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < LKS; kk += 8) {
      uint32_t ah[4], al[4];
      split_fast(st[a0 + kk], ah[0], al[0]);
      split_fast(st[a1 + kk], ah[1], al[1]);
      split_fast(st[a0 + kk + 4], ah[2], al[2]);
      split_fast(st[a1 + kk + 4], ah[3], al[3]);
#pragma unroll
      for (int i = 0; i < N1; ++i) {
        const int n0 = (nq * N1 + i) * 8;
        if (n0 < kc_lim) {
          uint32_t bh[2], bl[2];
          split_fast(st[b0 + n0 * SS + kk], bh[0], bl[0]);
          split_fast(st[b0 + n0 * SS + kk + 4], bh[1], bl[1]);
          mma_3xtf32(sub[i], ah, al, bh, bl);
        }
      }
      // each 64 columns' sum in accumulators of its own, added in f32
      // (the tensor cores' f32 accumulation loses bits over long sums)
      if (kk % 64 == 56) {
#pragma unroll
        for (int i = 0; i < N1; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lg[i][j] += sub[i][j];
            sub[i][j] = 0.f;
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N1; ++i) {
    const int n0 = (nq * N1 + i) * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = r0 + mt * 16 + g8 + 8 * h, col = n0 + 2 * tig;
      const bool on = p < P && n0 < kc_lim;
      const float mk = on ? mask[p] : 0.f;
      const float g0 = (on && k0 + col < kB)
          ? (1.f / (1.f + expf(-lg[i][2 * h]))) * mk : 0.f;
      const float g1 = (on && k0 + col + 1 < kB)
          ? (1.f / (1.f + expf(-lg[i][2 * h + 1]))) * mk : 0.f;
      *reinterpret_cast<float2*>(g + (size_t)p * ldg + k0 + col) =
          make_float2(g0, g1);
    }
  }
}

// d_vi and d_vo of a column slice over a group of `tpg` tiles of GTM rows,
// and the group's d_wn partial of the slice; KB negatives a pass over the
// tiles (with more, d_vi accumulates through device memory between passes:
// each thread adds to the elements it wrote itself, a fixed order).
template <int SW, int KB, bool SHIFTED>
__global__ void __launch_bounds__(GTHR, GMINB)
sgns_grads(const float* __restrict__ vi, const float* __restrict__ vo,
           const float* __restrict__ wn, const float* __restrict__ g_pos,
           const float* __restrict__ g, float* __restrict__ d_vi,
           float* __restrict__ d_vo, float* __restrict__ part, int P, int D,
           int kB, int ldg, int tpg) {
  constexpr int SV = SW + 4, SG = KB + 4;   // row strides: slices, g
  constexpr int TILE = GTM * (SG + 2 * SV); // a tile's buffer: g, vi, vo
  constexpr int WM2 = GTM / 16, WN2 = 4 / WM2;  // d_vi: a half's warps
  constexpr int N2 = SW / 8 / WN2;          // d_vi: 8-column tiles a warp
  constexpr int WM3 = KB / 32, WN3 = 8 / WM3;  // d_wn: warps along KB, SW
  constexpr int N3 = SW / 8 / WN3;          // d_wn: 8-column tiles a warp
  static_assert(SW % 32 == 0 && KB % 64 == 0 && KB <= 128 && N3 >= 1 &&
                N2 >= 1 && GTM % 16 == 0 && 4 % WM2 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* s_wn = reinterpret_cast<float*>(sm_raw);   // [KB, SV]
  float* ring = s_wn + KB * SV;                     // GSTAGES tiles
  float* xch = ring + GSTAGES * TILE;               // [GTM * SW] d_vi sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, tig = lane & 3;
  // d_vi: the half of the pass's negatives, rows, column group
  const int kh = warp >> 2, mt = warp % WM2, nh = (warp & 3) / WM2;
  const int m3 = (warp % WM3) * 32, wn3 = warp / WM3;  // d_wn
  const int c0 = blockIdx.x * SW, cw = min(SW, D - c0);
  const int ntiles = (P + GTM - 1) / GTM;
  const int t0 = blockIdx.y * tpg, nt = max(0, min(tpg, ntiles - t0));
  const bool vec_vo = D % 4 == 0 && (uintptr_t)d_vo % 16 == 0;
  const bool pair = D % 2 == 0 && (uintptr_t)d_vi % 8 == 0 &&
                    (uintptr_t)part % 8 == 0;
  float* my_part = part + (size_t)blockIdx.y * kB * D;
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // a tile's inputs; g only after sgns_logits has ended
  auto issue_rows = [&](int i, int k0) {
    float* b = ring + (i % GSTAGES) * TILE + GTM * SG;
    const int r0 = (t0 + i) * GTM;
    const size_t o = (size_t)r0 * D + c0;
    copy_tile<GTM, SW, SV, GTHR, SHIFTED>(b, vi + o, D, P - r0, cw);
    if (k0 == 0)
      copy_tile<GTM, SW, SV, GTHR, SHIFTED>(b + GTM * SV, vo + o, D, P - r0,
                                            cw);
  };
  auto issue_g = [&](int i, int k0) {
    const int r0 = (t0 + i) * GTM;
    copy_tile<GTM, KB, SG, GTHR, false>(ring + (i % GSTAGES) * TILE,
                                        g + (size_t)r0 * ldg + k0, ldg,
                                        P - r0, ldg - k0);
  };

  for (int k0 = 0; k0 < kB; k0 += KB) {
    const int kc_lim = min(KB, (kB - k0 + 15) & ~15);
    const float* wn_s = wn + (size_t)k0 * D + c0;
    copy_tile<KB, SW, SV, GTHR, SHIFTED>(s_wn, wn_s, D, kB - k0, cw);
    // the shift of this thread's wn rows (kk + tig, kk + tig + 4: rows 4
    // apart start 4 * D floats apart, the same modulo 4)
    const int sh_wn = shift_of<SHIFTED>(wn_s + (size_t)tig * D);
    if (k0 == 0) {
      // vi and vo are the caller's: copy them before g is ready
#pragma unroll
      for (int j = 0; j < GSTAGES - 1; ++j)
        if (j < nt) issue_rows(j, k0);
      asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
      for (int j = 0; j < GSTAGES - 1; ++j) {
        if (j < nt) issue_g(j, k0);
        cp_commit();
      }
    } else {
#pragma unroll
      for (int j = 0; j < GSTAGES - 1; ++j) {
        if (j < nt) {
          issue_rows(j, k0);
          issue_g(j, k0);
        }
        cp_commit();
      }
    }
    float acc3[2][N3][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < N3; ++i)
        acc3[j][i][0] = acc3[j][i][1] = acc3[j][i][2] = acc3[j][i][3] = 0.f;

    for (int i = 0; i < nt; ++i) {
      cp_wait<GSTAGES - 2>();   // tile i has landed (this thread's copies)
      __syncthreads();          // ... everyone's; tile i - 1's buffer is free
      if (i + GSTAGES - 1 < nt) {
        issue_rows(i + GSTAGES - 1, k0);
        issue_g(i + GSTAGES - 1, k0);
      }
      cp_commit();
      const float* sg = ring + (i % GSTAGES) * TILE;
      const float* svi = sg + GTM * SG;
      const float* svo = svi + GTM * SV;
      const int r0 = (t0 + i) * GTM;
      const float* vi_t = vi + (size_t)r0 * D + c0;   // row_shift's rows
      const float* vo_t = vo + (size_t)r0 * D + c0;
      // the shifts of this thread's rows: vi's kk + tig and kk + tig + 4,
      // vo's mt * 16 + g8 and 8 below it (rows 4 apart start 4 * D floats
      // apart: the same modulo 4)
      const int sh_vi = shift_of<SHIFTED>(vi_t + (size_t)tig * D);
      const int sh_vo =
          shift_of<SHIFTED>(vo_t + (size_t)(mt * 16 + g8) * D);

      if (d_vo != nullptr && k0 == 0) {     // d_vo = g_pos * vi
        constexpr int G = SW / 4;
        for (int e = tid; e < GTM * G; e += GTHR) {
          const int r = e / G, c = (e - r * G) * 4, p = r0 + r;
          if (p < P && c < cw) {
            const float gp = g_pos[p];
            const float* x =
                svi + r * SV + shift_of<SHIFTED>(vi_t + (size_t)r * D) + c;
            float* o = d_vo + (size_t)p * D + c0 + c;
            if (vec_vo) {                   // D % 4 == 0: c + 3 < cw
              *reinterpret_cast<float4*>(o) =
                  make_float4(gp * x[0], gp * x[1], gp * x[2], gp * x[3]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (c + q < cw) o[q] = gp * x[q];
            }
          }
        }
      }

      // d_vi [GTM, SW] = g . wn over the pass's negatives: warps 0-3 sum
      // negatives 0-63, warps 4-7 64-127, each warp GTM / WM2 rows by
      // N2 8-column tiles in accumulators of its own; 4-7 hand their sums
      // over through shared memory and 0-3 add them, the order in which
      // one warp would sum the two halves
      {
        float acc[N2][4];
#pragma unroll
        for (int q = 0; q < N2; ++q)
          acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
        const float* a = sg + (mt * 16 + g8) * SG + tig;
        for (int kk = kh * 64; kk < min(kc_lim, kh * 64 + 64); kk += 8) {
          uint32_t ah[4], al[4];
          split_fast(a[kk], ah[0], al[0]);
          split_fast(a[kk + 8 * SG], ah[1], al[1]);
          split_fast(a[kk + 4], ah[2], al[2]);
          split_fast(a[kk + 8 * SG + 4], ah[3], al[3]);
          const float* b = s_wn + (kk + tig) * SV + sh_wn + g8;
#pragma unroll
          for (int q = 0; q < N2; ++q) {
            const int n0 = (nh * N2 + q) * 8;
            uint32_t bh[2], bl[2];
            split_fast(b[n0], bh[0], bl[0]);
            split_fast(b[n0 + 4 * SV], bh[1], bl[1]);
            mma_3xtf32(acc[q], ah, al, bh, bl);
          }
        }
        float* x4 = xch + (warp & 3) * (N2 * 4 * 32) + lane;
        if (kh == 1) {
#pragma unroll
          for (int q = 0; q < N2; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) x4[(q * 4 + j) * 32] = acc[q][j];
        }
        __syncthreads();
        if (kh == 0) {
          if (kc_lim > 64) {
#pragma unroll
            for (int q = 0; q < N2; ++q)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[q][j] += x4[(q * 4 + j) * 32];
          }
#pragma unroll
          for (int q = 0; q < N2; ++q) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = mt * 16 + g8 + 8 * h, p = r0 + row;
              const int d = (nh * N2 + q) * 8 + 2 * tig;
              if (p >= P || d >= cw) continue;
              const float* x = svo + row * SV + sh_vo;
              const size_t o = (size_t)p * D + c0 + d;
              const float gp = k0 == 0 ? g_pos[p] : 1.f;
              if (pair) {                   // D even: d + 1 < cw too
                const float2 base = k0 == 0
                    ? make_float2(x[d], x[d + 1])
                    : *reinterpret_cast<const float2*>(d_vi + o);
                *reinterpret_cast<float2*>(d_vi + o) =
                    make_float2(gp * base.x + acc[q][2 * h],
                                gp * base.y + acc[q][2 * h + 1]);
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (d + e < cw) {
                    const float base =
                        k0 == 0 ? gp * x[d + e] : d_vi[o + e];
                    d_vi[o + e] = base + acc[q][2 * h + e];
                  }
                }
              }
            }
          }
        }
      }

      // the tile's d_wn share [KB, SW] = g^T . vi, added into the group's
      if (m3 < kc_lim) {
        float t3[2][N3][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < N3; ++q)
            t3[j][q][0] = t3[j][q][1] = t3[j][q][2] = t3[j][q][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < GTM; kk += 8) {
          uint32_t bh[N3][2], bl[N3][2];
          const float* b = svi + (kk + tig) * SV + sh_vi + g8;
#pragma unroll
          for (int q = 0; q < N3; ++q) {
            const int n0 = (wn3 + WN3 * q) * 8;
            split_fast(b[n0], bh[q][0], bl[q][0]);
            split_fast(b[n0 + 4 * SV], bh[q][1], bl[q][1]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (m3 + 16 * j < kc_lim) {
              const float* a = sg + (kk + tig) * SG + m3 + 16 * j + g8;
              uint32_t ah[4], al[4];
              split_fast(a[0], ah[0], al[0]);
              split_fast(a[8], ah[1], al[1]);
              split_fast(a[4 * SG], ah[2], al[2]);
              split_fast(a[4 * SG + 8], ah[3], al[3]);
#pragma unroll
              for (int q = 0; q < N3; ++q)
                mma_3xtf32(t3[j][q], ah, al, bh[q], bl[q]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < N3; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc3[j][q][e] += t3[j][q][e];
      }
    }

    // the group's partial of the pass, once
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int q = 0; q < N3; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kb = k0 + m3 + 16 * j + g8 + 8 * h;
          const int d = (wn3 + WN3 * q) * 8 + 2 * tig;
          if (kb < kB && d < cw) {
            float* dst = my_part + (size_t)kb * D + c0 + d;
            if (pair) {
              *reinterpret_cast<float2*>(dst) =
                  make_float2(acc3[j][q][2 * h], acc3[j][q][2 * h + 1]);
            } else {
              dst[0] = acc3[j][q][2 * h];
              if (d + 1 < cw) dst[1] = acc3[j][q][2 * h + 1];
            }
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // s_wn and the ring are the next pass's
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

template <int DP, int KC>
cudaError_t launch_tiles(const float* vi, const float* vo, const float* wn,
                         const float* g_pos, const float* mask, float* d_vi,
                         float* d_vo, float* part, int P, int D, int kB,
                         int nblk, cudaStream_t s) {
  constexpr size_t smem = sizeof(float2) *
                          ((size_t)(TM + KC) * (DP + 4) + TM * (KC + 4));
  static bool raised = false;   // the limit is set once for each width
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_shared_kernel<DP, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  sgns_shared_kernel<DP, KC><<<nblk, NTHR, smem, s>>>(
      vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB);
  return cudaSuccess;
}

// programmatic dependent launch: the launch overlaps the grid before it in
// the stream, whose end the kernel waits for (griddepcontrol.wait)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t s,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the split form: sgns_logits, then sgns_grads over `groups` row groups;
// SHIFTED where a row of vi, vo or wn may start off 16 bytes
template <bool SHIFTED>
cudaError_t launch_split(const float* vi, const float* vo, const float* wn,
                         const float* g_pos, const float* mask, float* d_vi,
                         float* d_vo, float* part, float* g, int P, int D,
                         int kB, int groups, cudaStream_t s) {
  constexpr size_t smem_l = sizeof(float) * LSTAGES * (LTM + LKC) * (LKS + 4);
  constexpr size_t smem_g =
      sizeof(float) * ((size_t)GKB * (GSW + 4) +
                       GSTAGES * GTM * ((GKB + 4) + 2 * (GSW + 4)) + GTM * GSW);
  static bool raised = false;   // the limits are set once for each form
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_logits<LKC, SHIFTED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_l);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          sgns_grads<GSW, GKB, SHIFTED>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_g);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int ldg = (kB + LKC - 1) / LKC * LKC;
  const int ntiles = (P + GTM - 1) / GTM;
  sgns_logits<LKC, SHIFTED>
      <<<dim3((P + LTM - 1) / LTM, (kB + LKC - 1) / LKC), LTHR, smem_l, s>>>(
          vi, wn, mask, g, P, D, kB, ldg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dependent(sgns_grads<GSW, GKB, SHIFTED>,
                          dim3((D + GSW - 1) / GSW, groups), dim3(GTHR),
                          smem_g, s, vi, vo, wn, g_pos, (const float*)g, d_vi,
                          d_vo, part, P, D, kB, ldg,
                          (ntiles + groups - 1) / groups);
}

}  // namespace

// The widths (DP, KC) and the split form above SPLIT_D mirror
// ops/sgns.py::launch_plan (WIDTHS, SPLIT_D). nblk is the number of d_wn
// partials: the tiles' kernel's persistent blocks, or the split form's row
// groups; g is the split form's scratch (ceil(P / LTM) * LTM rows of kB
// rounded up to LKC floats), refused when null above SPLIT_D. d_vo may be
// null: it is then not written.
extern "C" int srw_sgns_shared_launch(const float* vi, const float* vo,
                                      const float* wn, const float* g_pos,
                                      const float* mask, float* d_vi,
                                      float* d_vo, float* d_wn, float* part,
                                      float* g, int P, int D, int kB,
                                      int nblk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D > SPLIT_D && g == nullptr) return (int)cudaErrorInvalidValue;
  if (nblk > 0 && kB > 0 && D > 0) {
    cudaError_t err;
    if (D > SPLIT_D && D % 4 == 0 && (uintptr_t)vi % 16 == 0 &&
        (uintptr_t)vo % 16 == 0 && (uintptr_t)wn % 16 == 0)
      err = launch_split<false>(vi, vo, wn, g_pos, mask, d_vi, d_vo, part, g,
                                P, D, kB, nblk, s);
    else if (D > SPLIT_D)
      err = launch_split<true>(vi, vo, wn, g_pos, mask, d_vi, d_vo, part, g,
                               P, D, kB, nblk, s);
    else if (D <= 64)
      err = launch_tiles<64, 128>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    else if (D <= 128)
      err = launch_tiles<128, 128>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    else
      err = launch_tiles<256, 64>(
          vi, vo, wn, g_pos, mask, d_vi, d_vo, part, P, D, kB, nblk, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int n = kB * D;
  if (n > 0) {
    // launched while the kernel before it runs
    cudaError_t err = launch_dependent(
        reduce_partials, dim3((n + 31) / 32), dim3(32, RS), 0, s,
        (const float*)part, d_wn, nblk, n);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
