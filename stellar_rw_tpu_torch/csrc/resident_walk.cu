// Whole second-order walks over a resident row table, one walker per thread
// (sm_90a).
//
// Replaces the Pallas kernel of the JAX package,
// stellar_rw_tpu/ops/pallas/walk.py::walk_corpus_vmem -> _walk_kernel: every
// vertex's whole row (degree, neighbour ids, alias partner ids, alias
// keep-probabilities) stays on chip and each step's trials read nothing
// else. The TPU kernel can fetch a row only by a one-hot matmul and selects
// fields with lane masks; here a row is an indexed read, so those are gone,
// and prev is carried as an id, not as a row.
//
// Row r of the table is 1 + 3*md 32-bit words:
//   [deg | md neighbour ids | md alias partner ids | md keep-probabilities]
// ids as i32 (-1 in padded slots), probabilities as f32 bits.
//
// kShared = true: each block first copies the whole table into dynamic shared
// memory (up to 232,448 bytes), and every later read is shared memory.
// kShared = false: rows are read in place from device memory, where a table
// of this kernel's regime sits in the L2. The wrapper picks by the table's
// size.
//
// What bounds it on this card: not bytes (the table is read once, the corpus
// written once) but each thread's dependent chain: per trial three threefry
// blocks and three row reads at the drawn slot, then a membership scan of
// prev's neighbour ids. The design keeps all L steps in one launch with the
// walk state in registers, makes a trial's three draws together so that
// their chains overlap, stops a thread's trials at its first accept (draws
// are indexed, so skipping the rest shifts nothing), skips the scan where it
// cannot change the bias, and stores the corpus transposed ([L+2, W_pad]) so
// that a warp's stores coalesce.
//
// Draws: the uniform for (draw row r, component c, walker w) is element
// (r*3 + c)*W_pad + w of jax.random.uniform(key, (1 + L*T, 3, W_pad)), or of
// the external array when one is given. Trial j of step t reads draw row
// 1 + t*T + j; the first-order step reads row 0.
//
// Roundings follow the reference: u_pos * f32(deg) and u_acc * max_f are
// single f32 multiplies (__fmul_rn, no FMA contraction), the cast truncates,
// and 1/p, 1/q, max_f arrive as f32 from the host. Build without
// --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kBlock = 128;

struct Draws {
  uint2 key;
  const float* ext;   // external uniforms or nullptr
  uint32_t w_pad;
  uint32_t gid;
  // The three uniforms of draw row `row`. One branch around all three, so
  // that the three threefry chains are straight-line code and overlap.
  __device__ __forceinline__ void row3(int row, float& a, float& b,
                                       float& c) const {
    const uint32_t i0 = (uint32_t)row * 3u * w_pad + gid;
    const uint32_t i1 = i0 + w_pad, i2 = i1 + w_pad;
    if (ext != nullptr) {
      a = ext[i0]; b = ext[i1]; c = ext[i2];
    } else {
      a = srw::uniform_at(key, i0);
      b = srw::uniform_at(key, i1);
      c = srw::uniform_at(key, i2);
    }
  }
};

// Alias draw on row `r` of degree deg > 0 -> candidate id.
__device__ __forceinline__ int sample(const int* r, int deg, int md,
                                      float u_pos, float u_keep) {
  const int j = min((int)__fmul_rn(u_pos, (float)deg), deg - 1);
  const float keep = __int_as_float(r[1 + 2 * md + j]);
  return u_keep < keep ? r[1 + j] : r[1 + md + j];
}

template <bool kShared>
__global__ void __launch_bounds__(kBlock)
resident_walk_kernel(const int* __restrict__ tab_g, int table_words,
                     int row_words, int md, int V, int W_real, int W_pad,
                     int L, int T, uint2 key, const float* __restrict__ ext,
                     float inv_p, float inv_q, float max_f,
                     int* __restrict__ out) {
  extern __shared__ int tab_s[];
  const int* tab = tab_g;
  if (kShared) {
    // unrolled so that each thread keeps 8 loads in flight
#pragma unroll 8
    for (int i = threadIdx.x; i < table_words; i += blockDim.x)
      tab_s[i] = tab_g[i];
    __syncthreads();
    tab = tab_s;
  }
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= W_pad) return;
  int c = 0;   // columns written so far
  if (gid < W_real) {
    const Draws u{key, ext, (uint32_t)W_pad, (uint32_t)gid};
    const int start = gid % V;
    out[gid] = start;
    c = 1;
    const int* row = tab + (size_t)start * row_words;
    int deg = row[0];
    if (deg > 0) {
      int prev = start;
      float u_pos, u_keep, u_acc;   // the first-order step has no u_acc
      u.row3(0, u_pos, u_keep, u_acc);
      int cur = sample(row, deg, md, u_pos, u_keep);
      out[(size_t)W_pad + gid] = cur;
      c = 2;
      for (int t = 0; t < L; ++t) {
        row = tab + (size_t)cur * row_words;
        deg = row[0];
        if (deg <= 0) break;   // dead end: -1 from here on
        const int* prow = tab + (size_t)prev * row_words;
        const int pdeg = prow[0];
        // dst ends as the first accepted candidate, else the last trial's
        int dst = 0;
        for (int j = 0; j < T; ++j) {
          u.row3(1 + t * T + j, u_pos, u_keep, u_acc);
          const int cand = sample(row, deg, md, u_pos, u_keep);
          dst = cand;
          float f;
          if (cand == prev) {
            f = inv_p;
          } else if (inv_q == 1.0f) {
            f = 1.0f;            // member or not, the bias is 1
          } else {
            bool member = false;
#pragma unroll 8
            for (int k = 1; k <= pdeg; ++k) member |= prow[k] == cand;
            f = member ? 1.0f : inv_q;
          }
          if (__fmul_rn(u_acc, max_f) < f) break;
        }
        out[(size_t)(t + 2) * W_pad + gid] = dst;
        prev = cur;
        cur = dst;
        c = t + 3;
      }
    }
  }
  for (; c < L + 2; ++c) out[(size_t)c * W_pad + gid] = -1;
}

}  // namespace

// shared != 0: rows in shared memory (table_words * 4 bytes of dynamic shared
// memory); else rows in device memory. Returns the CUDA error code.
extern "C" int srw_resident_walk_launch(
    const int* tab, int V, int md, int W_real, int W_pad, int L, int T,
    unsigned key0, unsigned key1, const float* ext, float inv_p, float inv_q,
    float max_f, int shared, int* out, void* stream) {
  if (W_pad <= 0) return (int)cudaGetLastError();
  const int row_words = 1 + 3 * md;
  const int table_words = V * row_words;
  const int grid = (W_pad + kBlock - 1) / kBlock;
  const uint2 key = make_uint2(key0, key1);
  if (shared) {
    const size_t bytes = (size_t)table_words * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        resident_walk_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    resident_walk_kernel<true><<<grid, kBlock, bytes, (cudaStream_t)stream>>>(
        tab, table_words, row_words, md, V, W_real, W_pad, L, T, key, ext,
        inv_p, inv_q, max_f, out);
  } else {
    resident_walk_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        tab, table_words, row_words, md, V, W_real, W_pad, L, T, key, ext,
        inv_p, inv_q, max_f, out);
  }
  return (int)cudaGetLastError();
}
