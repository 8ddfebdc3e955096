// Whole node2vec walks, one walker per thread (sm_90a).
//
// Replaces the walk step of the JAX package, which XLA lowers there:
// stellar_rw_tpu/walk/engine.py::walk_corpus (vmeta branch) with
// ops/sampling.py::alias_draw, _make_trial and rejection_sample_static, and
// the threefry streams of ops/prng.py / round_uniforms_batched /
// tail_uniforms_batched. The result is bit for bit the JAX corpus: the
// first accepting trial among 0 .. T-1 wins, else the last trial's
// candidate. The static cascade the JAX package runs is an execution plan
// for a vector machine; a per-thread loop runs the same schedule directly
// and has no compaction buffer that could overflow.
//
// What bounds it on this card: dependent random 16-byte row reads (vmeta
// of cur, the alias row, prev's membership bucket) at every step, and
// threefry integer work (3-4 blocks of 20 rounds per trial). The design
// keeps every read one aligned int4 row, carries prev's vmeta row in
// registers instead of reading it again, keeps the walk state in registers
// for all L steps, and stores the corpus transposed ([L+2, N]) so that the
// stores of a warp coalesce.
//
// Roundings follow XLA exactly: u_pos * f32(deg) and u_acc * max_f are
// single f32 multiplies (__fmul_rn, so no FMA contraction), the cast to int
// truncates toward zero, and 1/p, 1/q, max_f arrive as f32 from the host.
// Build without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

using srw::threefry;
using srw::uniform_at;

// Weight-proportional neighbor of a row (start, deg) by its alias row.
__device__ __forceinline__ int alias_draw(const int4* __restrict__ alias_packed,
                                          int start, int deg, int E,
                                          float u_pos, float u_keep) {
  int j = (int)__fmul_rn(u_pos, (float)deg);
  j = min(j, max(deg - 1, 0));
  const int k = min(max(start + j, 0), E - 1);
  const int4 r = alias_packed[k];
  return u_keep < __int_as_float(r.x) ? r.y : r.z;
}

// cand in N(prev): a key's only home is bucket hash(cand) & mask of prev's
// bucket range.
__device__ __forceinline__ bool is_member(const int4* __restrict__ buckets,
                                          int base, int mask, int cand) {
  const int h = (int)((uint32_t)cand * 2654435761u);
  const int4 b = buckets[base + (h & mask)];
  return b.x == cand || b.y == cand || b.z == cand || b.w == cand;
}

constexpr int kDenseTrials = 2;  // trials read from the (3, Wd) array draw
constexpr int kBlock = 128;

// mode: 0 general; 1 q == 1 (no membership read); 2 p == q == 1 (trial 0
// always accepts).
__global__ void __launch_bounds__(kBlock)
walk_kernel(const int* __restrict__ starts, const int4* __restrict__ vmeta,
            const int4* __restrict__ alias_packed,
            const int4* __restrict__ buckets, const uint2* __restrict__ keys,
            int* __restrict__ out, int W, int N, int L, int T, int Wd, int E,
            float inv_p, float inv_q, float max_f, int mode) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const int r = row / W;
  const uint32_t w = (uint32_t)(row - r * W);
  const uint2* rkeys = keys + (size_t)r * (L + 1) * T;   // [L+1, T]
  const int s = starts[w];
  out[row] = s;
  int c = 1;
  const int4 vm0 = vmeta[s];
  if (vm0.y > 0) {
    // first-order step: step key t = 0, trial 0
    int cur = alias_draw(alias_packed, vm0.x, vm0.y, E,
                         uniform_at(rkeys[0], w), uniform_at(rkeys[0], Wd + w));
    out[(size_t)N + row] = cur;
    c = 2;
    int prev = s;
    int4 pm = vm0;
    for (int t = 1; t <= L; ++t) {
      const int4 cm = vmeta[cur];
      if (cm.y <= 0) break;  // dead end: -1 from here on
      const uint2* kt = rkeys + (size_t)t * T;
      const int ntrials = mode == 2 ? 1 : T;
      // dst ends as the first accepted candidate, else the last trial's
      int dst = 0;
      for (int j = 0; j < ntrials; ++j) {
        const uint2 kj = kt[j];
        float u_pos, u_keep, u_acc;
        if (j < kDenseTrials) {
          u_pos = uniform_at(kj, w);
          u_keep = uniform_at(kj, Wd + w);
          u_acc = uniform_at(kj, 2 * Wd + w);
        } else {
          // per-lane key fold_in(kj, w), then uniform(., (3,))
          const uint2 kw = threefry(kj.x, kj.y, 0u, w);
          u_pos = uniform_at(kw, 0u);
          u_keep = uniform_at(kw, 1u);
          u_acc = uniform_at(kw, 2u);
        }
        const int cand = alias_draw(alias_packed, cm.x, cm.y, E, u_pos,
                                    u_keep);
        dst = cand;
        if (mode == 2) break;
        float f;
        if (cand == prev) f = inv_p;
        else if (mode == 1) f = 1.0f;
        else f = is_member(buckets, pm.z, pm.w, cand) ? 1.0f : inv_q;
        if (__fmul_rn(u_acc, max_f) < f) break;
      }
      out[(size_t)(t + 1) * N + row] = dst;
      prev = cur;
      cur = dst;
      pm = cm;
      c = t + 2;
    }
  }
  for (; c < L + 2; ++c) out[(size_t)c * N + row] = -1;
}

}  // namespace

extern "C" int srw_walk_launch(const int* starts, const int* vmeta,
                               const int* alias_packed, const int* buckets,
                               const unsigned* keys, int* out, int W, int N,
                               int L, int T, int Wd, int E, float inv_p,
                               float inv_q, float max_f, int mode,
                               void* stream) {
  if (N > 0) {
    walk_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0,
                  (cudaStream_t)stream>>>(
        starts, reinterpret_cast<const int4*>(vmeta),
        reinterpret_cast<const int4*>(alias_packed),
        reinterpret_cast<const int4*>(buckets),
        reinterpret_cast<const uint2*>(keys), out, W, N, L, T, Wd, E, inv_p,
        inv_q, max_f, mode);
  }
  return (int)cudaGetLastError();
}
