// One node2vec trial as __device__ code, shared by walk.cu's walk_kernel
// (whole walks, a flat loop over (step, trial)) and shard_walk.cu's
// shard_serve (one step of a request on its owner shard), so that both
// compile the same text and draw the same bits.
//
// Semantics (ops/walk_step.py): trial j of a second-order step reads, for
// lane w, elements (w, Wd+w, 2Wd+w) of uniform(k, (3, Wd)) for j <
// kDenseTrials, else uniform(fold_in(k, w), (3,)), with k the trial's key
// of the key table; the candidate is an alias draw of cur's row, accepted
// iff u_acc * max_f < f(cand), f = 1/p for cand == prev, 1 for cand in
// N(prev), 1/q otherwise. The first accepting trial wins, else the last.
// Roundings follow XLA exactly (see walk.cu's note). Build without
// --use_fast_math.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace srw {

constexpr int kDenseTrials = 2;  // trials read from the (3, Wd) array draw

// trial modes: 0 general; 1 q == 1 (no membership read); 2 p == q == 1
// (trial 0 always accepts)
constexpr int kModePQ1 = 2;
constexpr int kModeQ1 = 1;

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

// The first-order step of lane w from vmeta row vm under step 0's trial 0
// key k: an alias draw on the dense draws.
__device__ __forceinline__ int first_order(const int4* __restrict__ alias_packed,
                                           int4 vm, int E, uint2 k,
                                           uint32_t w, int Wd) {
  return alias_draw(alias_packed, vm.x, vm.y, E, uniform_at(k, w),
                    uniform_at(k, Wd + w));
}

// Trial j of a second-order step of lane w under the trial's key k: cur's
// vmeta row cm, prev's pm, prev's id. Returns the candidate; `accept` says
// whether it is taken.
__device__ __forceinline__ int trial(const int4* __restrict__ alias_packed,
                                     const int4* __restrict__ buckets,
                                     uint2 k, int j, uint32_t w, int Wd,
                                     int4 cm, int4 pm, int prev, int E,
                                     float inv_p, float inv_q, float max_f,
                                     int mode, bool& accept) {
  uint32_t i_pos = w, i_keep = Wd + w, i_acc = 2 * Wd + w;
  if (j >= kDenseTrials) {
    // per-lane key fold_in(k, w), then uniform(., (3,))
    k = threefry(k.x, k.y, 0u, w);
    i_pos = 0u; i_keep = 1u; i_acc = 2u;
  }
  const int cand = alias_draw(alias_packed, cm.x, cm.y, E,
                              uniform_at(k, i_pos), uniform_at(k, i_keep));
  accept = true;
  if (mode != kModePQ1) {
    float f;
    if (cand == prev) f = inv_p;
    else if (mode == kModeQ1) f = 1.0f;
    else f = is_member(buckets, pm.z, pm.w, cand) ? 1.0f : inv_q;
    // u_acc is drawn only where it can decide: with f >= max_f the accept
    // is certain (walk.cu's note)
    if (f < max_f) accept = __fmul_rn(uniform_at(k, i_acc), max_f) < f;
  }
  return cand;
}

// One whole second-order step: trials 0 .. T-1 under the step's keys kt,
// the first accepted candidate, else the last trial's.
__device__ __forceinline__ int second_order(const int4* __restrict__ alias_packed,
                                            const int4* __restrict__ buckets,
                                            const uint2* __restrict__ kt,
                                            int T, uint32_t w, int Wd,
                                            int4 cm, int4 pm, int prev, int E,
                                            float inv_p, float inv_q,
                                            float max_f, int mode) {
  int cand = -1;
  for (int j = 0; j < T; ++j) {
    bool accept;
    cand = trial(alias_packed, buckets, kt[j], j, w, Wd, cm, pm, prev, E,
                 inv_p, inv_q, max_f, mode, accept);
    if (accept) break;
  }
  return cand;
}

// Launch `kernel` as a programmatic dependent of the grid before it in the
// stream: its blocks may be scheduled while that grid runs, and the kernel
// waits for it (griddepcontrol.wait) before its first read or write.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace srw
