// Whole node2vec walks, one walker per thread (sm_90a), and the trial-key
// table they read.
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
// What bounds it on this card: int32 issue. A trial is two or three
// threefry blocks of 20 rounds (some 85 integer operations each) around
// two dependent 16-byte row reads (the alias row, prev's membership
// bucket); the tables of the graphs run so far sit in the L2. What the
// design does about it:
//   * one flat loop over (step, trial) for each thread: a loop turn runs
//     one trial of the thread's own current step, and on accept (or at the
//     last trial) the thread stores the column and moves to its next step
//     in the same turn. Every uniform is a pure function of (key, index),
//     so the order in which a thread runs its trials is free. A warp then
//     runs as many turns as its slowest lane's trials over the whole walk,
//     not the sum over steps of the warp's slowest lane at each step;
//   * the dense (trials 0, 1) and per-lane (later trials) draws differ only
//     in key and counters, so lanes at different trials run the draws
//     together; only the per-lane key's extra block sits in a branch;
//   * u_acc is drawn only where it can decide. With f >= max_f the accept
//     is certain: uniform_at gives u <= 1 - 2^-23, so the exact product
//     u * max_f <= max_f - max_f * 2^-23 <= max_f - ulp(max_f), which is
//     representable and below max_f, and rounding to nearest cannot pass
//     a representable value: __fmul_rn(u, max_f) < max_f <= f. The values
//     are compared, not the branches (max_f is an f64 maximum rounded once,
//     1/p and 1/q are f32 quotients);
//   * every table read is one aligned int4 row, prev's vmeta row stays in
//     registers, the walk state stays in registers for all L steps, and the
//     corpus is stored transposed ([L+2, N]) so that a warp's stores
//     coalesce where its lanes are at the same step;
//   * the key of trial j of step t in round r, fold_in(fold_in(fold_in(key,
//     round_offset + r), t), j), is the same for every walker, so a second
//     kernel builds the [R, L+1, T] table on the card (below). The walk
//     kernel is an ordinary launch after it: as the table's programmatic
//     dependent, table + walk took 0.9-1.4% longer at walk_10k on an H100
//     (chip_compare.py's launch forms).
//
// The trial itself (alias_draw, is_member, the dense and per-lane draws)
// lives in walk_trial.cuh, which K11's serve half (shard_walk.cu) compiles
// too.
//
// Roundings follow XLA exactly: u_pos * f32(deg) and u_acc * max_f are
// single f32 multiplies (__fmul_rn, so no FMA contraction), the cast to int
// truncates toward zero, and 1/p, 1/q, max_f arrive as f32 from the host.
// Build without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"
#include "walk_trial.cuh"

namespace {

using srw::threefry;

constexpr int kBlock = 128;      // threads a block
constexpr int kKeyThreads = 256; // threads a block of the key table

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
  int c = 1;  // columns written so far
  const int4 vm0 = vmeta[s];
  if (vm0.y > 0) {
    // first-order step: step key t = 0, trial 0
    int cur = srw::first_order(alias_packed, vm0, E, rkeys[0], w, Wd);
    out[(size_t)N + row] = cur;
    c = 2;
    int prev = s;
    int4 pm = vm0;           // prev's vmeta row
    int4 cm = vmeta[cur];    // cur's; deg <= 0 is a dead end: -1 from here on
    int t = 1, j = 0;
    bool live = L >= 1 && cm.y > 0;
    while (live) {
      // one trial: trial j of step t
      bool accept;
      const int cand = srw::trial(alias_packed, buckets,
                                  rkeys[(size_t)t * T + j], j, w, Wd, cm, pm,
                                  prev, E, inv_p, inv_q, max_f, mode, accept);
      if (accept || j == T - 1) {
        // the step's result: the first accepted candidate, else the last
        out[(size_t)(t + 1) * N + row] = cand;
        c = t + 2;
        prev = cur;
        cur = cand;
        pm = cm;
        ++t;
        j = 0;
        if (t > L) {
          live = false;
        } else {
          cm = vmeta[cur];
          live = cm.y > 0;
        }
      } else {
        ++j;
      }
    }
  }
  for (; c < L + 2; ++c) out[(size_t)c * N + row] = -1;
}

// keys[r, t, j] = fold_in(fold_in(fold_in((k0, k1), round_offset + r), t), j)
//
// A warp a (round, step): its round key and step key are derived once for
// the T keys below them (every lane derives them, which costs the warp the
// same instructions as one lane would, and needs no shuffle), then lane l
// makes trials l, l + 32, ... So the table takes R * (L+1) * (2 + T)
// threefry blocks, not 3 a key. It releases a programmatic dependent (K11's
// first serve on the sharded path) at once: that grid's blocks are
// scheduled while this one runs and wait for it before they read a key. At
// the main path's size the table is bound by the launch, not by its
// operations.
__global__ void __launch_bounds__(kKeyThreads)
trial_keys_kernel(uint2* __restrict__ keys, uint32_t k0, uint32_t k1,
                  uint32_t round_offset, int R, int L1, int T) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (warp >= R * L1) return;
  const int r = warp / L1;
  const int t = warp - r * L1;
  const uint2 rk = threefry(k0, k1, 0u, round_offset + (uint32_t)r);
  const uint2 sk = threefry(rk.x, rk.y, 0u, (uint32_t)t);
  uint2* out = keys + (size_t)warp * T;
  for (int j = lane; j < T; j += 32)
    out[j] = threefry(sk.x, sk.y, 0u, (uint32_t)j);
}

}  // namespace

extern "C" int srw_walk_launch(const int* starts, const int* vmeta,
                               const int* alias_packed, const int* buckets,
                               const unsigned* keys, int* out, int W, int N,
                               int L, int T, int Wd, int E, float inv_p,
                               float inv_q, float max_f, int mode,
                               void* stream) {
  if (N > 0) {
    walk_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
        starts, reinterpret_cast<const int4*>(vmeta),
        reinterpret_cast<const int4*>(alias_packed),
        reinterpret_cast<const int4*>(buckets),
        reinterpret_cast<const uint2*>(keys), out, W, N, L, T, Wd, E, inv_p,
        inv_q, max_f, mode);
  }
  return (int)cudaGetLastError();
}

extern "C" int srw_trial_keys_launch(unsigned* keys, unsigned k0, unsigned k1,
                                     unsigned round_offset, int R, int L1,
                                     int T, void* stream) {
  const long long threads = 32LL * R * L1;
  if (threads > 0 && T > 0) {
    trial_keys_kernel<<<(unsigned)((threads + kKeyThreads - 1) / kKeyThreads),
                        kKeyThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<uint2*>(keys), k0, k1, round_offset, R, L1, T);
  }
  return (int)cudaGetLastError();
}
