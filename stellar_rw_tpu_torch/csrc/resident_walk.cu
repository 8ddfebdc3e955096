// Whole second-order walks over a resident row table, one walker per thread
// (sm_90a).
//
// Replaces the Pallas kernel of the JAX package,
// stellar_rw_tpu/ops/pallas/walk.py::walk_corpus_vmem -> _walk_kernel: every
// vertex's whole row (neighbour ids, degree, alias partner ids, alias
// keep-probabilities) stays on chip and each step's trials read nothing
// else. The TPU kernel can fetch a row only by a one-hot matmul and selects
// fields with lane masks; here a row is an indexed read, so those are gone,
// and prev is carried as an id and a degree, not as a row.
//
// Row r of the table is `stride` 32-bit words, 16-byte aligned
// (ops/resident_walk.py::row_layout):
//   [md4 neighbour ids | md pairs (keep-probability, alias partner id) | deg]
// md4 = md rounded up to 4 and at least 16, probabilities as f32 bits. An id
// word holds the id and, above it, that neighbour's own degree (-1 in padded
// slots). The ids come first so that they are read four at a time; a slot's
// keep-probability and alias partner sit together so that one 8-byte read
// brings both, and a step touches three 32-byte sectors of its row, not six.
//
// What bounds it on this card is not bytes (the table is read once, the
// corpus written once) and depends on the launch. A trial's uniforms are
// threefry blocks of 20 rounds, some 76 dependent integer instructions
// each, and a step needs two of them (u_pos, u_keep) beside a chain of row
// reads. Where warps are few (10,240 walkers are 320 warps for 528
// schedulers) the bound is one warp's latency: instructions issue in order,
// a dependent one some five clocks after the one before. Where warps are
// many it is instruction issue, two fifths of it threefry. With rows in
// device memory it is the L1's one row line a clock: a warp's 32 walkers
// stand on 32 rows, so each of a step's six reads is 32 lines. What the
// design does about it:
//   * one dependent read a step. The candidate's id word carries its
//     degree, so the next step computes its slot at once and reads the
//     slot's pair and its id; prev's first 16 ids are read a step early
//     into registers (they are cur's ids then), so membership compares
//     registers;
//   * no uniform depends on the walk's state: the uniform of (draw row,
//     component, walker) is a pure function of the key and its index. So a
//     thread makes the trial-0 u_pos and u_keep of its next kAhead steps
//     ahead of need, in straight-line code beside the row reads of the step
//     it is on (held there: left alone, the compiler sinks them below the
//     step's branches). The threefry chains overlap each other and the
//     reads' latency, and the chain a step waits on is the row reads alone;
//   * u_acc is drawn only where it can decide. With f >= max_f the accept
//     is certain: uniform_at gives u <= 1 - 2^-23, so the exact product
//     u * max_f <= max_f - ulp(max_f), which is representable and below
//     max_f, and rounding to nearest cannot pass a representable value:
//     __fmul_rn(u, max_f) < max_f <= f. The values are compared, not the
//     branches. In the last trial nothing is drawn either: its candidate is
//     the step's result, accepted or not;
//   * trials after the first and every u_acc that can decide run in a cold
//     path, drawn on demand: the trial's u_acc together with the next
//     trial's u_pos and u_keep, three chains side by side;
//   * the launch plan (ops/resident_walk.py::launch_plan) fills the card:
//     with rows in shared memory one block lives on an SM, so it launches at
//     most as many blocks as there are SMs and gives each its share of the
//     walkers (a thread takes several where there are more than 1,024 a
//     block); with rows in device memory, blocks of a few warps, several
//     an SM;
//   * the table comes into shared memory by bulk asynchronous copies
//     (cp.async.bulk on an mbarrier) that one thread issues, and every
//     thread makes its first draws while they fly; a thread waits on the
//     barrier only before its first row read;
//   * ids are read as int4s; a row's stride is 4 * (an odd number) words,
//     so that the rows' int4s spread over all eight 16-byte bank groups;
//   * the corpus is stored as it is returned ([W_pad, L+2]), two columns a
//     store: a warp's stores do not coalesce, but they cost less than the
//     second pass that transposed a [L+2, W_pad] corpus.
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

// steps whose trial-0 draws a thread makes together, ahead of need
constexpr int kAhead = 1;
// bytes one bulk copy instruction moves (a multiple of 16)
constexpr uint32_t kCopyChunk = 32768;

// An id word of the table: the neighbour's id in the low kIdBits bits and
// that vertex's degree above them (-1 in a padded slot), so that a step
// knows its row's degree without a read. Two words are equal iff their ids
// are.
constexpr int kIdBits = 26;
constexpr int kIdMask = (1 << kIdBits) - 1;
// ids of prev's row that a thread keeps in registers (the row has at least
// as many id slots)
constexpr int kHeld = 16;

// Word offsets inside a row; the neighbour ids start at 0.
struct Layout {
  int stride, pairs, deg;
};

// The block's copy of the table.
extern __shared__ __align__(16) int tab_s[];

// Row reads: from the block's copy in shared memory, or in place from
// device memory (`base`) through the read-only path.
template <bool kShared>
struct Rows {
  const int* base;
  __device__ __forceinline__ int word(int i) const {
    return kShared ? tab_s[i] : __ldg(base + i);
  }
  __device__ __forceinline__ int2 pair(int i) const {
    return kShared ? *reinterpret_cast<const int2*>(tab_s + i)
                   : __ldg(reinterpret_cast<const int2*>(base + i));
  }
  __device__ __forceinline__ int4 quad(int i) const {
    return kShared ? *reinterpret_cast<const int4*>(tab_s + i)
                   : __ldg(reinterpret_cast<const int4*>(base + i));
  }
};

// Uniforms by (draw row, component) for one walker.
template <bool kExt>
struct Draws {
  uint2 key;
  const float* ext;
  uint32_t w_pad, gid;
  __device__ __forceinline__ float at(uint32_t row, uint32_t c) const {
    const uint32_t i = (row * 3u + c) * w_pad + gid;
    return kExt ? __ldg(ext + i) : srw::uniform_at(key, i);
  }
};

// The first kHeld neighbour ids of a row, in registers.
struct Ids {
  int4 q[kHeld / 4];
};

template <bool kShared>
__device__ __forceinline__ Ids load_ids(const Rows<kShared>& rows, int r0) {
  Ids ids;
#pragma unroll
  for (int i = 0; i < kHeld / 4; ++i) ids.q[i] = rows.quad(r0 + 4 * i);
  return ids;
}

// Holds a value in a register at this point of the program, so that the
// compiler does not sink what computes it below a later branch.
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }

// Alias draw on the row at word r0 of degree deg > 0 -> candidate (an id
// word: the id with its vertex's degree above it).
template <bool kShared>
__device__ __forceinline__ int sample(const Rows<kShared>& rows, Layout lay,
                                      int r0, int deg, float u_pos,
                                      float u_keep) {
  const int j = min((int)__fmul_rn(u_pos, (float)deg), deg - 1);
  const int2 keep_alias = rows.pair(r0 + lay.pairs + 2 * j);
  const int id = rows.word(r0 + j);
  return u_keep < __int_as_float(keep_alias.x) ? id : keep_alias.y;
}

__device__ __forceinline__ bool among(const int4 v, int cand) {
  return (v.x == cand) | (v.y == cand) | (v.z == cand) | (v.w == cand);
}

// The bias of candidate cand after prev (degree pdeg, first ids in pids),
// id words compared whole. The rest of a long row is read from the table,
// unless membership cannot change the bias (1/q == 1).
template <bool kShared>
__device__ __forceinline__ float bias(const Rows<kShared>& rows, Layout lay,
                                      int prev, int pdeg, const Ids& pids,
                                      int cand, float inv_p, float inv_q) {
  bool member = false;
#pragma unroll
  for (int i = 0; i < kHeld / 4; ++i) member |= among(pids.q[i], cand);
  if (pdeg > kHeld && inv_q != 1.0f) {
    const int p0 = (prev & kIdMask) * lay.stride;
    for (int k = kHeld; k < pdeg; k += 4)
      member |= among(rows.quad(p0 + k), cand);
  }
  return cand == prev ? inv_p : (member ? 1.0f : inv_q);
}

// u_pos and u_keep of trial 0 of steps t0 .. t0 + kAhead - 1. Steps past
// the walk's last repeat its draws (never read; row 0 where L == 0), so that
// external uniforms are not read out of range.
template <bool kExt>
__device__ __forceinline__ void draw_ahead(const Draws<kExt>& u, int t0,
                                           int L, int T, float* up,
                                           float* uk) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int t = min(t0 + i, L - 1);
    const uint32_t row = t < 0 ? 0u : 1u + (uint32_t)t * T;
    up[i] = u.at(row, 0);
    uk[i] = u.at(row, 1);
  }
}

// One walker's row of the corpus, written column by column in order: two
// columns a store where rows are 8-byte aligned (an even number of columns).
struct CorpusRow {
  int* out;
  uint32_t gid, cols;
  bool pairs;
  int held;
  __device__ __forceinline__ void put(uint32_t c, int v) {
    int* row = out + (size_t)gid * cols;
    if (!pairs) {
      row[c] = v;
    } else if (c & 1u) {
      *reinterpret_cast<int2*>(row + c - 1) = make_int2(held, v);
    } else {
      held = v;
    }
  }
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread: copy `bytes` (a multiple of 16) from device to shared memory,
// completion counted on the mbarrier `bar`.
__device__ __forceinline__ void start_table_copy(int* dst, const int* src,
                                                 uint32_t bytes,
                                                 unsigned long long* bar) {
  const uint32_t b = shared_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
    const uint32_t n = min(kCopyChunk, bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(shared_addr(dst) + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void wait_table_copy(unsigned long long* bar) {
  const uint32_t b = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(b), "r"(0u) : "memory");
  } while (!done);
}

template <bool kShared, bool kExt>
__global__ void __launch_bounds__(kShared ? 1024 : 256)
resident_walk_kernel(const int* __restrict__ tab_g, uint32_t table_bytes,
                     Layout lay, int V, int W_real, int W_pad, int L, int T,
                     uint2 key, const float* __restrict__ ext, float inv_p,
                     float inv_q, float max_f, int* __restrict__ out) {
  __shared__ __align__(8) unsigned long long bar;
  if (kShared && threadIdx.x == 0)
    start_table_copy(tab_s, tab_g, table_bytes, &bar);
  const Rows<kShared> rows{tab_g};
  const uint32_t w_pad = (uint32_t)W_pad;
  const uint32_t all = gridDim.x * blockDim.x;
  uint32_t gid = blockIdx.x * blockDim.x + threadIdx.x;

  // the first walker's first draws, made while the table copy flies
  Draws<kExt> u{key, ext, w_pad, min(gid, w_pad - 1u)};
  float u_pos0 = u.at(0, 0), u_keep0 = u.at(0, 1);
  float up[kAhead], uk[kAhead];
  draw_ahead(u, 0, L, T, up, uk);
  if (kShared) {
    __syncthreads();   // the barrier's init, seen by every thread
    wait_table_copy(&bar);
  }

  while (gid < w_pad) {
    uint32_t c = 0;   // columns written so far
    CorpusRow row{out, gid, (uint32_t)L + 2u, (L & 1) == 0, 0};
    if (gid < (uint32_t)W_real) {
      const int start = (int)(gid % (uint32_t)V);
      row.put(0, start);
      c = 1;
      int r0 = start * lay.stride;
      int deg = rows.word(r0 + lay.deg);
      if (deg > 0) {
        int prev = (int)((uint32_t)start | ((uint32_t)deg << kIdBits));
        int pdeg = deg;
        Ids pids = load_ids(rows, r0);
        int cur = sample(rows, lay, r0, deg, u_pos0, u_keep0);
        row.put(1, cur & kIdMask);
        c = 2;
        deg = (int)((uint32_t)cur >> kIdBits);
        bool live = true;
        for (int t0 = 0; live && t0 < L; t0 += kAhead) {
          float nup[kAhead], nuk[kAhead];
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            const int t = t0 + i;
            if (!live || t >= L) break;
            if (deg <= 0) {   // dead end: -1 from here on
              live = false;
              break;
            }
            r0 = (cur & kIdMask) * lay.stride;
            int cand = sample(rows, lay, r0, deg, up[i], uk[i]);
            // the next group's draws, beside this step's row reads: held
            // here, above the branches that follow
            if (i == 0) {
              draw_ahead(u, t0 + kAhead, L, T, nup, nuk);
#pragma unroll
              for (int n = 0; n < kAhead; ++n) {
                pin(nup[n]);
                pin(nuk[n]);
              }
            }
            float f = bias(rows, lay, prev, pdeg, pids, cand, inv_p, inv_q);
            // cold path: u_acc can decide, and a later trial may follow
            for (int j = 0; f < max_f && j < T - 1; ++j) {
              const uint32_t r = 1u + (uint32_t)t * T + j;
              const float u_acc = u.at(r, 2);
              const float u_pos = u.at(r + 1u, 0);
              const float u_keep = u.at(r + 1u, 1);
              if (__fmul_rn(u_acc, max_f) < f) break;
              cand = sample(rows, lay, r0, deg, u_pos, u_keep);
              f = bias(rows, lay, prev, pdeg, pids, cand, inv_p, inv_q);
            }
            // the first accepted candidate, else the last trial's
            row.put((uint32_t)(t + 2), cand & kIdMask);
            c = t + 3;
            // cur's ids for the next step's membership: read now, compared
            // after that step's own row reads
            pids = load_ids(rows, r0);
            prev = cur;
            pdeg = deg;
            cur = cand;
            deg = (int)((uint32_t)cand >> kIdBits);
          }
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            up[i] = nup[i];
            uk[i] = nuk[i];
          }
        }
      }
    }
    for (; c < (uint32_t)L + 2u; ++c) row.put(c, -1);
    gid += all;
    if (gid >= w_pad) break;
    // a thread's next walker (more walkers than the launch has threads)
    u.gid = gid;
    u_pos0 = u.at(0, 0);
    u_keep0 = u.at(0, 1);
    draw_ahead(u, 0, L, T, up, uk);
  }
}

template <bool kShared, bool kExt>
int launch(const int* tab, uint32_t table_bytes, Layout lay, int V, int W_real,
           int W_pad, int L, int T, uint2 key, const float* ext, float inv_p,
           float inv_q, float max_f, int blocks, int threads, int* out,
           cudaStream_t stream) {
  const size_t dynamic = kShared ? table_bytes : 0;
  if (kShared) {
    cudaError_t e = cudaFuncSetAttribute(
        resident_walk_kernel<kShared, kExt>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
    if (e != cudaSuccess) return (int)e;
  }
  resident_walk_kernel<kShared, kExt><<<blocks, threads, dynamic, stream>>>(
      tab, table_bytes, lay, V, W_real, W_pad, L, T, key, ext, inv_p, inv_q,
      max_f, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The table is V rows of `stride` words (ids at 0, the pairs and the degree
// at the given word offsets). shared != 0: rows in shared memory (the
// table's bytes of dynamic shared memory); else rows in device memory.
// blocks x threads is the launch plan; the threads walk W_pad walkers
// between them. out is i32 [W_pad, L + 2]. Returns the CUDA error code.
extern "C" int srw_resident_walk_launch(
    const int* tab, int V, int stride, int o_pairs, int o_deg, int W_real,
    int W_pad, int L, int T, unsigned key0, unsigned key1,
    const float* ext, float inv_p, float inv_q, float max_f, int shared,
    int blocks, int threads, int* out, void* stream) {
  if (W_pad <= 0) return (int)cudaGetLastError();
  const Layout lay{stride, o_pairs, o_deg};
  const uint32_t table_bytes = (uint32_t)V * stride * sizeof(int);
  const uint2 key = make_uint2(key0, key1);
  cudaStream_t s = (cudaStream_t)stream;
#define SRW_LAUNCH(S, E)                                                     \
  launch<S, E>(tab, table_bytes, lay, V, W_real, W_pad, L, T, key, ext,      \
               inv_p, inv_q, max_f, blocks, threads, out, s)
  if (shared) return ext ? SRW_LAUNCH(true, true) : SRW_LAUNCH(true, false);
  return ext ? SRW_LAUNCH(false, true) : SRW_LAUNCH(false, false);
#undef SRW_LAUNCH
}
