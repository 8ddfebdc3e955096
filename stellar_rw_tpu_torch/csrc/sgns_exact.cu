// One exact-negative SGNS step (skip-gram, k negatives a pair) as one
// cooperative kernel launch, over one block or over the S slots of the
// data-parallel trainer's merged update.
//
// Replaces the JAX package's _sgns_apply over _pairs_for_block
// (stellar_rw_tpu/models/word2vec.py:154-210, 60-94), which XLA lowers to
// gathers of P = B*T*2w pair rows and (1 + k) target rows, two einsums and
// two scatter-adds: at B = 32, T = 82, w = 10, k = 5, D = 128 a step builds
// a [52,480, 6, 128] f32 target tensor (161 MB) and its gradient.
//
// sgns_exact_step runs in three phases, all of its blocks resident at once
// (a cooperative launch: the grid is two blocks an SM at most):
//   (a) gradients: persistent blocks, each over a contiguous range of
//       center positions; a block's warps split its (position, offset)
//       pairs into contiguous runs, so a warp keeps a center's row and its
//       gradient in registers while the center stays. A pair's 1 + k
//       targets go in groups of kGroup: their rows are read together, the
//       logits reduced together, g = sigmoid - label. Every gradient row
//       (g * vi for a target, the summed g * vo for a center) goes into a
//       small open-addressing table in shared memory keyed by (table, row),
//       holding the row's partial sum and count, when it finds a slot in
//       kProbes probes; the hub rows, which come first and most often, take
//       the table, and the rest go straight to device memory. At the end
//       each occupied slot is flushed as one row of device atomics. Device
//       rows are compact delta slots: a row-to-slot map (one int a
//       vocabulary row, -1 when free) gives a row its slot at its first
//       touch and lists it. Every gradient comes from the tables as they
//       were before the step, as in the functional JAX step.
//   (b) a grid barrier (cooperative_groups::this_grid().sync()), then the
//       update: the grid's warps stride over the listed slots, a row a
//       warp, w[row] += (-lr * delta) / max(cnt, 1), and put the slot's
//       delta and count and the row's map entry back to their empty values.
//   (c) a second grid barrier, once every block has read the two slot
//       counts, then block 0 zeroes them: the next step finds the
//       workspace empty, with no memset between. The block that finishes
//       last, found by an arrival counter between two __threadfence()
//       calls, measured a third slower, and as fast as the barrier without
//       the fences: after a step's flood of device atomics the fences are
//       the cost (chip_sgns_exact_parts.py keeps both forms as variants).
//
// Slots. The launch runs over S slots' blocks of BT = B*T positions each:
// position p belongs to slot p / BT, whose block, windows and negatives are
// a base pointer plus the slot times that array's slot stride (arguments
// of their own, not a struct of pointers indexed at run time, which would
// go to local memory). A pair's context lies in its own walk, so a slot's
// pairs read its own rows alone. The one-device step is S = 1. On one card
// the merged update of S slots is this same step (the wrapper counts its
// launches on their own): the JAX package's psum'd update
// (stellar_rw_tpu/models/word2vec.py:190-201),
// w - (lr * psum(acc)) / max(psum(cnt), 1), sums every slot's
// gradients of a row before it divides, which is what the delta slots hold
// when all slots' pairs add into one workspace; phase (b)'s
// (-lr * d) / max(c, 1) rounds as csrc/dp_apply.cu's (lr * acc) / max(c, 1)
// does. So a merged update is one launch, with no reduction buffer.
// In accumulate mode (srw_sgns_exact_accumulate_launch: a rank's slots of
// a merged update summed across ranks) phase (b) adds each listed slot's
// delta row and count into the merged update's reduction buffer (its
// acc_in, acc_out, cnt_in and cnt_out arrays) in place of the update, and
// still empties the slots; the buffer is all-reduced and csrc/dp_apply.cu
// moves the tables. A row has one slot in a launch and the launches run in
// turn on one stream, so the adds are plain, and a row no slot touched
// keeps acc 0 and count 0, as dp_apply.cu requires. The tables are read and
// written by the one kernel, so they come in as plain pointers and phase
// (a) reads them with plain loads (cached in L1 on sm_90), not
// through the read-only path, which the programming guide allows only for
// data that no thread writes during the kernel.
//
// The pair enumeration, dynamic window and negatives are the JAX package's
// (the block, its window draws cwin and the negative draws come in). Sums
// run in another order than JAX's (a warp reduction for the logit; atomics
// in no fixed order; the scatter-mean as sum-then-divide instead of
// divide-then-sum), so a step agrees with it to rounding, not bit for bit.
//
// What bounds it: not the reads. Each group of a pair's targets runs one
// chain of dependent reads (its negatives' indices, then the target rows,
// in L2 when the tables fit there), then its probes, dot and row adds; one
// warp a position with one target at a time, and a flag it waited on a
// target, ran a chain of ~62 targets a warp in 1.24 waves; groups of three,
// two blocks of 16 warps an SM, one wave. Taking the reads off that chain
// (the target rows of the group a stage or more ahead copied into a ring a
// warp in shared memory by cp.async or cp.async.bulk, while the current
// group's math runs: chip_sgns_exact_ring.cu) measured slower at every block
// but a star graph's, where it ties (the one-device step 0.112 ms against
// 0.095 at B 32, D 128), and as slow with one stage in flight as with three:
// the reads were not what the warps waited for, and the ring's cursor cost
// instructions and shared memory of its own. The time grows with the columns
// a group adds (D 64 0.071 ms, D 128 0.095, D 768 0.44 at B 32): the row
// adds, not the flops (2 * P * (1 + k) * D * 3), set it. The gradient rows
// land on few distinct rows: without the table a one-token block's 164,040
// row adds go to one device row, 8x slower and summed in one float. On
// blocks of real walks the table pays where a hub is every other token (a
// star graph's) and costs its probes where the largest row takes a few
// percent of the adds (PERF.md, section 6, has both on the H100). Any D: the
// logits and the row adds loop over D in slices of 32 * NV columns, held in
// registers when one slice covers the row and read again from L1 otherwise;
// the table holds fewer rows at larger D (ops/sgns_exact.py::launch_plan
// says how many). The update moves each touched row four times (3,456 rows x
// 512 B at walk_10k's block: 1.8 MB); as a kernel of its own it also cost a
// launch, a memset of the slot counts, and each warp's chain of dependent
// reads (counts, then list, then the rows); here it costs one grid barrier.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "delta_slots.cuh"

namespace {

namespace cg = cooperative_groups;
using srw::claim;

// The delta slots (delta_slots.cuh) and, in accumulate mode, the merged
// update's buffer: sum [2] the tables' [V, D] sums, num [2] their [V]
// counts
struct Scratch : srw::Scratch {
  float* sum[2] = {nullptr, nullptr};   // null: update the tables
  float* num[2] = {nullptr, nullptr};
  // a select, not an index, as in srw::Scratch
  __device__ float* sumt(int t) const { return t == 0 ? sum[0] : sum[1]; }
  __device__ float* numt(int t) const { return t == 0 ? num[0] : num[1]; }
};

// The launch's slots: S blocks of BT positions, each array's slot s at its
// base plus s times its stride (elements)
struct Slots {
  int S, BT;
  long long block, cwin, negs;
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;      // blocks of kMaxThreads an SM holds
constexpr int kGroup = 3;          // targets a warp reads and reduces at once
constexpr int kProbes = 2;         // table slots tried before device memory
constexpr int kEmpty = -1;         // a free table slot, a row with no slot
constexpr int kInBit = static_cast<int>(0x80000000u);  // key bit: w_in row
constexpr uint32_t kHashMult = 2654435761u;

// The table slot of `key` (inserted if absent), or -1 after kProbes slots.
__device__ __forceinline__ int probe(int* keys, int slots, int key) {
  if (slots == 0) return -1;
  int h = static_cast<int>(
      (static_cast<uint64_t>(static_cast<uint32_t>(key) * kHashMult) *
       static_cast<uint32_t>(slots)) >> 32);
  for (int i = 0; i < kProbes; ++i) {
    const int cur = static_cast<volatile int*>(keys)[h];
    if (cur == key) return h;
    if (cur == kEmpty) {
      const int prev = atomicCAS(keys + h, kEmpty, key);
      if (prev == kEmpty || prev == key) return h;
    }
    if (++h == slots) h = 0;
  }
  return -1;
}

// Where a row's adds go: a table slot (>= 0) or delta slot g as -1 - g.
__device__ __forceinline__ int dest_of(int* keys, int slots,
                                      const Scratch& s, int t, int row) {
  const int h = probe(keys, slots, t == 0 ? (row | kInBit) : row);
  return h >= 0 ? h : -1 - claim(s, t, row);
}

template <int NV>
__device__ __forceinline__ void add_row(float* tab, int dpad,
                                        const Scratch& s, int t, int dest,
                                        int c0, int D, int lane,
                                        const float (&v)[NV]) {
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = c0 + lane + 32 * m;
    if (c < D) {
      if (dest >= 0)
        atomicAdd(tab + static_cast<size_t>(dest) * dpad + c, v[m]);
      else
        atomicAdd(s.dt(t) + static_cast<size_t>(-1 - dest) * D + c, v[m]);
    }
  }
}

__device__ __forceinline__ void add_count(int* tcnt, const Scratch& s, int t,
                                          int dest, int n) {
  if (dest >= 0)
    atomicAdd(tcnt + dest, n);
  else
    atomicAdd(s.cntt(t) + (-1 - dest), n);
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

// Phase (b): the listed slots of both tables, a row a warp of the grid. The
// workspace was written by other blocks' atomics and stores: read at L2.
__device__ __forceinline__ void apply_slots(float* w_in, float* w_out,
                                            const Scratch& s, int D,
                                            float lr) {
  const int n_in = __ldcg(s.counts);
  const int n = n_in + __ldcg(s.counts + 1);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       item < n; item += warps) {
    const int t = item < n_in ? 0 : 1;
    const int slot = t == 0 ? item : item - n_in;
    const int row = __ldcg(s.listt(t) + slot);
    float* w = (t == 0 ? w_in : w_out) + static_cast<size_t>(row) * D;
    float* d = s.dt(t) + static_cast<size_t>(slot) * D;
    if (s.sum[0]) {  // accumulate mode: the delta and its count to the buffer
      float* a = s.sumt(t) + static_cast<size_t>(row) * D;
      for (int i = lane; i < D; i += 32) {
        a[i] += __ldcg(d + i);
        d[i] = 0.f;
      }
      if (lane == 0)
        s.numt(t)[row] += static_cast<float>(__ldcg(s.cntt(t) + slot));
    } else {
      const float c = static_cast<float>(max(__ldcg(s.cntt(t) + slot), 1));
      for (int i = lane; i < D; i += 32) {
        w[i] += (-lr * __ldcg(d + i)) / c;
        d[i] = 0.f;
      }
    }
    __syncwarp();
    if (lane == 0) {
      s.cntt(t)[slot] = 0;
      s.mapt(t)[row] = kEmpty;
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sgns_exact_step(float* w_in, float* w_out, const int* __restrict__ block,
                    const int* __restrict__ cwin,
                    const int* __restrict__ negs, Scratch s, Slots sl,
                    int T, int window, int k, int D, int positions,
                    int slots, float lr, int* stats) {
  constexpr int kSlice = 32 * NV;
  extern __shared__ int smem[];
  const int dpad = (D + 31) & ~31;
  int* keys = smem;
  int* tcnt = smem + slots;
  float* tab = reinterpret_cast<float*>(smem + 2 * slots);
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    keys[i] = kEmpty;
    tcnt[i] = 0;
  }
  for (int i = threadIdx.x; i < slots * dpad; i += blockDim.x) tab[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W2 = 2 * window;
  const int p0 = blockIdx.x * positions;
  const int n = max(0, min(sl.S * sl.BT - p0, positions)) * W2;
  const int i1 = static_cast<int>(static_cast<long long>(n) * (warp + 1) /
                                  nwarps);
  const bool one_slice = D <= kSlice;
  // the position's slot and its index q there address the slot's arrays
  int pos = -1, center = -1, cdest = 0, nvalid = 0, slot = 0, q = 0, t = 0,
      win = 0;
  int in_table = 0, in_device = 0, flushed = 0;  // this lane's, for stats
  float vi[NV], dvi[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) vi[m] = dvi[m] = 0.f;

  // the current center's gradient and pair count into its row's sum
  auto flush_center = [&]() {
    if (nvalid == 0) return;
    if (one_slice) add_row<NV>(tab, dpad, s, 0, cdest, 0, D, lane, dvi);
    if (lane == 0) add_count(tcnt, s, 0, cdest, nvalid);
  };

  for (int it = static_cast<int>(static_cast<long long>(n) * warp / nwarps);
       it < i1; ++it) {
    const int p = p0 + it / W2;
    const int o = it - (it / W2) * W2;
    if (p != pos) {
      flush_center();
      pos = p;
      slot = p / sl.BT;
      q = p - slot * sl.BT;
      center = block[slot * sl.block + q];
      nvalid = 0;
      t = q % T;
      win = cwin[slot * sl.cwin + q];
#pragma unroll
      for (int m = 0; m < NV; ++m) dvi[m] = 0.f;
      if (center >= 0 && one_slice)
        load_slice<NV>(w_in + static_cast<size_t>(center) * D, 0, D, lane,
                       vi);
    }
    if (center < 0) continue;
    const int off = o < window ? o - window : o - window + 1;
    const int tc = t + off;
    if (abs(off) > win || tc < 0 || tc >= T) continue;
    const int ctx = block[slot * sl.block + (q - t + tc)];
    if (ctx < 0) continue;
    if (nvalid++ == 0) {  // the center's first valid pair: its destination
      int d = 0;
      if (lane == 0) {
        d = dest_of(keys, slots, s, 0, center);
        ++(d >= 0 ? in_table : in_device);
      }
      cdest = __shfl_sync(kFull, d, 0);
    }
    const int* ng =
        negs + slot * sl.negs + (static_cast<long long>(q) * W2 + o) * k;
    for (int gb = 0; gb <= k; gb += kGroup) {
      const int nt = min(kGroup, k + 1 - gb);
      int my_tgt = 0;
      if (lane < nt) my_tgt = gb + lane == 0 ? ctx : ng[gb + lane - 1];
      int tgt[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) tgt[g] = __shfl_sync(kFull, my_tgt, g);
      // the group's rows are read first; their destinations are found
      // while the reads are in flight
      float vo[kGroup][NV], dot[kGroup];
      if (one_slice) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (g < nt)
            load_slice<NV>(w_out + static_cast<size_t>(tgt[g]) * D, 0, D,
                           lane, vo[g]);
      }
      int my_dest = 0;
      if (lane < nt) {
        my_dest = dest_of(keys, slots, s, 1, my_tgt);
        add_count(tcnt, s, 1, my_dest, 1);
        ++(my_dest >= 0 ? in_table : in_device);
      }
      int dst[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        dst[g] = __shfl_sync(kFull, my_dest, g);
        dot[g] = 0.f;
      }
      // the logits, slice by slice
      for (int c0 = 0; c0 < D; c0 += kSlice) {
        if (!one_slice)
          load_slice<NV>(w_in + static_cast<size_t>(center) * D, c0, D,
                         lane, vi);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (g < nt) {
            if (!one_slice)
              load_slice<NV>(w_out + static_cast<size_t>(tgt[g]) * D, c0, D,
                             lane, vo[g]);
#pragma unroll
            for (int m = 0; m < NV; ++m) dot[g] = fmaf(vi[m], vo[g][m], dot[g]);
          }
        }
      }
#pragma unroll
      for (int sh = 16; sh; sh >>= 1)
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          dot[g] += __shfl_xor_sync(kFull, dot[g], sh);
      float gr[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        gr[g] = 1.f / (1.f + expf(-dot[g])) - (gb + g == 0 ? 1.f : 0.f);
      // the gradient rows, slice by slice (one slice: rows still held)
      for (int c0 = 0; c0 < D; c0 += kSlice) {
        if (!one_slice)
          load_slice<NV>(w_in + static_cast<size_t>(center) * D, c0, D,
                         lane, vi);
        float acc[NV];
#pragma unroll
        for (int m = 0; m < NV; ++m) acc[m] = 0.f;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (g < nt) {
            if (!one_slice)
              load_slice<NV>(w_out + static_cast<size_t>(tgt[g]) * D, c0, D,
                             lane, vo[g]);
            float v[NV];
#pragma unroll
            for (int m = 0; m < NV; ++m) {
              acc[m] = fmaf(gr[g], vo[g][m], acc[m]);
              v[m] = gr[g] * vi[m];
            }
            add_row<NV>(tab, dpad, s, 1, dst[g], c0, D, lane, v);
          }
        }
        if (one_slice) {
#pragma unroll
          for (int m = 0; m < NV; ++m) dvi[m] += acc[m];
        } else {
          add_row<NV>(tab, dpad, s, 0, cdest, c0, D, lane, acc);
        }
      }
    }
  }
  flush_center();
  __syncthreads();

  // each occupied slot to its row's delta slot: one device row a slot
  for (int base = warp * 32; base < slots; base += nwarps * 32) {
    const int h = base + lane;
    const int key = h < slots ? keys[h] : kEmpty;
    const int tt = (key & kInBit) ? 0 : 1;
    int g = 0;
    if (key != kEmpty) {
      g = claim(s, tt, key & ~kInBit);
      atomicAdd(s.cntt(tt) + g, tcnt[h]);
    }
    flushed += key != kEmpty;
    for (unsigned occ = __ballot_sync(kFull, key != kEmpty); occ;
         occ &= occ - 1) {
      const int j = __ffs(occ) - 1;
      const int gj = __shfl_sync(kFull, g, j);
      const int tj = __shfl_sync(kFull, tt, j);
      const float* src = tab + static_cast<size_t>(base + j) * dpad;
      float* dst = s.dt(tj) + static_cast<size_t>(gj) * D;
      for (int c = lane; c < D; c += 32) atomicAdd(dst + c, src[c]);
    }
  }
  if (stats) {  // row adds into the table, into device memory; slots flushed
    for (int sh = 16; sh; sh >>= 1) {
      in_table += __shfl_xor_sync(kFull, in_table, sh);
      in_device += __shfl_xor_sync(kFull, in_device, sh);
      flushed += __shfl_xor_sync(kFull, flushed, sh);
    }
    if (lane == 0) {
      atomicAdd(stats, in_table);
      atomicAdd(stats + 1, in_device);
      atomicAdd(stats + 2, flushed);
    }
  }

  // (b) every block's rows are in the delta slots: the update
  cg::this_grid().sync();
  apply_slots(w_in, w_out, s, D, lr);
  // (c) every block has read the slot counts: zero them for the next step
  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.counts[0] = 0;
    s.counts[1] = 0;
  }
}

template <int NV>
cudaError_t launch_step(float* w_in, float* w_out, const int* block,
                        const int* cwin, const int* negs, Scratch s,
                        Slots sl, int T, int window, int k, int D,
                        int blocks, int threads, int positions, int slots,
                        float lr, int* stats, cudaStream_t stream) {
  const int dpad = (D + 31) & ~31;
  const size_t smem = static_cast<size_t>(slots) * (8 + 4 * dpad);
  cudaError_t err = cudaFuncSetAttribute(
      sgns_exact_step<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&w_in, &w_out, &block,     &cwin,  &negs,  &s,
                  &sl,   &T,     &window,    &k,     &D,     &positions,
                  &slots, &lr,   &stats};
  // refused (cudaErrorCooperativeLaunchTooLarge) if the blocks cannot all
  // be resident at once: never run as an ordinary launch
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sgns_exact_step<NV>), dim3(blocks),
      dim3(threads), args, smem, stream);
}

// a launch's arguments checked, then the step for the plan's NV
int run_step(void* w_in, void* w_out, const void* block, const void* cwin,
             const void* negs, const Scratch& s, int S, int BT,
             long long block_stride, long long cwin_stride,
             long long negs_stride, int T, int window, int k, int D,
             int blocks, int threads, int positions, int slots, float lr,
             void* stats, void* stream) {
  if (S <= 0 || BT <= 0) return 0;
  if (D < 1 || k < 0 || window < 1 || T < 1 || BT % T || threads < 32 ||
      threads % 32 || threads > kMaxThreads || slots < 0 || blocks < 1 ||
      block_stride < 0 || cwin_stride < 0 || negs_stride < 0 ||
      static_cast<long long>(S) * BT > 0x7fffffffLL ||
      static_cast<long long>(blocks) * positions <
          static_cast<long long>(S) * BT)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slots sl{S, BT, block_stride, cwin_stride, negs_stride};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(w_in);
  float* b = static_cast<float*>(w_out);
  const int* blk = static_cast<const int*>(block);
  const int* cw = static_cast<const int*>(cwin);
  const int* ng = static_cast<const int*>(negs);
  int* st_out = static_cast<int*>(stats);
  cudaError_t err;
  if (D <= 32)
    err = launch_step<1>(a, b, blk, cw, ng, s, sl, T, window, k, D, blocks,
                         threads, positions, slots, lr, st_out, st);
  else if (D <= 64)
    err = launch_step<2>(a, b, blk, cw, ng, s, sl, T, window, k, D, blocks,
                         threads, positions, slots, lr, st_out, st);
  else
    err = launch_step<4>(a, b, blk, cw, ng, s, sl, T, window, k, D, blocks,
                         threads, positions, slots, lr, st_out, st);
  cudaGetLastError();  // a refused launch leaves no error for later calls
  return static_cast<int>(err);
}

// the workspace's arrays from the wrapper's pointer list
Scratch step_scratch(void* const* scratch_ptrs) {
  Scratch s;
  static_cast<srw::Scratch&>(s) = srw::scratch(scratch_ptrs);
  return s;
}

}  // namespace

// One step for S slots of BT = B*T center positions each under a launch plan
// (ops/sgns_exact.py::launch_plan for S*B rows): `blocks` blocks of
// `threads` threads (all resident: at most two an SM), `positions`
// consecutive positions a block, a table of `slots` rows in shared memory;
// the tables move in place by lr. Slot s's block, windows and negatives
// start at block + s * block_stride, cwin + s * cwin_stride and negs + s *
// negs_stride (elements); one block is S = 1, and S > 1 on one card is the
// data-parallel trainer's merged update (see the note at the top). scratch:
// d_in, d_out, cnt_in, cnt_out, map_in, map_out, list_in, list_out,
// counts[2], all empty (zero, map -1) before the step and again after it.
// stats, when not null, gets three sums added: row adds into the tables, row
// adds into device memory, slots flushed. Returns the CUDA error of the
// launch (a refused cooperative launch included).
extern "C" int srw_sgns_exact_step_launch(
    void* w_in, void* w_out, const void* block, const void* cwin,
    const void* negs, void* const* scratch_ptrs, int S, int BT,
    long long block_stride, long long cwin_stride, long long negs_stride,
    int T, int window, int k, int D, int blocks, int threads, int positions,
    int slots, float lr, void* stats, void* stream) {
  return run_step(w_in, w_out, block, cwin, negs, step_scratch(scratch_ptrs),
                  S, BT, block_stride, cwin_stride, negs_stride, T, window, k,
                  D, blocks, threads, positions, slots, lr, stats, stream);
}

// The same step in accumulate mode: the S slots' gradient sums added into
// the reduction buffer's acc_in, acc_out [V, D] and their counts into
// cnt_in, cnt_out [V], the tables left as they are (lr is not read).
extern "C" int srw_sgns_exact_accumulate_launch(
    void* w_in, void* w_out, const void* block, const void* cwin,
    const void* negs, void* const* scratch_ptrs, int S, int BT,
    long long block_stride, long long cwin_stride, long long negs_stride,
    int T, int window, int k, int D, int blocks, int threads, int positions,
    int slots, float lr, void* stats, void* acc_in, void* acc_out,
    void* cnt_in, void* cnt_out, void* stream) {
  if (!acc_in || !acc_out || !cnt_in || !cnt_out)
    return static_cast<int>(cudaErrorInvalidValue);
  Scratch s = step_scratch(scratch_ptrs);
  s.sum[0] = static_cast<float*>(acc_in);
  s.sum[1] = static_cast<float*>(acc_out);
  s.num[0] = static_cast<float*>(cnt_in);
  s.num[1] = static_cast<float*>(cnt_out);
  return run_step(w_in, w_out, block, cwin, negs, s, S, BT, block_stride,
                  cwin_stride, negs_stride, T, window, k, D, blocks, threads,
                  positions, slots, lr, stats, stream);
}
