// One exact-negative SGNS step (skip-gram, k negatives a pair), in two
// kernels.
//
// Replaces the JAX package's _sgns_apply over _pairs_for_block
// (stellar_rw_tpu/models/word2vec.py:154-210, 60-94), which XLA lowers to
// gathers of P = B*T*2w pair rows and (1 + k) target rows, two einsums and
// two scatter-adds: at B = 32, T = 82, w = 10, k = 5, D = 128 a step builds
// a [52,480, 6, 128] f32 target tensor (161 MB) and its gradient.
//
//   (a) sgns_exact_grads: persistent blocks, two an SM, each over a
//       contiguous range of center positions; a block's warps split its
//       (position, offset) pairs into contiguous runs, so a warp keeps a
//       center's row and its gradient in registers while the center stays.
//       A pair's 1 + k targets go in groups of kGroup: their rows are read
//       together, the logits reduced together, g = sigmoid - label. Every
//       gradient row (g * vi for a target, the summed g * vo for a center)
//       goes into a small open-addressing table in shared memory keyed by
//       (table, row), holding the row's partial sum and count, when it
//       finds a slot in kProbes probes; the hub rows, which come first and
//       most often, take the table, and the rest go straight to device
//       memory. At the end each occupied slot is flushed as one row of
//       device atomics. Device rows are compact delta slots: a row-to-slot
//       map (one int a vocabulary row, -1 when free) gives a row its slot
//       at its first touch and lists it. The tables are only read: every
//       gradient comes from the tables as they were before the step, as in
//       the functional JAX step.
//   (b) sgns_exact_apply: over the listed slots only (their number is read
//       on the device: no host sync), w[row] += (-lr * delta) / max(cnt, 1),
//       then the slot's delta and count and the row's map entry go back to
//       their empty values for the next step.
//
// The pair enumeration, dynamic window and negatives are the JAX package's
// (the block, its window draws cwin and the negative draws come in). Sums
// run in another order than JAX's (a warp reduction for the logit; atomics
// in no fixed order; the scatter-mean as sum-then-divide instead of
// divide-then-sum), so a step agrees with it to rounding, not bit for bit.
//
// What bounds it: each pair's chain of dependent reads (its context, its
// negatives, then the target rows, in L2 when the tables fit there) and the
// target rows' device atomics, against 2 * P * (1 + k) * D * 3 flops. One
// warp a position with one target at a time, and a flag it waited on a
// target, ran a chain of ~62 targets a warp in 1.24 waves; groups of three,
// two blocks of 16 warps an SM, one wave. The gradient rows land on few
// distinct rows: without the table a one-token block's 164,040 row adds go
// to one device row, 8x slower and summed in one float. On blocks of real
// walks the table pays where a hub is every other token (a star graph's)
// and costs its probes where the largest row takes a few percent of the
// adds (PERF.md, section 6, has both on the H100). Any D: the logits
// and the row adds loop over D in slices of 32 * NV columns, held in
// registers when one slice covers the row and read again from L1
// otherwise; the table holds fewer rows at larger D (ops/sgns_exact.py::
// launch_plan says how many).

#include <cstdint>

#include <cuda_runtime.h>

#include "delta_slots.cuh"

namespace {

using srw::Scratch;
using srw::claim;
using srw::scratch;

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

template <int NV>
__device__ __forceinline__ void load_slice(const float* __restrict__ row,
                                           int c0, int D, int lane,
                                           float (&v)[NV]) {
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = c0 + lane + 32 * m;
    v[m] = c < D ? __ldg(row + c) : 0.f;
  }
}

template <int NV>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sgns_exact_grads(const float* __restrict__ w_in,
                     const float* __restrict__ w_out,
                     const int* __restrict__ block,
                     const int* __restrict__ cwin,
                     const int* __restrict__ negs, Scratch s, int BT, int T,
                     int window, int k, int D, int positions, int slots,
                     int* stats) {
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
  const int n = max(0, min(BT - p0, positions)) * W2;
  const int i1 = static_cast<int>(static_cast<long long>(n) * (warp + 1) /
                                  nwarps);
  const bool one_slice = D <= kSlice;
  int pos = -1, center = -1, cdest = 0, nvalid = 0, t = 0, row0 = 0, win = 0;
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
      center = block[p];
      nvalid = 0;
      t = p % T;
      row0 = p - t;
      win = cwin[p];
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
    const int ctx = block[row0 + tc];
    if (ctx < 0) continue;
    if (nvalid++ == 0) {  // the center's first valid pair: its destination
      int d = 0;
      if (lane == 0) {
        d = dest_of(keys, slots, s, 0, center);
        ++(d >= 0 ? in_table : in_device);
      }
      cdest = __shfl_sync(kFull, d, 0);
    }
    const int* ng = negs + (static_cast<size_t>(p) * W2 + o) * k;
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
}

__global__ void __launch_bounds__(256)
    sgns_exact_apply(float* w_in, float* w_out, Scratch s, int D, float lr) {
  const int n_in = s.counts[0];
  const int n = n_in + s.counts[1];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       item < n; item += warps) {
    const int t = item < n_in ? 0 : 1;
    const int slot = t == 0 ? item : item - n_in;
    const int row = s.listt(t)[slot];
    float* w = (t == 0 ? w_in : w_out) + static_cast<size_t>(row) * D;
    float* d = s.dt(t) + static_cast<size_t>(slot) * D;
    const float c = static_cast<float>(max(s.cntt(t)[slot], 1));
    for (int i = lane; i < D; i += 32) {
      w[i] += (-lr * d[i]) / c;
      d[i] = 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      s.cntt(t)[slot] = 0;
      s.mapt(t)[row] = kEmpty;
    }
  }
}

template <int NV>
cudaError_t launch_grads(const void* w_in, const void* w_out,
                         const void* block, const void* cwin,
                         const void* negs, const Scratch& s, int BT, int T,
                         int window, int k, int D, int blocks, int threads,
                         int positions, int slots, int* stats,
                         cudaStream_t stream) {
  const int dpad = (D + 31) & ~31;
  const size_t smem = static_cast<size_t>(slots) * (8 + 4 * dpad);
  cudaError_t err = cudaFuncSetAttribute(
      sgns_exact_grads<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sgns_exact_grads<NV><<<blocks, threads, smem, stream>>>(
      static_cast<const float*>(w_in), static_cast<const float*>(w_out),
      static_cast<const int*>(block), static_cast<const int*>(cwin),
      static_cast<const int*>(negs), s, BT, T, window, k, D, positions,
      slots, stats);
  return cudaGetLastError();
}

}  // namespace

// Kernel (a) for one block of BT = B*T center positions under a launch plan
// (ops/sgns_exact.py::launch_plan): `blocks` blocks of `threads` threads,
// `positions` consecutive positions a block, a table of `slots` rows in
// shared memory. scratch: d_in, d_out, cnt_in, cnt_out, map_in, map_out,
// list_in, list_out, counts[2]. stats, when not null, gets three sums added:
// row adds into the tables, row adds into device memory, slots flushed.
// Zeroes the two slot counts, then launches. Returns the CUDA error.
extern "C" int srw_sgns_exact_grads_launch(
    const void* w_in, const void* w_out, const void* block, const void* cwin,
    const void* negs, void* const* scratch_ptrs, int BT, int T, int window,
    int k, int D, int blocks, int threads, int positions, int slots,
    void* stats, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = scratch(scratch_ptrs);
  cudaError_t err = cudaMemsetAsync(s.counts, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess || BT <= 0) return static_cast<int>(err);
  if (D < 1 || k < 0 || window < 1 || threads < 32 || threads % 32 ||
      threads > kMaxThreads || slots < 0 || blocks < 1 ||
      static_cast<long long>(blocks) * positions < BT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32)
    err = launch_grads<1>(w_in, w_out, block, cwin, negs, s, BT, T, window,
                          k, D, blocks, threads, positions, slots,
                          static_cast<int*>(stats), st);
  else if (D <= 64)
    err = launch_grads<2>(w_in, w_out, block, cwin, negs, s, BT, T, window,
                          k, D, blocks, threads, positions, slots,
                          static_cast<int*>(stats), st);
  else
    err = launch_grads<4>(w_in, w_out, block, cwin, negs, s, BT, T, window,
                          k, D, blocks, threads, positions, slots,
                          static_cast<int*>(stats), st);
  return static_cast<int>(err);
}

// Kernel (b): `blocks` blocks of 8 warps stride over the listed slots.
extern "C" int srw_sgns_exact_apply_launch(void* w_in, void* w_out,
                                           void* const* scratch_ptrs, int D,
                                           int blocks, float lr,
                                           void* stream) {
  sgns_exact_apply<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w_in), static_cast<float*>(w_out),
      scratch(scratch_ptrs), D, lr);
  return static_cast<int>(cudaGetLastError());
}
