// The exact-negative step with its target rows read ahead: a design that
// measured slower than the step's plain loads on the H100 at every block but
// a star graph's, where it ties (PERF.md, section 6), kept for
// chip_sgns_exact_parts.py, which appends this file to
// stellar_rw_tpu_torch/csrc/sgns_exact.cu and launches it through
// srw_sgns_exact_ring_step_launch and srw_sgns_exact_ring_accumulate_launch
// (the source's arguments; its table, delta slots, update and checks are
// reused).
//
// Each warp's pairs are found by a cursor ahead of the math: it loads the
// indices of the group kStages + 1 ahead into a record (one field a lane),
// and the target rows of the group kStages ahead are copied into the
// warp's ring in shared memory (cp.async, 16 bytes a lane where a row
// starts on 16 bytes, else 4; or with kBulk one cp.async.bulk a row
// completing on a stage's mbarrier), so one group's L2 round trip overlaps
// the last group's probes, dot and row adds. The arithmetic is the
// source's: the same sums in the same order a warp, the same table and
// delta slots. The ring takes rows of one register slice (D <= kRingMaxD);
// wider rows run the source's step with its plain loads. Shared memory a
// block: the table, then each warp's kStages groups of kGroup rows, their
// records and a stage's mbarrier (smem_layout). Three stages of six rows
// at D 128 ask for more than a block of two an SM has: the card refuses
// the launch.
namespace {

constexpr bool kBulk = false;      // a row by one cp.async.bulk
constexpr int kStages = 2;         // groups whose rows a warp's ring holds
constexpr int kRingMaxD = 128;     // the widest row the ring holds: one
                                   // slice of NV = 4
constexpr int kMeta = 4 + kGroup;  // a group's record: nt, p, center, gb,
                                   // its targets

// Dynamic shared memory: the hub table (keys, counts, rows), then each
// warp's ring of kStages groups' rows, their records and the stages'
// mbarriers (byte offsets)
struct Layout {
  int rows, meta, bars, bytes;
};

__host__ __device__ inline Layout smem_layout(int slots, int D, int warps) {
  const int dpad = (D + 31) & ~31;
  Layout l;
  l.rows = (slots * (8 + 4 * dpad) + 15) & ~15;
  l.meta = l.rows + warps * kStages * kGroup * ((D + 3) & ~3) * 4;
  l.bars = (l.meta + warps * kStages * kMeta * 4 + 7) & ~7;
  l.bytes = l.bars + warps * kStages * 8;
  return l;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   shared_addr(dst)), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   shared_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(shared_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(shared_addr(dst)), "l"(src),
      "r"(bytes), "r"(shared_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(shared_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// sgns_exact_step with the ring, for rows of one slice (D <= 32 * NV)
template <int NV>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    sgns_exact_ring_step(float* w_in, float* w_out,
                         const int* __restrict__ block,
                         const int* __restrict__ cwin,
                         const int* __restrict__ negs, Scratch s, Slots sl,
                         int T, int window, int k, int D, int positions,
                         int slots, float lr, int* stats) {
  extern __shared__ __align__(16) int smem[];
  const int dpad = (D + 31) & ~31;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* keys = smem;
  int* tcnt = smem + slots;
  float* tab = reinterpret_cast<float*>(smem + 2 * slots);
  const Layout lay = smem_layout(slots, D, nwarps);
  char* base = reinterpret_cast<char*>(smem);
  const int dq = (D + 3) & ~3;
  float* ring = reinterpret_cast<float*>(base + lay.rows) +
                static_cast<size_t>(warp) * kStages * kGroup * dq;
  int* meta = reinterpret_cast<int*>(base + lay.meta) + warp * kStages * kMeta;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + lay.bars) +
                   warp * kStages;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    keys[i] = kEmpty;
    tcnt[i] = 0;
  }
  for (int i = threadIdx.x; i < slots * dpad; i += blockDim.x) tab[i] = 0.f;
  // rows by 16-byte copies where a row starts on 16 bytes
  const bool vec =
      (D & 3) == 0 && (reinterpret_cast<uintptr_t>(w_out) & 15) == 0;
  if (kBulk && vec && lane == 0) {
    for (int st = 0; st < kStages; ++st) bar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int W2 = 2 * window;
  const int p0 = blockIdx.x * positions;
  const int n = max(0, min(sl.S * sl.BT - p0, positions)) * W2;
  const int i1 = static_cast<int>(static_cast<long long>(n) * (warp + 1) /
                                  nwarps);
  int pos = -1, center = -1, cdest = 0, nvalid = 0;
  int in_table = 0, in_device = 0, flushed = 0;  // this lane's, for stats
  float vi[NV], dvi[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) vi[m] = dvi[m] = 0.f;

  // the current center's gradient and pair count into its row's sum
  auto flush_center = [&]() {
    if (nvalid == 0) return;
    add_row<NV>(tab, dpad, s, 0, cdest, 0, D, lane, dvi);
    if (lane == 0) add_count(tcnt, s, 0, cdest, nvalid);
  };

  // The cursor: the warp's next group of targets, found ahead of the math.
  // q_* is the position it is at (its slot's walk row and negatives), q_it
  // the next (position, offset) pair to look at, q_gb the group's first
  // target in its pair (q_o its offset, q_ctx its context).
  int q_it = static_cast<int>(static_cast<long long>(n) * warp / nwarps);
  int q_pos = -1, q_center = -1, q_t = 0, q_win = 0, q_ctx = 0, q_o = 0,
      q_gb = k + 1;
  const int* q_row = block;   // the cursor's walk in its slot's block
  const int* q_ng = negs;     // its position's negatives
  // the next group's target count (0: the warp's pairs are done)
  auto advance = [&]() -> int {
    q_gb += kGroup;
    if (q_gb <= k) return min(kGroup, k + 1 - q_gb);
    for (; q_it < i1; ++q_it) {
      const int p = p0 + q_it / W2;
      const int o = q_it - (q_it / W2) * W2;
      if (p != q_pos) {
        q_pos = p;
        const int slot = p / sl.BT;
        const int q = p - slot * sl.BT;
        const int* blk = block + slot * sl.block;
        q_center = blk[q];
        q_t = q % T;
        q_row = blk + (q - q_t);
        q_win = cwin[slot * sl.cwin + q];
        q_ng = negs + slot * sl.negs + static_cast<long long>(q) * W2 * k;
      }
      if (q_center < 0) continue;
      const int off = o < window ? o - window : o - window + 1;
      const int tc = q_t + off;
      if (abs(off) > q_win || tc < 0 || tc >= T) continue;
      const int ctx = q_row[tc];
      if (ctx < 0) continue;
      q_ctx = ctx;
      q_o = o;
      q_gb = 0;
      ++q_it;
      return min(kGroup, k + 1);
    }
    return 0;
  };
  // The group after the ring's as its record, one field a lane: lane 0 its
  // target count (0: none), 1 its position, 2 its center, 3 its first
  // target's index in the pair, 4 + g its target g (loaded here, a group
  // before its row is asked for)
  int nx = 0;
  auto next = [&]() {
    const int nt = advance();
    const int g = lane - 4;
    nx = lane == 0   ? nt
         : lane == 1 ? q_pos
         : lane == 2 ? q_center
         : lane == 3 ? q_gb
         : g < nt    ? (q_gb + g == 0 ? q_ctx : q_ng[q_o * k + q_gb + g - 1])
                     : 0;
  };
  // the next group into ring stage st: its record, and its rows' copies
  auto fetch = [&](int st) {
    int* m = meta + st * kMeta;
    if (lane < kMeta) m[lane] = nx;
    const int nt = __shfl_sync(kFull, nx, 0);
    if (nt > 0) {
      float* dst = ring + st * kGroup * dq;
      if (kBulk && vec) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        if (lane == 0) bar_expect(bars + st, nt * D * 4);
        __syncwarp();
        if (lane >= 4 && lane < 4 + nt)
          bulk_copy(dst + (lane - 4) * dq,
                    w_out + static_cast<size_t>(nx) * D, D * 4, bars + st);
      } else {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int row = __shfl_sync(kFull, nx, 4 + g);
          if (g < nt) {
            const float* src = w_out + static_cast<size_t>(row) * D;
            if (vec) {
              for (int c = 4 * lane; c < D; c += 128)
                cp_async<16>(dst + g * dq + c, src + c);
            } else {
              for (int c = lane; c < D; c += 32)
                cp_async<4>(dst + g * dq + c, src + c);
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  // the ring filled: kStages groups' rows asked for, the next one's indices
  // loaded
  next();
  for (int st = 0; st < kStages; ++st) {
    fetch(st);
    next();
  }
  for (int use = 0, st = 0;; ++st) {
    if (st == kStages) {
      st = 0;
      ++use;
    }
    const int* m = meta + st * kMeta;
    __syncwarp();
    const int nt = m[0];
    if (nt == 0) break;
    const int p = m[1], cen = m[2], gb = m[3];
    const int my_tgt = lane < nt ? m[4 + lane] : 0;
    // the group's rows, read before its stage is asked for again
    if (kBulk && vec)
      bar_wait(bars + st, use & 1);
    else
      cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* rows = ring + st * kGroup * dq;
    float vo[kGroup][NV];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < nt) {
#pragma unroll
        for (int mm = 0; mm < NV; ++mm) {
          const int c = lane + 32 * mm;
          vo[g][mm] = c < D ? rows[g * dq + c] : 0.f;
        }
      }
    }
    __syncwarp();
    fetch(st);
    next();
    if (p != pos) {  // a new center: the last one flushed, its row read
      flush_center();
      pos = p;
      center = cen;
      nvalid = 0;
#pragma unroll
      for (int mm = 0; mm < NV; ++mm) dvi[mm] = 0.f;
      load_slice<NV>(w_in + static_cast<size_t>(center) * D, 0, D, lane, vi);
    }
    if (gb == 0 && nvalid++ == 0) {  // the center's first valid pair
      int d = 0;
      if (lane == 0) {
        d = dest_of(keys, slots, s, 0, center);
        ++(d >= 0 ? in_table : in_device);
      }
      cdest = __shfl_sync(kFull, d, 0);
    }
    // the group's destinations, logits and gradient rows
    int my_dest = 0;
    if (lane < nt) {
      my_dest = dest_of(keys, slots, s, 1, my_tgt);
      add_count(tcnt, s, 1, my_dest, 1);
      ++(my_dest >= 0 ? in_table : in_device);
    }
    int dst[kGroup];
    float dot[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      dst[g] = __shfl_sync(kFull, my_dest, g);
      dot[g] = 0.f;
#pragma unroll
      for (int mm = 0; mm < NV; ++mm)
        if (g < nt) dot[g] = fmaf(vi[mm], vo[g][mm], dot[g]);
    }
#pragma unroll
    for (int sh = 16; sh; sh >>= 1)
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        dot[g] += __shfl_xor_sync(kFull, dot[g], sh);
    float acc[NV];
#pragma unroll
    for (int mm = 0; mm < NV; ++mm) acc[mm] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < nt) {
        const float gr =
            1.f / (1.f + expf(-dot[g])) - (gb + g == 0 ? 1.f : 0.f);
        float v[NV];
#pragma unroll
        for (int mm = 0; mm < NV; ++mm) {
          acc[mm] = fmaf(gr, vo[g][mm], acc[mm]);
          v[mm] = gr * vi[mm];
        }
        add_row<NV>(tab, dpad, s, 1, dst[g], 0, D, lane, v);
      }
    }
#pragma unroll
    for (int mm = 0; mm < NV; ++mm) dvi[mm] += acc[mm];
  }
  cp_async_wait<0>();
  flush_center();
  __syncthreads();

  // the source's flush, stats and phases (b) and (c)
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
  if (stats) {
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
  cg::this_grid().sync();
  apply_slots(w_in, w_out, s, D, lr);
  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.counts[0] = 0;
    s.counts[1] = 0;
  }
}

template <int NV>
cudaError_t launch_ring(float* w_in, float* w_out, const int* block,
                        const int* cwin, const int* negs, Scratch s,
                        Slots sl, int T, int window, int k, int D,
                        int blocks, int threads, int positions, int slots,
                        float lr, int* stats, cudaStream_t stream) {
  const size_t smem = smem_layout(slots, D, threads / 32).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      sgns_exact_ring_step<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&w_in, &w_out, &block,     &cwin,  &negs,  &s,
                  &sl,   &T,     &window,    &k,     &D,     &positions,
                  &slots, &lr,   &stats};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sgns_exact_ring_step<NV>), dim3(blocks),
      dim3(threads), args, smem, stream);
}

// run_step's checks, then the ring for rows of one slice and the source's
// step for wider ones
int run_ring(void* w_in, void* w_out, const void* block, const void* cwin,
             const void* negs, const Scratch& s, int S, int BT,
             long long block_stride, long long cwin_stride,
             long long negs_stride, int T, int window, int k, int D,
             int blocks, int threads, int positions, int slots, float lr,
             void* stats, void* stream) {
  if (D > kRingMaxD || S <= 0 || BT <= 0)
    return run_step(w_in, w_out, block, cwin, negs, s, S, BT, block_stride,
                    cwin_stride, negs_stride, T, window, k, D, blocks,
                    threads, positions, slots, lr, stats, stream);
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
    err = launch_ring<1>(a, b, blk, cw, ng, s, sl, T, window, k, D, blocks,
                         threads, positions, slots, lr, st_out, st);
  else if (D <= 64)
    err = launch_ring<2>(a, b, blk, cw, ng, s, sl, T, window, k, D, blocks,
                         threads, positions, slots, lr, st_out, st);
  else
    err = launch_ring<4>(a, b, blk, cw, ng, s, sl, T, window, k, D, blocks,
                         threads, positions, slots, lr, st_out, st);
  cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// srw_sgns_exact_step_launch with the ring
extern "C" int srw_sgns_exact_ring_step_launch(
    void* w_in, void* w_out, const void* block, const void* cwin,
    const void* negs, void* const* scratch_ptrs, int S, int BT,
    long long block_stride, long long cwin_stride, long long negs_stride,
    int T, int window, int k, int D, int blocks, int threads, int positions,
    int slots, float lr, void* stats, void* stream) {
  return run_ring(w_in, w_out, block, cwin, negs, step_scratch(scratch_ptrs),
                  S, BT, block_stride, cwin_stride, negs_stride, T, window, k,
                  D, blocks, threads, positions, slots, lr, stats, stream);
}

// srw_sgns_exact_accumulate_launch with the ring
extern "C" int srw_sgns_exact_ring_accumulate_launch(
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
  return run_ring(w_in, w_out, block, cwin, negs, s, S, BT, block_stride,
                  cwin_stride, negs_stride, T, window, k, D, blocks, threads,
                  positions, slots, lr, stats, stream);
}
