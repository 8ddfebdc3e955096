// The card's rate for the trainer draws' integer mix: threefry blocks with
// no memory traffic. Not a kernel of the port: chip_smoke.py (phase 13) and
// chip_draws_parts.py append this file to a copy of
// stellar_rw_tpu_torch/csrc/trainer_draws.cu under build/ and build the two
// together, so `form` 1 runs that source's block_fn (its adds as IMAD, or
// whatever a parts variant made of them) and `form` 0 threefry.cuh's block
// as the walk kernels compile it.
//
// Each thread runs kChains independent chains of `rounds` blocks (a block's
// counter is the last block's output, so the compiler cannot drop one) and
// stores nothing unless the chains' xor hits one value: blocks / second is
// blocks * kThreads * kChains * rounds over the kernel's time.

namespace {

constexpr int kChains = 8;

template <int Form>
__global__ void __launch_bounds__(kThreads)
    threefry_probe(uint2 k, int rounds, uint32_t one, uint32_t* out) {
  uint32_t a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    a[j] = (blockIdx.x * kThreads + threadIdx.x) * kChains + j;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      const uint2 o = Form == 0 ? srw::threefry(k.x, k.y, 0u, a[j])
                                : block_fn(k, a[j], one);
      a[j] = o.x ^ o.y;
    }
  }
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) x ^= a[j];
  if (x == 0x9E3779B9u + one) out[0] = x;
}

}  // namespace

// `blocks` blocks of kThreads threads, each thread kChains chains of
// `rounds` blocks of form 0 (threefry.cuh) or 1 (block_fn). Returns the
// CUDA error of the launch.
extern "C" int srw_threefry_probe_launch(unsigned k0, unsigned k1, int form,
                                         int blocks, int rounds, void* out,
                                         void* stream) {
  const uint2 k = make_uint2(k0, k1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (form == 0)
    threefry_probe<0><<<blocks, kThreads, 0, st>>>(k, rounds, 1u, o);
  else
    threefry_probe<1><<<blocks, kThreads, 0, st>>>(k, rounds, 1u, o);
  return static_cast<int>(cudaGetLastError());
}
