#!/usr/bin/env python3
"""Where the exact-CDF walk kernel's time goes on one GPU: the kernel source
with one part changed at a time, at chip_smoke's phase-10 corpus, and the
kernel on a graph whose rows are all shorter than a warp.

    python3 chip_cdf_parts.py

A variant is csrc/cdf_walk.cu with pieces of text replaced (VARIANTS; a piece
that is not exactly once in the source stops the script, so the list is kept
beside the kernel), built under build/ of the checkout. A variant that keeps
the design is held bit for bit to the base's corpus; one with a part taken
out walks elsewhere by design, so beside its time stand the row entries its
corpus made the walkers scan (sum of deg(cur) over the steps taken).

Among the variants is a design that weighs each entry of the chunked form
once (WEIGH_ONCE: a pass keeps each 32-entry piece's total in shared memory,
summed from a tile of the weights; lane 0 runs the sums to the crossing's
piece, which alone is weighed and scanned again; every sum in the same order
as the base, so the corpus is the base's bit for bit), with a tile of 8 or 32
pieces and with or without its unconditional bucket read.

The corpus is phase 10's: chip_smoke's walk_10k graph, 10,000 walkers x 10
rounds x walk length 80 at (p, q) = (1/16, 4), the chunked form, float32.
Times are chip_smoke's cuda_ms (CUDA events around 3 launches queued behind
a long product), every variant twice, in turns. One JSON object a line, the
card's name and power limit in each, and ptxas' registers of every variant.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import check, cuda_ms, regular_graph, synth_power_law_graph

# the bucket read of a second-order weight, and a constant-time stand-in
BUCKET_READ = (
    "    const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;\n"
    "    const int4 b = __ldg(&buckets[pv.bucket_base +\n"
    "                                  static_cast<int>(h & pv.bucket_mask)]);"
    "\n    f = (b.x == e.x || b.y == e.x || b.z == e.x || b.w == e.x) ? T(1) "
    ": inv_q;\n")
NO_BUCKET_READ = "taken out: the bucket read (f from the entry's low bit)"
NO_FIND = "taken out: the find pass after its first piece"
# the chunked form's pick rewritten to weigh each entry once: the base's
# source becomes the whole design (kTilePieces pieces a tile, the bucket
# row read whatever the entry)
WEIGH_ONCE = [
    ("constexpr uint32_t kHashMult = 2654435761u;\n",
     "constexpr uint32_t kHashMult = 2654435761u;\n"
     "constexpr int kThreads = 256;   // 8 walkers a block\n"
     "// shared memory a warp of the chunked form keeps of its row's piece"
     " totals:\n"
     "// 1,280 pieces (40,960 entries) in f32, 640 in f64; and its tile of\n"
     "// kTilePieces pieces' weights (a row of 33 a piece), weighed"
     " together\n"
     "constexpr int kSumBytes = 5120;\n"
     "constexpr int kTilePieces = 8;\n"
     "constexpr int kTileFloats = kTilePieces * 33;\n"
     "// rows of at most this many pieces go straight to the find loop\n"
     "constexpr int kDirect = 2;\n"),
    ("struct Ops<float> {\n",
     "struct Ops<float> {\n"
     "  static constexpr float kMinNormal = 1.17549435e-38f;\n"
     "  static constexpr float kShrink = 1.0f - 1.0f / 65536.0f;\n"),
    ("struct Ops<double> {\n",
     "struct Ops<double> {\n"
     "  static constexpr double kMinNormal = 2.2250738585072014e-308;\n"
     "  static constexpr double kShrink = 1.0 - 1.0 / 65536.0;\n"),
    ("  int id, bucket_base, bucket_mask;\n"
     "};\n"
     "\n",
     "  int id, bucket_base, bucket_mask;\n"
     "};\n"
     "\n"
     "// The bucket row is read whatever the entry (a valid row of the"
     " previous\n"
     "// vertex's table): no branch around the read, so a warp's reads of"
     " several\n"
     "// entries go out together.\n"),
    ("  T f;\n"
     "  if (e.x == pv.id) {\n"
     "    f = inv_p;\n"
     "  } else {\n"
     "    const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;\n"
     "    const int4 b = __ldg(&buckets[pv.bucket_base +\n"
     "                                  static_cast<int>(h &"
     " pv.bucket_mask)]);\n"
     "    f = (b.x == e.x || b.y == e.x || b.z == e.x || b.w == e.x) ? T(1)"
     " : inv_q;\n"
     "  }\n"
     "  return Ops<T>::mul(w, f);\n"
     "}\n"
     "\n"
     "// Index of the picked entry in the row [s, s + d), or -1 (the row"
     " head).\n"
     "template <typename T, bool kChunked, bool kSecond>\n"
     "__device__ int pick(const int2* __restrict__ rows, int s, int d, T u,\n"
     "                    const Prev& pv, const int4* __restrict__ buckets,"
     " T inv_p,\n"
     "                    T inv_q, int lane) {\n"
     "  using O = Ops<T>;\n"
     "  const int2* row = rows + s;\n"
     "  if (kChunked) {\n"
     "    T acc = T(0);\n"
     "    for (int i = lane; i < d; i += 32)\n"
     "      acc = O::add(acc, weigh<T, kSecond>(row[i], pv, buckets, inv_p,"
     " inv_q));\n"
     "    for (int off = 16; off; off >>= 1)\n"
     "      acc = O::add(acc, __shfl_xor_sync(kFull, acc, off));\n"
     "    const T thresh = O::mul(u, acc);\n"
     "    T cum = T(0);\n"
     "    for (int base = 0; base < d; base += 32) {\n"
     "      const int i = base + lane;\n"
     "      T v =\n"
     "          i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p,"
     " inv_q) : T(0);\n"
     "      for (int o = 1; o < 32; o <<= 1) {\n"
     "        const T y = __shfl_up_sync(kFull, v, o);\n"
     "        if (lane >= o) v = O::add(v, y);\n"
     "      }\n"
     "      const T c = O::add(cum, v);\n"
     "      const unsigned hit = __ballot_sync(kFull, i < d && c >="
     " thresh);\n"
     "      if (hit) return base + __ffs(hit) - 1;\n"
     "      cum = __shfl_sync(kFull, c, 31);\n"
     "    }\n"
     "    return -1;\n"
     "  }\n",
     "  const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;\n"
     "  const int4 b = __ldg(&buckets[pv.bucket_base +\n"
     "                                static_cast<int>(h &"
     " pv.bucket_mask)]);\n"
     "  const T f = e.x == pv.id ? inv_p\n"
     "              : (b.x == e.x || b.y == e.x || b.z == e.x || b.w =="
     " e.x)\n"
     "                  ? T(1)\n"
     "                  : inv_q;\n"
     "  return Ops<T>::mul(w, f);\n"
     "}\n"
     "\n"
     "// The padded form's pick: the first entry of the row [0, d) whose"
     " running\n"
     "// sum of b / total reaches u, or -1 (the row head). Its sum divides"
     " by the\n"
     "// total, so each entry is weighed in the total pass and again in the"
     " find\n"
     "// pass.\n"
     "template <typename T, bool kSecond>\n"
     "__device__ int pick_padded(const int2* __restrict__ row, int d, T u,\n"
     "                           const Prev& pv, const int4* __restrict__"
     " buckets,\n"
     "                           T inv_p, T inv_q, int lane) {\n"
     "  using O = Ops<T>;\n"),
    ("  return -1;\n"
     "}\n"
     "\n",
     "  return -1;\n"
     "}\n"
     "\n"
     "// Inclusive Kogge-Stone scan of a 32-entry piece over the lanes.\n"
     "template <typename T>\n"
     "__device__ __forceinline__ T piece_scan(T v, int lane) {\n"
     "  for (int o = 1; o < 32; o <<= 1) {\n"
     "    const T y = __shfl_up_sync(kFull, v, o);\n"
     "    if (lane >= o) v = Ops<T>::add(v, y);\n"
     "  }\n"
     "  return v;\n"
     "}\n"
     "\n"
     "// The sum of a piece's 32 values as lane 31 of piece_scan forms it:"
     " a\n"
     "// balanced pairwise tree (each level adds neighbouring partial"
     " sums).\n"
     "template <typename T>\n"
     "__device__ __forceinline__ T piece_total(const T* __restrict__ x) {\n"
     "  T s[16];\n"
     "#pragma unroll\n"
     "  for (int k = 0; k < 16; ++k) s[k] = Ops<T>::add(x[2 * k], x[2 * k +"
     " 1]);\n"
     "#pragma unroll\n"
     "  for (int n = 8; n; n >>= 1)\n"
     "#pragma unroll\n"
     "    for (int k = 0; k < n; ++k) s[k] = Ops<T>::add(s[2 * k], s[2 * k"
     " + 1]);\n"
     "  return s[0];\n"
     "}\n"
     "\n"
     "// The chunked form's pick: the first entry of the row [0, d) whose"
     " running\n"
     "// sum c of b reaches u * total, or -1 (the row head). The running"
     " sum goes\n"
     "// piece by piece: c = (sum before the piece) + the piece's"
     " Kogge-Stone scan,\n"
     "// the sum before the next piece being c at lane 31, i.e. the sum"
     " before\n"
     "// plus the piece's total; the total is the lane sums (lane i % 32"
     " adds\n"
     "// entry i) joined by a butterfly.\n"
     "//\n"
     "// One pass weighs each entry once, kTilePieces pieces at a time: it"
     " adds\n"
     "// the lane sums and puts each weight into the warp's `tile` (a row"
     " of 33 a\n"
     "// piece, so that both the row-wise writes and the column-wise reads"
     " miss no\n"
     "// bank); then each of kTilePieces lanes sums one piece as the scan's"
     " lane\n"
     "// 31 would (piece_total) into `sums` (the warp's first `cap`"
     " pieces). With thresh = u * total known,\n"
     "// lane 0 runs the sums before each piece up to the first piece that"
     " can\n"
     "// hold the crossing; that piece alone is weighed and scanned again,"
     " and\n"
     "// the ballot takes the first lane as before. The scan of a piece is"
     " not\n"
     "// monotone over its lanes under rounding (an inner lane can exceed"
     " lane 31\n"
     "// by a few ulps), so a piece is passed over only when the sum after"
     " it is\n"
     "// below thresh * (1 - 2^-16), far beyond that rounding; the find"
     " loop then\n"
     "// goes on from the found piece exactly as a pass from the start"
     " would.\n"
     "// Pieces beyond `cap` are weighed again. Rows of at most kDirect"
     " pieces go\n"
     "// straight to the find loop. Every sum is the same operation in the"
     " same\n"
     "// order as the plain version's.\n"
     "template <typename T, bool kSecond>\n"
     "__device__ int pick_chunked(const int2* __restrict__ row, int d, T u,\n"
     "                            const Prev& pv, const int4* __restrict__"
     " buckets,\n"
     "                            T inv_p, T inv_q, int lane, T* sums, T*"
     " tile,\n"
     "                            int cap) {\n"
     "  using O = Ops<T>;\n"
     "  const int pieces = (d + 31) >> 5;\n"
     "  T acc = T(0), cum = T(0);\n"
     "  int first = 0;\n"
     "  if (pieces <= kDirect) {\n"
     "    for (int i = lane; i < d; i += 32)\n"
     "      acc = O::add(acc, weigh<T, kSecond>(row[i], pv, buckets, inv_p,"
     " inv_q));\n"
     "  } else {\n"
     "    for (int p0 = 0; p0 < pieces; p0 += kTilePieces) {\n"
     "      // the group's reads all go out before its first store: a store\n"
     "      // between them would hold each read back behind the one before\n"
     "      int2 e[kTilePieces];\n"
     "#pragma unroll\n"
     "      for (int j = 0; j < kTilePieces; ++j) {\n"
     "        const int i = (p0 + j) * 32 + lane;\n"
     "        e[j] = i < d ? row[i] : make_int2(0, 0);\n"
     "      }\n"
     "      T v[kTilePieces];\n"
     "#pragma unroll\n"
     "      for (int j = 0; j < kTilePieces; ++j)\n"
     "        v[j] = (p0 + j) * 32 + lane < d\n"
     "                   ? weigh<T, kSecond>(e[j], pv, buckets, inv_p,"
     " inv_q)\n"
     "                   : T(0);\n"
     "      __syncwarp();  // the tile's last reads are done\n"
     "#pragma unroll\n"
     "      for (int j = 0; j < kTilePieces; ++j) {\n"
     "        acc = O::add(acc, v[j]);\n"
     "        tile[j * 33 + lane] = v[j];\n"
     "      }\n"
     "      __syncwarp();\n"
     "      if (lane < min(kTilePieces, pieces - p0) && p0 + lane < cap)\n"
     "        sums[p0 + lane] = piece_total(tile + lane * 33);\n"
     "    }\n"
     "  }\n"
     "  for (int off = 16; off; off >>= 1)\n"
     "    acc = O::add(acc, __shfl_xor_sync(kFull, acc, off));\n"
     "  const T thresh = O::mul(u, acc);\n"
     "  if (pieces > kDirect) {\n"
     "    __syncwarp();\n"
     "    const T lo = thresh < Ops<T>::kMinNormal\n"
     "                     ? T(0)\n"
     "                     : O::mul(thresh, Ops<T>::kShrink);\n"
     "    if (lane == 0) {\n"
     "      const int n = min(pieces, cap);\n"
     "      for (; first < n; ++first) {\n"
     "        const T next = O::add(cum, sums[first]);\n"
     "        if (next >= lo) break;\n"
     "        cum = next;\n"
     "      }\n"
     "    }\n"
     "    first = __shfl_sync(kFull, first, 0);\n"
     "    cum = __shfl_sync(kFull, cum, 0);\n"
     "  }\n"
     "  for (int base = first * 32; base < d; base += 32) {\n"
     "    const int i = base + lane;\n"
     "    const T v =\n"
     "        i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p, inv_q)"
     " : T(0);\n"
     "    const T c = O::add(cum, piece_scan(v, lane));\n"
     "    const unsigned hit = __ballot_sync(kFull, i < d && c >= thresh);\n"
     "    if (hit) return base + __ffs(hit) - 1;\n"
     "    cum = __shfl_sync(kFull, c, 31);\n"
     "  }\n"
     "  return -1;\n"
     "}\n"
     "\n"
     "// Index of the picked entry in the row [s, s + d), or -1 (the row"
     " head).\n"
     "template <typename T, bool kChunked, bool kSecond>\n"
     "__device__ __forceinline__ int pick(const int2* __restrict__ rows,"
     " int s,\n"
     "                                    int d, T u, const Prev& pv,\n"
     "                                    const int4* __restrict__ buckets,\n"
     "                                    T inv_p, T inv_q, int lane, T*"
     " sums,\n"
     "                                    T* tile, int cap) {\n"
     "  if (kChunked)\n"
     "    return pick_chunked<T, kSecond>(rows + s, d, u, pv, buckets,"
     " inv_p,\n"
     "                                    inv_q, lane, sums, tile, cap);\n"
     "  return pick_padded<T, kSecond>(rows + s, d, u, pv, buckets, inv_p,"
     " inv_q,\n"
     "                                 lane);\n"
     "}\n"
     "\n"),
    ("                    uint32_t round_offset, T inv_p, T inv_q) {\n",
     "                    uint32_t round_offset, T inv_p, T inv_q) {\n"
     "  extern __shared__ unsigned char smem_raw[];\n"
     "  constexpr int cap = kSumBytes / static_cast<int>(sizeof(T));\n"
     "  T* sums = reinterpret_cast<T*>(smem_raw) +\n"
     "            (threadIdx.x >> 5) * (cap + kTileFloats);\n"
     "  T* tile = sums + cap;\n"),
    ("                                           buckets, inv_p, inv_q,"
     " lane);\n",
     "                                           buckets, inv_p, inv_q,"
     " lane, sums,\n"
     "                                           tile, cap);\n"),
    ("                                          inv_p, inv_q, lane);\n",
     "                                          inv_p, inv_q, lane, sums,"
     " tile,\n"
     "                                          cap);\n"),
    ("  constexpr int kThreads = 256;  // 8 walkers a block\n"
     "  const long long threads = static_cast<long long>(N) * 32;\n"
     "  const unsigned blocks =\n"
     "      static_cast<unsigned>((threads + kThreads - 1) / kThreads);\n"
     "  cdf_walk_kernel<T, kChunked><<<blocks, kThreads, 0, stream>>>(\n",
     "  const long long threads = static_cast<long long>(N) * 32;\n"
     "  const unsigned blocks =\n"
     "      static_cast<unsigned>((threads + kThreads - 1) / kThreads);\n"
     "  const size_t smem =\n"
     "      kChunked ? (kThreads / 32) * (kSumBytes + kTileFloats *"
     " sizeof(T)) : 0;\n"
     "  if (kChunked) {\n"
     "    const cudaError_t err = cudaFuncSetAttribute(\n"
     "        cdf_walk_kernel<T, kChunked>,\n"
     "        cudaFuncAttributeMaxDynamicSharedMemorySize,"
     " static_cast<int>(smem));\n"
     "    if (err != cudaSuccess) return err;\n"
     "  }\n"
     "  cdf_walk_kernel<T, kChunked><<<blocks, kThreads, smem, stream>>>(\n"),
]
# WEIGH_ONCE's weigh() with the base's branch around the bucket read
BRANCHED_WEIGH = [
    (WEIGH_ONCE[3][1], WEIGH_ONCE[3][0]),
    ("  const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;\n"
     "  const int4 b = __ldg(&buckets[pv.bucket_base +\n"
     "                                static_cast<int>(h & pv.bucket_mask)]);"
     "\n  const T f = e.x == pv.id ? inv_p\n"
     "              : (b.x == e.x || b.y == e.x || b.z == e.x || b.w == e.x)\n"
     "                  ? T(1)\n                  : inv_q;\n",
     "  T f;\n  if (e.x == pv.id) {\n    f = inv_p;\n  } else {\n"
     + BUCKET_READ + "  }\n")]
# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "base": [],
    NO_BUCKET_READ: [(BUCKET_READ, "    f = (e.x & 1) ? T(1) : inv_q;\n")],
    "the bucket row read whatever the entry": [
        ("  T f;\n  if (e.x == pv.id) {\n    f = inv_p;\n  } else {\n"
         + BUCKET_READ + "  }\n",
         "  const uint32_t h = static_cast<uint32_t>(e.x) * kHashMult;\n"
         "  const int4 b = __ldg(&buckets[pv.bucket_base +\n"
         "                                static_cast<int>(h & "
         "pv.bucket_mask)]);\n"
         "  const T f = e.x == pv.id ? inv_p : (b.x == e.x || b.y == e.x || "
         "b.z == e.x || b.w == e.x) ? T(1) : inv_q;\n")],
    "the next piece's entries read a turn ahead in the find pass": [
        ("    T cum = T(0);\n    for (int base = 0; base < d; "
         "base += 32) {\n      const int i = base + lane;\n      T v =\n"
         "          i < d ? weigh<T, kSecond>(row[i], pv, buckets, inv_p, "
         "inv_q) : T(0);\n",
         "    T cum = T(0);\n    int2 e = lane < d ? row[lane] : "
         "make_int2(0, 0);\n    for (int base = 0; base < d; "
         "base += 32) {\n      const int i = base + lane;\n"
         "      const int2 next = i + 32 < d ? row[i + 32] : "
         "make_int2(0, 0);\n      T v = i < d ? weigh<T, kSecond>(e, pv, "
         "buckets, inv_p, inv_q) : T(0);\n      e = next;\n")],
    NO_FIND: [
        ("      cum = __shfl_sync(kFull, c, 31);\n    }\n    return -1;",
         "      cum = __shfl_sync(kFull, c, 31);\n      break;\n    }\n"
         "    return -1;")],
    "weigh once: an 8-piece tile, the bucket row read whatever the entry":
        WEIGH_ONCE,
    "weigh once: an 8-piece tile, the bucket row read where needed":
        WEIGH_ONCE + BRANCHED_WEIGH,
    "weigh once: a 32-piece tile, the bucket row read where needed":
        WEIGH_ONCE + BRANCHED_WEIGH + [("constexpr int kTilePieces = 8;",
                                        "constexpr int kTilePieces = 32;")],
}
# variants whose corpus is wrong by design
WRONG_BY_DESIGN = {NO_BUCKET_READ, NO_FIND}
L, R, P, Q = 80, 10, 0.0625, 4.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_cdf_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import cdf_walk as cw
    from stellar_rw_tpu_torch.ops import prng, sampling
    from stellar_rw_tpu_torch.walk import engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    source = (build.CSRC / cw.CDF_WALK_KERNEL.source).read_text()
    root = os.path.dirname(os.path.realpath(__file__))
    out_dir = os.path.join(root, "build", "cdf_parts")
    os.makedirs(out_dir, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        with open(os.path.join(out_dir, header.name), "w") as f:
            f.write(header.read_text())

    class Variant(build.Kernel):
        def __init__(self, index: int, edits):
            super().__init__(f"variant_{index}.cu",
                             cw.CDF_WALK_KERNEL.symbol,
                             cw.CDF_WALK_KERNEL.argtypes)
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"not once in the source: {old!r}")
                text = text.replace(old, new)
            self._path = build.Path(out_dir) / self.source
            self._path.write_text(text)

        @property
        def path(self):
            return self._path

    kernels = {name: Variant(i, edits)
               for i, (name, edits) in enumerate(VARIANTS.items())}
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), kernels.values()))
    for name, k in kernels.items():
        say(variant=name, ptxas=[
            line.split(":", 1)[-1].strip()
            for line in k.build_log.splitlines()
            if "registers" in line or "spill" in line])
    normal = cw.CDF_WALK_KERNEL
    key = prng.prng_key(0)

    def walker(graph, chunk=None):
        V = graph.num_vertices
        dg = sampling.device_put_graph(graph, "cuda", cdf=True)
        spec = engine.walk_spec(graph, L, R, P, Q, "cdf", 16, "float32", V)
        starts = torch.arange(V, dtype=torch.int32, device="cuda")
        chunk = spec.cdf_chunk if chunk is None else chunk
        deg = dg.vmeta[:, 1].long()

        def run(kernel):
            def fn():
                cw.CDF_WALK_KERNEL = kernel
                try:
                    return cw.cdf_walk_rounds(dg, starts, key, 0, R, L, P, Q,
                                              spec.max_degree, chunk)
                finally:
                    cw.CDF_WALK_KERNEL = normal
            return fn

        def scanned(corpus):
            live = corpus[:, 1:] >= 0
            return (int((deg[corpus[:, :-1].clamp_min(0).long()]
                         * live).sum()), int(live.sum()))
        return run, scanned, spec

    run, scanned, spec = walker(synth_power_law_graph(10_000, 334_000,
                                                      seed=0))
    want = run(kernels["base"])()
    entries = {}
    for name, k in kernels.items():
        got = run(k)()
        torch.cuda.synchronize()
        if name not in WRONG_BY_DESIGN:
            check(torch.equal(got, want), f"variant {name!r} changes the "
                  f"corpus")
        entries[name] = scanned(got)
        del got
    names = list(kernels)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(cuda_ms(run(kernels[name]), 3))
    say(graph="walk_10k", chunk=spec.cdf_chunk,
        max_degree=spec.max_degree, ms_in_turns=turns,
        entries_and_steps=entries)

    # rows shorter than a warp: one piece a step, chunked and padded
    run, scanned, spec = walker(regular_graph(10_000, 16, seed=0),
                                sampling.CDF_CHUNK)
    short = run(kernels["base"])
    entries, steps = scanned(short())
    run_pad, _, _ = walker(regular_graph(10_000, 16, seed=0), 0)
    say(graph="16-regular, 10,000 vertices",
        chunked_ms=[cuda_ms(short, 3), cuda_ms(short, 3)],
        padded_ms=[cuda_ms(run_pad(kernels["base"]), 3)],
        entries=entries, steps=steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
