#!/usr/bin/env python3
"""Where the data-parallel merged update's time goes on one GPU: K13
(csrc/dp_apply.cu) with one part changed or taken out at a time, on the
buffers of chip_smoke's phase 21.

    python3 chip_dp_parts.py

A variant is csrc/dp_apply.cu with pieces of text replaced (VARIANTS; a
piece that is not exactly once in the source stops the script), built under
build/dp_parts/ and launched with the grid ops/dp_apply.py::launch_plan
gives under the variant's blocks an SM. A variant that keeps the design is
held bit for bit to dp_apply_ref, the buffer empty after it, before it is
timed; one with a part taken out leaves wrong tables by design, and only
its time is read. The parts:

  * the touched rows a warp moves at once (4 in the base; 2, 8);
  * the launch bounds' blocks an SM, which cap the registers (5 in the
    base; 4, 6);
  * the rounds whose counts a lane has in flight (2 in the base: the
    round it moves and the next; 3, 4);
  * a lane's four counts by one 16-byte load (base) or a float at a time;
  * the sectors dealt to the warps in turn (base) or cut into one
    contiguous run a warp;
  * taken out: the rows' moves (the counts still read, listed and
    zeroed); all but the launch.

Each is timed on chip_smoke's fills (dp_fill: a, two slots' conv steps at
V 10,000; b, at V 1,000,000; c, every count nonzero at V 10,000), back to
back, each launch on a copy of the fill of its own, every variant twice in
turns. One JSON object a line, the card's name and power limit in each, and
ptxas' registers of every variant. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import check, cuda_ms, dp_fill

# name -> [(text in csrc/dp_apply.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    "batches of 8 rows": [("constexpr int kBatch = 4;",
                           "constexpr int kBatch = 8;")],
    "batches of 2 rows": [("constexpr int kBatch = 4;",
                           "constexpr int kBatch = 2;")],
    "4 blocks an SM": [("constexpr int kBlocksPerSm = 5;",
                        "constexpr int kBlocksPerSm = 4;")],
    "6 blocks an SM": [("constexpr int kBlocksPerSm = 5;",
                        "constexpr int kBlocksPerSm = 6;")],
    "3 rounds of counts in flight": [("constexpr int kAhead = 2;",
                                      "constexpr int kAhead = 3;")],
    "4 rounds of counts in flight": [("constexpr int kAhead = 2;",
                                      "constexpr int kAhead = 4;")],
    "6 blocks an SM, 3 rounds in flight": [
        ("constexpr int kBlocksPerSm = 5;", "constexpr int kBlocksPerSm = 6;"),
        ("constexpr int kAhead = 2;", "constexpr int kAhead = 3;")],
    "counts read a float at a time": [
        ("  const bool vec_cnt = reinterpret_cast<uintptr_t>(cnt) % 16 == 0;",
         "  const bool vec_cnt = false;")],
    "a contiguous run of sectors a warp": [
        ("    const long long sec = warp + (32LL * m + lane) * warps;",
         "    const long long per = (sectors + warps - 1) / warps;\n"
         "    const long long sec = 32LL * m + lane < per\n"
         "        ? warp * per + 32LL * m + lane : sectors;"),
        ("  for (int m = 0; warp + 32LL * m * warps < sectors; ++m) {",
         "  for (int m = 0; 32LL * m < (sectors + warps - 1) / warps; ++m) {")],
    "taken out: the rows' moves": [
        ("    for (int j0 = 0; j0 < n; j0 += kBatch) {",
         "    for (int j0 = 0; j0 < n && D < 0; j0 += kBatch) {")],
    "taken out: all but the launch": [
        ("  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;\n",
         "  if (D > 0) return;\n"
         "  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;\n")],
}
WRONG_BY_DESIGN = {name for name in VARIANTS if name.startswith("taken")}
FILLS = (("a", 10_000, False), ("b", 1_000_000, False), ("c", 10_000, True))
D, LR = 128, 0.025


def constant(text: str, name: str) -> int:
    """The value of `constexpr int name = N;` in a source."""
    line = next(l for l in text.splitlines()
                if l.startswith(f"constexpr int {name} = "))
    return int(line.split("=")[1].split(";")[0])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_dp_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import dp_apply as da

    root = os.path.dirname(os.path.realpath(__file__))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    source = (build.CSRC / da.DP_APPLY.source).read_text()
    out_dir = os.path.join(root, "build", "dp_parts")
    os.makedirs(out_dir, exist_ok=True)

    class Variant(build.Kernel):
        def __init__(self, index: int, text: str):
            super().__init__(f"variant_{index}.cu", da.DP_APPLY.symbol,
                             da.DP_APPLY.argtypes)
            self._path = build.Path(out_dir) / self.source
            self._path.write_text(text)
            self.per_sm = constant(text, "kBlocksPerSm")

        @property
        def path(self):
            return self._path

    kernels = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"not once in the source: {old!r}")
            text = text.replace(old, new)
        kernels[name] = Variant(i, text)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), kernels.values()))
    for name, k in kernels.items():
        say(variant=name, ptxas=[
            line.split(":", 1)[-1].strip()
            for line in k.build_log.splitlines()
            if "registers" in line or "spill" in line])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(k, w_in, w_out, buf):
        V = w_in.shape[0]
        sectors = -(-2 * V // da.SECTOR)
        blocks = max(1, min(-(-sectors // (da.THREADS // 32)),
                            k.per_sm * sms))
        acc_in, acc_out, cnt, _ = da.buffer_ptrs(buf, V, D)
        k.launch(build.ptr(w_in), build.ptr(w_out), acc_in, acc_out, cnt,
                 V, D, da.f32_lr(LR), blocks, build.stream(w_in.device))

    for fill_name, V, every in FILLS:
        w_in, w_out, fill, _ = dp_fill(torch, V, D, 40, every_row=every)
        want = (w_in.clone(), w_out.clone())
        da.dp_apply_ref(*want, fill.clone(), LR)
        iters = 20 if V <= 10_000 else 5
        fns = {}
        for name, k in kernels.items():
            if name not in WRONG_BY_DESIGN:
                got, buf = (w_in.clone(), w_out.clone()), fill.clone()
                run(k, *got, buf)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want))
                      and not bool(buf.any()),
                      f"{name} differs from dp_apply_ref on fill "
                      f"{fill_name}")

            def copies(k=k):
                bufs = iter([fill.clone() for _ in range(iters + 1)])
                return lambda: run(k, w_in, w_out, next(bufs))
            fns[name] = copies
        names = list(kernels)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms(fns[name](), iters))
        touched = int((fill[2 * V * D:] != 0).sum())
        say(fill=fill_name, V=V, D=D, touched_rows=touched,
            ms_back_to_back_in_turns=turns)
        del w_in, w_out, fill, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
