#!/usr/bin/env python3
"""Where sgns_shared_grads' time goes on one GPU: the kernel source with one
part taken out at a time, each variant built and timed at the main shape.

    python3 chip_sgns_parts.py

A variant is csrc/sgns_shared.cu with one piece of text replaced (the pieces
are listed in VARIANTS; a piece that is no longer in the source stops the
script, so the list is kept beside the kernel). A variant's result is wrong
by design; only its time is read. The difference between `base` and a
variant is what the part costs where nothing else hides it. Then the
kernel above D = 512 (column slices) under other slice widths and
negatives a chunk (SLICED: each a variant of the dispatch, held to the
plain version at rtol 1e-5 atol 1e-5) at (2624, 768, 128) and (2624, 1536,
128). Times are chip_smoke's cuda_ms (CUDA events around 100 launches, 20
for the sliced shapes, queued behind a long product), every variant twice,
in turns. Variants are written and built under build/ of the checkout.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import SGNS_SHAPES, cuda_ms

# name -> (text in the source, its replacement)
VARIANTS = {
    "base": None,
    "no second kernel (the partials are not summed)": (
        "  if (n > 0) {\n    // programmatic",
        "  if (n < 0) {\n    // programmatic"),
    "second kernel launched after the first ends": (
        "programmaticStreamSerializationAllowed = 1",
        "programmaticStreamSerializationAllowed = 0"),
    "16 loads in flight a thread, not 8": (
        "LOAD_BATCH = 8;", "LOAD_BATCH = 16;"),
    "one TF32 pass a product, not three": (
        "  mma_tf32(c, al, bh);\n  mma_tf32(c, ah, bl);\n", ""),
    "loads only (no product, zeros written)": (
        "      __syncthreads();\n\n      // product 1:",
        "      __syncthreads();\n      if (P > 0) continue;\n\n"
        "      // product 1:"),
    "no product 1": (
        "        for (int kk = 0; kk < DP; kk += 8) {",
        "        for (int kk = 0; kk < DP && P < 0; kk += 8) {"),
    "no product 2": (
        "        for (int kk = 0; kk < kc_lim; kk += 8) {",
        "        for (int kk = 0; kk < kc_lim && P < 0; kk += 8) {"),
    "no product 3": (
        "      if (m3 < kc_lim) {\n#pragma unroll\n"
        "        for (int kk = 0; kk < TM; kk += 8) {",
        "      if (m3 < kc_lim && P < 0) {\n#pragma unroll\n"
        "        for (int kk = 0; kk < TM; kk += 8) {"),
    "d_vi neither read (vo) nor written": (
        "            if (p < P && d < D) {\n              const size_t o",
        "            if (p < P && d < D && acc[i][2 * h] == 123.f) {\n"
        "              const size_t o"),
    "partials not written": (
        "        if (kb < kB && d < D) {\n          float* dst = my_part",
        "        if (kb < kB && d < D && acc3[i][2 * h] == 123.f) {\n"
        "          float* dst = my_part"),
}
# the sliced kernel's (slice width, negatives a chunk): name -> edit
SLICED = {
    "256 columns, 64 negatives a chunk (base)": None,
    "512 columns, 32 negatives a chunk": (
        "launch_sliced<256, 64>(", "launch_sliced<512, 32>("),
    "256 columns, 32 negatives a chunk": (
        "launch_sliced<256, 64>(", "launch_sliced<256, 32>("),
}
SLICED_SHAPES = [(2624, 768, 128), (2624, 1536, 128)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_sgns_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.ops import _build, sgns
    from stellar_rw_tpu_torch.ops._build import Kernel, ptr, stream

    source = (_build.CSRC / sgns.SGNS_KERNEL.source).read_text()
    out_dir = _build.BUILD_DIR.parent / "sgns_parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    class Variant(Kernel):
        def __init__(self, index: int, edit):
            super().__init__(f"variant_{index}.cu", sgns.SGNS_KERNEL.symbol,
                             sgns.SGNS_KERNEL.argtypes)
            text = source
            if edit is not None:
                if text.count(edit[0]) != 1:
                    raise RuntimeError(f"not once in the source: {edit[0]!r}")
                text = text.replace(*edit)
            self._path = out_dir / self.source
            self._path.write_text(text)

        @property
        def path(self):
            return self._path

    kernels = {name: Variant(i, edit)
               for i, (name, edit) in enumerate(VARIANTS.items())}
    sliced = {name: Variant(len(VARIANTS) + i, edit)
              for i, (name, edit) in enumerate(SLICED.items())}
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), [*kernels.values(),
                                         *sliced.values()]))

    P, D, kB = SGNS_SHAPES[0]
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
    vi, vo, wn = t(P, D), t(P, D), t(kB, D)
    valid = torch.as_tensor(rng.random(P) > 0.3).cuda().float()
    g_pos, mask = t(P) * valid, valid * 0.125
    plan = sgns.launch_plan(P, D, kB)
    d_vi, d_vo, d_wn = (torch.empty_like(x) for x in (vi, vo, wn))
    part = torch.empty(plan.part_floats, device="cuda")
    launch = lambda k: lambda: k.launch(
        ptr(vi), ptr(vo), ptr(wn), ptr(g_pos), ptr(mask), ptr(d_vi),
        ptr(d_vo), ptr(d_wn), ptr(part), P, D, kB, plan.blocks,
        stream(vi.device))
    names = list(kernels)
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        runs[name].append(cuda_ms(launch(kernels[name]), 100) * 1e3)
    x = torch.zeros(16, device="cuda")
    floor = cuda_ms(lambda: (x.add_(1), x.add_(1)), 100) * 1e3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"shape": [P, D, kB], "us_in_turns": runs,
                      "two_tiny_torch_launches_us": floor, "card": smi},
                     indent=1))

    for P, D, kB in SLICED_SHAPES:
        vi, vo, wn = t(P, D), t(P, D), t(kB, D)
        valid = torch.as_tensor(rng.random(P) > 0.3).cuda().float()
        g_pos, mask = t(P) * valid, valid * 0.125
        plan = sgns.launch_plan(P, D, kB)
        d_vi, d_vo, d_wn = (torch.empty_like(x) for x in (vi, vo, wn))
        part = torch.empty(plan.part_floats, device="cuda")
        want = sgns.sgns_shared_grads_ref(vi, vo, wn, g_pos, mask)
        plain = lambda: sgns.sgns_shared_grads_ref(vi, vo, wn, g_pos, mask)
        runs = {"plain": []}
        for name, k in sliced.items():
            launch(k)()
            torch.cuda.synchronize()
            for got, ref in zip((d_vi, d_vo, d_wn), want):
                if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5):
                    raise RuntimeError(
                        f"sliced variant {name!r} differs at {(P, D, kB)}: "
                        f"{float((got - ref).abs().max()):.3g}")
            runs[name] = []
        names = list(runs)
        for name in names + names[::-1]:
            fn = plain if name == "plain" else launch(sliced[name])
            runs[name].append(cuda_ms(fn, 20) * 1e3)
        print(json.dumps({"shape": [P, D, kB], "sliced_us_in_turns": runs,
                          "card": smi}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
