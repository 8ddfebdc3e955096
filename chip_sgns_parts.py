#!/usr/bin/env python3
"""Where sgns_shared_grads' time goes on one GPU: the kernel source with one
part taken out at a time, each variant built and timed at the main shape.

    python3 chip_sgns_parts.py

A variant is csrc/sgns_shared.cu with one piece of text replaced (the pieces
are listed in VARIANTS; a piece that is no longer in the source stops the
script, so the list is kept beside the kernel). A variant's result is wrong
by design; only its time is read. The difference between `base` and a
variant is what the part costs where nothing else hides it. Then the
split form that serves D above SPLIT_D (sgns_logits, sgns_grads and the
sum of the partials) under other designs (SPLIT: ring depth, stage width,
logit blocks' warps, rows and negatives, the TF32 split by cvt.rna, the
gradient kernel's ring, tile rows, slices, passes and row groups, every
row copied by the shifted path, launches that wait for the kernel before
them; each held to the plain version at rtol 1e-5 atol 1e-5, two calls
bit-identical) at SPLIT_SHAPES, the base also without d_vo as the conv
step calls it, beside the plain f32 products.
Times are chip_smoke's cuda_ms (CUDA events around 100 launches, 20 for
the split shapes, queued behind a long product), every variant twice, in
turns; first the card's mma.sync TF32 rate (chip_mma_probe.cu: warps of
1-8 independent accumulators, 1-4 blocks of 8 warps an SM) and ptxas'
registers and spills of each split variant; then each of the split
form's kernels' own time (torch.profiler, the variant whose launches wait
for the kernel before them), also with a part taken out (SPLIT_PARTS:
the logits' products, d_vi's or d_wn's product, two of the three TF32
passes; wrong by design). Variants are written and built
under build/ of the checkout.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import SGNS_SHAPES, cuda_ms

# name -> (text in the source, its replacement)
VARIANTS = {
    "base": None,
    "no second kernel (the partials are not summed)": (
        "  if (n > 0) {\n    // launched while",
        "  if (n < 0) {\n    // launched while"),
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
        "g) * SG + tig;\n        for (int kk = 0; kk < kc_lim; kk += 8) {",
        "g) * SG + tig;\n"
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
# the variant whose kernels each wait for the one before: torch.profiler
# reads each kernel's own time from it
SEQUENTIAL = "each kernel launched after the one before ends"
# the split form's design (D above SPLIT_D): name -> (edits of the source,
# the plan's changes: ops/sgns.py constants, or "sms" for launch_plan's SM
# count, which sets the row groups)
SPLIT = {
    "base: logit blocks of 32 rows x 32 negatives (8 warps), a ring of 2 "
    "stages of 64 columns; gradient slices of 64 "
    "columns, tiles of 32 rows in a ring of 2, passes of 128 negatives, 2 "
    "blocks an SM; dependent launches": ((), {}),
    "a ring of 3 stages": ((("LSTAGES = 2;", "LSTAGES = 3;"),), {}),
    "a ring of 4 stages": ((("LSTAGES = 2;", "LSTAGES = 4;"),), {}),
    "stages of 128 columns": ((("LKS = 64;", "LKS = 128;"),), {}),
    "logit blocks of 4 warps": ((("LTHR = 256;", "LTHR = 128;"),), {}),
    "logit blocks of 64 negatives": ((("LKC = 32;", "LKC = 64;"),),
                                     {"LOGIT_KC": 64}),
    "logit blocks of 16 rows x 64 negatives": (
        (("LTM = 32;", "LTM = 16;"), ("LKC = 32;", "LKC = 64;")),
        {"LOGIT_ROWS": 16, "LOGIT_KC": 64}),
    "logit blocks of 64 rows": ((("LTM = 32;", "LTM = 64;"),),
                                {"LOGIT_ROWS": 64}),
    "TF32 parts by cvt.rna (not cleared bits)": ((
        ("  hi = __float_as_uint(x) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));",
         "  split_tf32(x, hi, lo);"),), {}),
    "a ring of 3 gradient tiles, a block an SM": (
        (("GSTAGES = 2;", "GSTAGES = 3;"), ("GMINB = 2;", "GMINB = 1;")),
        {"GRAD_BLOCKS_PER_SM": 1}),
    "gradient tiles of 64 rows, a block an SM": (
        (("GTM = 32;", "GTM = 64;"), ("GMINB = 2;", "GMINB = 1;")),
        {"GRAD_ROWS": 64, "GRAD_BLOCKS_PER_SM": 1}),
    "gradient slices of 32 columns": ((("GSW = 64;", "GSW = 32;"),),
                                      {"SPLIT_SW": 32}),
    "gradient slices of 128 columns, a block an SM": (
        (("GSW = 64;", "GSW = 128;"), ("GMINB = 2;", "GMINB = 1;")),
        {"SPLIT_SW": 128, "GRAD_BLOCKS_PER_SM": 1}),
    "gradient passes of 64 negatives": ((("GKB = 128;", "GKB = 64;"),),
                                        {"GRAD_KB": 64}),
    "twice the row groups (two waves)": ((), {"sms": 264}),
    "half the row groups": ((), {"sms": 66}),
    "every row copied by the shifted path": ((
        ("if (D > SPLIT_D && D % 4 == 0 &&", "if (D > SPLIT_D && D < 0 &&"),),
        {}),
    SEQUENTIAL: ((("programmaticStreamSerializationAllowed = 1",
                   "programmaticStreamSerializationAllowed = 0"),), {}),
}
# the split form with a part taken out (a result wrong by design; each
# kernel's own time is read, its launches waiting for the kernel before)
SPLIT_PARTS = {
    "sgns_logits: loads only (no product)": (
        "    const float* st = ring + (s % LSTAGES) * STAGE;",
        "    if (P > 0) continue;\n"
        "    const float* st = ring + (s % LSTAGES) * STAGE;"),
    "sgns_grads: no d_vi product": (
        "      // one warp would sum the two halves\n      {",
        "      // one warp would sum the two halves\n      if (P < 0) {"),
    "sgns_grads: no d_wn product": (
        "      // the tile's d_wn share [KB, SW] = g^T . vi, added into the "
        "group's\n      if (m3 < kc_lim) {",
        "      // the tile's d_wn share [KB, SW] = g^T . vi, added into the "
        "group's\n      if (m3 < kc_lim && P < 0) {"),
    "one TF32 pass a product (all kernels)": (
        "  mma_tf32(c, al, bh);\n  mma_tf32(c, ah, bl);\n", ""),
}
# (P, D, kB): the conv step at D 768, 1,025 and 1,536; D 384 and 512, which
# the split form serves since it beat the tile kernel's widest width there
SPLIT_SHAPES = [(2624, 768, 128), (2624, 1025, 128), (2624, 1536, 128),
                (2624, 384, 128), (2624, 512, 128)]


@contextlib.contextmanager
def plan_changes(sgns, changes: dict):
    """ops/sgns.py's plan constants changed for a variant."""
    old = {k: getattr(sgns, k) for k in changes if k != "sms"}
    for k in old:
        setattr(sgns, k, changes[k])
    try:
        yield changes.get("sms", sgns.H100_SMS)
    finally:
        for k, v in old.items():
            setattr(sgns, k, v)


def ptxas_lines(kernel, names) -> list[str]:
    """ptxas' registers and spills of the entry functions whose mangled
    name holds one of `names`."""
    out, keep = [], False
    for line in kernel.build_log.splitlines():
        if "Compiling entry function" in line:
            keep = any(n in line for n in names)
        elif keep and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_sgns_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import ROOT, edited, source_kernel
    from stellar_rw_tpu_torch.ops import _build, sgns
    from stellar_rw_tpu_torch.ops._build import Kernel, ptr, stream

    source = (_build.CSRC / sgns.SGNS_KERNEL.source).read_text()
    out_dir = _build.BUILD_DIR.parent / "sgns_parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    class Variant(Kernel):
        def __init__(self, index: int, edits):
            super().__init__(f"variant_{index}.cu", sgns.SGNS_KERNEL.symbol,
                             sgns.SGNS_KERNEL.argtypes)
            self._path = out_dir / self.source
            self._path.write_text(edited(source, edits))

        @property
        def path(self):
            return self._path

    kernels = {name: Variant(i, [edit] if edit else [])
               for i, (name, edit) in enumerate(VARIANTS.items())}
    split = {name: Variant(len(VARIANTS) + i, edits)
             for i, (name, (edits, _)) in enumerate(SPLIT.items())}
    sequential = SPLIT[SEQUENTIAL][0]
    taken = {name: Variant(len(VARIANTS) + len(SPLIT) + i,
                           [edit, *sequential])
             for i, (name, edit) in enumerate(SPLIT_PARTS.items())}
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), [*kernels.values(),
                                         *split.values(), *taken.values()]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # the card's mma.sync TF32 rate: warps of `chains` independent
    # accumulators, 8 warps a block, 1-4 blocks an SM
    probe = source_kernel(
        "mma_probe", open(os.path.join(ROOT, "chip_mma_probe.cu")).read(),
        "srw_mma_probe", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
        "sgns_parts")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    rates = {}
    for per_sm in (1, 2, 4):
        for chains in (1, 2, 4, 8):
            iters = 4096
            ms = cuda_ms(lambda: probe.launch(
                sms * per_sm, 256, chains, iters, ptr(out),
                stream(out.device)), 5)
            flops = sms * per_sm * 8 * chains * iters * 2 * 16 * 8 * 8
            rates[f"{per_sm} blocks an SM, {chains} chains a warp"] = (
                flops / (ms * 1e-3) / 1e12)
    print(json.dumps({"mma_sync_tf32_tflops": rates, "card": smi}))
    print(json.dumps({"ptxas": {name: ptxas_lines(
        k, ("sgns_logits", "sgns_grads")) for name, k in split.items()},
        "card": smi}, indent=1))

    rng = np.random.default_rng(0)

    def inputs(P, D, kB):
        t = lambda *s: torch.as_tensor(
            (rng.standard_normal(s) * 0.3).astype(np.float32)).cuda()
        vi, vo, wn = t(P, D), t(P, D), t(kB, D)
        valid = torch.as_tensor(rng.random(P) > 0.3).cuda().float()
        return vi, vo, wn, t(P) * valid, valid * 0.125

    def launcher(k, plan, args, write_vo=True):
        """k's launch under `plan` into outputs of its own: (launch,
        (d_vi, d_vo, d_wn))."""
        vi, vo, wn, g_pos, mask = args
        outs = tuple(torch.zeros_like(x) for x in (vi, vo, wn))
        part = torch.empty(plan.part_floats, device="cuda")
        g = torch.empty(max(plan.g_floats, 1), device="cuda")
        P, D = vi.shape
        return lambda: k.launch(
            ptr(vi), ptr(vo), ptr(wn), ptr(g_pos), ptr(mask), ptr(outs[0]),
            ptr(outs[1]) if write_vo else None, ptr(outs[2]), ptr(part),
            ptr(g), P, D, wn.shape[0], plan.partials,
            stream(vi.device)), outs

    P, D, kB = SGNS_SHAPES[0]
    args = inputs(P, D, kB)
    plan = sgns.launch_plan(P, D, kB)
    names = list(kernels)
    fns = {name: launcher(kernels[name], plan, args)[0] for name in names}
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        runs[name].append(cuda_ms(fns[name], 100) * 1e3)
    x = torch.zeros(16, device="cuda")
    floor = cuda_ms(lambda: (x.add_(1), x.add_(1)), 100) * 1e3
    print(json.dumps({"shape": [P, D, kB], "us_in_turns": runs,
                      "two_tiny_torch_launches_us": floor, "card": smi},
                     indent=1))

    base = next(iter(SPLIT))
    for P, D, kB in SPLIT_SHAPES:
        args = inputs(P, D, kB)
        want = sgns.sgns_shared_grads_ref(*args)
        fns = {"plain": lambda: sgns.sgns_shared_grads_ref(*args)}
        err = {}
        for name, (_, changes) in SPLIT.items():
            with plan_changes(sgns, changes) as sms:
                plan = sgns.launch_plan(P, D, kB, sms)
            for label, write_vo in ((name, True),
                                    (name + ", d_vo not written", False)):
                if not write_vo and name != base:
                    continue
                fn, outs = launcher(split[name], plan, args, write_vo)
                fn()
                again = [o.clone() for o in outs]
                fn()
                torch.cuda.synchronize()
                for i, (got, ref) in enumerate(zip(outs, want)):
                    if i == 1 and not write_vo:
                        continue
                    if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5):
                        raise RuntimeError(
                            f"split variant {label!r} differs at "
                            f"{(P, D, kB)}: "
                            f"{float((got - ref).abs().max()):.3g}")
                    if not torch.equal(got, again[i]):
                        raise RuntimeError(f"split variant {label!r} gave "
                                           f"two results at {(P, D, kB)}")
                err[label] = max(float((o - r).abs().max()) for i, (o, r)
                                 in enumerate(zip(outs, want))
                                 if write_vo or i != 1)
                fns[label] = fn
        names = list(fns)
        runs = {name: [] for name in names}
        for name in names + names[::-1]:
            runs[name].append(cuda_ms(fns[name], 20) * 1e3)
        # each kernel's own time where none overlaps the one before it:
        # the design, then with a part taken out
        plan = sgns.launch_plan(P, D, kB)
        seq = {SEQUENTIAL: fns[SEQUENTIAL]}
        seq.update({name: launcher(k, plan, args, False)[0]
                    for name, k in taken.items()})
        each = {}
        for name, fn in seq.items():
            fn()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            each[name] = {sym: e.device_time_total / e.count
                          for e in prof.key_averages()
                          for sym in ("sgns_logits", "sgns_grads",
                                      "reduce_partials") if sym in e.key}
        print(json.dumps({"shape": [P, D, kB], "split_us_in_turns": runs,
                          "each_kernel_us_in_sequence": each,
                          "max_abs_err": err, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
