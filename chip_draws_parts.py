#!/usr/bin/env python3
"""Where the trainer draws kernel's time goes on one GPU, beside the card's
rate for its integer mix.

    python3 chip_draws_parts.py

First the probe: threefry blocks with no memory traffic
(chip_draws_probe.cu), in threefry.cuh's form as the walk kernels compile
it and in csrc/trainer_draws.cu's block_fn (its adds as IMAD on the FMA
pipe), as blocks a second. Then each variant of csrc/trainer_draws.cu: the
source with pieces of text replaced (VARIANTS; a piece that is not exactly
once in the source stops the script, so the list is kept beside the
kernel), built under build/ of the checkout with the probe and
chip_draws_ahead.cu appended, held bit for bit to trainer_draws_ref on
both chunks, and timed on the main path's chunks: the conv trainer's
(1,524 blocks of 2,624 windows and 128 negatives) and the exact trainer's
(15 blocks of 2,624 windows and 262,400 negatives), every variant twice,
in turns (chip_smoke's cuda_ms). Each variant's probe rates are printed
beside it (a variant of block_fn changes the probe's form 1). Then the
base kernel under runs of 2,048 elements, as the parent design cut a
block's draws, and the first design (chip_draws_ahead.cu: persistent
blocks that make the next item's keys ahead, its own entry point) under
one item a block, one wave of persistent blocks and runs of 2,048. One
JSON object a line, the card's name and power limit in each, and ptxas'
registers of every variant. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import (DRAWS_BLOCKS_PER_SM, OPS_PER_DRAW, PROBE_ARGTYPES,
                        PROBE_SYMBOL, ROOT, check, cuda_ms, draw_tables,
                        edited, probe_rates, source_kernel, with_probe)

# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "base": [],
    "runtime % by the span (the parent's modulo)": [
        ("  const uint32_t t = __umulhi(s.magic, v);\n"
         "  const uint32_t q = (t + ((v - t) >> s.sh1)) >> s.sh2;\n"
         "  return v - q * s.span;",
         "  return v % s.span;")],
    "plain adds (no IMAD)": [
        ("  return y * one + x;", "  return x + y;")],
    "runtime % and plain adds": [
        ("  const uint32_t t = __umulhi(s.magic, v);\n"
         "  const uint32_t q = (t + ((v - t) >> s.sh1)) >> s.sh2;\n"
         "  return v - q * s.span;",
         "  return v % s.span;"),
        ("  return y * one + x;", "  return x + y;")],
    # the parent's prologue: four threads, each key a chain of its own (kb
    # made four times, fold_in(kn, 1) after kn again: nine threefry blocks)
    "keys by four threads, a chain each (the parent's prologue)": [
        ("  if (threadIdx.x < 32) make_keys(key, static_cast<uint32_t>(c0 + "
         "y), keys);\n",
         "  if (threadIdx.x < 4) {\n"
         "    const uint32_t t = threadIdx.x;\n"
         "    const uint2 kb = srw::threefry(static_cast<uint32_t>(key[0]),\n"
         "                                   static_cast<uint32_t>(key[1]),"
         " 0u,\n"
         "                                   static_cast<uint32_t>(c0 + y));"
         "\n"
         "    const uint2 k = srw::threefry(kb.x, kb.y, 0u, t < 3 ? t : 2u);"
         "\n"
         "    keys[t] = t < 3 ? k : srw::threefry(k.x, k.y, 0u, 1u);\n"
         "  }\n")],
}
# persistent blocks that make the next item's keys ahead (this kernel's
# first design), appended to every variant's source with its own entry point
AHEAD_SOURCE = "chip_draws_ahead.cu"
AHEAD_SYMBOL = "srw_trainer_draws_ahead_launch"
# the main path's chunks: (name, negatives a pair or None, kB or None)
CHUNKS = [("conv", None, 128), ("exact", 5, None)]
B, T, WIN = 32, 82, 10


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_draws_parts: torch sees no CUDA device", file=sys.stderr)
        return 2
    from stellar_rw_tpu_torch.models.word2vec import _DRAW_BUDGET
    from stellar_rw_tpu_torch.ops import _build as build
    from stellar_rw_tpu_torch.ops import prng
    from stellar_rw_tpu_torch.ops import trainer_draws as td

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say = lambda **kw: print(json.dumps({**kw, "card": smi}), flush=True)
    source = (build.CSRC / td.TRAINER_DRAWS_KERNEL.source).read_text()
    with open(os.path.join(ROOT, AHEAD_SOURCE)) as f:
        ahead_text = f.read()
    # the ahead entry point: the kernel's arguments and `blocks` after `per`
    args = td.TRAINER_DRAWS_KERNEL.argtypes
    ahead_args = args[:11] + [ctypes.c_int] + args[11:]

    # each variant's draws kernel, its probe and the ahead design, from one
    # library
    probes, kernels = {}, {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = with_probe(edited(source, edits)) + "\n" + ahead_text
        probes[name] = source_kernel(f"variant_{i}", text, PROBE_SYMBOL,
                                     PROBE_ARGTYPES, "draws_parts")
        kernels[name] = source_kernel(
            f"variant_{i}", text, td.TRAINER_DRAWS_KERNEL.symbol,
            td.TRAINER_DRAWS_KERNEL.argtypes, "draws_parts")
    ahead = source_kernel("variant_0", with_probe(source) + "\n" + ahead_text,
                          AHEAD_SYMBOL, ahead_args, "draws_parts")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: k.fn(), probes.values()))
    for name, k in kernels.items():
        k.fn()
        say(variant=name, ptxas=[
            line.split(":", 1)[-1].strip()
            for line in probes[name].build_log.splitlines()
            if "registers" in line or "spill" in line])
    ahead.fn()

    key = prng.fold_in(prng.prng_key(1), 0).cuda()
    keep, alias = draw_tables(torch, 10_000, 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {name: probe_rates(torch, p) for name, p in probes.items()}
    say(probe_blocks_per_s=rates)
    for chunk, k, kB in CHUNKS:
        shape = (kB,) if kB else (B * T * 2 * WIN, k)
        M = int(np.prod(shape))
        n = min(3125, _DRAW_BUDGET // (M + B * T))
        want = td.trainer_draws_ref(key, 0, n, B, T, WIN, shape, keep, alias)
        cwin = torch.empty((n, B, T), dtype=torch.int32, device="cuda")
        negs = torch.empty((n,) + shape, dtype=torch.int32, device="cuda")
        draws = n * (2 * (B * T + M) + 5)

        def launch(kernel, plan, blocks=()):
            def run():
                kernel.launch(build.ptr(key), 0, n, B * T, M, WIN,
                              *td.span_magic(WIN), plan.runs, plan.per,
                              *blocks, build.ptr(keep), build.ptr(alias),
                              keep.shape[0], build.ptr(cwin), build.ptr(negs),
                              build.stream(key.device))
            return run

        def held(kernel, plan, blocks=()):
            cwin.fill_(-7)
            negs.fill_(-7)
            launch(kernel, plan, blocks)()
            torch.cuda.synchronize()
            return torch.equal(cwin, want[0]) and torch.equal(negs, want[1])

        base_plan = td.launch_plan(n, B * T, M)
        for name, kernel in kernels.items():
            check(held(kernel, base_plan), f"variant {name!r} differs from "
                  f"trainer_draws_ref on the {chunk} chunk")
        names = list(kernels)
        turns = {name: [] for name in names}
        for name in names + names[::-1]:
            turns[name].append(cuda_ms(launch(kernels[name], base_plan), 5))
        say(chunk=chunk, blocks=n, elements=n * (B * T + M), draws=draws,
            ops_per_draw=OPS_PER_DRAW, plan=base_plan._asdict(),
            ms_in_turns=turns,
            ms_at_the_probe_rate={
                name: {form: draws / r * 1e3 for form, r in rate.items()}
                for name, rate in rates.items()})
        # other plans: runs of 2,048 elements (the parent's cut), and the
        # ahead design (persistent blocks over the n * runs items)
        total = B * T + M
        cut = td.DrawPlan(-(-total // (td.THREADS * td.PER_THREAD)),
                          td.PER_THREAD)
        items, cut_items = n * base_plan.runs, n * cut.runs
        wave = sms * DRAWS_BLOCKS_PER_SM
        plans = {
            "base; launch_plan (one run a thread block)":
                (kernels["base"], base_plan, ()),
            "base; runs of 2,048 elements (the parent's cut)":
                (kernels["base"], cut, ()),
            "ahead; launch_plan's runs, one item a block":
                (ahead, base_plan, (items,)),
            "ahead; launch_plan's runs, one wave of persistent blocks":
                (ahead, base_plan, (min(items, wave),)),
            "ahead; runs of 2,048 elements, one item a block":
                (ahead, cut, (cut_items,))}
        by_plan = {}
        for label, (kernel, plan, blocks) in plans.items():
            check(held(kernel, plan, blocks), f"{label!r} differs from "
                  f"trainer_draws_ref ({chunk} chunk)")
            grid = blocks[0] if blocks else n * plan.runs
            by_plan[label] = [{**plan._asdict(), "blocks": grid}, [
                cuda_ms(launch(kernel, plan, blocks), 5) for _ in (0, 1)]]
        say(chunk=chunk, ms_by_plan=by_plan)
    return 0


if __name__ == "__main__":
    sys.exit(main())
