"""What can be held on the CPU of the two kernels' designs
(stellar_rw_tpu_torch/csrc/sgns_shared.cu, csrc/walk.cu):

  * the three-pass TF32 split of sgns_shared_grads' products, emulated in
    NumPy, meets the kernel's tolerance against f32 where one pass does not;
  * the walk kernel's flat (step, trial) loop with the skipped u_acc draw,
    transcribed for one walker at a time in plain Python integers, gives
    walk_corpus_ref's corpus bit for bit;
  * the wrappers' launch plans stay inside one block's shared memory (the
    shared-negative kernel, the exact-negative kernel's table), and the
    pieces chip_sgns_parts.py, chip_sgns_exact_parts.py, chip_cdf_parts.py,
    chip_conv_parts.py, chip_draws_parts.py, chip_spmm_parts.py and
    chip_hsoftmax_parts.py change in the kernels are in their sources;
  * every entry point defaults to the card, raises the named error without
    one, and runs with device="cpu".
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_cdf_parts
import chip_conv_parts
import chip_draws_parts
import chip_hsoftmax_parts
import chip_sgns_exact_parts
import chip_sgns_parts
import chip_spmm_parts
from stellar_rw_tpu_torch import cli
from stellar_rw_tpu_torch.errors import CudaUnavailable
from stellar_rw_tpu_torch.graph import csr as tcsr
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.models import node2vec as n2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import _build, prng, resident_walk, sampling
from stellar_rw_tpu_torch.ops import cdf_walk, hsoftmax, sgns, sgns_conv
from stellar_rw_tpu_torch.ops import sgns_exact, spmm
from stellar_rw_tpu_torch.ops import trainer_draws, walk_step
from stellar_rw_tpu_torch.utils.config import Params
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)

# the shapes the smoke run holds the kernel to on the card (P, D, kB)
SGNS_SHAPES = [(2624, 128, 128), (300, 50, 37), (7, 128, 256),
               (20000, 128, 128), (1000, 512, 64), (100, 200, 300)]
WALK_PQ = [(0.25, 0.25), (1.0, 1.0), (1.0, 4.0), (4.0, 0.25), (0.5, 1.0)]
M32 = 0xFFFFFFFF


# --- 1. the 3xTF32 split -------------------------------------------------

def _sgns_inputs(P, D, kB, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    vi, vo, wn = t(P, D), t(P, D), t(kB, D)
    valid = (rng.random(P) > 0.3).astype(np.float32)
    return vi, vo, wn, t(P) * valid, valid * np.float32(0.125)


def test_tf32_round_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)          # TF32's spacing in [1, 2)
    x = np.array([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                  -(one + ulp / 2), np.float32(0.3)], dtype=np.float32)
    got = sgns.tf32_round(x)
    want = np.array([one, one, one + ulp, one + ulp, -(one + ulp),
                     np.float32(0.3)], dtype=np.float32)
    np.testing.assert_array_equal(got[:5], want[:5])
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(float(got[5]) - 0.3) <= 0.3 * 2.0 ** -11


@pytest.mark.parametrize("shape", SGNS_SHAPES)
def test_three_tf32_passes_meet_the_tolerance_one_does_not(shape):
    args = _sgns_inputs(*shape)
    want = sgns.sgns_shared_grads_ref(*(torch.as_tensor(a) for a in args))
    three = sgns.sgns_shared_grads_tf32(*args, passes=3)
    one = sgns.sgns_shared_grads_tf32(*args, passes=1)
    for got, ref in zip(three, want):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)
    # d_vo is an elementwise product; the two matrix outputs must miss
    assert not np.allclose(one[0], want[0].numpy(), rtol=1e-5, atol=1e-5)
    assert not np.allclose(one[2], want[2].numpy(), rtol=1e-5, atol=1e-5)


# --- 2. the flat (step, trial) loop ---------------------------------------

def _rotl(v, d):
    return ((v << d) & M32) | (v >> (32 - d))


def _threefry(k0, k1, c0, c1):
    """One threefry-2x32 block on Python integers (csrc/threefry.cuh)."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    x0, x1 = (c0 + k0) & M32, (c1 + k1) & M32
    inject = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3), (k1, ks2, 4),
              (ks2, k0, 5))
    for i, (a, b, n) in enumerate(inject):
        for r in ((13, 15, 26, 6) if i % 2 == 0 else (17, 29, 16, 24)):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + a) & M32
        x1 = (x1 + b + n) & M32
    return x0, x1


def _uniform_at(key, idx):
    o0, o1 = _threefry(key[0], key[1], 0, idx)
    bits = np.uint32(((o0 ^ o1) >> 9) | 0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _alias_draw(alias, start, deg, E, u_pos, u_keep):
    j = int(np.float32(u_pos) * np.float32(deg))
    j = min(j, max(deg - 1, 0))
    row = alias[min(max(start + j, 0), E - 1)]
    return int(row[1]) if u_keep < row[:1].view(np.float32)[0] \
        else int(row[2])


def _is_member(buckets, base, mask, cand):
    h = (cand * int(sampling.HASH_MULT)) & M32
    return cand in buckets[base + (h & mask)].tolist()


def flat_loop_corpus(dg, starts, keys, L, p, q, n_stream):
    """csrc/walk.cu's walk_kernel for one walker at a time: one trial a loop
    turn, the step advanced in the turn that accepts, u_acc drawn only where
    f < max_f. Also returns how many u_acc draws it made."""
    vmeta, alias = dg.vmeta.numpy(), dg.alias_packed.numpy()
    buckets = dg.hash_buckets.numpy()
    E = dg.num_edges
    R, T = keys.shape[0], keys.shape[2]
    W = len(starts)
    Wd = sampling.draw_width(n_stream)
    inv_p, inv_q, max_f, mode = walk_step.bias_constants(p, q)
    keys = (keys.to(torch.int64) & M32).tolist()
    out = np.full((R * W, L + 2), -1, dtype=np.int32)
    acc_draws = 0
    for row in range(R * W):
        r, w = divmod(row, W)
        s = int(starts[w])
        out[row, 0] = s
        vm0 = vmeta[s]
        if vm0[1] <= 0:
            continue
        k = keys[r][0][0]
        cur = _alias_draw(alias, int(vm0[0]), int(vm0[1]), E,
                          _uniform_at(k, w), _uniform_at(k, Wd + w))
        out[row, 1] = cur
        prev, pm, cm = s, vm0, vmeta[cur]
        t, j = 1, 0
        live = L >= 1 and cm[1] > 0
        while live:
            k = keys[r][t][j]
            i_pos, i_keep, i_acc = w, Wd + w, 2 * Wd + w
            if j >= walk_step.DENSE_TRIALS:
                k = _threefry(k[0], k[1], 0, w)
                i_pos, i_keep, i_acc = 0, 1, 2
            cand = _alias_draw(alias, int(cm[0]), int(cm[1]), E,
                               _uniform_at(k, i_pos), _uniform_at(k, i_keep))
            accept = True
            if mode != walk_step.MODE_PQ1:
                if cand == prev:
                    f = inv_p
                elif mode == walk_step.MODE_Q1:
                    f = np.float32(1.0)
                else:
                    f = np.float32(1.0) if _is_member(
                        buckets, int(pm[2]), int(pm[3]), cand) else inv_q
                if f < max_f:
                    acc_draws += 1
                    accept = np.float32(_uniform_at(k, i_acc) * max_f) < f
            if accept or j == T - 1:
                out[row, t + 1] = cand
                prev, cur, pm = cur, cand, cm
                t, j = t + 1, 0
                if t > L:
                    live = False
                else:
                    cm = vmeta[cur]
                    live = cm[1] > 0
            else:
                j += 1
    return out, acc_draws


def _small_power_law(num_vertices=48, num_edges=300, seed=3):
    rng = np.random.default_rng(seed)
    draw = lambda: np.minimum(
        (num_vertices * rng.random(num_edges) ** (1 / 0.3)).astype(np.int64),
        num_vertices - 1)
    src, dst = draw(), draw()
    keep = src != dst
    return tcsr.from_edge_arrays(src[keep], dst[keep],
                                 num_vertices=num_vertices, symmetrize=True)


@pytest.fixture(scope="module")
def walk_graphs(karate_path):
    data = os.path.dirname(karate_path)
    return {
        "karate": tio.load_edge_list(karate_path, weighted=False,
                                     directed=False),
        "testgraph": tio.load_edge_list(os.path.join(data, "testgraph.txt"),
                                        weighted=False, directed=True),
        "powerlaw": _small_power_law(),
    }


@pytest.mark.parametrize("pq", WALK_PQ)
@pytest.mark.parametrize("name", ["karate", "testgraph", "powerlaw"])
def test_flat_trial_loop_equals_the_plain_version(walk_graphs, name, pq):
    g = walk_graphs[name]
    p, q = pq
    L, R = 8, 2
    dg = sampling.device_put_graph(g, "cpu")
    V = g.num_vertices
    starts = torch.arange(V, dtype=torch.int32)
    _, max_rounds = sampling.plan_sampler("rejection", p, q)
    keys = walk_step.trial_keys(prng.prng_key(11), 0, R, L, 4 * max_rounds)
    counts = {}
    want = walk_step.walk_corpus_ref(dg, starts, keys, L, p, q, V,
                                     counts=counts)
    got, acc_draws = flat_loop_corpus(dg, starts.numpy(), keys, L, p, q, V)
    np.testing.assert_array_equal(got, want.numpy())
    # the plain version counts the draws the loop needs, and its per-walker
    # totals are the turns the loop ran
    assert acc_draws == counts["acc_draws"]
    trials = counts["dense_trials"] + counts["lane_trials"]
    assert int(counts["walker_trials"].sum()) == trials
    assert acc_draws <= trials
    warp_total = int(walk_step.warp_max(counts["walker_trials"]).sum())
    assert warp_total <= counts["step_warp_max"] <= trials


def test_key_table_is_int32_bits_of_the_chain():
    keys = walk_step.trial_keys_ref(prng.prng_key(5), 3, 2, 4, 6)
    assert keys.dtype == torch.int32 and keys.shape == (2, 5, 6, 2)
    assert torch.equal(
        walk_step.trial_keys(prng.prng_key(5), 3, 2, 4, 6, device="cpu"),
        keys)
    assert bool((keys < 0).any())       # words above 2**31 keep their bits
    words = keys.numpy().view(np.uint32)
    for r, t, j in ((0, 0, 0), (1, 4, 5)):
        k = prng.prng_key(5).tolist()
        for d in (3 + r, t, j):
            k = _threefry(k[0], k[1], 0, d)
        assert words[r, t, j].tolist() == list(k)


# --- 3. launch plans -------------------------------------------------------

@pytest.mark.parametrize("shape", SGNS_SHAPES + [(1, 1, 1), (5000, 512, 512),
                                                 (31, 37, 129), (0, 128, 128)])
def test_sgns_launch_plan_fits_one_block(shape):
    P, D, kB = shape
    plan = sgns.launch_plan(P, D, kB)
    assert plan.smem_bytes <= sgns.SMEM_LIMIT
    assert plan.dp >= D and plan.dp % 32 == 0 and plan.kc % 32 == 0
    assert plan.dp * plan.kc <= 64 * 256      # the partial's registers
    assert plan.tiles * sgns.TILE_ROWS >= P > (plan.tiles - 1) * \
        sgns.TILE_ROWS or P == 0
    assert plan.blocks == min(plan.tiles, sgns.H100_SMS)
    assert plan.chunks * plan.kc >= kB > (plan.chunks - 1) * plan.kc
    assert plan.wn_placement == ("whole" if kB <= plan.kc else "chunks")
    assert plan.part_floats == max(plan.blocks, 1) * kB * D


def test_sgns_launch_plan_at_the_main_shape():
    plan = sgns.launch_plan(2624, 128, 128)
    assert plan == sgns.LaunchPlan(dp=128, kc=128, presplit=True, chunks=1,
                                   tiles=82, blocks=82, smem_bytes=202_752,
                                   wn_placement="whole",
                                   part_floats=82 * 128 * 128)
    assert sgns.launch_plan(20000, 128, 128).blocks == 132
    assert sgns.launch_plan(1000, 512, 64) == sgns.LaunchPlan(
        512, 32, False, 2, 32, 32, 136_704, "chunks", 32 * 64 * 512)


@pytest.mark.parametrize("shape", [(8, 0, 4), (-1, 513, 4), (8, 4, 0)])
def test_sgns_launch_plan_refuses(shape):
    with pytest.raises(ValueError):
        sgns.launch_plan(*shape)


@pytest.mark.parametrize("D,slices", [(513, 3), (768, 3), (1024, 4),
                                      (1536, 6), (3000, 12)])
def test_sgns_launch_plan_slices_any_dim(D, slices):
    """Above D = 512 the kernel runs its tiles over column slices of 256
    with 64 negatives a chunk (sgns_shared_sliced): f32 tiles, a d_wn
    partial of 64 floats a thread, any D."""
    for P, kB in ((2624, 128), (7, 256), (1, 1)):
        plan = sgns.launch_plan(P, D, kB)
        assert (plan.dp, plan.kc, plan.presplit) == sgns.SLICED
        assert plan.slices == slices and plan.slices * plan.dp >= D
        assert plan.smem_bytes == 4 * ((32 + 64) * 260 + 32 * 68)
        assert plan.smem_bytes <= sgns.SMEM_LIMIT
        assert plan.dp * plan.kc <= 64 * 256
        assert plan.chunks == -(-kB // 64)
        assert plan.part_floats == plan.blocks * kB * D
    assert sgns.launch_plan(2624, 768, 128) == sgns.LaunchPlan(
        256, 64, False, 2, 82, 82, 108_544, "chunks", 82 * 128 * 768, 3)
    assert all(sgns.launch_plan(100, D, 64).slices == 1 for D in (1, 64, 512))


SGNS_EDITS = {**chip_sgns_parts.VARIANTS, **chip_sgns_parts.SLICED}


@pytest.mark.parametrize("name", [n for n, edit in SGNS_EDITS.items()
                                  if edit])
def test_sgns_parts_variant_edits_the_source_once(name):
    """chip_sgns_parts.py patches the kernel by text: each piece must occur
    exactly once in csrc/sgns_shared.cu, and its replacement must differ."""
    old, new = SGNS_EDITS[name]
    source = (_build.CSRC / sgns.SGNS_KERNEL.source).read_text()
    assert source.count(old) == 1 and new != old


@pytest.mark.parametrize("D", [32, 128, 512, 768, 1024, 3000])
def test_sgns_exact_launch_plan_fits_one_block(D):
    """K4 at the main block (B 32, T 82, w 10, k 5) on 132 SMs: one wave of
    two persistent blocks an SM covering the positions, a table of
    TABLE_ROWS rows (fewer where half an SM's shared memory holds fewer:
    at large D); a row is one slice of registers up to D = 32 * nv."""
    B, T, win, k = 32, 82, 10, 5
    budget = 233_472 // 2 - 1_024
    row_bytes = 8 + 4 * (-(-D // 32) * 32)
    assert sgns_exact.slot_bytes(D) == row_bytes
    assert sgns_exact.TABLE_BUDGET == budget
    plan = sgns_exact.launch_plan(D, B, T, win, k)
    assert plan.slots == min(sgns_exact.TABLE_ROWS, budget // row_bytes) >= 9
    assert plan.smem_bytes == plan.slots * row_bytes <= budget
    assert plan.blocks <= 2 * 132 and plan.blocks * plan.positions >= B * T
    assert (plan.blocks - 1) * plan.positions < B * T
    assert plan.threads == sgns_exact.THREADS
    assert plan.nv == (1 if D <= 32 else 4)
    assert plan.slices == -(-D // (32 * plan.nv))


def test_sgns_exact_launch_plan_small_blocks(monkeypatch):
    """A block of few positions: a block a position, and a table no larger
    than twice the rows a position can touch."""
    plan = sgns_exact.launch_plan(16, 7, 30, 3, 2, sm_count=132)
    assert plan.blocks == 210 and plan.positions == 1
    assert plan.slots == 16
    monkeypatch.setattr(sgns_exact, "TABLE_ROWS", 1 << 20)
    big = sgns_exact.launch_plan(16, 7, 30, 3, 2)
    assert big.slots == 2 * (2 * 3 * 3 + 1)
    with pytest.raises(ValueError):
        sgns_exact.launch_plan(0, 32, 82, 10, 5)
    source = (_build.CSRC / sgns_exact.SGNS_EXACT_STEP.source).read_text()
    assert (f"constexpr int kMinBlocks = {sgns_exact.BLOCKS_PER_SM};"
            in source)


@pytest.mark.parametrize("name", [n for n, edits in
                                  chip_sgns_exact_parts.VARIANTS.items()
                                  if edits])
def test_sgns_exact_parts_variant_edits_the_source_once(name):
    """chip_sgns_exact_parts.py patches the kernel by text: each piece must
    occur exactly once in csrc/sgns_exact.cu, and its replacement must
    differ."""
    source = (_build.CSRC / sgns_exact.SGNS_EXACT_STEP.source).read_text()
    for old, new in chip_sgns_exact_parts.VARIANTS[name]:
        assert source.count(old) == 1 and new != old


@pytest.mark.parametrize("name", [n for n, edits in
                                  chip_draws_parts.VARIANTS.items()
                                  if edits])
def test_draws_parts_variant_edits_the_source_once(name):
    """chip_draws_parts.py patches csrc/trainer_draws.cu by text: each piece
    must occur exactly once in the source, and its replacement must
    differ."""
    source = (_build.CSRC / trainer_draws.TRAINER_DRAWS_KERNEL.source
              ).read_text()
    for old, new in chip_draws_parts.VARIANTS[name]:
        assert source.count(old) == 1 and new != old


@pytest.mark.parametrize("name", [n for n, edits in
                                  chip_cdf_parts.VARIANTS.items() if edits])
def test_cdf_parts_variant_edits_the_source_once(name):
    """chip_cdf_parts.py patches csrc/cdf_walk.cu by text, one piece after
    the other: each piece must occur exactly once in the text as the pieces
    before it left it, and its replacement must differ."""
    text = (_build.CSRC / cdf_walk.CDF_WALK_KERNEL.source).read_text()
    for old, new in chip_cdf_parts.VARIANTS[name]:
        assert text.count(old) == 1 and new != old
        text = text.replace(old, new)


@pytest.mark.parametrize("name", [
    n for n, edits in [*chip_conv_parts.VARIANTS.items(),
                       *chip_conv_parts.CLUSTER_VARIANTS.items()] if edits])
def test_conv_parts_variant_edits_the_source_once(name):
    """chip_conv_parts.py patches csrc/sgns_conv.cu, or the cluster design
    it appends to it (chip_conv_cluster.cu), by text: each piece must occur
    exactly once in its source, and its replacement must differ; the
    cluster design's entry points are in its file and not in the kernel
    source."""
    source = (_build.CSRC / sgns_conv.SGNS_CONV_ACCUMULATE.source
              ).read_text()
    cluster = (Path(chip_conv_parts.__file__).parent
               / chip_conv_parts.CLUSTER_SOURCE).read_text()
    edits = chip_conv_parts.VARIANTS.get(name)
    text = source if edits is not None else cluster
    for old, new in edits or chip_conv_parts.CLUSTER_VARIANTS[name]:
        assert text.count(old) == 1 and new != old
        text = text.replace(old, new)
    for symbol in ("srw_sgns_conv_accumulate_cluster_launch",
                   "srw_sgns_conv_max_clusters"):
        assert f"extern \"C\" int {symbol}(" in cluster
        assert symbol not in source


PARTS_OF = {
    "spmm": (chip_spmm_parts, chip_spmm_parts.VARIANTS,
             spmm.SPMM_SEGMENT_SUM),
    "sddmm": (chip_spmm_parts, chip_spmm_parts.SDDMM_VARIANTS,
              spmm.SPMM_SDDMM),
    "softmax": (chip_spmm_parts, chip_spmm_parts.SOFTMAX_VARIANTS,
                spmm.SPMM_ROW_SOFTMAX),
    "hsoftmax": (chip_hsoftmax_parts, chip_hsoftmax_parts.VARIANTS,
                 hsoftmax.HS_STEP)}


@pytest.mark.parametrize("script,name", [
    (s, n) for s, (_, table, _) in PARTS_OF.items()
    for n, edits in table.items() if edits])
def test_spmm_and_hs_parts_variant_edits_the_source_once(script, name):
    """chip_spmm_parts.py (the segment sum's, the SDDMM's and the row
    softmax's variants) and chip_hsoftmax_parts.py patch csrc/spmm.cu and
    csrc/hsoftmax.cu by text: each piece must occur exactly once in the
    source, and its replacement must differ. A part taken out is named
    so (its tables are wrong by design and are not held to float64)."""
    mod, table, kernel = PARTS_OF[script]
    source = (_build.CSRC / kernel.source).read_text()
    for old, new in table[name]:
        assert source.count(old) == 1 and new != old
    assert (name in mod.WRONG_BY_DESIGN) == name.startswith("taken out")


def test_hs_parts_tensor_core_variant_plan():
    """chip_hsoftmax_mma.cu (the products on the tensor cores) runs under
    the base plan's tile and blocks: at phase 19's block (tiles of 32, two
    blocks an SM, 20 levels) its layout fits the same budget; it takes no
    D over 128, and its chunk is the base kernel's."""
    mod = chip_hsoftmax_parts
    source = (Path(mod.__file__).parent / mod.MMA_SOURCE).read_text()
    assert f"constexpr int kChunk = {mod.CHUNK};" in source
    assert mod.CHUNK == hsoftmax.CHUNK
    assert "D > 128" in source and "8 * E + 1" in source
    base = hsoftmax.launch_plan(128, 256, 82, 10, levels=20)
    plan = mod.mma_plan(base, 10, 128, 20)
    assert plan._replace(smem_bytes=base.smem_bytes) == base
    assert plan.smem_bytes == mod.mma_smem_bytes(32, 10, 128, 20) == 4 * (
        2 * 64 * 132 + 32 * 132 + 64 * 36 + 3 * 52 + 64 + 8 * 640 + 1)
    assert plan.smem_bytes <= hsoftmax.SMEM_BUDGETS[0][1]
    assert mod.mma_plan(base, 10, 200, 20) is None
    assert mod.mma_plan(base._replace(tile=32), 10, 128, 200) is None


def test_spmm_parts_blocks_an_sm_follow_the_source():
    """A variant that changes the segment sum's blocks an SM is launched on
    the grid of that many: the base source's count is the wrapper's."""
    source = (_build.CSRC / spmm.SPMM_SEGMENT_SUM.source).read_text()
    assert (f"constexpr int kSegBlocks = {spmm.SEGMENT_BLOCKS_PER_SM};"
            in source)
    assert f"constexpr int kRun = {spmm.RUN};" in source
    assert f"constexpr int kFan = {spmm.FAN};" in source
    for name, edits in chip_spmm_parts.VARIANTS.items():
        n = chip_spmm_parts.blocks_per_sm(edits)
        assert (n is None) == (not name.endswith("blocks an SM"))
    hs_source = (_build.CSRC / hsoftmax.HS_STEP.source).read_text()
    assert f"constexpr int kGroup = {hsoftmax.KGROUP};" in hs_source
    assert "constexpr int kChunk = kWarps * kGroup;" in hs_source
    assert hsoftmax.CHUNK == hsoftmax.THREADS // 32 * hsoftmax.KGROUP


# --- 4. default devices ----------------------------------------------------

@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _karate(karate_path):
    return tio.load_edge_list(karate_path, weighted=False, directed=False)


ENTRY_POINTS = {
    "random_walks": lambda g, kw: engine.random_walks(
        g, walk_length=4, num_walks=1, **kw),
    "resident_walks": lambda g, kw: resident_walk.resident_walks(
        g, 4, 1, 0.5, 2.0, **kw),
    "train_skipgram": lambda g, kw: w2v.train_skipgram(
        np.arange(12, dtype=np.int32).reshape(3, 4) % g.num_vertices,
        g.num_vertices, w2v.SGNSConfig(dim=8, window=2, iters=1), **kw),
    "train_skipgram_streaming": lambda g, kw: w2v.train_skipgram_streaming(
        lambda r: torch.arange(12, dtype=torch.int32).reshape(3, 4) % (r + 2),
        2, (3, 4), g.num_vertices, w2v.SGNSConfig(dim=8, window=2, iters=1),
        np.ones(g.num_vertices), **kw),
    "run_walks": lambda g, kw: n2v.run_walks(
        g, Params(walk_length=4, num_walks=1), **kw),
    "embed_walks": lambda g, kw: n2v.embed_walks(
        np.arange(12, dtype=np.int32).reshape(3, 4), g,
        Params(w2v_dim=8, w2v_window=2, w2v_iter=1), **kw),
    "embed_token_corpus": lambda g, kw: n2v.embed_token_corpus(
        [["a", "b", "c"], ["b", "c", "a"]],
        Params(w2v_dim=8, w2v_window=2, w2v_iter=1), **kw),
    "embed_ragged_corpus": lambda g, kw: n2v.embed_ragged_corpus(
        np.array([3, 1, 2, 1, 3], dtype=np.int64),
        np.array([0, 3, 5], dtype=np.int64),
        Params(w2v_dim=8, w2v_window=2, w2v_iter=1), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(karate_path, no_gpu, name):
    g = _karate(karate_path)
    with pytest.raises(CudaUnavailable, match='device="cpu"'):
        ENTRY_POINTS[name](g, {})
    out = ENTRY_POINTS[name](g, {"device": "cpu"})
    assert out is not None


def test_cli_defaults_to_the_card(karate_path, no_gpu, tmp_path):
    assert cli.CudaUnavailable is CudaUnavailable
    argv = ["--cmd", "randomwalk", "--input", karate_path, "--output",
            str(tmp_path / "out"), "--walkLength", "4", "--numWalks", "1"]
    with pytest.raises(CudaUnavailable, match="no CUDA device"):
        cli.main(argv)
    assert cli.main(argv, device="cpu") == 0
