"""The exact-negative SGNS step (ops/sgns_exact.py) against the JAX
package's _sgns_apply: the plain version on a block where rows collide (a
vertex is a center and a target of other pairs, targets repeat), a NumPy
transcription of the kernel's arithmetic (gradients from the old tables
into compact delta slots, a grid barrier, then the touched rows updated by
sum-then-divide and the workspace emptied), the karate gates with exact
negatives, the kernel wrapper without a build, and the launch plan within
what a cooperative launch admits.

Tolerance rtol 1e-5 / atol 1e-6 on the tables after a step: the same pairs,
windows and negatives bit for bit; only the order of the sums differs
(einsum against a warp reduction and atomics, and the scatter-mean divided
after the sum instead of before). JAX runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.models import eval as tev
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import _build, sgns_exact
from stellar_rw_tpu_torch.ops.alias import build_alias
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)


def _case(V, D, B, T, win, k, seed):
    """Tables, a block with padding over a small vocabulary (so rows
    collide), and the JAX package's windows and negatives for it."""
    rng = np.random.default_rng(seed)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[-1, T - 3:] = -1
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        cwin = np.asarray(jax.random.randint(key, (B, T), 1, win + 1))
        keep, alias = build_alias(np.bincount(block[block >= 0],
                                              minlength=V) + 1.0)
        negs = np.asarray(jw2v._draw_negatives(
            jax.random.fold_in(key, 2), (B * T * 2 * win, k),
            jnp.asarray(keep), jnp.asarray(alias)))
    return w_in, w_out, block, cwin.astype(np.int32), negs, key


def _jax_step(w_in, w_out, block, key, negs, win, lr):
    with jax.enable_x64(False):
        c, x, v = jw2v._pairs_for_block(jnp.asarray(block), key, win)
        a_in, a_out = jw2v._sgns_apply(jnp.asarray(w_in), jnp.asarray(w_out),
                                       c, x, v, jnp.asarray(negs),
                                       jnp.float32(lr))
    return np.asarray(a_in), np.asarray(a_out)


GROUP, PROBES, IN_BIT = 3, 2, 1 << 31     # csrc/sgns_exact.cu's constants


def _slot_layout(block, cwin, negs):
    """The kernel's view of one block ([B, T]) or of S slots' ([S, B, T]):
    flat arrays, each slot's first element and the slot strides."""
    block, cwin, negs = (np.asarray(x) for x in (block, cwin, negs))
    if block.ndim == 2:
        block, cwin, negs = block[None], cwin[None], negs[None]
    S, B, T = block.shape
    return dict(S=S, B=B, T=T, k=negs.shape[-1], block=block.ravel(),
                cwin=cwin.ravel(), negs=negs.ravel(), base=(0, 0, 0),
                stride=(B * T, B * T, negs[0].size))


def _kernel_arithmetic(w_in, w_out, block, cwin, negs, win, lr, plan,
                       group=GROUP, layout=None, reads=None):
    """csrc/sgns_exact.cu's one kernel in NumPy under a launch plan, on a
    workspace laid out as ops/sgns_exact.py::Workspace, over one block or
    the S slots of a merged update (block [S, B, T]; or `layout`, the
    kernel's flat view: each slot's block, windows and negatives at a base
    plus the slot times a stride, as _slot_layout makes it). Phase (a)
    block by block: each block's warps over contiguous runs of the (position,
    offset) pairs of all the slots' positions (position p in slot p // BT),
    a pair's targets in groups of `group`: every gradient row added into
    the block's open-addressing table (key: the row, IN_BIT for w_in's; at
    most PROBES probes from the kernel's multiplicative hash) or, on a
    miss, into the row's compact delta slot (a row-to-slot map, -1 when
    free, a list of slot rows and a count of slots taken); the occupied
    slots flushed into the delta slots at the block's end. Only the old
    tables are read. Then the grid barrier, and phase (b): the grid's warps
    stride over the listed slots (w_in's first), a row a warp, each row
    updated and its slot, count and map entry emptied. Phase (c): a second
    grid barrier, then block 0 zeroes the slot counts. `reads`, a list,
    gets (slot, flat index) of every read of a block. Returns the tables,
    the listed rows, the table's stats and the workspace."""
    lay = layout or _slot_layout(block, cwin, negs)
    S, T, k = lay["S"], lay["T"], lay["k"]
    BT = lay["B"] * T
    V, D = w_in.shape
    W2 = 2 * win
    (bb0, cb0, nb0), (sb, sc, sn) = lay["base"], lay["stride"]

    def blk(slot, q):
        i = bb0 + slot * sb + q
        if reads is not None:
            reads.append((slot, i))
        return lay["block"][i]

    rows = (min(V, S * BT), min(V, S * BT * W2 * (1 + k)))
    ws = dict(d=[np.zeros((r, D), np.float32) for r in rows],
              cnt=[np.zeros(r, np.int64) for r in rows],
              map=[np.full(V, -1, np.int64) for _ in rows],
              list=[np.zeros(r, np.int64) for r in rows],
              counts=np.zeros(2, np.int64))
    stats = dict(hits=0, misses=0, flushed=0)

    def claim(t, row):
        if ws["map"][t][row] < 0:
            slot = ws["counts"][t]
            ws["counts"][t] += 1
            ws["map"][t][row] = slot
            ws["list"][t][slot] = row
        return ws["map"][t][row]

    for b0 in range(plan.blocks):
        C = plan.slots
        keys = np.full(C, -1, np.int64)
        tcnt = np.zeros(C, np.int64)
        tab = np.zeros((C, D), np.float32)

        def add(t, row, vec, n):
            row = int(row)
            key = row | IN_BIT if t == 0 else row
            h = ((key * 2654435761) % 2**32 * C) >> 32 if C else 0
            for _ in range(PROBES if C else 0):
                if keys[h] in (-1, key):
                    keys[h] = key
                    tab[h] += vec
                    tcnt[h] += n
                    stats["hits"] += 1
                    return
                h = (h + 1) % C
            stats["misses"] += 1
            g = claim(t, row)
            ws["d"][t][g] += vec
            ws["cnt"][t][g] += n

        p0 = b0 * plan.positions
        n = max(0, min(S * BT - p0, plan.positions)) * W2
        nw = plan.threads // 32
        for warp in range(nw):
            pos, nvalid, dvi = -1, 0, None
            for it in range(n * warp // nw, n * (warp + 1) // nw):
                p, o = p0 + it // W2, it % W2
                if p != pos:
                    if nvalid:
                        add(0, center, dvi, nvalid)
                    pos, nvalid = p, 0
                    slot, q = divmod(p, BT)
                    t = q % T
                    center = blk(slot, q)
                    win_p = lay["cwin"][cb0 + slot * sc + q]
                    dvi = np.zeros(D, np.float32)
                off = o - win if o < win else o - win + 1
                tc = t + off
                if (center < 0 or abs(off) > win_p or not 0 <= tc < T
                        or blk(slot, q - t + tc) < 0):
                    continue
                nvalid += 1
                vi = w_in[center]
                ng0 = nb0 + slot * sn + (q * W2 + o) * k
                targets = ([blk(slot, q - t + tc)]
                           + list(lay["negs"][ng0:ng0 + k]))
                for gb in range(0, k + 1, group):
                    grp = targets[gb:gb + group]
                    vo = w_out[grp]
                    g = (np.float32(1) / (np.float32(1) + np.exp(
                        -(vo @ vi)))).astype(np.float32)
                    if gb == 0:
                        g[0] -= np.float32(1)
                    dvi += (g[:, None] * vo).sum(0, dtype=np.float32)
                    for tgt, gj in zip(grp, g):
                        add(1, tgt, gj * vi, 1)
            if nvalid:
                add(0, center, dvi, nvalid)
        for h in np.flatnonzero(keys >= 0) if C else []:
            t = 0 if keys[h] & IN_BIT else 1
            g = claim(t, int(keys[h] & ~IN_BIT))
            ws["d"][t][g] += tab[h]
            ws["cnt"][t][g] += tcnt[h]
            stats["flushed"] += 1
    # (b) after the grid barrier
    listed = [ws["list"][t][:ws["counts"][t]].tolist() for t in (0, 1)]
    out = [w.copy() for w in (w_in, w_out)]
    n_in = ws["counts"][0]
    n = n_in + ws["counts"][1]
    warps = plan.blocks * (plan.threads // 32)
    for warp in range(warps):
        for item in range(warp, n, warps):
            t = 0 if item < n_in else 1
            slot = item if t == 0 else item - n_in
            r = ws["list"][t][slot]
            out[t][r] += (np.float32(-lr) * ws["d"][t][slot]) / np.float32(
                max(ws["cnt"][t][slot], 1))
            ws["d"][t][slot] = 0
            ws["cnt"][t][slot] = 0
            ws["map"][t][r] = -1
    # (c) every count read, after the second barrier: block 0 zeroes them
    ws["counts"][:] = 0
    return out[0], out[1], listed[0], listed[1], stats, ws


@pytest.mark.parametrize("V,D,B,T,win,k", [(40, 16, 3, 14, 3, 4),
                                           (12, 24, 4, 20, 5, 5),
                                           (20, 768, 2, 10, 3, 3)])
def test_step_matches_jax(V, D, B, T, win, k):
    w_in, w_out, block, cwin, negs, key = _case(V, D, B, T, win, k, V)
    # collisions: some vertex is a center and a target of another pair
    centers = set(block[block >= 0].tolist())
    assert centers & set(negs.ravel().tolist())
    a_in, a_out = _jax_step(w_in, w_out, block, key, negs, win, 0.1)
    b_in, b_out = sgns_exact.sgns_exact_step(
        torch.as_tensor(w_in.copy()), torch.as_tensor(w_out.copy()),
        torch.as_tensor(block), torch.as_tensor(cwin),
        torch.as_tensor(negs.copy()), 0.1, win)
    np.testing.assert_allclose(b_in.numpy(), a_in, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_out.numpy(), a_out, rtol=1e-5, atol=1e-6)
    assert np.abs(a_in - w_in).max() > 1e-3          # the step moved them


@pytest.mark.parametrize("slots", [None, 64, 6, 0])
def test_kernel_arithmetic_matches_jax(slots):
    """The kernel's order of work (old tables only, per-block tables of
    partial sums flushed into compact slots, the grid barrier, sum then
    divide, the touched rows alone, the counts zeroed after a second one)
    gives the JAX step to rounding; untouched rows stay bit for bit, and
    the workspace is empty again. slots: the plan's own table, one that
    holds every row a block touches, one so small that adds miss it and go
    to device memory, and none at all."""
    win, lr, k = 3, 0.1, 7
    w_in, w_out, block, cwin, negs, key = _case(30, 8, 3, 12, win, k, 7)
    plan = sgns_exact.launch_plan(8, 3, 12, win, k, sm_count=4)
    if slots is not None:
        plan = plan._replace(slots=slots)
    a_in, a_out = _jax_step(w_in, w_out, block, key, negs, win, lr)
    b_in, b_out, rows_in, rows_out, stats, ws = _kernel_arithmetic(
        w_in, w_out, block, cwin, negs, win, lr, plan)
    np.testing.assert_allclose(b_in, a_in, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_out, a_out, rtol=1e-5, atol=1e-6)
    rest = np.setdiff1d(np.arange(30), rows_in)
    np.testing.assert_array_equal(b_in[rest], w_in[rest])
    rest = np.setdiff1d(np.arange(30), rows_out)
    np.testing.assert_array_equal(b_out[rest], w_out[rest])
    assert set(rows_in) & set(rows_out)       # a row in both lists
    # compact slots: each touched row listed once
    assert len(set(rows_in)) == len(rows_in) and len(rows_out) == len(
        set(rows_out))
    assert plan.blocks == 8 and plan.positions == 5
    # the next step finds the workspace empty: no memset between steps
    assert not any(x.any() for x in (*ws["d"], *ws["cnt"], ws["counts"]))
    assert all((m == -1).all() for m in ws["map"])
    if slots == 0:
        assert stats["hits"] == stats["flushed"] == 0
    elif slots == 64:
        assert stats["misses"] == 0 and stats["hits"] > stats["flushed"]
    else:
        assert stats["misses"] > 0 and stats["hits"] > stats["flushed"] > 0


@pytest.mark.parametrize("V", [10_000, 1_000_000])
def test_workspace_is_bounded_by_the_block(V):
    """At karate's block (B 32, T 22, w 5, k 5) the delta slots are the
    rows the block can touch, whatever the vocabulary; a vocabulary row
    costs its map entry alone (an old [V, D] delta table pair: 1 GB at
    V = 10^6, D = 128)."""
    D, BT, win, k = 128, 32 * 22, 5, 5
    w = torch.empty((V, D), dtype=torch.float32, device="meta")
    ws = sgns_exact.Workspace(w, w, BT, win, k)
    assert ws.rows == (min(V, BT), min(V, BT * 2 * win * (1 + k)))
    block_bytes = sum(r * (D * 4 + 4 + 4) for r in ws.rows)
    assert ws.nbytes == block_bytes + 2 * V * 4 + 8
    assert ws.serves(w, w, BT, win, k)
    if V == 1_000_000:
        assert ws.rows == (BT, BT * 60)
        assert ws.nbytes < 0.05 * 2 * V * D * 4
        assert not ws.serves(w, w, BT, win + 1, k)


def test_karate_gate_with_exact_negatives(karate_path):
    """The karate gates of tests/test_word2vec.py (AUC > 0.75, faction
    accuracy >= 0.90 at train_frac 0.5) with the CLI's default trainer
    (shared_negatives = 0)."""
    g = tio.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=20, num_walks=10, seed=2,
                                device="cpu")
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                         seed=1)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg, device="cpu")
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = tev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices,
                                  seed=0)
    acc = tev.node_classification_accuracy(w_in, tev.karate_labels(g.ids),
                                           train_frac=0.5, seed=0)
    assert auc > 0.75 and acc >= 0.90, (auc, acc)


def test_exact_kernel_wrapper_raises_without_a_build(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel or raises: with no compiler
    the build fails loudly, nothing falls back to the plain version, and
    the step's launch count stays as it was."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(sgns_exact.SGNS_EXACT_STEP, "_fn", None)
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                    device="meta")
    before = sgns_exact.SGNS_EXACT_STEP.launches
    with pytest.raises(_build.KernelBuildError):
        sgns_exact.sgns_exact_step(
            meta(10, 8), meta(10, 8), meta(2, 5, dt=torch.int32),
            meta(2, 5, dt=torch.int32), meta(40, 3, dt=torch.int32), 0.1, 2)
    assert sgns_exact.SGNS_EXACT_STEP.launches == before


@pytest.mark.parametrize("sm_count", [1, 4, 132])
def test_launch_plan_fits_a_cooperative_launch(sm_count):
    """A cooperative launch runs only when every block can be resident at
    once: for every D from 1 to 1,024 and small blocks the plan asks for at
    most BLOCKS_PER_SM blocks an SM (the kernel's kMinBlocks), of the
    THREADS it is bounded to (kMaxThreads), each within its share of
    shared memory, and covers the block's positions."""
    source = (_build.CSRC / sgns_exact.SGNS_EXACT_STEP.source).read_text()
    assert (f"constexpr int kMinBlocks = {sgns_exact.BLOCKS_PER_SM};"
            in source)
    assert f"constexpr int kMaxThreads = {sgns_exact.THREADS};" in source
    for D in range(1, 1025):
        for B, T, win, k in ((1, 1, 1, 0), (2, 5, 2, 3), (3, 14, 3, 4),
                             (7, 30, 5, 5)):
            plan = sgns_exact.launch_plan(D, B, T, win, k, sm_count)
            assert 1 <= plan.blocks <= sgns_exact.BLOCKS_PER_SM * sm_count
            assert plan.threads == sgns_exact.THREADS
            assert plan.smem_bytes <= sgns_exact.TABLE_BUDGET
            assert plan.blocks * plan.positions >= B * T



def _slots_case(S, V, D, B, T, win, k, seed, own=False):
    """S slots' blocks over one small vocabulary (rows collide across the
    slots), the last slot's last walk all -1, windows and negatives drawn
    with numpy; own: each pair's first negative its own center."""
    rng = np.random.default_rng(seed)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    blocks = rng.integers(0, V, (S, B, T)).astype(np.int32)
    blocks[:, -1, T - 3:] = -1
    blocks[-1, -1] = -1
    cwin = rng.integers(1, win + 1, (S, B, T)).astype(np.int32)
    negs = rng.integers(0, V, (S, B * T * 2 * win, k)).astype(np.int32)
    if own:
        negs[..., 0] = np.maximum(np.repeat(blocks.reshape(S, -1), 2 * win,
                                            axis=1), 0)
    return w_in, w_out, blocks, cwin, negs


def _merged_f64(w_in, w_out, blocks, cwin, negs, win, lr):
    """The plain merged update of the slots in float64."""
    want = [torch.tensor(w, dtype=torch.float64) for w in (w_in, w_out)]
    sgns_exact.sgns_exact_merged_ref(
        *want, *(torch.as_tensor(x) for x in (blocks, cwin, negs)), lr, win)
    return [w.numpy() for w in want]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("group", [GROUP, 6])
def test_merged_step_transcribed_matches_the_float64_step(S, own, group):
    """The one-card merged update of S slots as the kernel computes it (all
    the slots' positions in one launch plan, one workspace, each row's
    gradients summed over every slot before the update divides by its
    count), transcribed in NumPy float32, against the plain merged update
    (each slot's accumulate, then dp_apply_ref) in float64 within rtol 1e-5
    atol 1e-6; in groups of 3 targets (the kernel's) and of 6 (a variant:
    the same sums in another grouping). The workspace is empty after it and
    each touched row is listed once."""
    win, lr, k, B, T = 3, 0.1, 4, 2, 12
    w_in, w_out, blocks, cwin, negs = _slots_case(S, 30, 8, B, T, win, k,
                                                  S, own)
    plan = sgns_exact.launch_plan(8, S * B, T, win, k, sm_count=4)
    b_in, b_out, rows_in, rows_out, stats, ws = _kernel_arithmetic(
        w_in, w_out, blocks, cwin, negs, win, lr, plan, group)
    want = _merged_f64(w_in, w_out, blocks, cwin, negs, win, lr)
    np.testing.assert_allclose(b_in, want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_out, want[1], rtol=1e-5, atol=1e-6)
    assert len(set(rows_in)) == len(rows_in)
    assert len(set(rows_out)) == len(rows_out)
    assert not any(x.any() for x in (*ws["d"], *ws["cnt"], ws["counts"]))
    assert all((m == -1).all() for m in ws["map"])
    assert stats["hits"] and stats["misses"]
    # the float32 twin the CPU trainer runs agrees too
    twin = [torch.tensor(w) for w in (w_in, w_out)]
    sgns_exact.sgns_exact_step(*twin, *(torch.as_tensor(x) for x in (
        blocks, cwin, negs)), lr, win)
    for t, w in zip(twin, want):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S", [2, 3])
def test_slot_strides_read_only_the_slots_rows(S):
    """The kernel's slot addressing: slot s's block, windows and negatives
    at a base plus s times each array's stride, as the trainer passes
    slots[:, i] of [S, n_blocks, B, T] and the chunk's draws [S, n, ...].
    The other blocks of the arrays hold a poison row (NaN in both tables),
    windows and negatives of their own: slot s's pairs read slot s's block
    alone, nothing comes of the poison, and the tables equal the
    transcription on the slots laid out contiguously, bit for bit."""
    win, lr, k, B, T, V, D, n, i = 2, 0.1, 3, 2, 9, 20, 8, 3, 1
    w_in, w_out, blocks, cwin, negs = _slots_case(S, V, D, B, T, win, k, 7)
    poison = V
    w_in = np.vstack([w_in, np.full((1, D), np.nan, np.float32)])
    w_out = np.vstack([w_out, np.full((1, D), np.nan, np.float32)])
    big_b = np.full((S, n, B, T), poison, np.int32)
    big_c = np.full((S, n + 1, B, T), win, np.int32)
    big_n = np.full((S, n + 2, *negs.shape[1:]), poison, np.int32)
    big_b[:, i], big_c[:, i + 1], big_n[:, i + 2] = blocks, cwin, negs
    lay = dict(S=S, B=B, T=T, k=k, block=big_b.ravel(), cwin=big_c.ravel(),
               negs=big_n.ravel(),
               base=(i * B * T, (i + 1) * B * T, (i + 2) * negs[0].size),
               stride=(n * B * T, (n + 1) * B * T, (n + 2) * negs[0].size))
    # the strides the wrapper reads off the trainer's views
    _, _, _, _, strides = sgns_exact._slot_layout(
        "t", torch.as_tensor(big_b)[:, i], torch.as_tensor(big_c)[:, i + 1],
        torch.as_tensor(big_n)[:, i + 2], win)
    assert strides == lay["stride"]
    plan = sgns_exact.launch_plan(D, S * B, T, win, k, sm_count=2)
    reads = []
    got = _kernel_arithmetic(w_in, w_out, None, None, None, win, lr, plan,
                             layout=lay, reads=reads)
    flat = _kernel_arithmetic(w_in, w_out, blocks, cwin, negs, win, lr, plan)
    for g, f in zip(got[:2], flat[:2]):
        assert np.isfinite(g[:V]).all()
        np.testing.assert_array_equal(g, f)
    assert {s for s, _ in reads} == set(range(S))
    for s, idx in reads:
        lo = lay["base"][0] + s * lay["stride"][0]
        assert lo <= idx < lo + B * T
    want = _merged_f64(w_in[:V], w_out[:V], blocks, cwin, negs, win, lr)
    np.testing.assert_allclose(got[0][:V], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1][:V], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sm_count", [132, 114])
def test_merged_launch_plan_fits_a_cooperative_launch(sm_count):
    """The merged update's plan cuts S * B * T positions: S = 1, 2 and 4
    slots of B 32, 16 and 8 (the trainer's B at row_block 32) take the B 32
    step's plan; for every D from 1 to 1,024 and S up to 4 the plan asks
    for at most BLOCKS_PER_SM blocks an SM of H100 SXM's 132 SMs or the
    PCIe part's 114, within each block's share of shared memory, and
    covers every slot's positions."""
    T, win, k = 82, 10, 5
    one = sgns_exact.launch_plan(128, 32, T, win, k, sm_count)
    for S, B in ((1, 32), (2, 16), (4, 8)):
        assert sgns_exact.launch_plan(128, S * B, T, win, k,
                                      sm_count) == one
    for D in range(1, 1025):
        for S, B, T, win, k in ((2, 16, 82, 10, 5), (4, 3, 14, 3, 4),
                                (3, 1, 1, 1, 0)):
            plan = sgns_exact.launch_plan(D, S * B, T, win, k, sm_count)
            assert 1 <= plan.blocks <= sgns_exact.BLOCKS_PER_SM * sm_count
            assert plan.smem_bytes <= sgns_exact.TABLE_BUDGET
            assert plan.smem_bytes == plan.slots * sgns_exact.slot_bytes(D)
            assert plan.blocks * plan.positions >= S * B * T


def test_constants_and_entry_points_match_the_source():
    """The transcription's constants are the kernel's, each wrapper's entry
    point is in the source, and the merged update launches the step's own
    entry point (a Kernel of its own only for its count)."""
    source = (_build.CSRC / sgns_exact.SGNS_EXACT_STEP.source).read_text()
    for line in (f"constexpr int kGroup = {GROUP};",
                 f"constexpr int kProbes = {PROBES};"):
        assert line in source, line
    for kernel in (sgns_exact.SGNS_EXACT_STEP, sgns_exact.SGNS_EXACT_MERGED,
                   sgns_exact.SGNS_EXACT_ACCUMULATE):
        assert kernel.source == "sgns_exact.cu"
        assert f'extern "C" int {kernel.symbol}(' in source
    assert source.count('extern "C" int ') == 2
    merged, step = sgns_exact.SGNS_EXACT_MERGED, sgns_exact.SGNS_EXACT_STEP
    assert merged is not step
    assert (merged.symbol, merged.argtypes) == (step.symbol, step.argtypes)


@pytest.mark.parametrize("S", [2, 4])
def test_merged_twin_reuses_its_buffer(S):
    """The CPU trainer's merged step takes one zero reduction buffer for
    all its updates: the twin with it gives the tables it gives with a
    buffer of its own, bit for bit, and leaves it zero again."""
    win, lr, k, B, T = 3, 0.1, 4, 2, 12
    w_in, w_out, blocks, cwin, negs = _slots_case(S, 30, 8, B, T, win, k,
                                                  S, False)
    slots = [torch.as_tensor(x) for x in (blocks, cwin, negs)]
    want = [torch.tensor(w) for w in (w_in, w_out)]
    got = [torch.tensor(w) for w in (w_in, w_out)]
    buf = torch.zeros(sgns_exact.buffer_numel(*w_in.shape))
    for _ in range(2):  # two updates on the one buffer
        sgns_exact.sgns_exact_step(*want, *slots, lr, win)
        sgns_exact.sgns_exact_step(*got, *slots, lr, win, buf)
        assert not buf.any()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("with_buffer", [False, True])
def test_merged_wrapper_raises_without_a_build(monkeypatch, tmp_path,
                                               with_buffer):
    """S slots on a device tensor go to the merged launch (or, with a
    buffer, the accumulate launch) or raise: with no compiler the build
    fails loudly, nothing falls back to the twin, and no count moves."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    kernel = (sgns_exact.SGNS_EXACT_ACCUMULATE if with_buffer
              else sgns_exact.SGNS_EXACT_MERGED)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel, "_fn", None)
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                    device="meta")
    counts = [k.launches for k in (sgns_exact.SGNS_EXACT_STEP,
                                   sgns_exact.SGNS_EXACT_MERGED,
                                   sgns_exact.SGNS_EXACT_ACCUMULATE)]
    with pytest.raises(_build.KernelBuildError):
        sgns_exact.sgns_exact_step(
            meta(10, 8), meta(10, 8), meta(2, 2, 5, dt=torch.int32),
            meta(2, 2, 5, dt=torch.int32), meta(2, 40, 3, dt=torch.int32),
            0.1, 2, buffer=meta(180) if with_buffer else None)
    assert counts == [k.launches for k in (sgns_exact.SGNS_EXACT_STEP,
                                           sgns_exact.SGNS_EXACT_MERGED,
                                           sgns_exact.SGNS_EXACT_ACCUMULATE)]


@pytest.mark.parametrize("bad", ["block not contiguous", "negs of another "
                                 "window", "cwin of another slot count"])
def test_slot_layout_refuses_what_the_kernel_cannot_address(bad):
    """The wrapper's slot layout: each slot's part contiguous, the shapes
    of one window and one slot count; anything else raises before a
    launch."""
    S, B, T, win, k = 2, 3, 7, 2, 3
    block = torch.zeros((S, B, T), dtype=torch.int32)
    cwin = torch.ones((S, B, T), dtype=torch.int32)
    negs = torch.zeros((S, B * T * 2 * win, k), dtype=torch.int32)
    if bad == "block not contiguous":
        block = torch.zeros((S, T, B), dtype=torch.int32).transpose(1, 2)
    elif bad == "negs of another window":
        negs = torch.zeros((S, B * T * 2 * (win + 1), k), dtype=torch.int32)
    else:
        cwin = cwin[:1]
    with pytest.raises(ValueError):
        sgns_exact._slot_layout("t", block, cwin, negs, win)
    ok = sgns_exact._slot_layout("t", block[:, :, :] if bad != "block not "
                                 "contiguous" else block.contiguous(),
                                 torch.ones((S, B, T), dtype=torch.int32),
                                 torch.zeros((S, B * T * 2 * win, k),
                                             dtype=torch.int32), win)
    assert ok == (S, B, T, k, (B * T, B * T, B * T * 2 * win * k))
