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


def _kernel_arithmetic(w_in, w_out, block, cwin, negs, win, lr, plan):
    """csrc/sgns_exact.cu's one kernel in NumPy under a launch plan, on a
    workspace laid out as ops/sgns_exact.py::Workspace. Phase (a) block by
    block: each block's warps over contiguous runs of its (position,
    offset) pairs, a pair's targets in groups of GROUP; every gradient row
    added into the block's open-addressing table (key: the row, IN_BIT for
    w_in's; at most PROBES probes from the kernel's multiplicative hash)
    or, on a miss, into the row's compact delta slot (a row-to-slot map, -1
    when free, a list of slot rows and a count of slots taken); the
    occupied slots flushed into the delta slots at the block's end. Only
    the old tables are read. Then the grid barrier, and phase (b): the
    grid's warps stride over the listed slots (w_in's first), a row a warp,
    each row updated and its slot, count and map entry emptied. Phase (c):
    a second grid barrier, then block 0 zeroes the slot counts. Returns
    the tables, the listed rows, the table's stats and the workspace."""
    B, T = block.shape
    V, D = w_in.shape
    k = negs.shape[1]
    BT, W2 = B * T, 2 * win
    rows = (min(V, BT), min(V, BT * W2 * (1 + k)))
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
        n = max(0, min(BT - p0, plan.positions)) * W2
        nw = plan.threads // 32
        for warp in range(nw):
            pos, nvalid, dvi = -1, 0, None
            for it in range(n * warp // nw, n * (warp + 1) // nw):
                p, o = p0 + it // W2, it % W2
                if p != pos:
                    if nvalid:
                        add(0, center, dvi, nvalid)
                    pos, nvalid = p, 0
                    bb, t = divmod(p, T)
                    center = block[bb, t]
                    dvi = np.zeros(D, np.float32)
                off = o - win if o < win else o - win + 1
                tc = t + off
                if (center < 0 or abs(off) > cwin[bb, t] or not 0 <= tc < T
                        or block[bb, tc] < 0):
                    continue
                nvalid += 1
                vi = w_in[center]
                targets = [block[bb, tc]] + list(negs[p * W2 + o])
                for gb in range(0, k + 1, GROUP):
                    grp = targets[gb:gb + GROUP]
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
    """The karate gates of tests/test_word2vec.py with the CLI's default
    trainer (shared_negatives = 0)."""
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
                                           seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


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

