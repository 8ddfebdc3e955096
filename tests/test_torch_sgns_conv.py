"""The conv step (ops/sgns_conv.py) against the JAX package's
_sgns_apply_shared_conv, and the design of its kernels (csrc/sgns_conv.cu)
transcribed in NumPy against the plain step, a float64 step and the JAX
function.

The transcription walks the accumulate kernel's grid under launch_plan: a
block of threads a tile of a walk, its rows and a halo of `window` rows a
side gathered, validity formed from the tokens, windows and bounds, a warp
a position, each pair's dot taken by its center's tile and again by its
context's as the warp takes it (a lane's fmaf shares over its four columns
of each 128-column chunk, then the transposed butterfly over the lanes),
row slices of `cols` columns (the dots summed over every slice before the
sigmoid); then the negative half, and the scatter-update over
group_blocks' units: a unit's rows summed in group order, a group's unit
sums summed in unit order (a hub group split into units), divided by the
group's count and added into the table once, the negatives' rows on their
own (-lr * d_wn / cnt_n). Tolerances: rtol 1e-5 / atol 1e-6 on the tables
after a step, the trainers' tolerance (the sums run in another order). JAX
runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import prng, sgns_conv

torch.set_num_threads(2)


def _block(B, T, V, tokens, seed):
    rng = np.random.default_rng(seed)
    u = {"zipf": rng.random((B, T)) ** (1 / 0.3),
         "uniform": rng.random((B, T)), "one": np.zeros((B, T)),
         "every other": rng.random((B, T)) ** (1 / 0.3)}[tokens]
    block = np.minimum((V * u).astype(np.int32), V - 1)
    if tokens == "every other":
        block[:, ::2] = 0                  # a hub at every other position
    block[-1, T - 5:] = -1                 # a walk that ended early
    if B > 2:
        block[1, 3:6] = -1                 # padding inside a walk
    return block


def _step_inputs(B, T, V, D, window, kB, tokens, seed):
    rng = np.random.default_rng(seed + 1)
    block = _block(B, T, V, tokens, seed)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    negs = rng.integers(0, V, kB).astype(np.int32)
    negs[1] = negs[0]                      # a repeated negative
    key = prng.fold_in(prng.prng_key(seed), 5)
    cwin = prng.randint(key, (B, T), 1, window + 1)
    return w_in, w_out, block, cwin.numpy(), negs


@pytest.mark.parametrize("B,T,window,kB,D", [(6, 23, 5, 64, 32),
                                             (4, 82, 10, 128, 64)])
def test_plain_conv_step_matches_jax(B, T, window, kB, D):
    """sgns_conv_step_ref (the moved plain step, from the dynamic windows)
    against the JAX function on the windows jax.random.randint draws."""
    V = 300
    w_in, w_out, block, _, negs = _step_inputs(B, T, V, D, window, kB,
                                               "zipf", B)
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(9)
        cwin = jax.random.randint(key, (B, T), 1, window + 1)
        valid, _ = jw2v._valid_for_block(jnp.asarray(block), key, window)
        a_in, a_out = jw2v._sgns_apply_shared_conv(
            jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(block), valid,
            jnp.asarray(negs), jnp.float32(0.05), neg_weight=5 / kB,
            window=window)
    b_in, b_out = sgns_conv.sgns_conv_step(
        torch.as_tensor(w_in), torch.as_tensor(w_out), torch.as_tensor(block),
        torch.tensor(np.asarray(cwin)), torch.as_tensor(negs), 0.05,
        5 / kB, window)
    np.testing.assert_allclose(b_in.numpy(), np.asarray(a_in), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b_out.numpy(), np.asarray(a_out), rtol=1e-5,
                               atol=1e-6)
    assert w2v._sgns_apply_shared_conv is sgns_conv._sgns_apply_shared_conv
    assert w2v._shift is sgns_conv._shift


# --- the kernels' design, transcribed --------------------------------------

def _offset(o, window):
    return o - window if o < window else o - window + 1


def _fma(a, b, c):
    """fmaf in NumPy: the product of two float32 exact in float64, the sum
    rounded to float32."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _butterfly(shares):
    """csrc/sgns_conv.cu's transposed butterfly (acc_fold) on the lane
    shares [K, 32] of K sums (f32): at steps 16, 8, 4, 2, 1 each lane adds
    its partner's (lane ^ step) partial to its own, and lane k % 32 ends
    with sum k (the offsets of a round of 32), which is returned for each
    k."""
    lanes = np.arange(32)
    q = shares.astype(np.float32)
    for h in (16, 8, 4, 2, 1):
        q = q + q[:, lanes ^ h]
    return q[np.arange(len(q)), np.arange(len(q)) % 32]


def _lane_dots(a, e, cols):
    """The dots of row a [cols] with rows e [K, cols] as the kernel's warp
    takes them: lane l's share over its four columns 4 * (ch * 32 + l) + j
    of each 128-column chunk ch (none past cols), in (ch, j) order by
    fmaf, then the butterfly over the lanes."""
    ch = -(-cols // 128)
    pad = ch * 128 - cols
    A = np.pad(a, (0, pad)).reshape(ch, 32, 4)
    E = np.pad(e, ((0, 0), (0, pad))).reshape(len(e), ch, 32, 4)
    v = np.zeros((len(e), 32), np.float32)
    for c in range(ch):
        for j in range(4):
            v = _fma(A[c, :, j], E[:, c, :, j], v)
    return _butterfly(v)


def _accumulate(w_in, w_out, block, cwin, negs, window, nw, plan):
    """The accumulate kernel's grid walked in NumPy (f32): a block a tile
    of a walk, its rows and a halo of `window` rows a side gathered (zero
    outside the walk, at padding and beyond D), rows in slices of plan.cols
    columns; a warp a position x, each pair's dot taken by its center's
    tile (ein[x] . eout[x + d]) and again by its context's (ein[x - d] .
    eout[x]) in lane shares and a butterfly, summed over the slices in
    order; g_pos = sigmoid - 1 on a valid pair; acc_in and acc_out by fmaf
    over the offsets in order."""
    B, T = block.shape
    D = w_in.shape[1]
    W2, tile, cols = 2 * window, plan.tile, plan.cols
    assert cols % 32 == 0
    H = tile + W2
    N = B * T
    offs = [_offset(o, window) for o in range(W2)]
    ein = np.zeros((N, D), np.float32)
    acc_in = np.zeros((N, D), np.float32)
    acc_out = np.zeros((N, D), np.float32)
    cnt = np.zeros((2, N), np.int64)
    valid = np.zeros(plan.blocks, np.int64)

    def rows(tab, tok, c0):
        out = np.zeros((H, cols), np.float32)
        w = min(cols, D - c0)
        out[:, :w] = np.where((tok >= 0)[:, None],
                              tab[np.maximum(tok, 0), c0:c0 + w], 0)
        return out

    for b in range(B):
        for tx in range(plan.tiles):
            t0 = tx * tile
            nt = min(tile, T - t0)
            pos = t0 - window + np.arange(H)
            inside = (pos >= 0) & (pos < T)
            tok = np.where(inside, block[b, np.clip(pos, 0, T - 1)], -1)
            win = np.where(inside, cwin[b, np.clip(pos, 0, T - 1)], 0)
            ok = lambda hc, hx: (tok[hc] >= 0 and tok[hx] >= 0
                                 and abs(hx - hc) <= win[hc])
            dots = np.zeros((2, nt, W2), np.float32)
            for s in range(plan.slices):
                s_in, s_out = rows(w_in, tok, s * cols), rows(
                    w_out, tok, s * cols)
                for tl in range(nt):
                    h = window + tl
                    dots[0, tl] += _lane_dots(
                        s_in[h], np.stack([s_out[h + d] for d in offs]), cols)
                    dots[1, tl] += _lane_dots(
                        s_out[h], np.stack([s_in[h - d] for d in offs]), cols)
            g = np.zeros_like(dots)
            for tl in range(nt):
                h, p = window + tl, b * T + t0 + tl
                okc = [ok(h, h + d) for d in offs]
                okx = [ok(h - d, h) for d in offs]
                one = np.float32(1)
                g[0, tl] = np.where(okc, one / (one + np.exp(-dots[0, tl]))
                                    - one, 0)
                g[1, tl] = np.where(okx, one / (one + np.exp(-dots[1, tl]))
                                    - one, 0)
                cnt[0, p], cnt[1, p] = sum(okc), sum(okx)
                valid[b * plan.tiles + tx] += cnt[0, p]
            for s in range(plan.slices):
                c0 = s * cols
                w = min(cols, D - c0)
                s_in, s_out = rows(w_in, tok, c0), rows(w_out, tok, c0)
                for tl in range(nt):
                    h, p = window + tl, b * T + t0 + tl
                    ai = np.zeros(cols, np.float32)
                    ao = np.zeros(cols, np.float32)
                    for o, d in enumerate(offs):
                        ai = _fma(g[0, tl, o], s_out[h + d], ai)
                        ao = _fma(g[1, tl, o], s_in[h - d], ao)
                    acc_in[p, c0:c0 + w] = ai[:w]
                    acc_out[p, c0:c0 + w] = ao[:w]
                    ein[p, c0:c0 + w] = s_in[h, :w]
    wn = w_out[negs]
    mask = np.float32(nw) * cnt[0].astype(np.float32)
    return ein, acc_in, acc_out, cnt, mask, valid, wn


def _scatter(w_in, w_out, block, d_in, acc_out, cnt, lr, hub):
    """The scatter-update's token groups in NumPy (f32), in place: a unit's
    rows summed in group order, a group's unit sums in unit order, over the
    group's count, one add a group and table. Returns each table's adds
    and the groups split over several units."""
    g = sgns_conv.group_blocks(torch.as_tensor(block)[None], hub)
    order, units = g.order[0].numpy(), g.units[0].numpy()
    flat = block.reshape(-1)
    N = len(flat)
    low = lambda u: (units[u] & 0x7FFFFFFF) if u < N else N
    # the units of each group: a unit starts one unless bit 31 is set
    groups = []
    for u in range(N):
        if low(u) >= low(u + 1) or flat[order[low(u)]] < 0:
            continue
        assert low(u + 1) - low(u) <= hub
        if units[u] >= 0:
            groups.append([])
        groups[-1].append(u)
    added, split = [0, 0], 0
    for us in groups:
        s, e = low(us[0]), low(us[-1] + 1)
        split += len(us) > 1
        for t, src, tab in ((0, d_in, w_in), (1, acc_out, w_out)):
            row = np.zeros(src.shape[1], np.float32)
            for u in us:                       # unit sums, in unit order
                part = np.zeros(src.shape[1], np.float32)
                for j in range(low(u), low(u + 1)):   # in group order
                    part = part + src[order[j]]
                row = row + part
            total = int(cnt[t, order[s:e]].sum())
            if total == 0:
                continue
            tab[flat[order[s]]] += (np.float32(-lr) * row) / np.float32(
                total)
            added[t] += 1
    return added, split


def _kernel_step(w_in, w_out, block, cwin, negs, lr, nw, window, plan,
                 hub=sgns_conv.HUB):
    """One conv step as the kernels make it: accumulate, the negative half
    (the plain f32 products), then the scatter-update over group_blocks'
    units and the negatives' rows. Returns new tables, each table's adds of
    a group and the groups split over several units."""
    ein, acc_in, acc_out, cnt, mask, valid, wn = _accumulate(
        w_in, w_out, block, cwin, negs, window, nw, plan)
    sneg = (1 / (1 + np.exp(-(ein @ wn.T)))).astype(np.float32) * mask[:, None]
    d_in = acc_in + sneg @ wn                  # sgns_shared_grads' d_vi
    d_wn = sneg.T @ ein
    w_in, w_out = w_in.copy(), w_out.copy()
    added, split = _scatter(w_in, w_out, block, d_in, acc_out, cnt, lr, hub)
    cnt_n = max(np.float32(valid.sum()) * np.float32(nw), np.float32(1))
    for k, row in enumerate(negs):
        w_out[row] += (np.float32(-lr) * d_wn[k]) / cnt_n
    return w_in, w_out, added, split


def _plain(w_in, w_out, block, cwin, negs, lr, nw, window, dtype):
    a_in = torch.tensor(w_in, dtype=dtype)
    a_out = torch.tensor(w_out, dtype=dtype)
    sgns_conv.sgns_conv_step_ref(a_in, a_out, torch.as_tensor(block),
                                 torch.as_tensor(cwin), torch.as_tensor(negs),
                                 lr, nw, window)
    return a_in.numpy(), a_out.numpy()


def _jax(w_in, w_out, block, cwin, negs, lr, nw, window):
    valid, _ = sgns_conv._valid_from_cwin(torch.as_tensor(block),
                                          torch.as_tensor(cwin), window)
    with jax.enable_x64(False):
        a_in, a_out = jw2v._sgns_apply_shared_conv(
            jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(block),
            jnp.asarray(valid.numpy()), jnp.asarray(negs), jnp.float32(lr),
            neg_weight=nw, window=window)
    return np.asarray(a_in), np.asarray(a_out)


# (B, T, V, D, window, kB, tokens, plan keywords, hub, negatives)
DESIGN_CASES = {
    "Zipf": (4, 30, 60, 32, 5, 16, "zipf", {}, 16, "random"),
    "uniform, row slices": (3, 21, 40, 72, 3, 8, "uniform", {}, 16,
                            "random"),
    "uniform, few rows collide": (4, 23, 300, 20, 6, 8, "uniform", {}, 16,
                                  "random"),
    "one token": (2, 17, 25, 40, 10, 8, "one", {}, 64, "random"),
    "one token split into units of 4": (2, 17, 25, 40, 10, 8, "one", {}, 4,
                                        "random"),
    "one token split, its negatives that token": (
        4, 40, 25, 40, 10, 8, "one", {}, 8, "the token"),
    "Zipf groups split into units": (4, 30, 60, 32, 5, 16, "zipf", {}, 3,
                                     "random"),
    "a negative among the tokens": (3, 26, 50, 36, 4, 8, "zipf", {}, 5,
                                    "a token"),
    "small ragged": (5, 9, 30, 16, 2, 4, "zipf", {}, 16, "a token"),
    "window wider than a tile's positions": (
        5, 9, 30, 16, 5, 4, "zipf", {"tiles": (4,)}, 16, "random"),
    "a walk of 201 positions": (2, 201, 80, 8, 10, 8, "zipf",
                                {"sm_count": 132}, 16, "random"),
    "a walk of 201 positions, one token split": (
        2, 201, 10, 8, 10, 8, "one", {"sm_count": 132}, 16, "random"),
    "a walk of 201 positions, one token split, its negatives that token": (
        2, 201, 10, 8, 10, 8, "one", {"sm_count": 132}, 16, "the token"),
    "a walk of 201 positions, a hub every other position": (
        2, 201, 80, 8, 10, 8, "every other", {"sm_count": 132}, 16,
        "a token"),
    "a slot's block (B 16)": (16, 82, 300, 40, 10, 16, "zipf",
                              {"sm_count": 132}, 16, "random"),
    "D 1,536: two slices of six chunks": (3, 11, 50, 1536, 5, 16, "zipf",
                                          {"sm_count": 132}, 16, "a token"),
}


@pytest.mark.parametrize("case", sorted(DESIGN_CASES))
def test_kernel_design_matches_the_plain_step(monkeypatch, case):
    """The transcription against the plain f32 step and the JAX function
    (rtol 1e-5, atol 1e-6), and against the float64 step no farther than
    the plain f32 step is, give or take the f32 rounding of the update; with
    a shared-memory budget that forces rows of three slices in one case.
    Each group adds into its row once, a hub group split or not."""
    B, T, V, D, window, kB, tokens, kw, hub, negatives = DESIGN_CASES[case]
    kw = {"sm_count": 8, **kw}
    plan = sgns_conv.launch_plan(B, T, D, window, **kw)
    if "row slices" in case:
        monkeypatch.setattr(sgns_conv, "SMEM_BUDGET", sgns_conv.smem_bytes(
            plan.tile, window, 32))
        plan = sgns_conv.launch_plan(B, T, D, window, **kw)
        assert plan.slices == 3 and plan.cols == 32
    if "slices of six" in case:
        assert (plan.slices, plan.cols, plan.threads) == (2, 768, 256)
    if "B 16" in case:
        assert (plan.tile, plan.blocks, plan.threads) == (8, 176, 128)
    if "wider" in case:
        assert plan.tile < window
    if "201" in case:
        assert plan.tiles * plan.tile >= T and plan.tiles >= 8
    w_in, w_out, block, cwin, negs = _step_inputs(B, T, V, D, window, kB,
                                                  tokens, D)
    if negatives == "the token":
        negs[:] = block[0, 0]
    elif negatives == "a token":
        negs[2] = block[0, 1]
    lr, nw = 0.05, 5 / kB
    k_in, k_out, added, split = _kernel_step(w_in, w_out, block, cwin, negs,
                                             lr, nw, window, plan, hub)
    p_in, p_out = _plain(w_in, w_out, block, cwin, negs, lr, nw, window,
                         torch.float32)
    d_in, d_out = _plain(w_in, w_out, block, cwin, negs, lr, nw, window,
                         torch.float64)
    j_in, j_out = _jax(w_in, w_out, block, cwin, negs, lr, nw, window)
    for k, p, d, j, old in ((k_in, p_in, d_in, j_in, w_in),
                            (k_out, p_out, d_out, j_out, w_out)):
        np.testing.assert_allclose(k, p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(k, j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(k, d, rtol=1e-5, atol=1e-6)
        assert np.abs(k - d).max() <= np.abs(p - d).max() + 1e-7
        assert (k != old).any()
    _, sizes = np.unique(block[block >= 0], return_counts=True)
    assert max(added) <= len(sizes)        # one add a group
    assert (split > 0) == (sizes.max() > hub)


@pytest.mark.parametrize("tokens,B,T,hub", [
    ("one", 32, 82, 16), ("one", 32, 82, 8), ("one", 2, 201, 16),
    ("every other", 2, 201, 16), ("one", 2, 17, 4), ("zipf", 4, 30, 3)])
def test_scatter_rounds_a_row_once(tokens, B, T, hub):
    """The scatter-update's groups against the same update taken in float64
    from the same f32 accumulations: a split group's row within one f32
    spacing of it, however many units the group has (its unit sums are
    summed before the table is touched, so the row takes one rounding);
    up to 2,624 positions of one row in 328 units."""
    V, D, lr = 40, 24, 0.05
    rng = np.random.default_rng(T + hub)
    block = _block(B, T, V, tokens, hub)
    N = B * T
    keep = block.reshape(-1) >= 0
    cnt = rng.integers(0, 21, (2, N)) * keep
    # a position without pairs on a side accumulates nothing there
    d_in, acc_out = ((rng.standard_normal((N, D)) * 0.3 * (c > 0)[:, None])
                     .astype(np.float32) for c in cnt)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    k_in, k_out = w_in.copy(), w_out.copy()
    added, split = _scatter(k_in, k_out, block, d_in, acc_out, cnt, lr, hub)
    rows, sizes = np.unique(block[block >= 0], return_counts=True)
    assert split > 0 and max(added) <= len(sizes)
    hubs = rows[sizes > hub]
    tok = np.maximum(block.reshape(-1), 0)[keep]
    for t, src, old, got in ((0, d_in, w_in, k_in), (1, acc_out, w_out,
                                                     k_out)):
        total = np.bincount(tok, cnt[t][keep], V)
        sums = np.zeros((V, D))
        np.add.at(sums, tok, src[keep].astype(np.float64))
        want = old - lr * sums / np.maximum(total, 1)[:, None]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        far = np.abs(got - want)[hubs] / np.spacing(np.maximum(
            np.abs(want), np.abs(old))[hubs].astype(np.float32))
        assert far.max() <= 1, far.max()


def _grouping_ref(blocks, hub):
    """group_blocks in NumPy: a stable argsort of each block's tokens
    (padding last), and each group cut into units of `hub`."""
    n = blocks.shape[0]
    flat = blocks.reshape(n, -1)
    N = flat.shape[1]
    order = np.zeros((n, N), np.int64)
    units = np.zeros((n, N), np.int64)
    for i in range(n):
        key = np.where(flat[i] < 0, np.iinfo(np.int32).max, flat[i])
        order[i] = np.argsort(key, kind="stable")
        keys = key[order[i]]
        nvalid = int((flat[i] >= 0).sum())
        cut = []
        for j in range(nvalid):
            if j == 0 or keys[j] != keys[j - 1]:
                start = j
            if (j - start) % hub == 0:
                cut.append(j if j == start else j - (1 << 31))
        units[i] = nvalid
        units[i, :len(cut)] = cut
    return order, units


@pytest.mark.parametrize("tokens,hub,chunk", [
    ("zipf", 32, 4096), ("zipf", 3, 2), ("uniform", 1, 4096),
    ("one", 4, 3), ("one", 1000, 4096), ("padded", 2, 1),
    ("all padding", 32, 4096), ("zipf", 7, 1), ("padded", 5, None)])
def test_grouping_equals_a_stable_argsort(tokens, hub, chunk, monkeypatch):
    """group_blocks (sorted positions, group starts, units) against NumPy's
    argsort(kind="stable") on a small corpus of five blocks, sorted a chunk
    of blocks at a time (None: the default, as many blocks as hold
    _GROUP_POSITIONS positions, here forced to two blocks)."""
    rng = np.random.default_rng(hub)
    blocks = np.stack([_block(3, 11, 20, "one" if tokens == "one" else
                              "uniform" if tokens == "uniform" else "zipf",
                              i) for i in range(5)])
    if tokens == "padded":
        blocks[rng.random(blocks.shape) < 0.3] = -1
    if tokens == "all padding":
        blocks[2] = -1
    if chunk is None:
        monkeypatch.setattr(sgns_conv, "_GROUP_POSITIONS", 2 * 33)
    got = sgns_conv.group_blocks(torch.as_tensor(blocks), hub, chunk)
    assert got.order.dtype == got.units.dtype == torch.int32
    assert got.order.shape == got.units.shape == (5, 33)
    order, units = _grouping_ref(blocks, hub)
    np.testing.assert_array_equal(got.order.numpy(), order)
    np.testing.assert_array_equal(got.units.numpy(), units)


LAUNCH_SHAPES = [(32, 82, 10), (32, 81, 10), (1, 5, 5), (128, 82, 10),
                 (4, 40, 40), (32, 201, 10), (32, 401, 10)]


@pytest.mark.parametrize("D", [1, 64, 128, 300, 768, 1024, 1536, 4096])
@pytest.mark.parametrize("B,T,window", LAUNCH_SHAPES)
def test_launch_plan_fits_and_fills(D, B, T, window):
    """The accumulate kernel's plan: shared memory within two blocks an SM
    (so within 232,448 bytes) at any D, slices of a multiple of 32 columns
    covering the row, tiles covering the walk, 128 threads a block at one
    chunk and 256 at more, and the grid giving each of 132 SMs two blocks
    where a tile of 8 can; at walk_10k's blocks (B 32, T 81-82) tiles of 8
    give 352 blocks, and at a slot's (B 16) 176, at least 0.9 x 132 both;
    longer walks take wider tiles where they still fill the SMs."""
    plan = sgns_conv.launch_plan(B, T, D, window)
    assert plan.smem_bytes <= sgns_conv.SMEM_BUDGET <= 232_448
    assert plan.smem_bytes == sgns_conv.smem_bytes(plan.tile, window,
                                                   plan.cols)
    assert plan.cols % 32 == 0 and plan.slices * plan.cols >= D > (
        plan.slices - 1) * plan.cols
    assert plan.threads == (sgns_conv.ACC_THREADS
                            * (1 if plan.cols <= sgns_conv.CHUNK else 2))
    if B == 32 and T >= 81:
        for b in (32, 16):
            assert sgns_conv.launch_plan(b, T, D, window).blocks >= 0.9 * 132
    assert plan.tiles * plan.tile >= T > (plan.tiles - 1) * plan.tile
    assert plan.blocks == plan.tiles * B
    assert plan.halo_rows == plan.tile + 2 * window
    if B * -(-T // 8) >= 2 * 132:
        assert plan.blocks >= 2 * 132
    if (B, T) in ((32, 82), (32, 81)):
        assert (plan.tile, plan.blocks) == (8, 352)
        assert plan.slices == (1 if D <= 480 else -(-D // 480))
        assert sgns_conv.launch_plan(16, T, D, window).blocks == 176
    if (B, T) == (32, 401):
        assert (plan.tile, plan.blocks) == (32, 416)
    forced = sgns_conv.launch_plan(B, T, D, window, tiles=(32,))
    assert forced.tile == min(32, T)


def test_launch_plan_refuses_what_it_cannot_place():
    with pytest.raises(ValueError):
        sgns_conv.launch_plan(32, 82, 128, 5000)
    with pytest.raises(ValueError):
        sgns_conv.launch_plan(0, 82, 128, 5)
    with pytest.raises(ValueError):
        sgns_conv.launch_plan(70_000, 82, 128, 5)


def test_the_plan_mirrors_the_source():
    """ops/sgns_conv.py's constants are csrc/sgns_conv.cu's: the scatters'
    threads a block, the accumulate kernel's at a narrow slice, and the
    threads the launch picks by the slice."""
    from stellar_rw_tpu_torch.ops import _build

    src = (_build.CSRC / "sgns_conv.cu").read_text()
    assert f"constexpr int kThreads = {sgns_conv.THREADS};" in src
    assert f"constexpr int kAccThreads = {sgns_conv.ACC_THREADS};" in src
    assert (f"const int threads = cols > {sgns_conv.CHUNK} ? 2 * kAccThreads"
            f" : kAccThreads;") in src
    assert "cols < 32 || cols % 32 != 0" in src
