"""The conv step (ops/sgns_conv.py) against the JAX package's
_sgns_apply_shared_conv, and the design of its kernels (csrc/sgns_conv.cu)
transcribed in NumPy against the plain step and a float64 step.

The transcription walks the accumulate kernel's grid under launch_plan:
a walk's positions in tiles with a halo of `window` positions each side,
validity formed from the tokens, windows and bounds, each pair's dot taken
by its center's tile and again by its context's, row slices of `cols`
columns (the dots summed over every slice before the sigmoid); then the
negative half, the scatter into delta slots claimed at a row's first touch
with integer counts, the negatives' rows updated on their own
(-lr * d_wn / cnt_n) and the apply (-lr * sum / max(count, 1)). Tolerances:
rtol 1e-5 / atol 1e-6 on the tables after a step, the trainers' tolerance
(the sums run in another order). JAX runs with x64 off."""

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
         "uniform": rng.random((B, T)), "one": np.zeros((B, T))}[tokens]
    block = np.minimum((V * u).astype(np.int32), V - 1)
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


def _accumulate(w_in, w_out, block, cwin, negs, window, nw, plan):
    """The accumulate kernel's grid walked in NumPy (f32)."""
    B, T = block.shape
    D = w_in.shape[1]
    W2, tile, cols = 2 * window, plan.tile, plan.cols
    H = tile + W2
    N = B * T
    ein = np.zeros((N, D), np.float32)
    acc_in = np.zeros((N, D), np.float32)
    acc_out = np.zeros((N, D), np.float32)
    cnt = np.zeros((2, N), np.int64)
    valid = np.zeros(plan.blocks, np.int64)
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
                c0 = s * cols
                w = min(cols, D - c0)
                rows = lambda tab: np.where(
                    (tok >= 0)[:, None], tab[np.maximum(tok, 0), c0:c0 + w],
                    np.float32(0))
                s_in, s_out = rows(w_in), rows(w_out)
                for side in range(2):
                    for tl in range(nt):
                        for o in range(W2):
                            d = _offset(o, window)
                            hc = window + tl - side * d
                            if ok(hc, hc + d):
                                dots[side, tl, o] += np.float32(
                                    s_in[hc] @ s_out[hc + d])
            g = np.zeros_like(dots)
            for side in range(2):
                for tl in range(nt):
                    for o in range(W2):
                        d = _offset(o, window)
                        hc = window + tl - side * d
                        if ok(hc, hc + d):
                            g[side, tl, o] = np.float32(1) / (
                                np.float32(1) + np.exp(-dots[side, tl, o])
                            ) - np.float32(1)
            for tl in range(nt):
                h, p = window + tl, b * T + t0 + tl
                cnt[0, p] = sum(ok(h, h + _offset(o, window))
                                for o in range(W2))
                cnt[1, p] = sum(ok(h - _offset(o, window), h)
                                for o in range(W2))
                valid[b * plan.tiles + tx] += cnt[0, p]
            for s in range(plan.slices):
                c0 = s * cols
                w = min(cols, D - c0)
                s_in = np.where((tok >= 0)[:, None],
                                w_in[np.maximum(tok, 0), c0:c0 + w], 0)
                s_out = np.where((tok >= 0)[:, None],
                                 w_out[np.maximum(tok, 0), c0:c0 + w], 0)
                for tl in range(nt):
                    h, p = window + tl, b * T + t0 + tl
                    for o in range(W2):
                        d = _offset(o, window)
                        acc_in[p, c0:c0 + w] += g[0, tl, o] * s_out[h + d]
                        acc_out[p, c0:c0 + w] += g[1, tl, o] * s_in[h - d]
                    ein[p, c0:c0 + w] = s_in[h]
    wn = w_out[negs]
    mask = np.float32(nw) * cnt[0].astype(np.float32)
    return ein, acc_in, acc_out, cnt, mask, valid, wn


def _kernel_step(w_in, w_out, block, cwin, negs, lr, nw, window, plan):
    """One conv step as the kernels make it: accumulate, the negative half
    (the plain f32 products), the scatter into slots and the negatives'
    own pass, then the apply. Returns new tables and the slots taken."""
    ein, acc_in, acc_out, cnt, mask, valid, wn = _accumulate(
        w_in, w_out, block, cwin, negs, window, nw, plan)
    sneg = (1 / (1 + np.exp(-(ein @ wn.T)))).astype(np.float32) * mask[:, None]
    d_in = acc_in + sneg @ wn                  # sgns_shared_grads' d_vi
    d_wn = sneg.T @ ein
    w_in, w_out = w_in.copy(), w_out.copy()
    slots = [{}, {}]                           # row -> [sum, count], in
    for p, tok in enumerate(block.reshape(-1)):   # claim order
        if tok < 0:
            continue
        for t, src in ((0, d_in), (1, acc_out)):
            if cnt[t, p]:
                s = slots[t].setdefault(int(tok), [np.zeros_like(src[p]), 0])
                s[0] = s[0] + src[p]
                s[1] += int(cnt[t, p])
    cnt_n = max(np.float32(valid.sum()) * np.float32(nw), np.float32(1))
    for k, row in enumerate(negs):             # before the apply
        w_out[row] += (np.float32(-lr) * d_wn[k]) / cnt_n
    for t, tab in ((0, w_in), (1, w_out)):
        for row, (s, c) in slots[t].items():
            tab[row] += (np.float32(-lr) * s) / np.float32(max(c, 1))
    return w_in, w_out, [len(s) for s in slots]


def _plain(w_in, w_out, block, cwin, negs, lr, nw, window, dtype):
    a_in = torch.tensor(w_in, dtype=dtype)
    a_out = torch.tensor(w_out, dtype=dtype)
    sgns_conv.sgns_conv_step_ref(a_in, a_out, torch.as_tensor(block),
                                 torch.as_tensor(cwin), torch.as_tensor(negs),
                                 lr, nw, window)
    return a_in.numpy(), a_out.numpy()


@pytest.mark.parametrize("B,T,V,D,window,kB,tokens,sliced", [
    (4, 30, 60, 32, 5, 16, "zipf", False),
    (3, 21, 40, 72, 3, 8, "uniform", True),
    (2, 17, 25, 40, 10, 8, "one", False),
    (5, 9, 30, 16, 2, 4, "zipf", False),
])
def test_kernel_design_matches_the_plain_step(monkeypatch, B, T, V, D,
                                              window, kB, tokens, sliced):
    """The transcription against the plain f32 step (rtol 1e-5, atol 1e-6)
    and against the float64 step no farther than the plain f32 step is,
    give or take the f32 rounding of the update; with a shared-memory budget
    that forces rows of three slices in one case."""
    plan = sgns_conv.launch_plan(B, T, D, window, sm_count=8)
    if sliced:
        monkeypatch.setattr(sgns_conv, "SMEM_BUDGET", sgns_conv.smem_bytes(
            plan.tile, window, 32))
        plan = sgns_conv.launch_plan(B, T, D, window, sm_count=8)
        assert plan.slices == 3 and plan.cols == 32
    w_in, w_out, block, cwin, negs = _step_inputs(B, T, V, D, window, kB,
                                                  tokens, D)
    lr, nw = 0.05, 5 / kB
    k_in, k_out, taken = _kernel_step(w_in, w_out, block, cwin, negs, lr, nw,
                                      window, plan)
    p_in, p_out = _plain(w_in, w_out, block, cwin, negs, lr, nw, window,
                         torch.float32)
    d_in, d_out = _plain(w_in, w_out, block, cwin, negs, lr, nw, window,
                         torch.float64)
    for k, p, d, old in ((k_in, p_in, d_in, w_in), (k_out, p_out, d_out,
                                                   w_out)):
        np.testing.assert_allclose(k, p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(k, d, rtol=1e-5, atol=1e-6)
        assert np.abs(k - d).max() <= np.abs(p - d).max() + 1e-7
        assert (k != old).any()
    toks = block[block >= 0]
    assert taken[0] <= len(np.unique(toks)) and taken[1] <= len(
        np.unique(toks))


@pytest.mark.parametrize("D", [1, 64, 128, 300, 768, 1024, 1536, 4096])
@pytest.mark.parametrize("B,T,window", [(32, 82, 10), (32, 81, 10),
                                        (1, 5, 5), (128, 82, 10),
                                        (4, 40, 40)])
def test_launch_plan_fits_and_fills(D, B, T, window):
    """The accumulate kernel's plan: shared memory within two blocks an SM
    (so within 232,448 bytes) at any D, slices covering the row, tiles
    covering the walk, and the grid giving each of 132 SMs two blocks
    where a tile of 8 can; at walk_10k's blocks (B 32, T 81-82) tiles of 8
    give 352 blocks."""
    plan = sgns_conv.launch_plan(B, T, D, window)
    assert plan.smem_bytes <= sgns_conv.SMEM_BUDGET <= 232_448
    assert plan.smem_bytes == sgns_conv.smem_bytes(plan.tile, window,
                                                   plan.cols)
    assert plan.cols % 32 == 0 and plan.slices * plan.cols >= D > (
        plan.slices - 1) * plan.cols
    assert plan.tiles * plan.tile >= T > (plan.tiles - 1) * plan.tile
    assert plan.blocks == plan.tiles * B
    assert plan.halo_rows == plan.tile + 2 * window
    if B * -(-T // 8) >= 2 * 132:
        assert plan.blocks >= 2 * 132
    if (B, T) in ((32, 82), (32, 81)):
        assert (plan.tile, plan.blocks) == (8, 352)
        assert plan.slices == (1 if D <= 480 else -(-D // 480))
    forced = sgns_conv.launch_plan(B, T, D, window, tiles=(32,))
    assert forced.tile == min(32, T)


def test_launch_plan_refuses_a_window_with_no_room():
    with pytest.raises(ValueError):
        sgns_conv.launch_plan(32, 82, 128, 500)
    with pytest.raises(ValueError):
        sgns_conv.launch_plan(0, 82, 128, 5)
