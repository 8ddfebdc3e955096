"""The trainer's per-block draws (ops/trainer_draws.py) against the JAX
package's epoch scan: for each block id of a chunk, kb = fold_in(key, i),
the dynamic windows jax.random.randint(kb, (B, T), 1, w + 1) and the
negatives _draw_negatives(fold_in(kb, 2), shape, keep, alias), bit for bit,
for both trainers' shapes and chunks that do not divide the epoch. Then a
NumPy transcription of csrc/trainer_draws.cu (its grid, its split of a
block's elements into cwin then negs, its uint32 randint and f32 pick)
against the plain version. JAX runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.ops.alias import build_alias
from stellar_rw_tpu_torch.ops import prng
from stellar_rw_tpu_torch.ops import trainer_draws as td

torch.set_num_threads(2)


def _alias(V, seed):
    rng = np.random.default_rng(seed)
    return build_alias(rng.random(V) ** 2 * 50 + 0.01)


def _jax_draws(seed, ep, ids, B, T, window, shape, keep, alias):
    with jax.enable_x64(False):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ep)
        out = []
        for i in ids:
            kb = jax.random.fold_in(key, i)
            cwin = jax.random.randint(kb, (B, T), 1, window + 1)
            negs = jw2v._draw_negatives(jax.random.fold_in(kb, 2), shape,
                                        jnp.asarray(keep), jnp.asarray(alias))
            out.append((np.asarray(cwin), np.asarray(negs)))
    return out


# (B, T, window, k or None, kB or None, V, c0, n): exact and shared shapes,
# chunks that start inside the epoch and do not divide it, window 1 (a span
# of 1) and a one-row vocabulary
CASES = [
    (3, 14, 3, 4, None, 50, 0, 3),
    (4, 23, 5, 5, None, 34, 7, 2),
    (6, 23, 5, None, 64, 300, 5, 3),
    (2, 82, 10, None, 128, 40, 0, 1),
    (3, 9, 1, 2, None, 20, 11, 4),
    (2, 11, 10, None, 16, 1, 3, 2),
    (2, 7, 2, 3, None, 1, 0, 2),
]


@pytest.mark.parametrize("B,T,window,k,kB,V,c0,n", CASES)
def test_trainer_draws_ref_matches_jax(B, T, window, k, kB, V, c0, n):
    keep, alias = _alias(V, B + T)
    shape = (kB,) if kB else (B * T * 2 * window, k)
    want = _jax_draws(4, 1, range(c0, c0 + n), B, T, window, shape, keep,
                      alias)
    key = prng.fold_in(prng.prng_key(4), 1)
    cwin, negs = td.trainer_draws(key, c0, n, B, T, window, shape,
                                  torch.as_tensor(keep, dtype=torch.float32),
                                  torch.as_tensor(alias, dtype=torch.int32))
    assert cwin.shape == (n, B, T) and cwin.dtype == torch.int32
    assert negs.shape == (n,) + shape and negs.dtype == torch.int32
    for j, (w_cwin, w_negs) in enumerate(want):
        np.testing.assert_array_equal(cwin[j].numpy(), w_cwin)
        np.testing.assert_array_equal(negs[j].numpy(), w_negs)
    assert int(cwin.min()) >= 1 and int(cwin.max()) <= window
    assert int(negs.min()) >= 0 and int(negs.max()) < V


def test_epoch_chunks_draw_the_jax_streams():
    """_train_epoch's chunking: the draws of every chunk of an epoch whose
    chunk does not divide it, concatenated, are the JAX scan's."""
    B, T, window, kB, V, n_blocks, chunk = 2, 9, 3, 8, 25, 7, 3
    keep, alias = _alias(V, 3)
    want = _jax_draws(9, 2, range(n_blocks), B, T, window, (kB,), keep, alias)
    key = prng.fold_in(prng.prng_key(9), 2)
    got = [td.trainer_draws(key, c0, min(chunk, n_blocks - c0), B, T, window,
                            (kB,), torch.as_tensor(keep, dtype=torch.float32),
                            torch.as_tensor(alias, dtype=torch.int32))
           for c0 in range(0, n_blocks, chunk)]
    cwin = torch.cat([c for c, _ in got]).numpy()
    negs = torch.cat([g for _, g in got]).numpy()
    np.testing.assert_array_equal(cwin, np.stack([c for c, _ in want]))
    np.testing.assert_array_equal(negs, np.stack([g for _, g in want]))


# --- a transcription of csrc/trainer_draws.cu ------------------------------

M32 = np.uint64(0xFFFFFFFF)


def _threefry(k0, k1, c0, c1):
    """threefry.cuh's block on uint64 arrays holding uint32 values."""
    rotl = lambda v, d: ((v << np.uint64(d)) & M32) | (v >> np.uint64(32 - d))
    k0, k1 = np.uint64(k0), np.uint64(k1)
    ks2 = k0 ^ k1 ^ np.uint64(0x1BD11BDA)
    x0 = (np.asarray(c0, np.uint64) + k0) & M32
    x1 = (np.asarray(c1, np.uint64) + k1) & M32
    inject = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3), (k1, ks2, 4),
              (ks2, k0, 5))
    for i, (a, b, m) in enumerate(inject):
        for r in ((13, 15, 26, 6) if i % 2 == 0 else (17, 29, 16, 24)):
            x0 = (x0 + x1) & M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + a) & M32
        x1 = (x1 + b + np.uint64(m)) & M32
    return x0, x1


def _grid(n, BT, M):
    """srw_trainer_draws_launch's (x, y) grid: runs of THREADS * PER_THREAD
    elements of a block's cwin then negs along x, blocks along y (at most
    65,535; the kernel strides over more)."""
    return -(-(BT + M) // (td.THREADS * td.PER_THREAD)), min(n, 65_535)


def _kernel_draws(key, c0, n, BT, M, window, keep, alias):
    """The kernel's grid walked in Python: blocks along y (striding past
    65,535), runs of THREADS * PER_THREAD elements along x, element e of a
    block cwin's when e < BT, else negs' e - BT; keys made a block at a
    time; uint32 randint, f32 u1 * n truncated, the alias pick."""
    gx, gy = _grid(n, BT, M)
    cwin = np.full((n, BT), -7, np.int64)
    negs = np.full((n, M), -7, np.int64)
    span = np.uint64(window)
    m16 = np.uint64(65536) % span
    mult = (m16 * m16) % span
    fn = np.float32(len(keep))
    for by in range(gy):
        for y in range(by, n, gy):
            kb = _threefry(key[0], key[1], 0, c0 + y)
            ks = [_threefry(kb[0], kb[1], 0, t) for t in range(3)]
            ks.append(_threefry(ks[2][0], ks[2][1], 0, 1))
            for bx in range(gx):
                base = bx * td.THREADS * td.PER_THREAD
                e = (base + np.arange(td.PER_THREAD)[:, None] * td.THREADS
                     + np.arange(td.THREADS)[None, :]).reshape(-1)
                e = e[e < BT + M]
                ec, en = e[e < BT], e[e >= BT] - BT
                bits = lambda k, i: np.bitwise_xor(*_threefry(k[0], k[1], 0,
                                                              i))
                hi, lo = bits(ks[0], ec), bits(ks[1], ec)
                off = (((hi % span) * mult) & M32) + (lo % span)
                assert (cwin[y, ec] == -7).all()
                cwin[y, ec] = 1 + ((off & M32) % span).astype(np.int64)
                f = lambda b: ((b >> np.uint64(9)) | np.uint64(0x3F800000)
                               ).astype(np.uint32).view(np.float32) - \
                    np.float32(1)
                u1, u2 = f(bits(ks[2], en)), f(bits(ks[3], en))
                j = np.minimum((u1 * fn).astype(np.int32), len(keep) - 1)
                assert (negs[y, en] == -7).all()
                negs[y, en] = np.where(u2 < keep[j], j, alias[j])
    assert (cwin != -7).all() and (negs != -7).all()   # each element once
    return cwin, negs


@pytest.mark.parametrize("B,T,window,k,kB,V,c0,n", CASES[:2] + CASES[4:6])
def test_kernel_transcription_equals_the_plain_version(B, T, window, k, kB,
                                                       V, c0, n):
    keep, alias = _alias(V, B)
    shape = (kB,) if kB else (B * T * 2 * window, k)
    key = prng.fold_in(prng.prng_key(13), 0)
    want_c, want_n = td.trainer_draws_ref(
        key, c0, n, B, T, window, shape,
        torch.as_tensor(keep, dtype=torch.float32),
        torch.as_tensor(alias, dtype=torch.int32))
    got_c, got_n = _kernel_draws(key.tolist(), c0, n, B * T,
                                 int(np.prod(shape)), window,
                                 keep.astype(np.float32),
                                 alias.astype(np.int64))
    np.testing.assert_array_equal(got_c, want_c.reshape(n, -1).numpy())
    np.testing.assert_array_equal(got_n, want_n.reshape(n, -1).numpy())


def test_grid_strides_past_the_y_limit():
    """More blocks than a grid's y extent: the kernel's y loop visits every
    block once, and x covers a block's elements (phase 13 of chip_smoke.py
    draws 70,000 blocks in one launch on the card)."""
    n = 70_000
    gx, gy = _grid(n, 10, 3)
    assert (gx, gy) == (1, 65_535)
    visits = [y for by in range(gy) for y in range(by, n, gy)]
    assert sorted(visits) == list(range(n))
    gx, _ = _grid(2, 2624, 262_400)
    assert (gx - 1) * td.THREADS * td.PER_THREAD < 2624 + 262_400 <= \
        gx * td.THREADS * td.PER_THREAD
