"""The port's shared-negative gradients and trainer steps against the JAX
package: sgns_shared_grads_ref against the Pallas kernel (interpret mode, as
tests/test_pallas.py runs it), one conv step and one exact step against the
JAX functions on identical inputs, and the per-block draws bit for bit.
JAX runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.ops.alias import build_alias
from stellar_rw_tpu.ops.pallas.sgns import sgns_shared_grads as pallas_grads
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import _build, prng, sgns

torch.set_num_threads(2)


def _inputs(P, D, kB, seed=0):
    rng = np.random.default_rng(seed)
    vi, vo = (rng.standard_normal((P, D)).astype(np.float32) * 0.3
              for _ in range(2))
    wn = rng.standard_normal((kB, D)).astype(np.float32) * 0.3
    valid = (rng.random(P) > 0.3).astype(np.float32)
    g_pos = rng.standard_normal(P).astype(np.float32) * valid
    return vi, vo, wn, g_pos, valid * 0.125


@pytest.mark.parametrize("P,D,kB,tile", [
    (512, 128, 128, 256),
    (300, 50, 37, 256),
    (7, 128, 256, 512),
    (2624, 128, 128, 512),   # the slice's conv block: 32 walks x 82
])
def test_sgns_ref_matches_pallas_kernel(P, D, kB, tile):
    args = _inputs(P, D, kB)
    with jax.enable_x64(False):
        want = pallas_grads(*(jnp.asarray(a) for a in args), tile_p=tile,
                            interpret=True)
    got = sgns.sgns_shared_grads(*(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _tables(V, D, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((V, D)) * 0.1).astype(np.float32),
            (rng.standard_normal((V, D)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("B,T,win,kB", [(6, 23, 5, 64), (4, 82, 10, 128)])
def test_conv_step_matches_jax(B, T, win, kB):
    rng = np.random.default_rng(B)
    V, D = 300, 32
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[1, T - 5:] = -1                  # padding present
    negs = rng.integers(0, V, kB).astype(np.int32)
    w_in, w_out = _tables(V, D, 1)
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(9)
        valid, _ = jw2v._valid_for_block(jnp.asarray(block), key, win)
        a_in, a_out = jw2v._sgns_apply_shared_conv(
            jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(block), valid,
            jnp.asarray(negs), jnp.float32(0.1), neg_weight=5 / kB,
            window=win)
    t_valid, _ = w2v._valid_for_block(torch.as_tensor(block),
                                      prng.prng_key(9), win)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    b_in, b_out = w2v._sgns_apply_shared_conv(
        torch.as_tensor(w_in), torch.as_tensor(w_out),
        torch.as_tensor(block), t_valid, torch.as_tensor(negs), 0.1,
        neg_weight=5 / kB, window=win)
    np.testing.assert_allclose(b_in.numpy(), np.asarray(a_in), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b_out.numpy(), np.asarray(a_out), rtol=1e-5,
                               atol=1e-6)


def test_conv_negative_half_is_sgns_shared_grads():
    """The conv step's negative half (word2vec.py:428-466) through
    sgns_shared_grads_ref with vi = ein, g_pos = 0, mask = neg_weight*vcnt.
    Tolerance rtol 1e-5 / atol 1e-6 (outputs are O(1) sums of ~100 terms),
    not 0: JAX scales sigmoid(ein wn^T) @ wn by the mask after the product,
    the kernel scales the sigmoid tile before it, so the f32 roundings
    differ."""
    rng = np.random.default_rng(5)
    B, T, D, kB, win = 4, 30, 32, 64, 5
    nw = 5 / kB
    ein = (rng.standard_normal((B, T, D)) * 0.3).astype(np.float32)
    wn = (rng.standard_normal((kB, D)) * 0.3).astype(np.float32)
    vcnt = rng.integers(0, 2 * win + 1, (B, T)).astype(np.float32)
    with jax.enable_x64(False):
        e2 = jnp.asarray(ein.reshape(-1, D))
        sneg = jax.nn.sigmoid(jnp.dot(e2, jnp.asarray(wn).T))
        m = nw * jnp.asarray(vcnt).reshape(-1)
        want_vi = jnp.dot(sneg, jnp.asarray(wn)) * m[:, None]
        want_wn = jnp.dot((sneg * m[:, None]).T, e2)
    t2 = torch.as_tensor(ein.reshape(-1, D))
    d_vi, d_vo, d_wn = sgns.sgns_shared_grads_ref(
        t2, t2, torch.as_tensor(wn), torch.zeros(B * T),
        nw * torch.as_tensor(vcnt).reshape(-1))
    np.testing.assert_allclose(d_vi.numpy(), np.asarray(want_vi), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(d_wn.numpy(), np.asarray(want_wn), rtol=1e-5,
                               atol=1e-6)
    assert not d_vo.any()


def test_exact_step_matches_jax():
    rng = np.random.default_rng(0)
    V, D, B, T, win, k = 50, 16, 3, 14, 3, 4
    block = rng.integers(0, V, (B, T)).astype(np.int32)
    block[2, 10:] = -1
    w_in, w_out = _tables(V, D, 2)
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(3)
        c, x, v = jw2v._pairs_for_block(jnp.asarray(block), key, win)
        keep, alias = build_alias(np.bincount(block[block >= 0],
                                              minlength=V) + 1.0)
        negs = jw2v._draw_negatives(jax.random.fold_in(key, 2),
                                    (c.shape[0], k), jnp.asarray(keep),
                                    jnp.asarray(alias))
        a_in, a_out = jw2v._sgns_apply(
            jnp.asarray(w_in), jnp.asarray(w_out), c, x, v, negs,
            jnp.float32(0.1))
    tk = prng.prng_key(3)
    tc, tx, tv = w2v._pairs_for_block(torch.as_tensor(block), tk, win)
    for a, b in ((tc, c), (tx, x), (tv, v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tnegs = w2v._draw_negatives(prng.fold_in(tk, 2), (tc.shape[0], k),
                                torch.as_tensor(keep),
                                torch.as_tensor(alias).long())
    np.testing.assert_array_equal(tnegs.numpy(), np.asarray(negs))
    b_in, b_out = w2v._sgns_apply(torch.as_tensor(w_in),
                                  torch.as_tensor(w_out), tc, tx, tv, tnegs,
                                  0.1)
    np.testing.assert_allclose(b_in.numpy(), np.asarray(a_in), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b_out.numpy(), np.asarray(a_out), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(128,), (50, 5)])
def test_negative_draws_bitwise(shape):
    keep, alias = build_alias(np.arange(1, 41, dtype=np.float64) ** 0.75)
    with jax.enable_x64(False):
        want = jw2v._draw_negatives(jax.random.PRNGKey(6), shape,
                                    jnp.asarray(keep), jnp.asarray(alias))
    got = w2v._draw_negatives(prng.prng_key(6), shape, torch.as_tensor(keep),
                              torch.as_tensor(alias).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_embeddings_bitwise():
    with jax.enable_x64(False):
        a_in, a_out = jw2v._init_embeddings(
            34, 16, jax.random.fold_in(jax.random.PRNGKey(1), 0x1A17))
    b_in, b_out = w2v._init_embeddings(
        34, 16, prng.fold_in(prng.prng_key(1), 0x1A17))
    np.testing.assert_array_equal(b_in.numpy(), np.asarray(a_in))
    np.testing.assert_array_equal(b_out.numpy(), np.asarray(a_out))


@pytest.mark.parametrize("d", [-3, -1, 0, 2, 7])
def test_shift_matches_jax(d):
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    np.testing.assert_array_equal(w2v._shift(torch.as_tensor(x), d).numpy(),
                                  np.asarray(jw2v._shift(jnp.asarray(x), d)))


def test_sgns_kernel_wrapper_raises_without_a_build(monkeypatch, tmp_path):
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(sgns.SGNS_KERNEL, "_fn", None)
    m = lambda *s: torch.empty(s, device="meta")
    before = sgns.SGNS_KERNEL.launches
    with pytest.raises(_build.KernelBuildError):
        sgns.sgns_shared_grads(m(8, 4), m(8, 4), m(3, 4), m(8), m(8))
    assert sgns.SGNS_KERNEL.launches == before
