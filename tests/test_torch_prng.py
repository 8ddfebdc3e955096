"""The port's threefry streams (stellar_rw_tpu_torch/ops/prng.py) against
jax.random, element for element.

Every JAX draw runs with x64 off, the production setting: under the suite's
x64 mode jax.random.uniform draws f64 and randint int64, other streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.ops import prng as jprng
from stellar_rw_tpu.ops import sampling as jsampling
from stellar_rw_tpu_torch.ops import prng, sampling

torch.set_num_threads(2)


def _np(key):
    return np.asarray(jax.random.key_data(key) if jnp.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key(seed):
    with jax.enable_x64(False):
        want = _np(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), want)


@pytest.mark.parametrize("chain", [(0,), (3, 0, 1), (7, 81, 63), (2**31 + 5,)])
def test_fold_in_chain(chain):
    with jax.enable_x64(False):
        k = jax.random.PRNGKey(11)
        for d in chain:
            k = jax.random.fold_in(k, d)
        want = _np(k)
    t = prng.prng_key(11)
    for d in chain:
        t = prng.fold_in(t, d)
    np.testing.assert_array_equal(t.numpy(), want)


def test_fold_in_batched_matches_scalar():
    base = prng.prng_key(5)
    batched = prng.fold_in(base, torch.arange(37))
    with jax.enable_x64(False):
        want = np.stack([_np(jax.random.fold_in(jax.random.PRNGKey(5), i))
                         for i in range(37)])
    np.testing.assert_array_equal(batched.numpy(), want)


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(num):
    with jax.enable_x64(False):
        want = _np(jax.random.split(jax.random.PRNGKey(9), num))
    np.testing.assert_array_equal(prng.split(prng.prng_key(9), num).numpy(),
                                  want)


def test_threefry_block_matches_jax_package():
    rng = np.random.default_rng(0)
    k0, k1, c0, c1 = (rng.integers(0, 2**32, 257, dtype=np.int64)
                      for _ in range(4))
    with jax.enable_x64(False):
        o0, o1 = jprng.threefry2x32_block(
            *(jnp.asarray(x.astype(np.uint32)) for x in (k0, k1, c0, c1)))
    t0, t1 = prng.threefry2x32_block(*(torch.as_tensor(x)
                                       for x in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(o0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(o1).astype(np.int64))


@pytest.mark.parametrize("W", [1, 34, 8191, 8192, 8193])
def test_dense_trial_draw(W):
    """The (3, draw_width(W)) trial draw, W on both sides of DRAW_QUANTUM."""
    Wd = sampling.draw_width(W)
    assert Wd == jsampling.draw_width(W)
    with jax.enable_x64(False):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 4), 1)
        want = np.asarray(jax.random.uniform(k, (3, Wd), dtype=jnp.float32))
    t = prng.fold_in(prng.fold_in(prng.prng_key(3), 4), 1)
    got = prng.uniform(t, (3, Wd))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    lane = torch.arange(W)
    with jax.enable_x64(False):
        pkg = jprng.uniform3_at(jax.random.key_data(k) if jnp.issubdtype(
            k.dtype, jax.dtypes.prng_key) else k, jnp.arange(W), Wd)
    for c, u in enumerate(prng.uniform3_at(t, lane, Wd)):
        np.testing.assert_array_equal(u.numpy(), want[c, :W])
        np.testing.assert_array_equal(u.numpy(), np.asarray(pkg[c]))


def test_tail_trial_draws():
    """uniform(fold_in(k, w), (3,)) per lane, the tail-trial stream."""
    with jax.enable_x64(False):
        k = jax.random.fold_in(jax.random.PRNGKey(8), 5)
        want = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(k, w), (3,), dtype=jnp.float32))
            for w in range(40)])
    t = prng.fold_in(prng.prng_key(8), 5)
    kw = prng.fold_in(t, torch.arange(40))
    np.testing.assert_array_equal(prng.uniform(kw, (3,)).numpy(), want)


@pytest.mark.parametrize("shape,lo,hi", [((32, 82), 1, 11), ((5, 7), 1, 4),
                                         ((300,), 0, 1000), ((4, 4), 3, 3),
                                         ((64,), -5, 70000)])
def test_randint(shape, lo, hi):
    with jax.enable_x64(False):
        k = jax.random.fold_in(jax.random.PRNGKey(1), 17)
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
    got = prng.randint(prng.fold_in(prng.prng_key(1), 17), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_batched_keys():
    keys = prng.fold_in(prng.prng_key(4), torch.arange(6))
    got = prng.randint(keys, (3, 5), 1, 11)
    with jax.enable_x64(False):
        want = np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.PRNGKey(4), i), (3, 5), 1, 11))
            for i in range(6)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_matrix_init_stream():
    """The embedding-init draw: uniform(key, (vocab, dim))."""
    with jax.enable_x64(False):
        k = jax.random.fold_in(jax.random.PRNGKey(0), 0x1A17)
        want = np.asarray(jax.random.uniform(k, (34, 16), jnp.float32))
    got = prng.uniform(prng.fold_in(prng.prng_key(0), 0x1A17), (34, 16))
    np.testing.assert_array_equal(got.numpy(), want)
