"""The exact-negative SGNS step (ops/sgns_exact.py) against the JAX
package's _sgns_apply: the plain version on a block where rows collide (a
vertex is a center and a target of other pairs, targets repeat), a NumPy
transcription of the two kernels' arithmetic (gradients from the old
tables into a delta table, then the touched rows updated by
sum-then-divide), the karate gates with exact negatives, and the kernel
wrapper without a build.

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


def _kernel_arithmetic(w_in, w_out, block, cwin, negs, win, lr):
    """csrc/sgns_exact.cu in NumPy: kernel (a) per center position, reading
    only the old tables, then kernel (b) over the touched rows."""
    B, T = block.shape
    V, D = w_in.shape
    k = negs.shape[1]
    d_in = np.zeros_like(w_in)
    d_out = np.zeros_like(w_out)
    cnt_in = np.zeros(V, np.int64)
    cnt_out = np.zeros(V, np.int64)
    touched_in, touched_out = [], []
    offs = list(range(-win, 0)) + list(range(1, win + 1))
    for pos in range(B * T):
        b, t = divmod(pos, T)
        center = block[b, t]
        if center < 0:
            continue
        vi = w_in[center]
        dvi = np.zeros(D, np.float32)
        nvalid = 0
        for o, off in enumerate(offs):
            tc = t + off
            if abs(off) > cwin[b, t] or not 0 <= tc < T or block[b, tc] < 0:
                continue
            nvalid += 1
            targets = [block[b, tc]] + list(negs[pos * 2 * win + o])
            for j, tgt in enumerate(targets):
                vo = w_out[tgt]
                g = np.float32(1 / (1 + np.exp(-np.dot(vi, vo)))
                               - (j == 0))
                dvi += g * vo
                d_out[tgt] += g * vi
                cnt_out[tgt] += 1
                if tgt not in touched_out:
                    touched_out.append(tgt)
        if nvalid:
            d_in[center] += dvi
            cnt_in[center] += nvalid
            if center not in touched_in:
                touched_in.append(center)
    w_in, w_out = w_in.copy(), w_out.copy()
    for w, d, cnt, rows in ((w_in, d_in, cnt_in, touched_in),
                            (w_out, d_out, cnt_out, touched_out)):
        for r in rows:
            w[r] += (np.float32(-lr) * d[r]) / np.float32(max(cnt[r], 1))
    return w_in, w_out, touched_in, touched_out


@pytest.mark.parametrize("V,D,B,T,win,k", [(40, 16, 3, 14, 3, 4),
                                           (12, 24, 4, 20, 5, 5)])
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


def test_kernel_arithmetic_matches_jax():
    """The kernels' order of work (old tables only, sum then divide, the
    touched rows alone) gives the JAX step to rounding; untouched rows stay
    bit for bit."""
    win, lr = 3, 0.1
    w_in, w_out, block, cwin, negs, key = _case(30, 8, 3, 12, win, 3, 7)
    a_in, a_out = _jax_step(w_in, w_out, block, key, negs, win, lr)
    b_in, b_out, rows_in, rows_out = _kernel_arithmetic(
        w_in, w_out, block, cwin, negs, win, lr)
    np.testing.assert_allclose(b_in, a_in, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_out, a_out, rtol=1e-5, atol=1e-6)
    rest = np.setdiff1d(np.arange(30), rows_in)
    np.testing.assert_array_equal(b_in[rest], w_in[rest])
    assert set(rows_in) & set(rows_out)       # a row in both lists


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
    """A tensor off the CPU goes to the kernels or raises: with no compiler
    the build fails loudly, and nothing falls back to the plain version."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(sgns_exact.SGNS_EXACT_GRADS, "_fn", None)
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                    device="meta")
    before = (sgns_exact.SGNS_EXACT_GRADS.launches,
              sgns_exact.SGNS_EXACT_APPLY.launches)
    with pytest.raises(_build.KernelBuildError):
        sgns_exact.sgns_exact_step(
            meta(10, 8), meta(10, 8), meta(2, 5, dt=torch.int32),
            meta(2, 5, dt=torch.int32), meta(40, 3, dt=torch.int32), 0.1, 2)
    assert (sgns_exact.SGNS_EXACT_GRADS.launches,
            sgns_exact.SGNS_EXACT_APPLY.launches) == before

