"""The data-parallel trainer of the port (parallel/dp.py, ops/dp_apply.py,
the steps' accumulate modes, models/word2vec.py's num_partitions and
train_skipgram_multiproc on one process) against the JAX package's psum'd
steps and trainers on conftest's CPU devices, and the three kernel changes
transcribed in NumPy against the plain step in float64.

One merged update: every slot's step adds its gradient sums and counts into
one reduction buffer, then each row moves by lr * acc / max(cnt, 1). In the
conv form the negatives' counts merge with the context rows' (the JAX
package's word2vec.py:478-480), so a block whose negatives are its own
tokens is among the cases. Tolerances: rtol 1e-5 / atol 1e-6 on one merged
update (tests/test_word2vec.py:160), rtol 1e-4 / atol 1e-6 on whole runs
(the trainers' tolerance: sums in another order). JAX runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as PS

from stellar_rw_tpu.graph import io as jio
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.graph import io as tio
from stellar_rw_tpu_torch.models import eval as tev
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import dp_apply as da
from stellar_rw_tpu_torch.ops import prng, sgns_conv, sgns_exact
from stellar_rw_tpu_torch.parallel import dp

torch.set_num_threads(2)

LR = np.float32(0.05)


@pytest.fixture(scope="module")
def walks(karate_path):
    """97 karate walks (a ragged N) of the JAX engine, 10 steps."""
    g = jio.load_edge_list(karate_path, weighted=False, directed=False)
    with jax.enable_x64(False):
        return np.asarray(jengine.random_walks(g, walk_length=8,
                                               num_walks=3, seed=2))[:97]


def _slot_blocks(P, B, T, V, seed, own_negatives=False, kB=None, k=None,
                 window=3):
    """P slots' blocks (Zipf tokens, a walk ending early), windows and
    negatives: kB shared ones a slot, or k a pair; own_negatives puts the
    slot's own tokens among its negatives."""
    rng = np.random.default_rng(seed)
    blocks = np.minimum((V * rng.random((P, B, T)) ** (1 / 0.3)).astype(
        np.int32), V - 1)
    blocks[:, -1, T - 4:] = -1
    cwin = np.stack([prng.randint(prng.fold_in(prng.prng_key(seed), s),
                                  (B, T), 1, window + 1).numpy()
                     for s in range(P)]).astype(np.int32)
    if kB:
        negs = rng.integers(0, V, (P, kB)).astype(np.int32)
        if own_negatives:                 # half of them the slot's tokens
            negs[:, :kB // 2] = np.maximum(
                blocks.reshape(P, -1)[:, :kB // 2], 0)
    else:
        negs = rng.integers(0, V, (P, B * T * 2 * window, k)).astype(np.int32)
        if own_negatives:
            negs[..., 0] = np.maximum(
                np.repeat(blocks.reshape(P, -1), 2 * window, axis=1), 0)
    return blocks, cwin, negs


def _tables(V, D, seed):
    rng = np.random.default_rng(seed + 100)
    return ((rng.standard_normal((V, D)) * 0.3).astype(np.float32),
            (rng.standard_normal((V, D)) * 0.3).astype(np.float32))


def _port_merged(w_in, w_out, blocks, cwin, negs, window, kB, k,
                 dtype=torch.float32):
    """One merged update of the port's plain steps in accumulate mode."""
    a_in = torch.tensor(w_in, dtype=dtype)
    a_out = torch.tensor(w_out, dtype=dtype)
    buf = torch.zeros(da.buffer_numel(*w_in.shape), dtype=dtype)
    for s in range(len(blocks)):
        b, c, n = (torch.as_tensor(x[s]) for x in (blocks, cwin, negs))
        if kB:
            sgns_conv.sgns_conv_step(a_in, a_out, b, c, n, float(LR), k / kB,
                                     window, buffer=buf)
        else:
            sgns_exact.sgns_exact_step(a_in, a_out, b, c, n, float(LR),
                                       window, buffer=buf)
    da.dp_apply(a_in, a_out, buf, float(LR))
    assert not buf.any()
    return a_in.numpy(), a_out.numpy()


def _jax_merged(w_in, w_out, blocks, cwin, negs, window, kB, k):
    """The JAX package's psum'd step under shard_map, a slot a CPU
    device."""
    P = len(blocks)
    mesh = Mesh(np.array(jax.devices()[:P]), ("dp",))
    valid = np.stack([sgns_exact._valid_from_cwin(
        torch.as_tensor(blocks[s]), torch.as_tensor(cwin[s]), window)[0]
        .numpy() for s in range(P)])

    def step(wi, wo, block, v, n):
        if kB:
            return jw2v._sgns_apply_shared_conv(
                wi, wo, block[0], v[0], n[0], LR, neg_weight=k / kB,
                window=window, axis_name="dp")
        offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
        T = block.shape[2]
        ctx = np.clip(np.arange(T)[:, None] + offs[None, :], 0, T - 1)
        centers = jnp.broadcast_to(block[0][:, :, None], v[0].shape)
        contexts = block[0][:, ctx]
        return jw2v._sgns_apply(wi, wo, centers.reshape(-1),
                                contexts.reshape(-1), v[0].reshape(-1),
                                n[0], LR, axis_name="dp")

    fn = jax.shard_map(step, mesh=mesh,
                       in_specs=(PS(), PS(), PS("dp"), PS("dp"), PS("dp")),
                       out_specs=(PS(), PS()))
    with jax.enable_x64(False):
        out = fn(jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(blocks),
                 jnp.asarray(valid), jnp.asarray(negs))
        return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("form,own", [("exact", False), ("exact", True),
                                      ("conv", True)])
def test_merged_step_matches_jax(P, form, own):
    """One merged update of P slots, the port's plain form against the JAX
    package's _sgns_apply / _sgns_apply_shared_conv with axis_name under
    shard_map over P CPU devices, on identical inputs (in the conv form
    half of each slot's negatives are its own tokens)."""
    V, D, B, T, window = 40, 16, 3, 14, 3
    kB, k = (16, 5) if form == "conv" else (None, 3)
    blocks, cwin, negs = _slot_blocks(P, B, T, V, P, own, kB, k, window)
    w_in, w_out = _tables(V, D, P)
    got = _port_merged(w_in, w_out, blocks, cwin, negs, window, kB, k)
    want = _jax_merged(w_in, w_out, blocks, cwin, negs, window, kB, k)
    for g, w, old in zip(got, want, (w_in, w_out)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert not np.array_equal(g, old)


def test_conv_negative_counts_merge_with_the_context_rows():
    """With one slot the merged conv update is not the single-device step
    where a row is both a context and a negative: the dp count merges the
    two means into one, as in the JAX package."""
    V, D, B, T, window, kB = 12, 8, 2, 10, 3, 8
    blocks, cwin, negs = _slot_blocks(1, B, T, V, 7, True, kB, 5, window)
    w_in, w_out = _tables(V, D, 7)
    merged = _port_merged(w_in, w_out, blocks, cwin, negs, window, kB, 5)
    one_in, one_out = torch.tensor(w_in), torch.tensor(w_out)
    sgns_conv.sgns_conv_step(one_in, one_out, torch.as_tensor(blocks[0]),
                             torch.as_tensor(cwin[0]),
                             torch.as_tensor(negs[0]), float(LR), 5 / kB,
                             window)
    np.testing.assert_allclose(merged[0], one_in.numpy(), rtol=1e-5,
                               atol=1e-6)
    shared = np.intersect1d(negs[0], blocks[0][blocks[0] >= 0])
    assert len(shared)
    assert not np.allclose(merged[1][shared], one_out.numpy()[shared],
                           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kB", [0, 8])
def test_train_skipgram_partitions_matches_jax(walks, P, kB):
    """train_skipgram(num_partitions=P) on the CPU against the JAX
    train_skipgram(num_partitions=P) on P CPU devices: two epochs on
    karate, N = 97 rows (ragged: the last slot's tail is padding)."""
    kw = dict(dim=8, window=3, negatives=2, iters=2, seed=1, lr=0.05,
              shared_negatives=kB)
    with jax.enable_x64(False):
        want = jw2v.train_skipgram(walks, 34, jw2v.SGNSConfig(**kw),
                                   num_partitions=P)
    got = w2v.train_skipgram(walks.copy(), 34, w2v.SGNSConfig(**kw),
                             num_partitions=P, device="cpu")
    B = max(1, min(-(-32 // P), -(-97 // P)))
    assert 97 % (B * P)                       # the layout is ragged
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_karate_gate_at_four_partitions(karate_path):
    """The JAX package's test_data_parallel_training on the port, P = 4:
    link AUC > 0.7 and faction accuracy >= 0.85."""
    g = tio.load_edge_list(karate_path, weighted=False, directed=False)
    jg = jio.load_edge_list(karate_path, weighted=False, directed=False)
    with jax.enable_x64(False):
        walks = np.asarray(jengine.random_walks(jg, walk_length=20,
                                                num_walks=10, seed=2))
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.2, iters=20,
                         seed=1)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg,
                                 num_partitions=4, device="cpu")
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = tev.link_prediction_auc(w_in, np.asarray(edges), g.num_vertices,
                                  seed=0)
    acc = tev.node_classification_accuracy(w_in, tev.karate_labels(g.ids),
                                           seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


@pytest.mark.parametrize("n,target", [(12, 5), (12, 12), (7, 3), (1, 8),
                                      (30, 1), (64, 16), (97, 10)])
def test_divisor_block_matches_jax(n, target):
    assert w2v._divisor_block(n, target) == jw2v._divisor_block(n, target)


@pytest.mark.parametrize("N,D", [(97, 2), (97, 4), (8, 8), (3, 4)])
def test_full_corpus_blocks_match_jax(N, D):
    """full_corpus_blocks of one rank against the JAX package's on D CPU
    devices of one process; the ranks' blocks of a world of 2 together are
    the same blocks; _rows_from_blocks reassembles any range of them."""
    rng = np.random.default_rng(N)
    corpus = rng.integers(-1, 34, (N, 6)).astype(np.int32)
    want, n_want = jw2v.full_corpus_blocks(corpus, D)
    got, n_got = w2v.full_corpus_blocks(corpus, D)
    assert n_got == n_want
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ranks = [w2v.full_corpus_blocks(corpus, D, rank=r, world=2)[0]
             for r in range(2)]
    assert [s for blk in ranks for s, _ in blk] == [s for s, _ in want]
    for lo, hi in ((0, n_want), (1, n_want - 1), (n_want // 2, n_want + 3)):
        np.testing.assert_array_equal(
            w2v._rows_from_blocks(ranks[1], lo, hi, 6),
            jw2v._rows_from_blocks(want[D // 2:], lo, hi, 6))


@pytest.mark.parametrize("kB", [0, 8])
def test_multiproc_on_one_process_matches_jax(walks, kB):
    """train_skipgram_multiproc(num_devices=2) in a world of one against
    the JAX package's on 2 CPU devices of one process."""
    kw = dict(dim=8, window=3, negatives=2, iters=2, seed=3, lr=0.05,
              shared_negatives=kB)
    jblocks, rows = jw2v.full_corpus_blocks(walks, 2)
    with jax.enable_x64(False):
        want = jw2v.train_skipgram_multiproc(jblocks, rows, 34,
                                             jw2v.SGNSConfig(**kw),
                                             num_devices=2)
    blocks, rows2 = w2v.full_corpus_blocks(walks, 2)
    assert rows2 == rows
    got = w2v.train_skipgram_multiproc(blocks, rows, 34,
                                       w2v.SGNSConfig(**kw), num_devices=2,
                                       device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_multiproc_needs_a_row_width_without_blocks():
    cfg = w2v.SGNSConfig(dim=4, iters=1)
    with pytest.raises(ValueError):
        w2v.train_skipgram_multiproc([], 8, 5, cfg, num_devices=2,
                                     device="cpu")
    w_in, _ = w2v.train_skipgram_multiproc([], 8, 5, cfg, num_devices=2,
                                           row_width=6, device="cpu")
    assert w_in.shape == (5, 4) and np.isfinite(w_in).all()


def test_reduction_buffer_and_backend_rule():
    """The buffer's layout and size; the backend from the device map."""
    assert da.buffer_numel(10, 4) == 2 * 10 * 4 + 2 * 10
    buf = torch.zeros(da.buffer_numel(10, 4))
    acc_in, acc_out, cnt_in, cnt_out = da.buffer_views(buf, 10, 4)
    acc_out[3, 1] = 2.0
    cnt_in[9] = 1.0
    assert buf[10 * 4 + 3 * 4 + 1] == 2.0
    assert buf[2 * 10 * 4 + 9] == 1.0
    assert [p.value for p in da.buffer_ptrs(buf, 10, 4)] == [
        v.data_ptr() for v in (acc_in, acc_out, cnt_in, cnt_out)]
    for layout in (da.buffer_views, da.buffer_ptrs):
        with pytest.raises(ValueError):
            layout(buf[1:], 10, 4)
    assert dp.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert dp.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert dp.backend_for(["cpu", "cpu"]) == "gloo"
    assert dp.backend_for(["cuda", "cuda"]) == "gloo"
    assert list(dp.slot_range(1, 3)) == [3, 4, 5]
    assert dp.rank_world() == (0, 1)
    key = prng.prng_key(4)
    with jax.enable_x64(False):
        want = jax.random.key_data(jax.random.fold_in(
            jax.random.PRNGKey(4), 3))
    assert dp.slot_key(key, 3).tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# The kernels' changes in NumPy (float32), against the plain float64 step


def _exact_accumulate_np(w_in, w_out, block, cwin, negs, window, acc, cnt):
    """csrc/sgns_exact.cu in accumulate mode, with no shared-memory table
    (every row straight to its delta slot, claimed at its first touch):
    phase (a) adds each valid pair's gradient rows, from the old tables,
    into the slots; phase (b) adds each listed slot's delta row and count
    into the buffer's acc and cnt rows and empties the slot. Returns the
    rows listed of each table."""
    B, T = block.shape
    V, D = w_in.shape
    k = negs.shape[1]
    W2 = 2 * window
    d = [dict(), dict()]          # row -> [delta, count], in claim order
    for p in range(B * T):
        b, t = divmod(p, T)
        center = block[b, t]
        if center < 0:
            continue
        dvi, nvalid = np.zeros(D, np.float32), 0
        for o in range(W2):
            off = o - window if o < window else o - window + 1
            tc = t + off
            if abs(off) > cwin[b, t] or not 0 <= tc < T or block[b, tc] < 0:
                continue
            nvalid += 1
            vi = w_in[center]
            targets = [block[b, tc]] + list(negs[p * W2 + o])
            vo = w_out[targets]
            g = (np.float32(1) / (np.float32(1) + np.exp(-(vo @ vi)))
                 ).astype(np.float32)
            g[0] -= np.float32(1)
            dvi += (g[:, None] * vo).sum(0, dtype=np.float32)
            for tgt, gj in zip(targets, g):
                slot = d[1].setdefault(int(tgt), [np.zeros(D, np.float32),
                                                  0])
                slot[0] += gj * vi
                slot[1] += 1
        if nvalid:
            slot = d[0].setdefault(int(center), [np.zeros(D, np.float32), 0])
            slot[0] += dvi
            slot[1] += nvalid
    for t in (0, 1):                              # phase (b), accumulate
        for row, (delta, n) in d[t].items():
            acc[t][row] += delta
            cnt[t][row] += np.float32(n)
    return [list(d[t]) for t in (0, 1)]


def _conv_scatter_accumulate_np(block, d_in, acc_out, cnt_pos, d_wn, negs,
                                nvalid, nw, acc, cnt, hub):
    """csrc/sgns_conv.cu's scatter kernel in accumulate mode: each token
    group's rows summed by units of `hub` positions in group order, the
    unit sums in unit order, the sum added into acc[tok] and the count into
    cnt[tok]; each negative's d_wn * (valid pairs * nw / cnt_n) into
    acc_out and cnt_n into cnt_out."""
    g = sgns_conv.group_blocks(torch.as_tensor(block)[None], hub)
    order = g.order[0].numpy()
    flat = block.reshape(-1)
    tokens = flat[order]
    for tok in np.unique(tokens[tokens >= 0]):
        pos = order[tokens == tok]                # the group, in order
        for t, src in ((0, d_in), (1, acc_out)):
            row = np.zeros(src.shape[1], np.float32)
            for u0 in range(0, len(pos), hub):
                part = np.zeros(src.shape[1], np.float32)
                for j in pos[u0:u0 + hub]:
                    part = part + src[j]
                row = row + part
            total = int(cnt_pos[t][pos].sum())
            if total == 0:
                continue
            acc[t][tok] += row
            cnt[t][tok] += np.float32(total)
    cnt_n = max(np.float32(nvalid) * np.float32(nw), np.float32(1))
    scale = np.float32(nvalid) * np.float32(nw) / cnt_n
    for n, row in enumerate(negs):
        acc[1][row] += d_wn[n] * scale
        cnt[1][row] += cnt_n


def _dp_apply_np(w_in, w_out, acc, cnt, lr):
    """csrc/dp_apply.cu: (lr * acc) / max(cnt, 1), then the difference,
    each rounded once in float32; the buffer zeroed."""
    out = []
    for w, a, c in zip((w_in, w_out), acc, cnt):
        q = (np.float32(lr) * a) / np.maximum(c, np.float32(1))[:, None]
        out.append((w - q).astype(np.float32))
        a[:] = 0
        c[:] = 0
    return out


@pytest.mark.parametrize("form,own", [("exact", False), ("exact", True),
                                      ("conv", False), ("conv", True)])
def test_kernel_changes_transcribed_match_the_float64_step(form, own):
    """Two slots through the kernels' accumulate modes and K13 in NumPy
    (float32) against the port's plain merged update in float64; K13's
    transcription bit for bit against dp_apply_ref in float32; the buffer
    empty after the update."""
    V, D, B, T, window = 30, 12, 3, 16, 3
    kB, k = (24, 5) if form == "conv" else (None, 2)
    P = 2
    blocks, cwin, negs = _slot_blocks(P, B, T, V, 11, own, kB, k, window)
    w_in, w_out = _tables(V, D, 11)
    want = _port_merged(w_in, w_out, blocks, cwin, negs, window, kB, k,
                        dtype=torch.float64)
    acc = [np.zeros((V, D), np.float32) for _ in range(2)]
    cnt = [np.zeros(V, np.float32) for _ in range(2)]
    for s in range(P):
        if kB:
            wi, wo = torch.tensor(w_in), torch.tensor(w_out)
            valid, _ = sgns_exact._valid_from_cwin(
                torch.as_tensor(blocks[s]), torch.as_tensor(cwin[s]), window)
            # the accumulate kernel and sgns_shared_grads are unchanged:
            # their outputs by position, from the plain pieces
            (tok, _, d_in, a_out, _, _, d_wn, _, _) = sgns_conv._conv_grads(
                wi, wo, torch.as_tensor(blocks[s]), valid,
                torch.as_tensor(negs[s]), k / kB, window)
            vf = valid.numpy()
            offs = sgns_exact._offsets(window)
            vcnt = vf.sum(-1).reshape(-1)
            cnt_out_pos = sum(sgns_conv._shift(torch.as_tensor(
                vf[..., i].astype(np.int64)), -d).numpy()
                for i, d in enumerate(offs)).reshape(-1)
            _conv_scatter_accumulate_np(
                blocks[s], d_in.numpy(), a_out.numpy(),
                (vcnt, cnt_out_pos), d_wn.numpy(), negs[s], int(vf.sum()),
                np.float32(k / kB), acc, cnt, hub=4)
        else:
            _exact_accumulate_np(w_in, w_out, blocks[s], cwin[s], negs[s],
                                 window, acc, cnt)
    buf = torch.as_tensor(np.concatenate(
        [acc[0].ravel(), acc[1].ravel(), cnt[0], cnt[1]]))
    ref_in, ref_out = torch.tensor(w_in), torch.tensor(w_out)
    da.dp_apply_ref(ref_in, ref_out, buf.clone(), float(LR))
    got = _dp_apply_np(w_in, w_out, acc, cnt, LR)
    np.testing.assert_array_equal(got[0], ref_in.numpy())
    np.testing.assert_array_equal(got[1], ref_out.numpy())
    assert not any(a.any() for a in acc) and not any(c.any() for c in cnt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_dp_apply_ref_is_the_jax_expression():
    """dp_apply_ref against the JAX expression of the psum'd update, and
    the buffer left empty; a row that no slot touched (count 0, sum 0)
    stays as it is."""
    rng = np.random.default_rng(5)
    V, D = 17, 7
    w_in, w_out = _tables(V, D, 5)
    acc = [rng.standard_normal((V, D)).astype(np.float32) for _ in range(2)]
    cnt = [rng.integers(0, 4, V).astype(np.float32) for _ in range(2)]
    for a, c in zip(acc, cnt):
        a[c == 0] = 0
    buf = torch.as_tensor(np.concatenate(
        [acc[0].ravel(), acc[1].ravel(), cnt[0], cnt[1]]))
    a_in, a_out = torch.tensor(w_in), torch.tensor(w_out)
    da.dp_apply(a_in, a_out, buf, float(LR))
    assert not buf.any()
    with jax.enable_x64(False):
        for got, w, a, c in ((a_in, w_in, acc[0], cnt[0]),
                             (a_out, w_out, acc[1], cnt[1])):
            want = np.asarray(jnp.asarray(w) - LR * jnp.asarray(a)
                              / jnp.maximum(jnp.asarray(c), 1.0)[:, None])
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
            zero = c == 0
            np.testing.assert_array_equal(got.numpy()[zero], w[zero])


def test_cli_partitions_default_to_the_card(karate_path, tmp_path,
                                            monkeypatch):
    """`node2vec --w2vPartitions 2` runs on the card by default: with none,
    CudaUnavailable before anything is written; device="cpu" runs it."""
    from stellar_rw_tpu_torch import cli

    argv = ["--cmd", "node2vec", "--input", karate_path, "--output",
            str(tmp_path / "o"), "--walkLength", "4", "--numWalks", "1",
            "--dim", "8", "--iter", "1", "--w2vPartitions", "2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(cli.CudaUnavailable):
        cli.main(argv)
    assert not (tmp_path / "o").exists()
    assert cli.main(argv, device="cpu") == 0
