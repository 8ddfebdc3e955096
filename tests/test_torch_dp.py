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


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_merged_twin_matches_jax(P, own, padded):
    """The exact form's merged update as the trainer makes it on one card,
    one step over the P slots' blocks (sgns_exact_step on slots[:, i] of
    [P, n_blocks, B, T] and the chunk's [P, n, ...] draws: on the CPU its
    twin, each slot's accumulate then dp_apply_ref), against the JAX
    package's psum'd _sgns_apply under shard_map over P CPU devices;
    own-token negatives, and a last slot whose walks are all -1 (the
    padding of a ragged corpus)."""
    V, D, B, T, window, k = 40, 16, 3, 14, 3, 3
    blocks, cwin, negs = _slot_blocks(P, B, T, V, P + 10, own, None, k,
                                      window)
    if padded:
        blocks[-1] = -1
    w_in, w_out = _tables(V, D, P)
    want = _jax_merged(w_in, w_out, blocks, cwin, negs, window, None, k)
    n, j = 3, 1
    laid = lambda x: torch.as_tensor(np.repeat(x[:, None], n, axis=1))
    got = [torch.tensor(w) for w in (w_in, w_out)]
    sgns_exact.sgns_exact_step(*got, laid(blocks)[:, j], laid(cwin)[:, j],
                               laid(negs)[:, j], float(LR), window)
    for g, w, old in zip(got, want, (w_in, w_out)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
        assert not np.array_equal(g.numpy(), old)
    # the one-slot-at-a-time form of the same update agrees too
    one = _port_merged(w_in, w_out, blocks, cwin, negs, window, None, k)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g.numpy(), o)


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


@pytest.mark.parametrize("P", [2, 4, 3])
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


def _exact_accumulate_np(w_in, w_out, block, cwin, negs, window, acc, cnt,
                         d=None):
    """csrc/sgns_exact.cu in accumulate mode, with no shared-memory table
    (every row straight to its delta slot, claimed at its first touch):
    phase (a) adds each valid pair's gradient rows, from the old tables,
    into the slots; phase (b) adds each listed slot's delta row and count
    into the buffer's acc and cnt rows and empties the slot. Returns the
    rows listed of each table. d: delta slots that other slots of the same
    launch filled first (phase (b) then runs over all of them); block
    [S, B, T]: the S slots of one launch."""
    if block.ndim == 3:
        d = [dict(), dict()]
        for s in range(len(block) - 1):
            _exact_deltas_np(w_in, w_out, block[s], cwin[s], negs[s], window,
                             d)
        return _exact_accumulate_np(w_in, w_out, block[-1], cwin[-1],
                                    negs[-1], window, acc, cnt, d)
    d = d or [dict(), dict()]
    _exact_deltas_np(w_in, w_out, block, cwin, negs, window, d)
    for t in (0, 1):                              # phase (b), accumulate
        for row, (delta, n) in d[t].items():
            acc[t][row] += delta
            cnt[t][row] += np.float32(n)
    return [list(d[t]) for t in (0, 1)]


def _exact_deltas_np(w_in, w_out, block, cwin, negs, window, d):
    """Phase (a) of the transcription above for one block: its pairs'
    gradient rows into the delta slots d (row -> [delta, count], in claim
    order)."""
    B, T = block.shape
    V, D = w_in.shape
    W2 = 2 * window
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


def _conv_scatter_accumulate_np(block, d_in, acc_out, cnt_pos, d_wn, negs,
                                nvalid, nw, acc, cnt):
    """csrc/sgns_conv.cu's scatter in accumulate mode: each negative's
    d_wn * (valid pairs * nw / cnt_n) into acc_out and cnt_n into cnt_out;
    then each (position, table): a position at padding or with count 0 in
    the table adds nothing, any other adds its row into acc[tok] and its
    count into cnt[tok], each add rounded in float32."""
    vsum = np.float32(nvalid) * np.float32(nw)
    cnt_n = max(vsum, np.float32(1))
    scale = np.float32(vsum / cnt_n)
    for n, row in enumerate(negs):
        acc[1][row] += d_wn[n] * scale
        cnt[1][row] += cnt_n
    for p, tok in enumerate(block.reshape(-1)):
        for t, src in ((0, d_in), (1, acc_out)):
            if tok < 0 or cnt_pos[t][p] == 0:
                continue
            acc[t][tok] += src[p]
            cnt[t][tok] += np.float32(cnt_pos[t][p])


def _dp_apply_np(w_in, w_out, acc, cnt, lr, warps=3):
    """csrc/dp_apply.cu on a grid of `warps` warps: the 2·V rows (acc_in's,
    then acc_out's) in sectors of 4 dealt to the warps in turn; each row
    whose count is not 0 moves by (lr * acc) / max(cnt, 1), then the
    difference, each rounded once in float32, and its acc row and count are
    zeroed. A row whose count is 0 is not read."""
    out = [w_in.copy(), w_out.copy()]
    rows = [(t, r) for t in (0, 1) for r in range(len(cnt[t]))]
    sectors = -(-len(rows) // 4)
    dealt = [s for w in range(warps) for s in range(w, sectors, warps)]
    assert sorted(dealt) == list(range(sectors))
    for sec in dealt:
        for t, r in rows[4 * sec:4 * sec + 4]:
            if cnt[t][r] == 0:
                continue
            q = (np.float32(lr) * acc[t][r]) / max(cnt[t][r], np.float32(1))
            out[t][r] = (out[t][r] - q).astype(np.float32)
            acc[t][r] = 0
            cnt[t][r] = 0
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
                np.float32(k / kB), acc, cnt)
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


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("own", [False, True])
def test_slots_in_one_accumulate_launch_transcribed(P, own):
    """A rank's slots in one accumulate launch (the exact form across
    ranks): every slot's gradient rows summed in one set of delta slots,
    then added into the buffer once a row, transcribed in NumPy float32.
    The counts equal the plain accumulate's, acc is exactly 0 wherever the
    count is 0 (K13's precondition), and K13's transcription of the buffer
    is within rtol 1e-5 atol 1e-6 of the plain merged update in float64
    and bit for bit dp_apply_ref in float32."""
    V, D, B, T, window, k = 600, 12, 3, 16, 2, 2
    blocks, cwin, negs = _slot_blocks(P, B, T, V, 13, own, None, k, window)
    w_in, w_out = _tables(V, D, 13)
    want = _port_merged(w_in, w_out, blocks, cwin, negs, window, None, k,
                        dtype=torch.float64)
    acc = [np.zeros((V, D), np.float32) for _ in range(2)]
    cnt = [np.zeros(V, np.float32) for _ in range(2)]
    listed = _exact_accumulate_np(w_in, w_out, blocks, cwin, negs, window,
                                  acc, cnt)
    assert all(len(set(r)) == len(r) for r in listed)
    plain = torch.zeros(da.buffer_numel(V, D))
    sgns_exact.sgns_exact_accumulate_ref(
        torch.tensor(w_in), torch.tensor(w_out),
        *(torch.as_tensor(x) for x in (blocks, cwin, negs)), window, plain)
    np.testing.assert_array_equal(cnt[0], da.buffer_views(plain, V, D)[2])
    np.testing.assert_array_equal(cnt[1], da.buffer_views(plain, V, D)[3])
    for a, c in zip(acc, cnt):
        assert (c == 0).any() and not a[c == 0].any()
    buf = torch.as_tensor(np.concatenate(
        [acc[0].ravel(), acc[1].ravel(), cnt[0], cnt[1]]))
    ref = [torch.tensor(w) for w in (w_in, w_out)]
    da.dp_apply_ref(*ref, buf, float(LR))
    got = _dp_apply_np(w_in, w_out, acc, cnt, LR)
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g, r.numpy())
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("multiproc", [False, True])
def test_exact_partitions_merge_without_a_buffer(walks, multiproc,
                                                 monkeypatch):
    """In one process the exact form's merged update is the step over all
    the slots (no reduction buffer: dp.merge, and with it K13, never
    runs), and one call a block index; the conv form still merges through
    the buffer."""
    calls = {"merge": 0, "step": 0}
    merge, step = dp.merge, w2v.sgns_exact_step

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(dp, "merge", count("merge", merge))
    monkeypatch.setattr(w2v, "sgns_exact_step", count("step", step))
    for kB in (0, 8):
        calls.update(merge=0, step=0)
        kw = dict(dim=8, window=3, negatives=2, iters=1, seed=3, lr=0.05,
                  shared_negatives=kB)
        if multiproc:
            blocks, rows = w2v.full_corpus_blocks(walks, 2)
            w2v.train_skipgram_multiproc(blocks, rows, 34,
                                         w2v.SGNSConfig(**kw), num_devices=2,
                                         device="cpu")
            merged = (rows // 2) // w2v._divisor_block(rows // 2, 16)
        else:
            w2v.train_skipgram(walks.copy(), 34, w2v.SGNSConfig(**kw),
                               num_partitions=2, device="cpu")
            merged = -(-97 // 32)
        if kB:
            assert calls["merge"] == merged and calls["step"] == 0
        else:
            assert calls["merge"] == 0 and calls["step"] == merged


def _one_slot(tokens, form, V, B, T, window, kB, k, seed):
    """One slot's block, windows and negatives: Zipf tokens, Zipf with the
    block's own tokens among its negatives, or one token alone."""
    blocks, cwin, negs = _slot_blocks(1, B, T, V, seed,
                                      tokens == "own negatives", kB, k,
                                      window)
    if tokens == "one token":
        blocks[blocks >= 0] = 3
    return blocks[0], cwin[0], negs[0]


def _jax_accumulators(form, w_in, w_out, block, valid, negs, window, kB, k,
                      monkeypatch):
    """The JAX package's psum'd step's dense accumulators (acc_in, cnt_in,
    acc_out, cnt_out) for one slot: its psum taken as the identity and
    recorded, the step run eagerly."""
    seen = []

    def psum(x, axis_name):
        seen.append(np.asarray(x))
        return x
    monkeypatch.setattr(jax.lax, "psum", psum)
    with jax.enable_x64(False):
        if form == "conv":
            jw2v._sgns_apply_shared_conv(
                jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(block),
                jnp.asarray(valid), jnp.asarray(negs), LR,
                neg_weight=k / kB, window=window, axis_name="dp")
        else:
            T = block.shape[1]
            offs = np.concatenate([np.arange(-window, 0),
                                   np.arange(1, window + 1)])
            ctx = np.clip(np.arange(T)[:, None] + offs[None, :], 0, T - 1)
            centers = np.broadcast_to(block[:, :, None], valid.shape)
            jw2v._sgns_apply(jnp.asarray(w_in), jnp.asarray(w_out),
                             jnp.asarray(centers.reshape(-1)),
                             jnp.asarray(block[:, ctx].reshape(-1)),
                             jnp.asarray(valid.reshape(-1)),
                             jnp.asarray(negs), LR, axis_name="dp")
    assert len(seen) == 4
    return seen


@pytest.mark.parametrize("form", ["exact", "conv"])
@pytest.mark.parametrize("tokens", ["zipf", "own negatives", "one token"])
def test_rows_with_count_zero_have_acc_zero(form, tokens, monkeypatch):
    """What csrc/dp_apply.cu relies on to skip a row: in the JAX package's
    psum'd step (its dense accumulators, x64 off) and in the port's
    accumulate modes alike, every row whose count is 0 has acc exactly 0;
    padding and windows leave such rows among the block's own tokens."""
    V, D, B, T, window = 400, 8, 3, 14, 3
    kB, k = (16, 5) if form == "conv" else (None, 3)
    block, cwin, negs = _one_slot(tokens, form, V, B, T, window, kB, k, 5)
    w_in, w_out = _tables(V, D, 5)
    valid = sgns_exact._valid_from_cwin(torch.as_tensor(block),
                                        torch.as_tensor(cwin), window)[0]
    a_in, c_in, a_out, c_out = _jax_accumulators(
        form, w_in, w_out, block, valid.numpy(), negs, window, kB, k,
        monkeypatch)
    buf = torch.zeros(da.buffer_numel(V, D))
    args = (torch.tensor(w_in), torch.tensor(w_out), torch.as_tensor(block),
            torch.as_tensor(cwin), torch.as_tensor(negs))
    if kB:
        sgns_conv.sgns_conv_accumulate_ref(*args, k / kB, window, buf)
    else:
        sgns_exact.sgns_exact_accumulate_ref(*args, window, buf)
    p_in, p_out, q_in, q_out = (x.numpy() for x in da.buffer_views(buf, V, D))
    for acc, cnt in ((a_in, c_in), (a_out, c_out), (p_in, q_in),
                     (p_out, q_out)):
        zero = cnt == 0
        assert zero.any() and not zero.all()
        assert (acc[zero] == 0).all()
    np.testing.assert_array_equal(q_in, c_in)
    np.testing.assert_array_equal(q_out, c_out)


@pytest.mark.parametrize("form,V,D", [("exact", 300, 12), ("conv", 30, 12),
                                      ("conv", 200, 5), ("exact", 650, 3)])
def test_touched_rows_apply_is_dp_apply_ref(form, V, D):
    """K13's transcription, which moves only the rows whose count is not 0
    and never reads the others (their acc poisoned with NaN stays as it
    was), bit for bit dp_apply_ref on buffers that two slots' plain
    accumulate steps filled, and the buffer empty after it."""
    B, T, window = 3, 16, 3
    kB, k = (24, 5) if form == "conv" else (None, 2)
    blocks, cwin, negs = _slot_blocks(2, B, T, V, V, True, kB, k, window)
    w_in, w_out = _tables(V, D, V)
    buf = torch.zeros(da.buffer_numel(V, D))
    for s in range(2):
        args = (torch.tensor(w_in), torch.tensor(w_out),
                torch.as_tensor(blocks[s]), torch.as_tensor(cwin[s]),
                torch.as_tensor(negs[s]))
        if kB:
            sgns_conv.sgns_conv_accumulate_ref(*args, k / kB, window, buf)
        else:
            sgns_exact.sgns_exact_accumulate_ref(*args, window, buf)
    acc = [a.numpy().copy() for a in da.buffer_views(buf, V, D)[:2]]
    cnt = [c.numpy().copy() for c in da.buffer_views(buf, V, D)[2:]]
    untouched = [c == 0 for c in cnt]
    assert all(u.any() and not u.all() for u in untouched)
    for a, u in zip(acc, untouched):
        a[u] = np.nan
    ref_in, ref_out = torch.tensor(w_in), torch.tensor(w_out)
    da.dp_apply_ref(ref_in, ref_out, buf, float(LR))
    got = _dp_apply_np(w_in, w_out, acc, cnt, LR)
    np.testing.assert_array_equal(got[0], ref_in.numpy())
    np.testing.assert_array_equal(got[1], ref_out.numpy())
    for a, c, u in zip(acc, cnt, untouched):
        assert np.isnan(a[u]).all() and not a[~u].any() and not c.any()


@pytest.mark.parametrize("where", ["acc_in", "acc_out"])
def test_touched_rows_apply_needs_acc_zero_at_count_zero(where):
    """K13's precondition pinned: on a buffer with acc not 0 at a row whose
    count is 0 (which no accumulate step makes), dp_apply_ref moves that
    row by lr * acc while the kernel's transcription leaves it, and its acc,
    as they were; every other row agrees bit for bit."""
    rng = np.random.default_rng(17)
    V, D = 23, 6
    w_in, w_out = _tables(V, D, 17)
    acc = [rng.standard_normal((V, D)).astype(np.float32) for _ in range(2)]
    cnt = [rng.integers(0, 3, V).astype(np.float32) for _ in range(2)]
    for a, c in zip(acc, cnt):
        a[c == 0] = 0
    t = ("acc_in", "acc_out").index(where)
    row = int(np.flatnonzero(cnt[t] == 0)[0])
    acc[t][row] = 0.5
    buf = torch.as_tensor(np.concatenate(
        [acc[0].ravel(), acc[1].ravel(), cnt[0], cnt[1]]))
    ref = (torch.tensor(w_in), torch.tensor(w_out))
    da.dp_apply_ref(*ref, buf, float(LR))
    got = _dp_apply_np(w_in, w_out, acc, cnt, LR)
    differ = [np.flatnonzero((g != r.numpy()).any(-1))
              for g, r in zip(got, ref)]
    assert [list(d) for d in differ] == [[row] if s == t else []
                                         for s in (0, 1)]
    np.testing.assert_array_equal(got[t][row], (w_in, w_out)[t][row])
    assert (acc[t][row] == 0.5).all() and not acc[1 - t].any()


@pytest.mark.parametrize("D", [12, 13])
@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("tokens", ["zipf", "own negatives", "one token"])
def test_scatter_accumulate_transcribed(tokens, window, D):
    """The scatter in accumulate mode transcribed (a position and table at
    a time, count-0 positions skipped) against the plain accumulate mode
    in float64: counts equal, the merged update of its buffer within rtol
    1e-5 atol 1e-6 of the float64 one (a float32 sum of a hub row's many
    positions is further from float64 than that before it is divided by
    its count), and acc exactly 0 where the count is 0."""
    V, B, T, kB, k = 40, 3, 16, 24, 5
    block, cwin, negs = _one_slot(tokens, "conv", V, B, T, window, kB, k, 9)
    w_in, w_out = _tables(V, D, 9)
    want = torch.zeros(da.buffer_numel(V, D), dtype=torch.float64)
    sgns_conv.sgns_conv_accumulate_ref(
        torch.tensor(w_in, dtype=torch.float64),
        torch.tensor(w_out, dtype=torch.float64), torch.as_tensor(block),
        torch.as_tensor(cwin), torch.as_tensor(negs), k / kB, window, want)
    valid, _ = sgns_exact._valid_from_cwin(torch.as_tensor(block),
                                           torch.as_tensor(cwin), window)
    (_, _, d_in, a_out, _, _, d_wn, _, _) = sgns_conv._conv_grads(
        torch.tensor(w_in), torch.tensor(w_out), torch.as_tensor(block),
        valid, torch.as_tensor(negs), k / kB, window)
    vf = valid.numpy()
    vcnt = vf.sum(-1).reshape(-1)
    cnt_out_pos = sum(sgns_conv._shift(torch.as_tensor(
        vf[..., i].astype(np.int64)), -d).numpy()
        for i, d in enumerate(sgns_exact._offsets(window))).reshape(-1)
    acc = [np.zeros((V, D), np.float32) for _ in range(2)]
    cnt = [np.zeros(V, np.float32) for _ in range(2)]
    _conv_scatter_accumulate_np(block, d_in.numpy(), a_out.numpy(),
                                (vcnt, cnt_out_pos), d_wn.numpy(), negs,
                                int(vf.sum()), np.float32(k / kB), acc, cnt)
    w = [x.numpy() for x in da.buffer_views(want, V, D)]
    # the in-table counts are whole; cnt_out holds the negatives' fractional
    # cnt_n, summed in float32
    np.testing.assert_array_equal(cnt[0], w[2])
    np.testing.assert_allclose(cnt[1], w[3], rtol=1e-6)
    assert ((cnt[1] == 0) == (w[3] == 0)).all()
    for t in (0, 1):
        assert not acc[t][cnt[t] == 0].any()
    moved = [torch.tensor(w, dtype=torch.float64) for w in (w_in, w_out)]
    da.dp_apply_ref(*moved, torch.as_tensor(np.concatenate(
        [acc[0].ravel(), acc[1].ravel(), cnt[0], cnt[1]])).double(),
        float(LR))
    ref = [torch.tensor(w, dtype=torch.float64) for w in (w_in, w_out)]
    da.dp_apply_ref(*ref, want, float(LR))
    for a, b in zip(moved, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("V", [1, 3, 1001, 10_000, 1_000_000, 5_000_000])
@pytest.mark.parametrize("sms", [132, 8])
def test_dp_apply_launch_plan(V, sms):
    """K13's grid: a warp a sector of SECTOR rows while one wave of
    resident blocks holds that many warps, else that one wave; no block
    without a sector."""
    blocks = da.launch_plan(V, sms)
    sectors = -(-2 * V // da.SECTOR)
    warps = blocks * da.THREADS // 32
    assert 1 <= blocks <= da.BLOCKS_PER_SM * sms
    assert warps >= sectors or blocks == da.BLOCKS_PER_SM * sms
    assert warps - da.THREADS // 32 < sectors


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
