"""The hierarchical-softmax trainer of the port (models/hsoftmax.py,
ops/hsoftmax.py) against the JAX package's stellar_rw_tpu/models/
hsoftmax.py, and the design of its kernel (csrc/hsoftmax.cu) transcribed
in NumPy against the plain step in float64.

One block of hs_step_ref against one block of the JAX _hs_epoch (rtol 1e-5,
atol 1e-6: the sums run in another order); train_skipgram_hs on the CPU
against the JAX trainer after 2 epochs (rtol 1e-4, atol 1e-6); the karate
quality gate of tests/test_hsoftmax.py. The transcription walks the
kernel's grid under launch_plan: persistent blocks striding over halo tiles
of a walk, each tile's syn0 rows and their gradient sums by halo position,
a center's live levels KGROUP at a time against its valid contexts, each
level group's node rows into their delta slots, the halo sums flushed
after each tile, then the update as sum over count. JAX runs with x64 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_rw_tpu.models import hsoftmax as jhs
from stellar_rw_tpu.models import word2vec as jw2v
from stellar_rw_tpu_torch.graph import io
from stellar_rw_tpu_torch.models import eval as ev
from stellar_rw_tpu_torch.models import hsoftmax as hs
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.ops import hsoftmax as ops_hs
from stellar_rw_tpu_torch.ops import prng
from stellar_rw_tpu_torch.ops import trainer_draws as td
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)


def _karate_walks(karate_path, walk_length=20, num_walks=10, seed=2):
    g = io.load_edge_list(karate_path, weighted=False, directed=False)
    walks = engine.random_walks(g, walk_length=walk_length,
                                num_walks=num_walks, p=0.25, q=0.25,
                                seed=seed, device="cpu")
    return g, np.asarray(walks)


def _zipf_block(B, T, V, seed, pads=True):
    rng = np.random.default_rng(seed)
    block = np.minimum(rng.zipf(1.5, (B, T)) - 1, V - 1).astype(np.int32)
    if pads:
        block[-1, T - 5:] = -1             # a walk that ended early
        block[0, 2:4] = -1                 # padding inside a walk
    return block


def _case(name, karate_path):
    """(block [B, T], V, D, window, counts): karate walks; a Zipf(1.5)
    corpus of 200 tokens (deep paths); the same with pad rows."""
    if name == "karate":
        g, walks = _karate_walks(karate_path)
        block = walks[:12].astype(np.int32)
        counts = np.bincount(walks[walks >= 0], minlength=34)
        return block, 34, 16, 5, counts.astype(np.float64)
    block = _zipf_block(6, 23, 200, seed=3, pads=name == "zipf pads")
    counts = np.random.default_rng(4).zipf(1.5, 200).astype(np.float64)
    return block, 200, 24, 4, counts


def _tables(V, D, seed):
    rng = np.random.default_rng(seed)
    syn0 = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    syn1 = (rng.standard_normal((max(V - 1, 1), D)) * 0.3).astype(np.float32)
    return syn0, syn1


def _cwin(B, T, window, seed, ep=1):
    key = prng.fold_in(prng.prng_key(seed), ep)
    cwin, _ = td.trainer_draws(key, 0, 1, B, T, window, (0,), None, None)
    return key, cwin[0]


def _plain(syn0, syn1, block, cwin, huff, lr, window, dtype):
    a0 = torch.tensor(syn0, dtype=dtype)       # copies: updated in place
    a1 = torch.tensor(syn1, dtype=dtype)
    pts, lbl, pmk = (torch.as_tensor(x) for x in huff)
    ops_hs.hs_step_ref(a0, a1, torch.as_tensor(block), cwin, pts, lbl, pmk,
                       lr, window)
    return a0.numpy(), a1.numpy()


# ----------------------------------------------------------------- draws


def test_trainer_draws_ref_without_negatives_matches_jax():
    """The HS trainer's draws: the windows alone (M = 0, no alias table),
    bit for bit the JAX epoch's randint of each block's key."""
    B, T, window = 5, 17, 4
    key = prng.fold_in(prng.prng_key(6), 2)
    cwin, negs = td.trainer_draws_ref(key, 3, 4, B, T, window, (0,), None,
                                      None)
    assert cwin.shape == (4, B, T) and negs.shape == (4, 0)
    assert negs.dtype == torch.int32
    with jax.enable_x64(False):
        jkey = jax.random.fold_in(jax.random.PRNGKey(6), 2)
        for j, i in enumerate(range(3, 7)):
            want = jax.random.randint(jax.random.fold_in(jkey, i), (B, T), 1,
                                      window + 1)
            np.testing.assert_array_equal(cwin[j].numpy(), np.asarray(want))


# ------------------------------------------------------------ one block


@pytest.mark.parametrize("name", ["karate", "zipf", "zipf pads"])
def test_hs_step_ref_matches_one_jax_block(karate_path, name):
    block, V, D, window, counts = _case(name, karate_path)
    B, T = block.shape
    huff = hs.build_huffman(counts)
    syn0, syn1 = _tables(V, D, seed=B)
    key, cwin = _cwin(B, T, window, seed=9)
    lr = 0.05
    with jax.enable_x64(False):
        jkey = jax.random.fold_in(jax.random.PRNGKey(9), 1)
        j0, j1 = jhs._hs_epoch(
            jnp.array(syn0), jnp.array(syn1), jnp.asarray(block[None]),
            *(jnp.asarray(x) for x in huff), jkey, np.float32(lr),
            np.float32(lr), window)
        j0, j1 = np.asarray(j0), np.asarray(j1)
    p0, p1 = _plain(syn0, syn1, block, cwin, huff, lr, window, torch.float32)
    np.testing.assert_allclose(p0, j0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p1, j1, rtol=1e-5, atol=1e-6)
    assert np.abs(p0 - syn0).max() > 0 and np.abs(p1 - syn1).max() > 0


def test_hs_step_ref_tiny_vocabularies():
    """V = 1 (no live path entry: nothing moves) and V = 2 (a one-level
    tree: syn1 of one row)."""
    lr, window = 0.1, 2
    for V in (1, 2):
        block = np.array([[0, V - 1, 0, -1, V - 1, 0]], np.int32)
        huff = hs.build_huffman(np.arange(1, V + 1, dtype=np.float64))
        syn0, syn1 = _tables(V, 8, seed=V)
        _, cwin = _cwin(1, 6, window, seed=V)
        p0, p1 = _plain(syn0, syn1, block, cwin, huff, lr, window,
                        torch.float32)
        with jax.enable_x64(False):
            jkey = jax.random.fold_in(jax.random.PRNGKey(V), 1)
            j0, j1 = jhs._hs_epoch(
                jnp.array(syn0), jnp.array(syn1), jnp.asarray(block[None]),
                *(jnp.asarray(x) for x in huff), jkey, np.float32(lr),
                np.float32(lr), window)
        np.testing.assert_allclose(p0, np.asarray(j0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p1, np.asarray(j1), rtol=1e-5, atol=1e-6)
        if V == 1:
            np.testing.assert_array_equal(p0, syn0)
            np.testing.assert_array_equal(p1, syn1)


# --------------------------------------------------------------- trainer


def test_train_skipgram_hs_matches_jax_two_epochs(karate_path):
    g, walks = _karate_walks(karate_path, walk_length=12, num_walks=4,
                             seed=5)
    cfg = w2v.SGNSConfig(dim=16, window=3, lr=0.1, iters=2, seed=3,
                         row_block=32)
    seen = []
    got = hs.train_skipgram_hs(walks, g.num_vertices, cfg,
                               on_epoch=lambda ep, s: seen.append(ep),
                               device="cpu")
    with jax.enable_x64(False):
        jcfg = jw2v.SGNSConfig(dim=16, window=3, lr=0.1, iters=2, seed=3,
                               row_block=32)
        want = jhs.train_skipgram_hs(walks, g.num_vertices, jcfg)
    assert seen == [0, 1] and got.shape == (34, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_train_skipgram_hs_default_device_is_cuda(karate_path):
    from stellar_rw_tpu_torch.errors import CudaUnavailable

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is served")
    with pytest.raises(CudaUnavailable):
        hs.train_skipgram_hs(np.zeros((2, 3), np.int32), 2,
                             w2v.SGNSConfig(dim=4, iters=1))


def test_hs_trainer_karate_quality(karate_path):
    """The karate gates of tests/test_hsoftmax.py on the port's walks and
    trainer (device="cpu")."""
    g, walks = _karate_walks(karate_path)
    cfg = w2v.SGNSConfig(dim=32, window=5, lr=0.2, iters=20, seed=2)
    syn0 = hs.train_skipgram_hs(walks, g.num_vertices, cfg, device="cpu")
    assert syn0.shape == (34, 32) and np.isfinite(syn0).all()
    edges = [(v, int(d)) for v in range(g.num_vertices)
             for d in g.neighbors(v)[0] if v < int(d)]
    auc = ev.link_prediction_auc(syn0, np.asarray(edges), g.num_vertices,
                                 seed=0)
    acc = ev.node_classification_accuracy(syn0, ev.karate_labels(g.ids),
                                          seed=0)
    assert auc > 0.7 and acc >= 0.85, (auc, acc)


# ------------------------------------------------ the kernel's design


def _kernel_transcription(syn0, syn1, block, cwin, huff, lr, window, plan):
    """csrc/hsoftmax.cu's order in float32 (see the module)."""
    f32 = np.float32
    syn0, syn1 = syn0.copy(), syn1.copy()
    points, labels, pmask = huff
    B, T = block.shape
    D = syn0.shape[1]
    L = points.shape[1]
    tile, H = plan.tile, plan.halo_rows
    per_walk = -(-T // tile)
    d0, d1 = {}, {}             # delta slots: row -> [sum, count]

    def add(d, row, v, n):
        s = d.setdefault(row, [np.zeros(D, f32), 0])
        s[0] += v
        s[1] += n

    for blk in range(plan.blocks):
        for ti in range(blk, B * per_walk, plan.blocks):
            b, t0 = divmod(ti, per_walk)
            t0 *= tile
            tokh = [int(block[b, t]) if 0 <= t < T else -1
                    for t in range(t0 - window, t0 - window + H)]
            xh = np.stack([syn0[max(k, 0)] * f32(k >= 0) for k in tokh])
            dxh = np.zeros((H, D), f32)
            cnth = [0] * H
            for ci in range(min(tile, T - t0)):
                hc = ci + window
                center = tokh[hc]
                if center < 0:
                    continue
                win = min(int(cwin[b, t0 + ci]), window)
                ctx = [hc + d for d in range(-win, win + 1)
                       if d != 0 and tokh[hc + d] >= 0]
                for h in ctx:
                    cnth[h] += 1
                if not ctx:
                    continue
                live = [l for l in range(L) if pmask[center, l] != 0]
                for g0 in range(0, len(live), ops_hs.KGROUP):
                    lev = live[g0:g0 + ops_hs.KGROUP]
                    nodes = [int(points[center, l]) for l in lev]
                    lab = labels[center, lev].astype(f32)
                    vo = syn1[nodes]
                    dvo = np.zeros((len(lev), D), f32)
                    for h in ctx:
                        dots = (vo * xh[h]).sum(1, dtype=f32)
                        gr = (f32(1) / (f32(1) + np.exp(-dots))) - lab
                        dvo += gr[:, None] * xh[h][None]
                        dxh[h] += (gr[:, None] * vo).sum(0, dtype=f32)
                    for node, row in zip(nodes, dvo):
                        add(d1, node, row, len(ctx))
            for h in range(H):
                if cnth[h]:
                    add(d0, tokh[h], dxh[h], cnth[h])
    for w, d in ((syn0, d0), (syn1, d1)):
        for row, (s, n) in d.items():
            w[row] += (f32(-lr) * s) / f32(max(n, 1))
    return syn0, syn1


@pytest.mark.parametrize("name,D,sms,tile", [
    ("karate", 16, 2, 8), ("zipf", 24, 1, 4), ("zipf pads", 24, 3, 8),
    ("zipf pads", 40, 132, None)])
def test_kernel_transcription_matches_float64(karate_path, name, D, sms,
                                              tile):
    """The kernel's order against the plain step in float64 (and the plain
    f32 step), with tiles that split walks (a plan's tile narrowed),
    several tiles a persistent block and several level groups a center."""
    block, V, _, window, counts = _case(name, karate_path)
    B, T = block.shape
    huff = hs.build_huffman(counts)
    syn0, syn1 = _tables(V, D, seed=D)
    _, cwin = _cwin(B, T, window, seed=D + 1)
    lr = 0.05
    plan = ops_hs.launch_plan(D, B, T, window, sms)
    if tile is not None:
        plan = plan._replace(tile=tile, halo_rows=tile + 2 * window,
                             tiles=B * -(-T // tile))
    k0, k1 = _kernel_transcription(syn0, syn1, block, cwin.numpy(), huff, lr,
                                   window, plan)
    w0, w1 = _plain(syn0, syn1, block, cwin, huff, lr, window, torch.float64)
    p0, p1 = _plain(syn0, syn1, block, cwin, huff, lr, window, torch.float32)
    for got, want, plain, old in ((k0, w0, p0, syn0), (k1, w1, p1, syn1)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-6)
        assert np.abs(got - old).max() > 0


def test_kernel_transcription_one_token_block():
    """Every position one token: every center on one path (the hub), V 2
    (a one-level tree) and V 1 (no live level)."""
    for V in (1, 2, 50):
        block = np.zeros((3, 30), np.int32)
        counts = np.arange(V, 0, -1).astype(np.float64)
        huff = hs.build_huffman(counts)
        syn0, syn1 = _tables(V, 8, seed=V)
        _, cwin = _cwin(3, 30, 3, seed=V)
        plan = ops_hs.launch_plan(8, 3, 30, 3, 2)
        k0, k1 = _kernel_transcription(syn0, syn1, block, cwin.numpy(), huff,
                                       0.1, 3, plan)
        w0, w1 = _plain(syn0, syn1, block, cwin, huff, 0.1, 3, torch.float64)
        np.testing.assert_allclose(k0, w0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(k1, w1, rtol=1e-5, atol=1e-6)


def test_launch_plan():
    """Tiles, residency and shared memory of the plan."""
    # the main path's block: tiles of 32 give the card two blocks an SM
    p = ops_hs.launch_plan(128, 256, 82, 10)
    assert (p.tile, p.tiles, p.halo_rows) == (32, 256 * 3, 52)
    assert (p.blocks_per_sm, p.blocks) == (2, 264)
    assert p.smem_bytes == ops_hs.smem_bytes(32, 10, 128) \
        <= ops_hs.SMEM_BUDGETS[0][1]
    # few walks: narrower tiles for more of them
    assert ops_hs.launch_plan(128, 32, 82, 10).tile == 8
    assert ops_hs.launch_plan(64, 4, 3, 2, 2).tile == 3       # never above T
    # wide rows: narrower tiles, then one block an SM before refusing
    p = ops_hs.launch_plan(768, 256, 82, 10)
    assert (p.tile, p.blocks_per_sm) == (16, 1)
    assert p.smem_bytes <= ops_hs.SMEM_BUDGETS[1][1]
    p = ops_hs.launch_plan(384, 256, 82, 10)
    assert (p.tile, p.blocks_per_sm) == (16, 2)
    with pytest.raises(ValueError):
        ops_hs.launch_plan(4096, 2, 82, 10)
    with pytest.raises(ValueError):
        ops_hs.launch_plan(128, 0, 82, 10)
    # the tile's halo: two window's rows beside its centers
    assert ops_hs.smem_bytes(8, 10, 100) == 4 * (
        2 * 28 * 128 + 2 * 28 + 8 * 2 * 10 * ops_hs.KGROUP)


def test_workspace_bounded_by_the_block():
    syn0 = torch.zeros((1000, 8))
    syn1 = torch.zeros((999, 8))
    ws = ops_hs.HSWorkspace(syn0, syn1, 60, 12)
    assert ws.rows == (60, 720)
    assert ws.serves_hs(syn0, syn1, 60, 12)
    assert not ws.serves_hs(syn0, syn1, 61, 12)
    ws = ops_hs.HSWorkspace(syn0, syn1, 5000, 12)
    assert ws.rows == (1000, 999)
    assert ws.map[0].shape == (1000,) and ws.map[1].shape == (999,)
