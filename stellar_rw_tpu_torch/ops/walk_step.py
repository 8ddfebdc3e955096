"""The node2vec walk step: streams, trial semantics, kernel and plain version.

Semantics (the JAX package's walk/engine.py::walk_corpus, vmeta branch, with
ops/sampling.py::alias_draw, _make_trial and rejection_sample_static):

  * row r*W + w of a dispatch is round r of walker w; column 0 is the start,
    column 1 a first-order alias draw, columns 2..L+1 second-order steps; a
    walker that reaches a dead end writes -1 from then on;
  * each second-order step runs trials j = 0 .. T-1 (T = max_rounds *
    k_candidates): an alias candidate of cur, accepted iff
    u_acc * max_f < f(cand) with f = 1/p for cand == prev, 1 for cand in
    N(prev), 1/q otherwise. The first accepting trial wins, else the last
    trial's candidate. p == q == 1 runs trial 0 only, q == 1 reads no
    membership bucket;
  * trial j of step t in round r reads, for lane w: elements (w, Wd+w,
    2Wd+w) of uniform(k, (3, Wd)) for j < DENSE_TRIALS, else
    uniform(fold_in(k, w), (3,)), with k = fold_in(fold_in(fold_in(seed_key,
    round_offset + r), t), j) and Wd = draw_width(n_stream).

`walk_rounds` launches csrc/walk.cu for CUDA tensors and runs the plain
version `walk_corpus_ref` for CPU tensors; the two agree bit for bit. So do
`trial_keys`, which builds the key table by the second kernel of that source
for a CUDA device, and its plain version `trial_keys_ref`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import prng
from ._build import Kernel, ptr, require_cuda, stream
from .sampling import HASH_MULT, DeviceGraph, draw_width

DENSE_TRIALS = 2   # trials read from the (3, Wd) array draw; later ones
#                    read per-lane draws

WALK_KERNEL = Kernel(
    "walk.cu", "srw_walk_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
    + [ctypes.c_int] + [ctypes.c_void_p])
# the key-table kernel of the same source (and the same library)
KEYS_KERNEL = Kernel(
    "walk.cu", "srw_trial_keys_launch",
    [ctypes.c_void_p] + [ctypes.c_uint] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p])

# trial modes (csrc/walk.cu): general, q == 1, p == q == 1
MODE_GENERAL, MODE_Q1, MODE_PQ1 = 0, 1, 2


def bias_constants(p: float, q: float) -> tuple[np.float32, np.float32,
                                                 np.float32, int]:
    """(1/p, 1/q, max_f, mode) rounded as the JAX sampler rounds them: 1/p
    and 1/q are f32 quotients, max_f the f64 max(1/p, 1, 1/q) rounded once
    to f32."""
    inv_p = np.float32(1.0) / np.float32(p)
    inv_q = np.float32(1.0) / np.float32(q)
    max_f = np.float32(max(1.0 / p, 1.0, 1.0 / q))
    if p == 1.0 and q == 1.0:
        mode = MODE_PQ1
    elif q == 1.0:
        mode = MODE_Q1
    else:
        mode = MODE_GENERAL
    return inv_p, inv_q, max_f, mode


def trial_keys(base_key: torch.Tensor, round_offset: int, num_rounds: int,
               walk_length: int, num_trials: int,
               device=None) -> torch.Tensor:
    """The key table [R, L+1, T, 2] on `device` (default: base_key's): key of
    trial j of step t in round r, fold_in(fold_in(fold_in(base_key,
    round_offset + r), t), j). A CUDA device launches the key-table kernel of
    csrc/walk.cu; the CPU runs trial_keys_ref. Either way the 32-bit words
    come as int32 with the same bits, the form walk_rounds reads."""
    device = base_key.device if device is None else torch.device(device)
    if device.type == "cpu":
        return trial_keys_ref(base_key.cpu(), round_offset, num_rounds,
                              walk_length, num_trials)
    KEYS_KERNEL.fn()
    n = num_rounds * (walk_length + 1) * num_trials
    if not 0 <= round_offset < 2**32 or n >= 2**31:
        raise ValueError("trial_keys: round offset or table beyond 32 bits")
    keys = torch.empty((num_rounds, walk_length + 1, num_trials, 2),
                       dtype=torch.int32, device=device)
    require_cuda("trial_keys", keys)
    k0, k1 = (int(v) for v in base_key.tolist())
    KEYS_KERNEL.launch(ptr(keys), k0, k1, round_offset, num_rounds,
                       walk_length + 1, num_trials, stream(device))
    return keys


def trial_keys_ref(base_key: torch.Tensor, round_offset: int,
                   num_rounds: int, walk_length: int,
                   num_trials: int) -> torch.Tensor:
    """Plain torch version of the key-table kernel: int32 [R, L+1, T, 2],
    each 32-bit word as the int32 with the same bits."""
    dev = base_key.device
    rk = prng.fold_in(base_key, torch.arange(num_rounds, device=dev)
                      + round_offset)                          # [R, 2]
    sk = prng.fold_in(rk[:, None, :],
                      torch.arange(walk_length + 1, device=dev))  # [R, L+1, 2]
    keys = prng.fold_in(sk[:, :, None, :],
                        torch.arange(num_trials, device=dev))  # [R, L+1, T, 2]
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)


def trial_uniforms(kj: torch.Tensor, lane: torch.Tensor, j: int, Wd: int):
    """(u_pos, u_keep, u_acc) of trial j for lanes `lane` under trial keys
    kj [n, 2]."""
    if j < DENSE_TRIALS:
        return prng.uniform3_at(kj, lane, Wd)
    kw = prng.fold_in(kj, lane)
    return tuple(prng.uniform_at(kw, torch.full_like(lane, c))
                 for c in range(3))


def _alias_draw(g: DeviceGraph, start, deg, u_pos, u_keep):
    j = torch.minimum((u_pos * deg.to(torch.float32)).to(torch.int32),
                      (deg - 1).clamp_min(0))
    k = (start + j).clamp(0, max(g.num_edges - 1, 0)).long()
    apk = g.alias_packed[k]
    return torch.where(u_keep < apk[:, 0].view(torch.float32), apk[:, 1],
                       apk[:, 2])


def member(g: DeviceGraph, base, mask, cand):
    """cand in the neighbor set whose buckets start at `base` with nb-1 =
    `mask`: a key's only home is bucket hash(cand) & mask."""
    h = (cand.to(torch.int64) * int(HASH_MULT)) & prng.MASK32
    win = g.hash_buckets[(base + (h & mask)).long()]
    return (win == cand[..., None]).any(dim=-1)


def _second_order(g, kt, rnd, lane, Wd, vm, pm, prev, alive, consts, tally):
    """One second-order step for every lane (result unused where dead).
    tally.trials[j] grows by the lanes that ran trial j, tally.acc_draws by
    the trials whose u_acc could decide (f < max_f), tally.step by one for
    each trial a lane ran."""
    inv_p, inv_q, max_f, mode = consts
    dst = torch.zeros_like(prev)
    open_ = alive.clone()
    for j in range(1 if mode == MODE_PQ1 else kt.shape[1]):
        idx = open_.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        tally.trials[j] += idx.numel()
        tally.step[idx] += 1
        u_pos, u_keep, u_acc = trial_uniforms(kt[rnd[idx], j], lane[idx], j,
                                              Wd)
        cand = _alias_draw(g, vm[idx, 0], vm[idx, 1], u_pos, u_keep)
        dst[idx] = cand
        if mode == MODE_PQ1:
            break
        if mode == MODE_Q1:
            f = torch.where(cand == prev[idx], inv_p, 1.0)
        else:
            hit = member(g, pm[idx, 2], pm[idx, 3], cand)
            f = torch.where(cand == prev[idx], inv_p,
                            torch.where(hit, 1.0, inv_q))
        tally.acc_draws += int((f < max_f).sum())
        open_[idx[u_acc * max_f < f]] = False
    return dst


class _Tally:
    """Trial counts of one walk_corpus_ref call."""

    def __init__(self, num_trials: int, n: int, device):
        self.trials = [0] * num_trials
        self.acc_draws = 0
        self.step = torch.zeros(n, dtype=torch.int64, device=device)
        self.walker = torch.zeros(n, dtype=torch.int64, device=device)
        self.step_warp_max = 0

    def close_step(self) -> None:
        """Fold the step's per-lane trial counts into the walk's totals."""
        self.walker += self.step
        self.step_warp_max += int(warp_max(self.step).sum())
        self.step.zero_()


def warp_max(per_lane: torch.Tensor, warp: int = 32) -> torch.Tensor:
    """Maximum over each run of `warp` consecutive lanes (the last run may
    be short): what a warp of the walk kernel waits for."""
    n = per_lane.shape[0]
    pad = torch.zeros(-n % warp, dtype=per_lane.dtype, device=per_lane.device)
    return torch.cat([per_lane, pad]).reshape(-1, warp).max(dim=1).values


def walk_corpus_ref(g: DeviceGraph, starts: torch.Tensor, keys: torch.Tensor,
                    walk_length: int, p: float, q: float, n_stream: int,
                    counts: dict | None = None) -> torch.Tensor:
    """Plain torch version of csrc/walk.cu, vectorized over walkers: each
    step loops trials while any walker is still open. Returns i32
    [R*W, L+2]. `keys` is the int32 table of trial_keys. `counts`, when
    given, receives the trials run: `dense_trials` and `lane_trials` (those
    that read the dense draws, those that read per-lane draws), `acc_draws`
    (the trials whose u_acc could decide: f < max_f), `walker_trials` (i64
    [R*W], each walker's total) and `step_warp_max` (the sum over steps and
    over warps of 32 consecutive walkers of the most trials a lane of the
    warp ran in the step)."""
    dev = starts.device
    keys = keys.to(torch.int64) & prng.MASK32   # the words, unsigned
    R, W = keys.shape[0], starts.shape[0]
    N = R * W
    Wd = draw_width(n_stream)
    inv_p, inv_q, max_f, mode = bias_constants(p, q)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    consts = (f32(inv_p), f32(inv_q), f32(max_f), mode)
    row = torch.arange(N, device=dev)
    rnd, lane = row // W, row % W
    starts_b = starts.repeat(R)
    vm0 = g.vmeta[starts_b.long()]
    alive = vm0[:, 1] > 0
    k0 = keys[rnd, 0, 0]
    dst0 = _alias_draw(g, vm0[:, 0], vm0[:, 1], prng.uniform_at(k0, lane),
                       prng.uniform_at(k0, lane + Wd))
    first = torch.where(alive, dst0, -1)
    cur, prev, pm = torch.where(alive, first, starts_b), starts_b, vm0
    cols = [starts_b, first]
    tally = _Tally(keys.shape[2], N, dev)
    for t in range(1, walk_length + 1):
        vm = g.vmeta[cur.clamp_min(0).long()]
        alive = alive & (vm[:, 1] > 0)
        dst = _second_order(g, keys[:, t], rnd, lane, Wd, vm, pm, prev, alive,
                            consts, tally)
        tally.close_step()
        cols.append(torch.where(alive, dst, -1))
        prev = torch.where(alive, cur, prev)
        pm = torch.where(alive[:, None], vm, pm)
        cur = torch.where(alive, dst, cur)
    if counts is not None:
        counts.update(dense_trials=sum(tally.trials[:DENSE_TRIALS]),
                      lane_trials=sum(tally.trials[DENSE_TRIALS:]),
                      acc_draws=tally.acc_draws,
                      walker_trials=tally.walker,
                      step_warp_max=tally.step_warp_max)
    return torch.stack(cols, dim=1).to(torch.int32)


def walk_rounds(g: DeviceGraph, starts: torch.Tensor, keys: torch.Tensor,
                walk_length: int, p: float, q: float,
                n_stream: int) -> torch.Tensor:
    """R rounds of walks from `starts` (i32 [W]) under the trial key table
    `keys` (trial_keys on the tensors' device) -> i32 [R*W, L+2]. CUDA
    tensors launch csrc/walk.cu; CPU tensors run walk_corpus_ref."""
    if starts.device.type == "cpu":
        return walk_corpus_ref(g, starts, keys, walk_length, p, q, n_stream)
    WALK_KERNEL.fn()
    R, T = keys.shape[0], keys.shape[2]
    W = starts.shape[0]
    N = R * W
    if keys.shape != (R, walk_length + 1, T, 2):
        raise ValueError(f"walk_rounds: key table shape {tuple(keys.shape)}")
    if N >= 2**31 or g.num_edges >= 2**31:
        raise ValueError("walk_rounds: batch or graph beyond i32 indexing")
    for name, t in (("starts", starts), ("vmeta", g.vmeta),
                    ("alias_packed", g.alias_packed),
                    ("hash_buckets", g.hash_buckets), ("keys", keys)):
        if t.dtype != torch.int32:
            raise ValueError(f"walk_rounds: {name} must be int32, "
                             f"got {t.dtype}")
    require_cuda("walk_rounds", starts, g.vmeta, g.alias_packed,
                 g.hash_buckets, keys)
    out = torch.empty((walk_length + 2, N), dtype=torch.int32,
                      device=starts.device)
    inv_p, inv_q, max_f, mode = bias_constants(p, q)
    WALK_KERNEL.launch(
        ptr(starts), ptr(g.vmeta), ptr(g.alias_packed), ptr(g.hash_buckets),
        ptr(keys), ptr(out), W, N, walk_length, T, draw_width(n_stream),
        g.num_edges, float(inv_p), float(inv_q), float(max_f), mode,
        stream(starts.device))
    return out.t().contiguous()
