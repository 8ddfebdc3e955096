"""jax.random's threefry-2x32 streams in plain torch, for the reference.

A frozen copy of the stream semantics that stellar_rw_tpu_torch/ops/prng.py
documents (and the JAX package's jax.random calls define), written anew so
that the reference imports nothing of the program:

  * PRNGKey(seed) = (seed >> 32, seed & 0xFFFFFFFF);
  * fold_in(key, d) = threefry2x32(key, (0, d));
  * bits(key, shape)[i] = o0 ^ o1 of threefry2x32(key, (0, i)) for the
    row-major flat index i (jax's partitionable threefry);
  * uniform f32 = bitcast(0x3F800000 | bits >> 9) - 1;
  * randint(key, shape, lo, hi): two bit streams from fold_in(key, 0) and
    fold_in(key, 1), reduced modulo the span as jax/_src/random.py does.

Words are held in int64 tensors with values in [0, 2**32), masked back to 32
bits after every sum: exact on every device, whatever its int32 overflow does.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, d: int) -> torch.Tensor:
    return ((v << d) & MASK32) | (v >> (32 - d))


def threefry(k0, k1, c0, c1):
    """One 20-round threefry-2x32 block over broadcast int64 tensors."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    inject = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3), (k1, ks2, 4),
              (ks2, k0, 5))
    for i, (a, b, n) in enumerate(inject):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + a) & MASK32
        x1 = (x1 + b + n) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """PRNGKey(seed) as int64 [2], for 0 <= seed < 2**64."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """fold_in for keys k [..., 2] and data broadcasting against k[..., 0]."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=k.device)
    data = data.to(torch.int64) & MASK32
    o0, o1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def bits_at(k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Element idx (row-major flat) of bits(k, shape); k [..., 2] broadcasts
    against idx."""
    idx = idx.to(torch.int64)
    o0, o1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(idx), idx)
    return o0 ^ o1


def to_f32(bits: torch.Tensor) -> torch.Tensor:
    return (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
            - 1.0)


def uniform_at(k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Element idx of uniform(k, shape, float32)."""
    return to_f32(bits_at(k, idx))


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """uniform(k, shape) for each key of k [..., 2]: k.shape[:-1] + shape."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    return uniform_at(k.reshape(k.shape[:-1] + (1,) * len(shape) + (2,)),
                      idx)


def randint(k: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """randint(k, shape, lo, hi) as int32 for each key of k [..., 2]."""
    span = max(hi - lo, 1)
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    sub = fold_in(k[..., None, :], torch.arange(2, device=k.device))
    view = lambda kk: kk.reshape(kk.shape[:-1] + (1,) * len(shape) + (2,))
    hi_bits = bits_at(view(sub[..., 0, :]), idx)
    lo_bits = bits_at(view(sub[..., 1, :]), idx)
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = ((((hi_bits % span) * mult) & MASK32) + (lo_bits % span)) & MASK32
    return (lo + off % span).to(torch.int32)
