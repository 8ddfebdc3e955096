"""JAX's threefry streams, reproduced in torch bit for bit.

The walk engine and the trainer consume `jax.random` streams in the JAX
package (stellar_rw_tpu/ops/prng.py, walk/engine.py, models/word2vec.py).
The port reproduces them exactly, so a corpus or a trainer step can be held
bitwise against the JAX package from the same seed:

  * keys are uint32 pairs; PRNGKey(seed) = (seed >> 32, seed & 0xFFFFFFFF);
  * fold_in(key, d) = threefry2x32_block(key, 0, d);
  * split(key, n)[i] = threefry2x32_block(key, 0, i) (partitionable mode,
    the default since jax 0.4.30);
  * bits(key, shape)[i] = o0 ^ o1 of threefry2x32_block(key, hi32(i), lo32(i))
    for the row-major flat index i;
  * uniform f32 = bitcast(0x3F800000 | bits >> 9) - 1;
  * uniform f64 (x64 on) draws 64-bit words (o0 << 32) | o1 and maps them
    as bitcast(0x3FF0000000000000 | bits >> 12) - 1;
  * randint draws two bit streams from split(key) and reduces them modulo
    the span (jax/_src/random.py::_randint).

torch's uint32 lacks most arithmetic, so every word is an int64 tensor
holding a value in [0, 2**32); sums and shifts are masked back to 32 bits.
Keys are int64 tensors [..., 2] and broadcast against the counters.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, d: int) -> torch.Tensor:
    return ((v << d) & MASK32) | (v >> (32 - d))


def threefry2x32_block(k0, k1, c0, c1):
    """One 20-round threefry-2x32 block, elementwise over broadcast int64
    tensors of uint32 values. Same schedule as XLA's threefry2x32."""
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


def bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform's [0, 1) mapping for 32-bit draws."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a non-negative seed below 2**64."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in; `data` is an int or an integer tensor that
    broadcasts against key[..., 0]."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK32
    o0, o1 = threefry2x32_block(key[..., 0], key[..., 1],
                                torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split for one key -> [num, 2]."""
    return fold_in(key, torch.arange(num, dtype=torch.int64,
                                     device=key.device))


def bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Element `idx` (row-major flat, < 2**32) of jax.random.bits(key, shape)
    for uint32; key[..., 0] and key[..., 1] broadcast against idx."""
    idx = idx.to(torch.int64)
    o0, o1 = threefry2x32_block(key[..., 0], key[..., 1],
                                torch.zeros_like(idx), idx)
    return o0 ^ o1


def uniform_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Element `idx` of jax.random.uniform(key, shape, float32)."""
    return bits_to_f32(bits_at(key, idx))


def uniform_f64_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Element `idx` of jax.random.uniform(key, shape, float64) (x64 on):
    the 64-bit word (o0 << 32) | o1 of the block, its top 52 bits as the
    mantissa of a double in [1, 2), minus 1."""
    idx = idx.to(torch.int64)
    o0, o1 = threefry2x32_block(key[..., 0], key[..., 1],
                                torch.zeros_like(idx), idx)
    # the 52 mantissa bits: o0's 32 and the top 20 of o1, as one int64
    mant = (o0 << 20) | (o1 >> 12)
    return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0


def uniform3_at(key: torch.Tensor, w: torch.Tensor, Wd: int):
    """Elements (0, w), (1, w), (2, w) of jax.random.uniform(key, (3, Wd)):
    a rejection trial's (u_pos, u_keep, u_acc) for lanes w."""
    return tuple(uniform_at(key, w + c * Wd) for c in range(3))


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) for each key in key[..., :];
    output shape = key.shape[:-1] + shape."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return bits_at(key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,)),
                   idx)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) for each key in key[..., :];
    output shape = key.shape[:-1] + shape."""
    return bits_to_f32(random_bits(key, shape))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) with int32 output
    (the production default, x64 off), for each key in key[..., :]."""
    span = maxval - minval
    if span <= 0:
        span = 1
    k = fold_in(key[..., None, :], torch.arange(2, device=key.device))
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    # uint32 arithmetic as in jax: products and sums wrap modulo 2**32
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = ((((hi % span) * mult) & MASK32) + (lo % span)) & MASK32
    off = off % span
    return (minval + off).to(torch.int32)
