"""JAX's threefry-2x32 draws for the tracker's reference: a copy of the
port's `utils/threefry.{prng_key, threefry2x32, split, uniform}`, so that
the reference's RANSAC picks its hypotheses from the same uniforms as the
program's.

Where the copy departs from the port: only the float32 uniforms the
tracker draws are copied (no `random_bits`, no float64 branch).
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device="cpu") -> Tensor:
    """`jax.random.PRNGKey(seed)`: int64 [2] holding the uint32 words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must lie in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def _rotl(v: Tensor, r: int) -> Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words (x1, x2) under
    the key words (k1, k2), uint32 values in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def _hash_counts(key: Tensor, shape):
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], counts >> 32, counts & MASK32)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: Tensor, num: int = 2) -> Tensor:
    """`jax.random.split(key, num)`: int64 [num, 2]."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def uniform(key: Tensor, shape, minval=0.0, maxval=1.0) -> Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`, bit for
    bit: the bits in the mantissa of [1, 2), minus 1, mapped onto [minval,
    maxval) with one rounding."""
    shape = tuple(shape)
    b1, b2 = _hash_counts(key, shape)
    mant = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    out = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(out, lo)
