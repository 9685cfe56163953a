"""JAX's default PRNG in plain torch: threefry-2x32 keys, `split` and
`uniform`, bit for bit.

The device tracker's RANSAC draws its hypotheses from a key that the tracker
state carries (`models/tracker_device.py`), as the JAX package's tracker
does with `jax.random`. This module computes the same values, so that
tracker seed k is the same stream of draws in both packages and a JAX
tracker state converted mid-run continues on the same draws.

What it reproduces: JAX 0.9's default implementation ("threefry2x32") with
`jax_threefry_partitionable=True` (JAX's default; the JAX package never
changes it):

- a key is two uint32 words; `prng_key(seed)` is `[seed >> 32,
  seed & 0xFFFFFFFF]` (`jax._src.prng.threefry_seed`);
- `threefry2x32` is the 20-round Threefry-2x32 hash (Salmon et al.,
  "Parallel random numbers: as easy as 1, 2, 3", SC 2011) with JAX's
  rotation constants and key schedule;
- `split(key, num)` hashes the row-major counts 0..num−1, split into their
  high and low words, under the key; row i is new key i;
- `random_bits(key, 32, shape)` hashes the counts the same way and xors the
  two output words; 64 bits put the first word high;
- `uniform` sets the random bits into the mantissa of a float in [1, 2),
  subtracts 1 and maps [0, 1) affinely onto [minval, maxval). XLA on the
  CPU fuses that map into one fused multiply-add, so it is formed here with
  one rounding: for float32 the product of the two float32 factors is exact
  in float64 and the sum is rounded once to float32; float64 has no wider
  type and is within 1 ulp of JAX.

The tracker draws float32 uniforms only; `random_bits` (also the 64-bit
words) and the float64 branch of `uniform` have no caller in the package
and are kept for the parity tests against `jax.random`
(`tests/test_torch_threefry.py`), which pin down the whole of JAX's
scheme, not just the tracker's slice of it.

Keys and words are int64 tensors holding uint32 values (CUDA's uint32
support in torch is incomplete); every add and shift is masked back to 32
bits. Everything runs on the key's device as elementwise tensor ops, with
no read back to the host.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device="cuda") -> Tensor:
    """`jax.random.PRNGKey(seed)`: int64 [2] holding the uint32 words
    (seed >> 32, seed & 0xFFFFFFFF). `seed` in [0, 2**63)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must lie in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64,
                        device=device)


def _rotl(v: Tensor, r: int) -> Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor,
                 x2: Tensor) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash of the count words (x1, x2) under the key
    words (k1, k2), all uint32 values in int64 tensors (broadcast)."""
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


def _hash_counts(key: Tensor, shape) -> tuple[Tensor, Tensor]:
    """The hash of the row-major counts 0..prod(shape)−1 (high and low
    words) under `key`: two int64 tensors of `shape`."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], counts >> 32, counts & MASK32)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: Tensor, num: int = 2) -> Tensor:
    """`jax.random.split(key, num)`: int64 [num, 2], row i the i-th new key
    (`key, k1 = split(key)` carries the first and uses the second)."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: Tensor, width: int, shape) -> Tensor:
    """`jax.random.bits`' words: 32-bit values as int64; 64-bit values as
    int64 with the uint64's bit pattern (negative above 2**63)."""
    b1, b2 = _hash_counts(key, tuple(shape))
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(key: Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`: float32
    bit for bit, float64 within 1 ulp."""
    shape = tuple(shape)
    b1, b2 = _hash_counts(key, shape)
    if dtype == torch.float32:
        mant = ((b1 ^ b2) >> 9) | 0x3F800000          # 1.m in [1, 2)
        floats = mant.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        # the top 52 of the 64 bits (b1 << 32 | b2) >> 12, kept below 2**63
        mant = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        floats = mant.view(torch.float64) - 1.0
    else:
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    dev = key.device
    lo = torch.tensor(minval, dtype=dtype, device=dev)
    span = torch.tensor(maxval, dtype=dtype, device=dev) - lo
    if dtype == torch.float32:
        # one rounding of floats·span + lo, as XLA's fused multiply-add
        out = (floats.double() * span.double() + lo.double()).float()
    else:
        out = floats * span + lo
    return torch.maximum(out, lo)
