"""Port vs JAX: `utils/threefry.py`, JAX's default PRNG in torch, on the CPU.

Every value is held against `jax.random` in this process: `prng_key`,
chains of `split` and the raw 32- and 64-bit words exactly; `uniform` in
float32 bit for bit (with and without `minval` / `maxval`, 20 seeds, the
tracker's RANSAC shape, an odd size and a rank-3 shape); `uniform` in
float64 within 1 ulp (XLA on the CPU fuses the affine map into one
multiply-add, which float64 has no wider type to reproduce).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_torch.utils import threefry

SHAPES = [(64, 150), (1, 7), (3, 5, 2)]
RANGES = [(0.0, 1.0), (1e-7, 1.0 - 1e-7)]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def test_jax_draws_with_the_partitionable_threefry():
    """The port reproduces JAX's default PRNG with the partitionable
    counters; should JAX's default change, this says why the others fail."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 3, 2 ** 31 - 1, 2 ** 32 + 5])
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(threefry.prng_key(seed, "cpu").numpy(),
                                  _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 + 5])
def test_split_chain_equals_jax(seed):
    """Three splits in a row, each carrying the first key and using the
    second (the tracker's `key, k1 = split(key)`), and a split into four."""
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed, "cpu")
    for _ in range(3):
        jk, jk1 = jax.random.split(jk)
        tk, tk1 = threefry.split(tk)
        np.testing.assert_array_equal(tk.numpy(), _words(jk))
        np.testing.assert_array_equal(tk1.numpy(), _words(jk1))
    np.testing.assert_array_equal(threefry.split(tk, 4).numpy(),
                                  _words(jax.random.split(jk, 4)))


@pytest.mark.parametrize("width", [32, 64])
def test_random_bits_equal_jax(width):
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.bits(key, (4, 33), getattr(jnp,
                                                           f"uint{width}")))
    out = threefry.random_bits(threefry.prng_key(5, "cpu"), width, (4, 33))
    np.testing.assert_array_equal(out.numpy(), ref.view(np.int64)
                                  if width == 64 else ref.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", RANGES)
def test_uniform_float32_equals_jax_bit_for_bit(shape, bounds):
    for seed in range(20):
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                            jnp.float32, *bounds))
        out = threefry.uniform(threefry.prng_key(seed, "cpu"), shape,
                               torch.float32, *bounds).numpy()
        assert out.dtype == np.float32 and out.shape == shape
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", RANGES)
def test_uniform_float64_within_one_ulp_of_jax(shape, bounds):
    for seed in range(20):
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                            jnp.float64, *bounds))
        out = threefry.uniform(threefry.prng_key(seed, "cpu"), shape,
                               torch.float64, *bounds).numpy()
        assert out.dtype == np.float64 and out.shape == shape
        ulps = np.abs(out.view(np.int64) - ref.view(np.int64))
        assert ulps.max() <= 1, (seed, ulps.max())
        assert (out >= bounds[0]).all() and (out < bounds[1]).all()
