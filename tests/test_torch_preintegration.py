"""Port vs JAX: ops/preintegration.py (f64, CPU), rtol=1e-9 atol=1e-11 —
the same algebra in another reduction order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import preintegration as jpre
from anticipated_vins_mono_torch.ops import preintegration as tpre

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11


def _imu_batch(seed, n=20, pad=0, dt=0.005):
    rng = np.random.default_rng(seed)
    dts = np.concatenate([np.full(n, dt), np.zeros(pad)])
    accs = rng.normal(size=(n + pad, 3)) * 0.5 + np.array([0, 0, 9.8])
    gyrs = rng.normal(size=(n + pad, 3)) * 0.2
    acc0 = rng.normal(size=3) * 0.5 + np.array([0, 0, 9.8])
    gyr0 = rng.normal(size=3) * 0.2
    ba, bg = rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.005
    return dts, accs, gyrs, acc0, gyr0, ba, bg


def _assert_pre_close(tp, jp):
    for name in jpre.Preintegrated._fields:
        a, b = getattr(tp, name), getattr(jp, name)
        if b is None:
            assert a is None
            continue
        # S = L⁻¹ has entries ~1e6 and P entries ~1e-9: relative tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=ATOL if name != "P" else 1e-20,
                                   err_msg=name)


@pytest.mark.parametrize("with_cov", [True, False])
@pytest.mark.parametrize("pad", [0, 5])
def test_preintegrate_matches_jax(with_cov, pad):
    args = _imu_batch(1, pad=pad)
    jp = jpre.preintegrate(*[jnp.asarray(a) for a in args], jpre.ImuNoise(),
                           with_cov=with_cov)
    tp = tpre.preintegrate(*[torch.from_numpy(a) for a in args],
                           tpre.ImuNoise(), with_cov=with_cov)
    _assert_pre_close(tp, jp)


def test_preintegrate_batched_over_pairs_equals_vmap():
    """The port integrates all pairs in one 20-step loop; JAX vmaps the scan."""
    batches = [_imu_batch(s) for s in range(4)]
    stacked = [np.stack([b[i] for b in batches]) for i in range(7)]
    jp = jax.vmap(lambda *a: jpre.preintegrate(*a, jpre.ImuNoise()))(
        *[jnp.asarray(a) for a in stacked])
    tp = tpre.preintegrate(*[torch.from_numpy(a) for a in stacked],
                           tpre.ImuNoise())
    assert tp.dp.shape == (4, 3) and tp.P.shape == (4, 15, 15)
    _assert_pre_close(tp, jp)


def test_long_dt_noise_inflation_matches_jax():
    args = _imu_batch(2, n=6, dt=0.02)
    jp = jpre.preintegrate(*[jnp.asarray(a) for a in args], jpre.ImuNoise())
    tp = tpre.preintegrate(*[torch.from_numpy(a) for a in args],
                           tpre.ImuNoise())
    _assert_pre_close(tp, jp)


def test_corrected_deltas_match_jax():
    args = _imu_batch(3)
    jp = jpre.preintegrate(*[jnp.asarray(a) for a in args], jpre.ImuNoise())
    tp = tpre.preintegrate(*[torch.from_numpy(a) for a in args],
                           tpre.ImuNoise())
    ba = args[5] + 0.01
    bg = args[6] - 0.002
    jd = jpre.corrected_deltas(jp, jnp.asarray(ba), jnp.asarray(bg))
    td = tpre.corrected_deltas(tp, torch.from_numpy(ba), torch.from_numpy(bg))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_noise_cov18_matches_jax():
    np.testing.assert_allclose(
        tpre.ImuNoise().noise_cov18(torch.float64).numpy(),
        np.asarray(jpre.ImuNoise().noise_cov18(jnp.float64)), rtol=1e-15)
    assert tpre.ImuNoise._fields == jpre.ImuNoise._fields
    assert tpre.Preintegrated._fields == jpre.Preintegrated._fields
