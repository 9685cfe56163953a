"""Port vs JAX: the float32 selection semantics at the reference deployment's
size (H = 13, Ω 126×126, 128 candidates, κ̄ = 30) on the newest frame of the
seed-0 window problem, for every scoring route.

In float32 this Ω is indefinite (its float64 eigenvalues run from 0.027 to
1.2e8), so what the greedy picks depends on how a failed factorization is
scored:

- "lowrank" factors Ω_acc by Cholesky. The JAX factor of an indefinite Ω is
  NaN, every gain is NaN, the greedy admits nothing and `_device_select`
  backfills the κ̄ most probable features. The port must do the same, per
  problem of a batch.
- "chol" on the CPU (`lie.logdet_psd`, a Cholesky): NaN again, the same
  backfill, in both packages.
- "chol" on a TPU (the JAX Pallas kernel) and on the card (the port's logdet
  kernel): right-looking elimination with each pivot floored at 1e-30, so
  every gain is finite and the greedy picks by float32 gains that carry the
  rounding noise of ROADMAP queue C 1. The JAX side is put on that route
  here by swapping `pallas_kernels.logdet_psd` for the kernel in interpret
  mode (compile caches cleared around the swap: the jitted `_device_select`
  would otherwise keep the route it was first traced with); the port side
  scores with the plain versions of what the card launches.

The JAX runs sit in one module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.models.feature_selector import \
    _device_select as j_device_select
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.ops import pallas_kernels as jpk
from anticipated_vins_mono_torch.models import anticipation as tant
from anticipated_vins_mono_torch.models.feature_selector import device_select
from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils.synthetic import (
    make_window_problem, selector_inputs)

torch.set_num_threads(1)

KAPPA = 30
# first-round log-determinants, the Pallas kernel in interpret mode against
# the port's plain twin on the same float32 inputs: two right-looking
# eliminations with the 1e-30 floor, one dividing by the pivot and the other
# multiplying by its reciprocal. Each Ω + p·Δ has 7-9 pivots below float32
# noise (queue C 1), and the log of such a pivot moves by O(1) with the last
# bits of the update. Measured on the 87 candidates finite on both routes:
# median 0.088, largest 1.377 on values of about 1.56e3 (8.8e-4 relative,
# ~7,400 float32 ulps of the value)
LOGDET_ATOL = 2.0
# an overflowed candidate's twin value lies this far below the round's best
# at least (measured: 350)
OVERFLOW_GAP = 100.0
# TPU route vs the card's route: the picks they share, measured 23 of 30 with
# x64 on, as the suite runs JAX (22 with it off)
# (the rest is queue C 1's float32 order noise)
MIN_SHARED_PICKS = 23


def _tpu_logdet(M, use_pallas: bool = True):
    """The JAX package's `pallas_kernels.logdet_psd` as a TPU runs it: the
    Pallas kernel (interpret mode) for a [B,N,N] batch."""
    if use_pallas and M.ndim == 3:
        return jpk.logdet_psd_batched(M, interpret=True)
    return jlie.logdet_psd(M)


def _jax_selections(args) -> dict:
    """The JAX package's float32 picks by scoring route. The jitted
    `select_informative` reads the impl from the environment and the route
    from a module attribute when it is traced, and keeps that trace for
    later calls of the same shapes, so the compile caches are cleared
    before each route and after the last."""
    a = [jnp.asarray(x.numpy().astype(np.float32)) for x in args]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANT_SELECT_GROUP", "1")
        try:
            for name, impl in (("lowrank", "lowrank"), ("chol", "chol"),
                               ("chol_tpu", "chol")):
                if name == "chol_tpu":
                    mp.setattr(jpk, "logdet_psd", _tpu_logdet)
                mp.setenv("ANT_SELECT_IMPL", impl)
                jax.clear_caches()
                sel, *_ = j_device_select(jant.SelectorConfig(), KAPPA, 20,
                                          0.005, *a)
                out[name] = np.asarray(sel)
        finally:
            jax.clear_caches()
    return out


def _port_select(args, impl, dtype=torch.float32):
    sel, *_ = device_select(tant.SelectorConfig(), KAPPA, 20, 0.005,
                            *[x.to(dtype) for x in args], impl=impl,
                            device="cpu")
    return sel.numpy()


def _greedy_inputs(args):
    """(Ω, Δ, p, valid) that the port's float32 `device_select` hands the
    greedy."""
    seen = {}
    inner = tant.select_informative

    def record(Omega, Deltas, probs, valid, kappa, **kw):
        seen.update(Omega=Omega, Deltas=Deltas, probs=probs, valid=valid)
        return inner(Omega, Deltas, probs, valid, kappa, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tant, "select_informative", record)
        _port_select(args, "lowrank")
    return seen["Omega"], seen["Deltas"], seen["probs"], seen["valid"]


@pytest.fixture(scope="module")
def full():
    cfg = WindowConfig(window=10, max_feats=128)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               dtype=torch.float32, device="cpu")
    probs, args = selector_inputs(prob, cfg)
    valid = args[11].numpy() > 0
    by_prob = np.argsort(-np.where(valid, probs.numpy(), -1.0),
                         kind="stable")[:KAPPA]
    return dict(args=args, by_prob=set(by_prob),
                jax_sel=_jax_selections(args), greedy=_greedy_inputs(args))


def _picks(sel):
    return set(np.flatnonzero(np.asarray(sel)))


def test_lowrank_float32_picks_equal_jax_the_backfill(full):
    """Ω indefinite in float32: JAX's NaN Cholesky admits nothing and the
    backfill picks; the port's "lowrank" must not score with the partial
    factor `cholesky_ex` leaves."""
    jsel = full["jax_sel"]["lowrank"]
    tsel = _port_select(full["args"], "lowrank")
    np.testing.assert_array_equal(tsel, jsel)
    assert _picks(tsel) == full["by_prob"]


def test_lowrank_float64_unchanged(full):
    """float64 resolves Ω: the port's "lowrank" picks its "chol" set, a full
    κ̄ that is not the backfill (`test_torch_anticipation.py` holds that set
    against the JAX package's)."""
    tsel = _port_select(full["args"], "lowrank", torch.float64)
    np.testing.assert_array_equal(
        tsel, _port_select(full["args"], "chol", torch.float64))
    assert int(tsel.sum()) == KAPPA
    assert _picks(tsel) != full["by_prob"]


def test_lowrank_failed_factorization_is_per_problem(full):
    """A [2,…] batch: problem 0 is Ω + c·I (positive definite in float32 for
    all 30 rounds), problem 1 the indefinite Ω. Problem 0 keeps the picks it
    gets alone; problem 1 admits nothing (what `device_select` backfills)
    and its Ω is returned unchanged."""
    Omega, Deltas, probs, valid = full["greedy"]
    eye = torch.eye(Omega.shape[-1], dtype=Omega.dtype)
    Om_pd = Omega + 1e3 * eye
    alone, _ = tant.select_informative(Om_pd, Deltas, probs, valid, KAPPA,
                                       impl="lowrank", device="cpu")
    assert int(alone.sum()) == KAPPA
    sel, Om = tant.select_informative(
        torch.stack([Om_pd, Omega]), torch.stack([Deltas, Deltas]),
        torch.stack([probs, probs]), torch.stack([valid, valid]), KAPPA,
        impl="lowrank", device="cpu")
    np.testing.assert_array_equal(sel[0].numpy(), alone.numpy())
    assert int(sel[1].sum()) == 0
    np.testing.assert_array_equal(Om[1].numpy(), Omega.numpy())


def test_chol_cpu_route_is_the_backfill_in_both_packages(full):
    """(c) The CPU route of "chol" (a Cholesky, NaN on an indefinite Ω) is
    the pure backfill in the JAX package and in the port."""
    jsel = full["jax_sel"]["chol"]
    tsel = _port_select(full["args"], "chol")
    np.testing.assert_array_equal(tsel, jsel)
    assert _picks(jsel) == full["by_prob"]


def test_chol_card_route_first_round_logdets_equal_tpu_route(full):
    """(a) The first round's log-determinants of Ω + p·Δ: the JAX Pallas
    kernel (interpret mode) against the port's plain twins of the card's
    kernel, unblocked and through the fused loader, on the same float32
    inputs. Where a Cholesky gives NaN for every candidate the greedy may
    admit, both eliminations give values within LOGDET_ATOL of each other
    and the same best candidate. A candidate whose float32 elimination
    overflows is NaN on the Pallas route (its update spans the whole padded
    matrix, and 0·inf lands in the padding rows) and finite but far below
    the round's best on the twin's: neither can be admitted."""
    Omega, Deltas, probs, valid = full["greedy"]
    cand = Omega[None] + probs[:, None, None] * Deltas
    live = valid.numpy() > 0
    assert live.sum() >= KAPPA
    chol = np.asarray(jlie.logdet_psd(jnp.asarray(cand.numpy()[live])))
    assert np.all(np.isnan(chol))

    ref = np.asarray(jpk.logdet_psd_batched(jnp.asarray(cand.numpy()),
                                            interpret=True))[live]
    twin = hk.logdet_psd_batched_plain(cand).numpy()[live]
    loader = hk.logdet_psd_affine_batched(Omega, Deltas, probs).numpy()[live]
    np.testing.assert_array_equal(loader, twin)
    ok = np.isfinite(ref)
    assert ok.sum() >= KAPPA
    np.testing.assert_allclose(twin[ok], ref[ok], rtol=0, atol=LOGDET_ATOL)
    assert np.argmax(twin) == np.argmax(np.where(ok, ref, -np.inf))
    assert np.all(~(twin[~ok] > ref[ok].max() - OVERFLOW_GAP))


def test_chol_card_route_picks_overlap_tpu_route(full, monkeypatch):
    """(b) The whole selection on the card's route (the port's "chol" scored
    by the plain twin of its logdet kernel) against the JAX package's TPU
    route: a full κ̄ of picks on both sides, not the backfill, and at least
    MIN_SHARED_PICKS of them shared."""
    monkeypatch.setattr(hk, "logdet_psd", hk.logdet_psd_batched)
    tsel = _port_select(full["args"], "chol")
    jsel = full["jax_sel"]["chol_tpu"]
    assert int(tsel.sum()) == int(jsel.sum()) == KAPPA
    assert _picks(jsel) != full["by_prob"]
    assert _picks(tsel) != full["by_prob"]
    assert len(_picks(tsel) & _picks(jsel)) >= MIN_SHARED_PICKS
