"""Port vs JAX: models/anticipation.py and feature_selector._device_select
(f64, CPU). rtol=1e-8 on the matrices (same algebra, other reduction order,
a few matrix inverses); the greedy's selected masks must be IDENTICAL."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.models.feature_selector import \
    _device_select as j_device_select
from anticipated_vins_mono_torch.models import anticipation as tant
from anticipated_vins_mono_torch.models.feature_selector import (
    _device_select as t_device_select, device_select)

torch.set_num_threads(1)

RTOL = 1e-8
H, F, KAPPA = 4, 24, 6
JCFG = jant.SelectorConfig(horizon=H, max_features=KAPPA)
TCFG = tant.SelectorConfig(horizon=H, max_features=KAPPA)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _state(seed=0):
    rng = np.random.default_rng(seed)
    q = np.array([1.0, 0.05, -0.03, 0.02])
    q /= np.linalg.norm(q)
    return dict(p=rng.normal(size=3), q=q, v=np.array([0.8, 0.1, -0.05]),
                acc=np.array([0.2, 0.1, 9.9]), gyr=np.array([0.02, -0.01, 0.05]),
                ba=rng.normal(size=3) * 0.01, bg=rng.normal(size=3) * 0.001)


def _horizon(seed=0):
    s = _state(seed)
    return jant.imu_horizon(*_j(s["p"], s["q"], s["v"], s["acc"], s["gyr"],
                                s["ba"], s["bg"]), H, 20, 0.005)


def _candidates(seed=1, n=F):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (n, 1)),
                          rng.uniform(-0.4, 0.4, (n, 1)), np.ones((n, 1))], -1)
    return pts, rng.uniform(2.0, 9.0, n), rng.uniform(0.5, 1.0, n)


def test_config_keeps_the_jax_fields():
    assert tant.SelectorConfig._fields == jant.SelectorConfig._fields
    assert tant.SelectorConfig() == tuple(jant.SelectorConfig())
    assert tant.SelectorConfig().dim == 126


def test_imu_horizon_matches_jax():
    s = _state()
    args = (s["p"], s["q"], s["v"], s["acc"], s["gyr"], s["ba"], s["bg"])
    ref = jant.imu_horizon(*_j(*args), H, 20, 0.005)
    out = tant.imu_horizon(*_t(*args), H, 20, 0.005)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-12)


def test_gt_horizon_matches_jax():
    ps, qs, _ = _horizon(3)
    s = _state(4)
    ref = jant.gt_horizon(*_j(s["p"], s["q"]), ps, qs)
    out = tant.gt_horizon(*_t(s["p"], s["q"], np.asarray(ps), np.asarray(qs)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-12)


def test_omega_from_motion_and_prior_match_jax():
    _, qs, _ = _horizon()
    ref = jant.add_omega_prior(jant.omega_from_motion(qs, 20, 0.005, JCFG))
    tq, = _t(np.asarray(qs))
    om = tant.omega_from_motion(tq, 20, 0.005, TCFG)
    out = tant.add_omega_prior(om)
    assert out is not om
    scale = np.max(np.abs(np.asarray(ref)))
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= RTOL * scale
    jo, ja = jant.linear_imu_matrices(qs[0], qs[1], 20, 0.005, 0.0064, 1.6e-9)
    to, ta = tant.linear_imu_matrices(tq[0], tq[1], 20, 0.005, 0.0064, 1.6e-9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL)


@pytest.mark.parametrize("any_lm", [True, False])
def test_nn_depths_matches_jax(any_lm):
    rng = np.random.default_rng(5)
    cand = rng.uniform(-0.5, 0.5, (F, 2))
    lm_uv = rng.uniform(-0.5, 0.5, (9, 2))
    lm_depth = rng.uniform(1, 10, 9)
    lm_mask = (rng.uniform(size=9) > 0.4).astype(float) * float(any_lm)
    ref = jant.nn_depths(*_j(cand, lm_uv, lm_depth, lm_mask))
    out = tant.nn_depths(*_t(cand, lm_uv, lm_depth, lm_mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _deltas(survival):
    ps, qs, _ = _horizon()
    pts, depth, probs = _candidates()
    jcfg = JCFG._replace(survival_weighting=survival)
    tcfg = TCFG._replace(survival_weighting=survival)
    if survival:
        ref = jax.vmap(lambda b, d, p: jant.delta_ell(b, d, ps, qs, jcfg,
                                                      prob=p))(*_j(pts, depth,
                                                                   probs))
        out = tant.delta_ell(*_t(pts, depth, np.asarray(ps), np.asarray(qs)),
                             tcfg, prob=_t(probs)[0])
    else:
        ref = jax.vmap(lambda b, d: jant.delta_ell(b, d, ps, qs, jcfg))(
            *_j(pts, depth))
        out = tant.delta_ell(*_t(pts, depth, np.asarray(ps), np.asarray(qs)),
                             tcfg)
    return ref, out, probs


@pytest.mark.parametrize("survival", [False, True])
def test_delta_ell_matches_jax(survival):
    (rD, rn), (tD, tn), _ = _deltas(survival)
    assert tuple(tD.shape) == (F, TCFG.dim, TCFG.dim)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
    scale = np.max(np.abs(np.asarray(rD)))
    assert np.max(np.abs(tD.numpy() - np.asarray(rD))) <= RTOL * scale


def _selection_problem():
    ps, qs, _ = _horizon()
    Omega = jant.add_omega_prior(jant.omega_from_motion(qs, 20, 0.005, JCFG))
    (rD, rn), _, probs = _deltas(False)
    valid = np.ones(F)
    valid[[3, 11]] = 0.0
    return np.asarray(Omega), np.asarray(rD), probs, valid


def test_logdet_upper_bounds_match_jax():
    Omega, Deltas, probs, _ = _selection_problem()
    ref = jant.logdet_upper_bounds(*_j(Omega, Deltas, probs))
    out = tant.logdet_upper_bounds(*_t(Omega, Deltas, probs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("impl", ["chol", "lowrank"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("budget", [None, 4])
def test_select_informative_matches_jax(impl, group, budget):
    Omega, Deltas, probs, valid = _selection_problem()
    jb = None if budget is None else jnp.asarray(budget)
    tb = None if budget is None else torch.tensor(budget)
    rsel, rOm = jant.select_informative(
        *_j(Omega, Deltas, probs, valid), KAPPA, impl=impl, budget=jb,
        group=group)
    tsel, tOm = tant.select_informative(
        *_t(Omega, Deltas, probs, valid), KAPPA, impl=impl, budget=tb,
        group=group, device="cpu")
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(rsel))
    assert int(tsel.sum()) == (KAPPA if budget is None else budget)
    assert float(tsel[3]) == 0.0 and float(tsel[11]) == 0.0
    scale = np.max(np.abs(np.asarray(rOm)))
    assert np.max(np.abs(tOm.numpy() - np.asarray(rOm))) <= RTOL * scale


def test_select_informative_impls_agree_and_default_is_chol_on_cpu():
    Omega, Deltas, probs, valid = _selection_problem()
    args = _t(Omega, Deltas, probs, valid)
    a, _ = tant.select_informative(*args, KAPPA, impl="chol", device="cpu")
    b, _ = tant.select_informative(*args, KAPPA, impl="lowrank", device="cpu")
    c, _ = tant.select_informative(*args, KAPPA, device="cpu")
    assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError):
        tant.select_informative(*args, KAPPA, impl="qr", device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_select_informative_chol_single_problem_picks_the_jax_set(dtype):
    """The case the card serves through the fused Ω + p·Δ loader (one
    problem, no leading batch): on the CPU it takes the materialised sum,
    and picks what the JAX package picks in either float type (in float32
    this Ω is beyond the type, every Cholesky gain is NaN and both packages
    admit nothing: the reference's behaviour, reproduced)."""
    args = [np.asarray(x, dtype) for x in _selection_problem()]
    rsel, _ = jant.select_informative(*_j(*args), KAPPA, impl="chol")
    tsel, tOm = tant.select_informative(*_t(*args), KAPPA, impl="chol",
                                        device="cpu")
    assert tOm.dtype == _t(args[0])[0].dtype
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(rsel))
    assert int(tsel.sum()) == (KAPPA if dtype is np.float64 else 0)


def test_select_informative_batched_problems_equal_single_ones():
    """Leading dimensions are independent selection problems."""
    Omega, Deltas, probs, valid = _selection_problem()
    probs2 = probs[::-1].copy()
    tO, tD, tp, tv, tp2 = _t(Omega, Deltas, probs, valid, probs2)
    sel, Om = tant.select_informative(
        torch.stack([tO, tO]), torch.stack([tD, tD]), torch.stack([tp, tp2]),
        torch.stack([tv, tv]), KAPPA, impl="chol", device="cpu")
    for b, p in enumerate((tp, tp2)):
        s1, O1 = tant.select_informative(tO, tD, p, tv, KAPPA, impl="chol",
                                         device="cpu")
        assert torch.equal(sel[b], s1)
        np.testing.assert_allclose(Om[b].numpy(), O1.numpy(), rtol=1e-12)
    assert not torch.equal(sel[0], sel[1])


def _device_select_args(seed, kappa_cands=F):
    s = _state(seed)
    pts, _, probs = _candidates(seed + 1)
    rng = np.random.default_rng(seed + 2)
    cand_valid = (rng.uniform(size=F) > 0.15).astype(float)
    used_pts, used_depth, _ = _candidates(seed + 3, 5)
    used_valid = np.array([1.0, 1, 0, 1, 0])
    lm_uv = rng.uniform(-0.5, 0.5, (7, 2))
    lm_depth = rng.uniform(2, 8, 7)
    lm_mask = np.array([1.0, 1, 1, 0, 1, 1, 0])
    return (s["p"], s["q"], s["v"], s["acc"], s["gyr"], s["ba"], s["bg"],
            np.array([0.05, 0.02, 0.0]), np.array([1.0, 0, 0, 0]),
            pts, probs, cand_valid, used_pts, used_depth, used_valid,
            lm_uv, lm_depth, lm_mask)


@pytest.mark.parametrize("mode", ["plain", "survival", "budget", "gt"])
def test_device_select_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("ANT_SELECT_IMPL", "chol")
    monkeypatch.setenv("ANT_SELECT_GROUP", "1")
    args = _device_select_args(0)
    jcfg = JCFG._replace(survival_weighting=(mode == "survival"))
    tcfg = TCFG._replace(survival_weighting=(mode == "survival"))
    jkw, tkw = {}, {}
    if mode == "budget":
        jkw["budget"], tkw["budget"] = jnp.asarray(3), torch.tensor(3)
    if mode == "gt":
        ps, qs, _ = _horizon(9)
        jkw.update(gt_p=ps, gt_q=qs)
        tkw.update(gt_p=_t(np.asarray(ps))[0], gt_q=_t(np.asarray(qs))[0])
    rsel, rOm, rps, rqs = j_device_select(jcfg, KAPPA, 20, 0.005, *_j(*args),
                                          **jkw)
    tsel, tOm, tps, tqs = t_device_select(tcfg, KAPPA, 20, 0.005, *_t(*args),
                                          impl="chol", group=1, device="cpu",
                                          **tkw)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(rsel))
    assert int(tsel.sum()) == (3 if mode == "budget" else KAPPA)
    scale = np.max(np.abs(np.asarray(rOm)))
    assert np.max(np.abs(tOm.numpy() - np.asarray(rOm))) <= RTOL * scale
    np.testing.assert_allclose(tps.numpy(), np.asarray(rps), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(tqs.numpy(), np.asarray(rqs), rtol=RTOL,
                               atol=1e-12)


def test_device_select_backfills_to_kappa_by_probability(monkeypatch):
    """Every candidate gated out of the horizon's FOV (camera turned away):
    the greedy finds nothing, the backfill takes the κ̄ most probable."""
    monkeypatch.setenv("ANT_SELECT_IMPL", "chol")
    args = list(_device_select_args(1))
    args[4] = np.array([0.0, 25.0, 0.0])     # gyro: fast rotation
    rsel, *_ = j_device_select(JCFG, KAPPA, 20, 0.005, *_j(*args))
    tsel, *_ = device_select(TCFG, KAPPA, 20, 0.005, *_t(*args), impl="chol",
                             device="cpu")
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(rsel))
    assert int(tsel.sum()) == KAPPA
    probs = np.where(args[11] > 0, args[10], -1)
    assert set(np.flatnonzero(tsel.numpy())) == set(np.argsort(-probs)[:KAPPA])


def test_full_size_selection_f64_matches_jax_and_f32_cannot_resolve_it(
        monkeypatch):
    """The reference deployment's size (H = 13, Ω 126×126, 128 candidates,
    κ̄ = 30) on the newest frame of the seed-0 window problem.

    float64: the port and the JAX package pick the identical 30.
    float32: Ω's condition number is beyond the type. The JAX package's
    accumulated Ω comes out indefinite, so its Cholesky gains are NaN, the
    greedy admits nothing and the result is the backfill by probability —
    not the float64 answer. (A property of the reference that the port
    reproduces; the selector needs float64 or a rescaled Ω at this size.)"""
    from anticipated_vins_mono_torch.ops.window import WindowConfig
    from anticipated_vins_mono_torch.utils.synthetic import (
        make_window_problem, selector_inputs)
    monkeypatch.setenv("ANT_SELECT_IMPL", "chol")
    monkeypatch.setenv("ANT_SELECT_GROUP", "1")
    cfg = WindowConfig(window=10, max_feats=128)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               dtype=torch.float32, device="cpu")
    probs, args = selector_inputs(prob, cfg)
    kappa = 30

    def jax_select(dtype):
        a = [jnp.asarray(x.numpy().astype(dtype)) for x in args]
        sel, Om, _, _ = j_device_select(jant.SelectorConfig(), kappa, 20,
                                        0.005, *a)
        assert Om.dtype == dtype
        return np.asarray(sel), np.asarray(Om, np.float64)

    sel64, Om64 = jax_select(np.float64)
    tsel, tOm, _, _ = device_select(
        tant.SelectorConfig(), kappa, 20, 0.005, *[x.double() for x in args],
        impl="chol", device="cpu")
    np.testing.assert_array_equal(tsel.numpy(), sel64)
    assert int(sel64.sum()) == kappa
    assert np.max(np.abs(tOm.numpy() - Om64)) <= RTOL * np.max(np.abs(Om64))

    eig64 = np.linalg.eigvalsh(Om64)
    assert eig64[0] > 0
    assert eig64[-1] / eig64[0] > 1.0 / np.finfo(np.float32).eps

    sel32, Om32 = jax_select(np.float32)
    assert np.linalg.eigvalsh(Om32)[0] < 0          # indefinite in float32
    valid = (args[11].numpy() > 0)
    by_prob = np.argsort(-np.where(valid, probs.numpy(), -1.0),
                         kind="stable")[:kappa]
    assert set(np.flatnonzero(sel32)) == set(by_prob)    # pure backfill
    assert len(set(np.flatnonzero(sel32)) & set(np.flatnonzero(sel64))) < kappa
