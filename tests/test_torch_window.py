"""Port vs JAX: ops/window.py (f64, CPU).

Tolerances: single functions rtol=1e-9 (same algebra, other reduction
order; H has entries ~1e11 so its check is relative to its scale);
`lm_solve` after its iterations: state atol=1e-6, cost rtol=1e-6, because
accept/reject and eight damped solves amplify rounding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_tpu.utils import synthetic as jsyn
from anticipated_vins_mono_torch.ops import window as tw
from anticipated_vins_mono_torch.utils import convert

torch.set_num_threads(1)

SMALL = dict(window=3, max_feats=16)


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _problem(seed=0, dtype=jnp.float64, **cfg_kw):
    """The JAX problem and the same problem carried into the port."""
    jcfg = jw.WindowConfig(**cfg_kw)
    tcfg = tw.WindowConfig(**cfg_kw)
    jp = jsyn.make_window_problem(jcfg, seed=seed, perturb=0.3,
                                  pixel_noise=0.5, dtype=dtype)
    st = convert.window_state_from_numpy(_np_tree(jp.init), "cpu")
    ms = convert.window_measurements_from_numpy(_np_tree(jp.meas), "cpu")
    return jcfg, tcfg, jp.init, jp.meas, st, ms


def _assert_scaled(a, b, rtol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.max(np.abs(b)), 1e-300)
    assert a.shape == b.shape, name
    assert np.max(np.abs(a - b)) <= rtol * scale, (name, np.max(np.abs(a - b)),
                                                   scale)


def _assert_state_close(ts, js, atol):
    for name in jw.WindowState._fields:
        b = getattr(js, name)
        if b is None:
            assert getattr(ts, name) is None
            continue
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(b),
                                   atol=atol, rtol=0, err_msg=name)


def test_config_and_containers_keep_the_jax_fields():
    jf, tf_ = jw.WindowConfig._fields, tw.WindowConfig._fields
    assert [f if f != "pallas_schur" else "fused_schur" for f in jf] == list(tf_)
    assert tw.WindowConfig().fused_schur is False
    assert tw.WindowConfig().dim == jw.WindowConfig().dim == 178
    for name in ("WindowState", "PriorFactor", "WindowMeasurements"):
        assert getattr(tw, name)._fields == getattr(jw, name)._fields


@pytest.mark.parametrize("cfg_kw", [SMALL, dict(window=10, max_feats=32)],
                         ids=["w3f16", "w10f32"])
def test_normal_equations_cost_and_schur_match_jax(cfg_kw):
    jcfg, tcfg, jst, jms, st, ms = _problem(0, **cfg_kw)
    jout = jax.jit(lambda a, b: jw.normal_equations_fast(a, b, jcfg))(jst, jms)
    tout = tw.normal_equations_fast(st, ms, tcfg)
    for a, b, n in zip(tout, jout, ("H", "g", "H_lp", "h_ll", "g_l")):
        _assert_scaled(a.numpy(), b, 1e-12, n)
    # the port's own dense path gives the same normal equations
    r_all, J_all, p_res, p_rows, p_rho, _ = tw.linearize(st, ms, tcfg)
    dense = tw.build_normal_equations(r_all, J_all, p_res, p_rows, p_rho, tcfg)
    for a, b, n in zip(dense, tout, ("H", "g", "H_lp", "h_ll", "g_l")):
        _assert_scaled(a.numpy(), b.numpy(), 1e-12, "dense " + n)
    np.testing.assert_allclose(float(tw.robust_cost(st, ms, tcfg)),
                               float(jax.jit(lambda a, b: jw.robust_cost(a, b, jcfg))(jst, jms)),
                               rtol=1e-12)
    lam = 1e-3
    jdx, jdr, jpred = jw.schur_solve(*jout, jnp.asarray(lam), jcfg)
    tdx, tdr, tpred = tw.schur_solve(*tout, torch.tensor(lam,
                                                         dtype=torch.float64),
                                     tcfg)
    _assert_scaled(tdx.numpy(), jdx, 1e-7, "dx")
    _assert_scaled(tdr.numpy(), jdr, 1e-7, "d_rho")
    np.testing.assert_allclose(float(tpred), float(jpred), rtol=1e-8)


def test_linearize_matches_jax():
    jcfg, tcfg, jst, jms, st, ms = _problem(1, **SMALL)
    jout = jax.jit(lambda a, b: jw.linearize(a, b, jcfg))(jst, jms)
    tout = tw.linearize(st, ms, tcfg)
    for a, b, n in zip(tout, jout, ("r", "J", "p_res", "p_rows", "p_rho",
                                    "p_sq")):
        _assert_scaled(a.numpy(), b, 1e-12, n)


def test_retract_and_boxminus_match_jax():
    jcfg, tcfg, jst, jms, st, ms = _problem(2, **SMALL)
    rng = np.random.default_rng(0)
    dx = rng.normal(size=jcfg.dim) * 0.05
    d_rho = rng.normal(size=jcfg.max_feats) * 0.05
    jn = jw.retract(jst, jnp.asarray(dx), jnp.asarray(d_rho), jcfg)
    tn = tw.retract(st, torch.from_numpy(dx), torch.from_numpy(d_rho), tcfg)
    _assert_state_close(tn, jn, 1e-13)
    np.testing.assert_allclose(
        tw.state_boxminus(tn, st, tcfg).numpy(),
        np.asarray(jw.state_boxminus(jn, jst, jcfg)), rtol=1e-10, atol=1e-13)


def test_lm_solve_matches_jax():
    jcfg, tcfg, jst, jms, st, ms = _problem(0, iters=8, **SMALL)
    jout, jd = jw.lm_solve(jst, jms, jcfg)
    tout, td = tw.lm_solve(st, ms, tcfg, device="cpu")
    _assert_state_close(tout, jout, 1e-6)
    for k in ("cost0", "cost", "lambda", "imu_chi2", "prior_chi2"):
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert float(td["cost"]) < float(td["cost0"])


def test_batched_solve_equals_single_solves_and_vmap():
    """B=3 written out == three B=1 solves == jax.vmap(lm_solve): λ, cost
    and accept/reject are per scenario."""
    probs = [_problem(s, iters=6, **SMALL) for s in (0, 1, 2)]
    jcfg, tcfg = probs[0][0], probs[0][1]
    jst = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[p[2] for p in probs])
    jms = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[p[3] for p in probs])
    jout, jd = jax.vmap(lambda s, m: jw.lm_solve(s, m, jcfg))(jst, jms)
    st = convert.window_state_from_numpy(_np_tree(jst), "cpu")
    ms = convert.window_measurements_from_numpy(_np_tree(jms), "cpu")
    tout, td = tw.lm_solve(st, ms, tcfg, device="cpu")
    assert tout.p.shape == (3, 4, 3) and td["cost"].shape == (3,)
    _assert_state_close(tout, jout, 1e-6)
    np.testing.assert_allclose(td["cost"].numpy(), np.asarray(jd["cost"]),
                               rtol=1e-6)
    np.testing.assert_allclose(td["lambda"].numpy(), np.asarray(jd["lambda"]),
                               rtol=1e-6)
    # the scenarios took different accept/reject paths or at least costs
    assert len(set(np.round(td["cost"].numpy(), 6))) == 3
    for b, p in enumerate(probs):
        one = jax.tree_util.tree_map(lambda x: x[None], (_np_tree(p[2]),
                                                         _np_tree(p[3])))
        s1 = convert.window_state_from_numpy(one[0], "cpu")
        m1 = convert.window_measurements_from_numpy(one[1], "cpu")
        o1, d1 = tw.lm_solve(s1, m1, tcfg, device="cpu")
        assert o1.p.shape == (1, 4, 3)
        np.testing.assert_allclose(o1.p[0].numpy(), tout.p[b].numpy(),
                                   atol=1e-9)
        np.testing.assert_allclose(float(d1["cost"][0]), float(td["cost"][b]),
                                   rtol=1e-9)


def _variant(kind):
    kw = dict(iters=5, **SMALL)
    if kind == "nielsen":
        kw["lm_strategy"] = "nielsen"
    if kind == "td":
        kw["estimate_td"] = True
        kw["tr_over_row"] = 2e-5
    jcfg, tcfg, jst, jms, st, ms = _problem(3, **kw)
    rng = np.random.default_rng(7)
    F, NF = jcfg.max_feats, jcfg.nf
    if kind == "zupt":
        jms = jms._replace(zupt_w=jnp.asarray(rng.uniform(0, 3, NF)),
                           anchor_pin_rp=jnp.asarray(0.25))
    if kind == "td":
        jms = jms._replace(vel=jnp.asarray(rng.normal(size=(F, NF, 2)) * 0.2),
                           td_obs=jnp.asarray(rng.normal(size=NF) * 0.003))
        jst = jst._replace(td=jnp.asarray(0.004))
    if kind == "relo":
        pts = np.array(jms.pts[:, 0])
        pts[:, :2] += rng.normal(size=(F, 2)) * 1e-3
        jms = jms._replace(relo_pts=jnp.asarray(pts),
                           relo_valid=jms.mask[:, 0] * jms.feat_valid)
        jst = jst._replace(relo_p=jst.p[0] + 0.02, relo_q=jst.q[0])
    if kind == "feat_w":
        jms = jms._replace(feat_w=jnp.asarray(rng.uniform(0.5, 1.5, F)))
    st = convert.window_state_from_numpy(_np_tree(jst), "cpu")
    ms = convert.window_measurements_from_numpy(_np_tree(jms), "cpu")
    return jcfg, tcfg, jst, jms, st, ms


@pytest.mark.parametrize("kind", ["relo", "zupt", "td", "nielsen", "feat_w"])
def test_lm_solve_variants_match_jax(kind):
    jcfg, tcfg, jst, jms, st, ms = _variant(kind)
    np.testing.assert_allclose(float(tw.robust_cost(st, ms, tcfg)),
                               float(jax.jit(lambda a, b: jw.robust_cost(a, b, jcfg))(jst, jms)),
                               rtol=1e-12)
    jout, jd = jw.lm_solve(jst, jms, jcfg)
    tout, td = tw.lm_solve(st, ms, tcfg, device="cpu")
    _assert_state_close(tout, jout, 1e-6)
    np.testing.assert_allclose(float(td["cost"]), float(jd["cost"]), rtol=1e-6)
    np.testing.assert_allclose(float(td["lambda"]), float(jd["lambda"]),
                               rtol=1e-6)
    assert float(td["cost"]) < float(td["cost0"])


def test_f32_solve_keeps_f64_cost_and_f32_lambda():
    """Carry dtypes in an f32 run: λ follows the state, the cost is summed
    in f64, and the Schur step runs in f64 inside."""
    jcfg, tcfg, jst, jms, st, ms = _problem(0, dtype=jnp.float32, iters=3,
                                            **SMALL)
    assert st.p.dtype == torch.float32
    tout, td = tw.lm_solve(st, ms, tcfg, device="cpu")
    assert tout.p.dtype == torch.float32
    assert td["lambda"].dtype == torch.float32
    assert td["cost"].dtype == torch.float64
    assert float(td["cost"]) < float(td["cost0"])


def test_failed_factorization_is_rejected_not_raised():
    """A NaN in the normal equations yields a rejected step (state kept, λ
    raised), as in the JAX loop."""
    jcfg, tcfg, jst, jms, st, ms = _problem(0, iters=2, **SMALL)
    bad = ms._replace(pts=ms.pts.clone())
    bad.pts[0, 1, 0] = float("nan")
    out, d = tw.lm_solve(st, bad, tcfg, device="cpu")
    np.testing.assert_array_equal(out.p.numpy(), st.p.numpy())
    assert float(d["lambda"]) == pytest.approx(tcfg.lm_lambda_init * 16)
