"""Port vs JAX: ops/factors.py residuals and tangent Jacobians (f64, CPU),
rtol=1e-9 atol=1e-11 — the same algebra in another reduction order; the
Jacobians are forward-mode derivatives of the same residual∘boxplus."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import factors as jf
from anticipated_vins_mono_tpu.ops import preintegration as jpre
from anticipated_vins_mono_torch.ops import factors as tf_
from anticipated_vins_mono_torch.ops import preintegration as tpre

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11
N = 6


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _proj_inputs(seed=0):
    rng = np.random.default_rng(seed)
    p_i, p_j = rng.normal(size=(N, 3)), rng.normal(size=(N, 3))
    q_i = _quats(rng)
    dq = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, 3)) * 0.05], -1)
    q_j = np.asarray(jf.lie.quat_normalize(
        jf.lie.quat_mul(jnp.asarray(q_i), jnp.asarray(dq))))
    tic = np.tile(np.array([0.05, 0.02, 0.0]), (N, 1))
    qic = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, 3)) * 0.01], -1)
    qic /= np.linalg.norm(qic, axis=-1, keepdims=True)
    rho = rng.uniform(0.1, 0.5, size=N)
    pt_i = np.concatenate([rng.uniform(-0.4, 0.4, (N, 2)), np.ones((N, 1))], -1)
    pt_j = np.concatenate([rng.uniform(-0.4, 0.4, (N, 2)), np.ones((N, 1))], -1)
    return p_i, q_i, p_j, q_j, tic, qic, rho, pt_i, pt_j


def _t(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("name", ["projection_residual_raw",
                                  "projection_residual",
                                  "projection_residual_unit_sphere"])
def test_projection_residuals_match_jax(name):
    args = _proj_inputs()
    ref = getattr(jf, name)(*_j(args))
    out = getattr(tf_, name)(*_t(args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_projection_td_residual_matches_jax():
    rng = np.random.default_rng(4)
    p_i, q_i, p_j, q_j, tic, qic, rho, pt_i, pt_j = _proj_inputs(1)
    extra = (rng.normal(size=(N, 2)) * 0.3, rng.normal(size=(N, 2)) * 0.3,
             rng.normal(size=N) * 0.01, rng.normal(size=N) * 0.01,
             rng.uniform(-200, 200, N), rng.uniform(-200, 200, N))
    td = np.full(N, 0.02)
    args = (p_i, q_i, p_j, q_j, tic, qic, rho, td, pt_i, pt_j) + extra
    ref = jf.projection_td_residual(*_j(args), tr_over_row=3e-5)
    out = tf_.projection_td_residual(*_t(args), tr_over_row=3e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _imu_inputs(seed=2):
    rng = np.random.default_rng(seed)
    n, dt = 20, 0.005
    pre_args = (np.full(n, dt),
                rng.normal(size=(n, 3)) * 0.5 + np.array([0, 0, 9.8]),
                rng.normal(size=(n, 3)) * 0.2,
                np.array([0.1, 0.0, 9.8]), np.array([0.0, 0.1, 0.0]),
                np.zeros(3), np.zeros(3))
    jp = jpre.preintegrate(*_j(pre_args), jpre.ImuNoise())
    tp = tpre.preintegrate(*_t(pre_args), tpre.ImuNoise())
    q_i = _quats(rng, 1)[0]
    q_j = _quats(rng, 1)[0]
    st = (rng.normal(size=3), q_i, rng.normal(size=3), rng.normal(size=3) * .01,
          rng.normal(size=3) * .001,
          rng.normal(size=3), q_j, rng.normal(size=3), rng.normal(size=3) * .01,
          rng.normal(size=3) * .001)
    return st, jp, tp


@pytest.mark.parametrize("name", ["imu_residual_raw", "imu_residual"])
def test_imu_residuals_match_jax(name):
    st, jp, tp = _imu_inputs()
    ref = getattr(jf, name)(*_j(st), jp)
    out = getattr(tf_, name)(*_t(st), tp)
    # whitened residuals are ~1e5: relative tolerance carries the check
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-8,
                               atol=ATOL)


def test_sqrt_info_and_cauchy_match_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 15, 15))
    P = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(15)
    np.testing.assert_allclose(
        tf_.sqrt_info_from_cov(torch.from_numpy(P)).numpy(),
        np.asarray(jf.sqrt_info_from_cov(jnp.asarray(P))), rtol=RTOL, atol=ATOL)
    s = rng.uniform(0, 30, 20)
    np.testing.assert_allclose(
        tf_.cauchy_weight(torch.from_numpy(s), 1.5).numpy(),
        np.asarray(jf.cauchy_weight(jnp.asarray(s), 1.5)), rtol=1e-14)
    assert tf_.GRAVITY == jf.GRAVITY and tf_.FOCAL_LENGTH == jf.FOCAL_LENGTH
    np.testing.assert_array_equal(tf_.proj_sqrt_info().numpy(),
                                  np.asarray(jf.proj_sqrt_info()))


def test_projection_tangent_jacobian_matches_jacfwd():
    """A batch of factors in one call against JAX's per-factor jacfwd."""
    p_i, q_i, p_j, q_j, tic, qic, rho, pt_i, pt_j = _proj_inputs(3)

    def jres(pa, pj, pe, r, a, b):
        return jf.projection_residual(pa.p, pa.q, pj.p, pj.q, pe.p, pe.q,
                                      r, a, b)

    def one(pi, qi, pj_, qj, t, qc, r, a, b):
        return jf.tangent_jacobian(
            lambda x, y, z, rr: jres(x, y, z, rr, a, b),
            (jf.PoseTangent(pi, qi), jf.PoseTangent(pj_, qj),
             jf.PoseTangent(t, qc)), (r,))
    ref_res, ref_J = jax.vmap(one)(*_j((p_i, q_i, p_j, q_j, tic, qic, rho,
                                        pt_i, pt_j)))

    tp_i, tq_i, tp_j, tq_j, ttic, tqic, trho, tpt_i, tpt_j = _t(
        (p_i, q_i, p_j, q_j, tic, qic, rho, pt_i, pt_j))

    def tres(pa, pj, pe, r, a, b):
        return tf_.projection_residual(pa.p, pa.q, pj.p, pj.q, pe.p, pe.q,
                                       r, a, b)
    res, J = tf_.tangent_jacobian(
        tres, (tf_.PoseTangent(tp_i, tq_i), tf_.PoseTangent(tp_j, tq_j),
               tf_.PoseTangent(ttic, tqic)), (trho,), (tpt_i, tpt_j))
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), rtol=RTOL,
                               atol=ATOL)
    assert len(J) == 4
    for a, b in zip(J, ref_J):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-9)


def test_tangent_jacobian_off_the_unit_sphere_matches_jacfwd():
    """Quaternions whose norms are off 1 (as float32 states' are, by
    rounding): JAX's jacfwd differentiates at the boxplus of δ=0, i.e. at
    the renormalised quaternion, through the normalisation; the residual
    stays the one at the pose given. Off by 1e-3 here so that a Jacobian
    taken at the raw quaternion misses by ~1e-3 relative."""
    p_i, q_i, p_j, q_j, tic, qic, rho, pt_i, pt_j = _proj_inputs(5)
    q_i, q_j, qic = q_i * 1.001, q_j * 0.999, qic * 1.0005
    args = (p_i, q_i, p_j, q_j, tic, qic, rho, pt_i, pt_j)

    def one(pi, qi, pj_, qj, t, qc, r, a, b):
        return jf.tangent_jacobian(
            lambda x, y, z, rr: jf.projection_residual(
                x.p, x.q, y.p, y.q, z.p, z.q, rr, a, b),
            (jf.PoseTangent(pi, qi), jf.PoseTangent(pj_, qj),
             jf.PoseTangent(t, qc)), (r,))
    ref_res, ref_J = jax.vmap(one)(*_j(args))
    tp_i, tq_i, tp_j, tq_j, ttic, tqic, trho, tpt_i, tpt_j = _t(args)
    res, J = tf_.tangent_jacobian(
        lambda pa, pj, pe, r, a, b: tf_.projection_residual(
            pa.p, pa.q, pj.p, pj.q, pe.p, pe.q, r, a, b),
        (tf_.PoseTangent(tp_i, tq_i), tf_.PoseTangent(tp_j, tq_j),
         tf_.PoseTangent(ttic, tqic)), (trho,), (tpt_i, tpt_j))
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(J, ref_J):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-9)


def test_imu_tangent_jacobian_matches_jacfwd():
    """One factor without batch dimensions, the 15-row IMU residual."""
    st, jp, tp = _imu_inputs(6)
    jst, tst = _j(st), _t(st)

    def jres(pi, pj, si, sj):
        return jf.imu_residual(pi.p, pi.q, si[0:3], si[3:6], si[6:9],
                               pj.p, pj.q, sj[0:3], sj[3:6], sj[6:9], jp)
    ref_res, ref_J = jf.tangent_jacobian(
        jres, (jf.PoseTangent(jst[0], jst[1]), jf.PoseTangent(jst[5], jst[6])),
        (jnp.concatenate(jst[2:5]), jnp.concatenate(jst[7:10])))

    def tres(pi, pj, si, sj, pre):
        return tf_.imu_residual(pi.p, pi.q, si[..., 0:3], si[..., 3:6],
                                si[..., 6:9], pj.p, pj.q, sj[..., 0:3],
                                sj[..., 3:6], sj[..., 6:9], pre)
    res, J = tf_.tangent_jacobian(
        tres, (tf_.PoseTangent(tst[0], tst[1]), tf_.PoseTangent(tst[5], tst[6])),
        (torch.cat(tst[2:5]), torch.cat(tst[7:10])), (tp,))
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), rtol=1e-8,
                               atol=ATOL)
    for a, b in zip(J, ref_J):
        # entries up to ~1e7 after whitening: relative tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-6)


def test_apply_pose_delta_matches_jax():
    rng = np.random.default_rng(11)
    p = rng.normal(size=(N, 3))
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    dx = rng.normal(size=(N, 6)) * 0.1
    ref = jf.apply_pose_delta(jf.PoseTangent(jnp.asarray(p), jnp.asarray(q)),
                              jnp.asarray(dx))
    out = tf_.apply_pose_delta(
        tf_.PoseTangent(torch.from_numpy(p), torch.from_numpy(q)),
        torch.from_numpy(dx))
    np.testing.assert_allclose(out.p.numpy(), np.asarray(ref.p), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.q.numpy(), np.asarray(ref.q), rtol=RTOL,
                               atol=ATOL)
