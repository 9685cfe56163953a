"""Port vs JAX: models/initialization.py — every function of the
visual-inertial initialization chain on the same inputs, to 1e-9.

The inputs are a real window: the first NF frames of the simulated stream
over `analytic_trajectory(3.0)` (window 6, 0.5 px noise) inserted into a
`FeatureDB`, and their raw IMU pairs — what `VioEstimator._try_initialize`
hands the chain. The two-view and SfM functions are the same numpy in both
packages (the RANSAC draws from `np.random.default_rng(seed)` in the same
order, so a seed gives the same inlier set); the quaternion conversions go
through each package's own `lie`.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from anticipated_vins_mono_tpu.models import initialization as jin
from anticipated_vins_mono_tpu.models.feature_db import FeatureDB
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.utils.sequence import SequenceSimulator
from anticipated_vins_mono_tpu.utils.synthetic import analytic_trajectory
from anticipated_vins_mono_torch.models import initialization as tin

TOL = dict(rtol=1e-9, atol=1e-9)
NF = 7


@pytest.fixture(scope="module")
def window():
    traj = analytic_trajectory(3.0)
    sim = SequenceSimulator(traj, seed=0, pixel_noise=0.5, max_features=50)
    frames = list(sim.frames(NF))
    db = FeatureDB(64, NF)
    for k, fm in enumerate(frames):
        db.add_frame(k, fm.feats)
    pairs = [(fm.imu_dts, fm.imu_acc, fm.imu_gyr, fm.acc0, fm.gyr0)
             for fm in frames[1:]]
    return traj, db, pairs


def _pres(mod, pairs, bg=np.zeros(3)):
    return [mod.preintegrate_host(*p, np.zeros(3), bg) for p in pairs]


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def test_preintegrate_host_equals_jax(window):
    _, _, pairs = window
    bg = np.array([0.01, -0.02, 0.005])
    for jp, tp in zip(_pres(jin, pairs, bg), _pres(tin, pairs, bg)):
        for name in ("dp", "dq", "dv", "dt_sum", "J"):
            _close(getattr(tp, name), getattr(jp, name))


def _pair_obs(db, i, j):
    both = (db.mask[:, i] > 0) & (db.mask[:, j] > 0)
    return db.pts[both, i, :2], db.pts[both, j, :2]


def test_two_view_geometry_equals_jax(window):
    _, db, _ = window
    x1, x2 = _pair_obs(db, 0, NF - 1)
    E_j, E_t = jin.essential_8pt(x1, x2), tin.essential_8pt(x1, x2)
    _close(E_t, E_j)
    Rj, tj, gj = jin.recover_pose(E_j, x1, x2)
    Rt, tt, gt = tin.recover_pose(E_t, x1, x2)
    assert gt == gj
    _close(Rt, Rj)
    _close(tt, tj)
    _close(tin._triangulate_pair(Rt, tt, x1, x2),
           jin._triangulate_pair(Rj, tj, x1, x2), rtol=1e-9, atol=1e-7)
    for (g1, R1, t1), (g2, R2, t2) in zip(
            tin.recover_pose_candidates(E_t, x1, x2),
            jin.recover_pose_candidates(E_j, x1, x2)):
        assert g1 == g2
        _close(R1, R2)
        _close(t1, t2)
    R_rot_t, res_t = tin.rotation_only_fit(x1, x2)
    R_rot_j, res_j = jin.rotation_only_fit(x1, x2)
    _close(R_rot_t, R_rot_j)
    assert abs(res_t - res_j) <= 1e-12


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_relative_pose_ransac_same_inliers(window, seed):
    """Same generator, same call order: the same inlier set per seed."""
    _, db, _ = window
    x1, x2 = _pair_obs(db, 1, NF - 1)
    # a few gross outliers so that the inlier set is not everything
    x2 = x2.copy()
    x2[::7] += 0.05
    got_j = jin.relative_pose_ransac(x1, x2, seed=seed)
    got_t = tin.relative_pose_ransac(x1, x2, seed=seed)
    assert (got_j is None) == (got_t is None)
    assert got_t is not None
    np.testing.assert_array_equal(got_t[2], got_j[2])
    assert 0 < got_t[2].sum() < len(x1)
    _close(got_t[0], got_j[0])
    _close(got_t[1], got_j[1])


def test_pnp_gn_equals_jax():
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, (40, 3)) + [0, 0, 6.0]
    R_true = np.asarray(jlie.quat_to_rot(jlie.exp_so3_quat(
        jnp.asarray([0.05, -0.1, 0.02]))))
    p_true = np.array([0.2, -0.1, 0.3])
    Pc = (X - p_true) @ R_true.T
    obs = Pc[:, :2] / Pc[:, 2:3] + rng.normal(size=(40, 2)) * 1e-3
    obs[:3] += 0.05                               # Huber-weighted outliers
    Rj, pj = jin.pnp_gn(X, obs, np.eye(3), np.zeros(3))
    Rt, pt = tin.pnp_gn(X, obs, np.eye(3), np.zeros(3))
    _close(Rt, Rj)
    _close(pt, pj)
    assert np.abs(Rt - R_true).max() < 1e-2


@pytest.mark.parametrize("seed", [1, 2])
def test_construct_sfm_equals_jax(window, seed):
    _, db, _ = window
    sj = jin.construct_sfm(db.pts, db.mask, NF, seed=seed)
    st = tin.construct_sfm(db.pts, db.mask, NF, seed=seed)
    assert sj is not None and st is not None
    assert st["l"] == sj["l"]
    np.testing.assert_array_equal(st["X_ok"], sj["X_ok"])
    for name in ("R_cw", "c_w"):
        _close(st[name], sj[name])
    _close(st["X"], sj["X"], rtol=1e-9, atol=1e-8)
    assert abs(st["med_reproj"] - sj["med_reproj"]) <= 1e-12


def _sfm_alignment_inputs(mod, db, pairs):
    sfm = mod.construct_sfm(db.pts, db.mask, NF, seed=1)
    R_wb = np.einsum("nij->nji", sfm["R_cw"])
    q_wb = np.stack([np.asarray(jlie.rot_to_quat(jnp.asarray(R)))
                     for R in R_wb])
    return sfm, R_wb, q_wb, _pres(mod, pairs)


def test_gyro_bias_and_linear_alignment_equal_jax(window):
    _, db, pairs = window
    sfm, R_wb, q_wb, pres_j = _sfm_alignment_inputs(jin, db, pairs)
    _, _, _, pres_t = _sfm_alignment_inputs(tin, db, pairs)
    dbg_j = jin.solve_gyro_bias(q_wb, pres_j)
    dbg_t = tin.solve_gyro_bias(q_wb, pres_t)
    _close(dbg_t, dbg_j, rtol=1e-9, atol=1e-12)
    tic = np.array([0.02, -0.01, 0.03])
    out_j = jin.linear_alignment(R_wb, sfm["c_w"], pres_j, tic)
    out_t = tin.linear_alignment(R_wb, sfm["c_w"], pres_t, tic)
    assert (out_j is None) == (out_t is None)
    assert out_t is not None
    for a, b in zip(out_t, out_j):
        _close(a, b, rtol=1e-9, atol=1e-10)


def test_gravity_refinement_and_tangent_basis_equal_jax(window):
    _, db, pairs = window
    sfm, R_wb, _, pres = _sfm_alignment_inputs(jin, db, pairs)
    for g0 in (np.array([0.3, -0.2, 9.7]), np.array([9.8, 0.1, 0.2])):
        _close(tin._tangent_basis(g0), jin._tangent_basis(g0))
        out_t = tin.refine_gravity(R_wb, sfm["c_w"], pres, np.zeros(3), g0)
        out_j = jin.refine_gravity(R_wb, sfm["c_w"], pres, np.zeros(3), g0)
        for a, b in zip(out_t, out_j):
            if b is None:
                assert a is None
            else:
                _close(a, b, rtol=1e-9, atol=1e-10)


def test_extrinsic_rotation_calibrator_equals_jax():
    """The JAX package's calibration scenario (rotating + translating rig
    over a landmark field) on both calibrators: same convergence flag after
    every pair, same R_ic from the second pair on. After ONE pair the
    consistency rows (Qleft(q_imu) − Qright(q_cam)) have a two-dimensional
    null space, so R_ic is not determined and the SVD's last vector depends
    on rounding (the two packages take different members); from two pairs
    on the null space is one-dimensional."""
    rng = np.random.default_rng(0)
    ric_true = np.asarray(jlie.quat_to_rot(
        jlie.exp_so3_quat(jnp.asarray([0.3, -0.5, 0.9]))))
    cj, ct = jin.ExtrinsicRotationCalibrator(8), \
        tin.ExtrinsicRotationCalibrator(8)
    lms = rng.uniform(-3, 3, size=(120, 3)) + [0, 0, 8.0]
    R_b, p_b = np.eye(3), np.zeros(3)

    def project(Rb, pb):
        Pc = (lms - pb) @ (Rb @ ric_true)
        return Pc[:, :2] / Pc[:, 2:3], Pc[:, 2] > 0.5

    converged = False
    for k in range(14):
        dR = np.asarray(jlie.quat_to_rot(jlie.exp_so3_quat(
            jnp.asarray(rng.normal(size=3) * 0.12))))
        R_n, p_n = R_b @ dR, p_b + rng.normal(size=3) * 0.2
        uv1, ok1 = project(R_b, p_b)
        uv2, ok2 = project(R_n, p_n)
        ok = ok1 & ok2
        q_imu = np.asarray(jlie.rot_to_quat(jnp.asarray(dR)))
        ric_j, done_j = cj.add_pair(uv1[ok], uv2[ok], q_imu)
        ric_t, done_t = ct.add_pair(uv1[ok], uv2[ok], q_imu)
        assert done_t == done_j
        if k > 0:
            _close(ric_t, ric_j)
        R_b, p_b = R_n, p_n
        converged = done_t
        if converged:
            break
    assert converged
