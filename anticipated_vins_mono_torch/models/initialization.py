"""Visual-inertial initialization — SfM-lite + gyro bias + linear alignment.

Counterpart of `anticipated_vins_mono_tpu/models/initialization.py`,
function for function. The arithmetic is the same numpy; the few
quaternion/rotation conversions go through the port's `ops/lie` on float64
CPU tensors (`_lie`), where the JAX package calls its `lie` through `jnp`.

Capability parity with the reference `initial/` package
(vins_estimator/src/initial/):

- relative pose by essential matrix on normalized coords with RANSAC
  (solve_5pts.cpp:193-230 — here 8-point instead of 5-point: with ≥20
  correspondences and known intrinsics the LS essential estimate is
  equivalent in practice)
- windowed structure: fix frame l and newest, triangulate, PnP the rest
  (initial_sfm.cpp:117-244)
- gyroscope-bias least squares on SfM vs preintegrated rotations
  (initial_aligment.cpp:3-37)
- linear velocity/gravity/scale alignment + 2-dof gravity refinement
  (initial_aligment.cpp:55-197; the /100 scale conditioning at :151,180)

Host-side by design: initialization runs once (or rarely, after a failure
reboot) on an 11-frame problem — not a hot path. The hot path
(repropagation + windowed BA) stays on the device. The RANSAC draws come
from `np.random.default_rng(seed)` in the JAX package's order, so a seed
gives the same inlier sets.
"""

from __future__ import annotations

import numpy as np
import torch

from anticipated_vins_mono_torch.models.feature_selector import (
    _np_exp_quat, _np_quat_mul, _np_quat_rot)
from anticipated_vins_mono_torch.ops import lie

GRAVITY_MAG = 9.81007


def _lie(fn, *args):
    """`fn` of the port's `ops/lie` on float64 CPU tensors, as numpy."""
    return fn(*[torch.tensor(np.asarray(a, np.float64), dtype=torch.float64)
                for a in args]).numpy()


def _quat_to_R(q):
    return _lie(lie.quat_to_rot, q)


def _R_to_quat(R):
    return _lie(lie.rot_to_quat, R)


# ----------------------------------------------------------------------------
# Host-precision preintegration (init-time)
# ----------------------------------------------------------------------------


class HostPreintegration:
    """Minimal f64 preintegration product for the initialization chain."""

    __slots__ = ("dp", "dq", "dv", "dt_sum", "J")

    def __init__(self, dp, dq, dv, dt_sum, J_q_bg):
        self.dp, self.dq, self.dv, self.dt_sum = dp, dq, dv, dt_sum
        J = np.zeros((15, 15))
        J[3:6, 12:15] = J_q_bg
        self.J = J


def preintegrate_host(dts, acc, gyr, acc0, gyr0, ba, bg) -> HostPreintegration:
    """Midpoint preintegration in numpy float64.

    The init chain (gyro-bias LS, linear alignment) is precision-sensitive;
    running it from device-dtype (f32 on TPU) preintegrations makes
    initialization behave differently per backend. This host path keeps it
    deterministic and f64 everywhere. Mirrors the device scan
    (ops/preintegration.py) without covariance."""
    dp = np.zeros(3)
    dv = np.zeros(3)
    dq = np.array([1.0, 0, 0, 0])
    J_q_bg = np.zeros((3, 3))
    a_prev, w_prev = np.asarray(acc0, float), np.asarray(gyr0, float)
    t = 0.0
    for k in range(len(dts)):
        dt = float(dts[k])
        a1, w1 = np.asarray(acc[k], float), np.asarray(gyr[k], float)
        un_w = 0.5 * (w_prev + w1) - bg
        dq_new = _np_quat_mul(dq, _np_exp_quat(un_w * dt))
        dq_new /= np.linalg.norm(dq_new)
        R0 = _np_quat_rot(dq)
        R1 = _np_quat_rot(dq_new)
        un_a = 0.5 * (R0 @ (a_prev - ba) + R1 @ (a1 - ba))
        dp = dp + dv * dt + 0.5 * un_a * dt * dt
        dv = dv + un_a * dt
        # δθ/δbg propagation: J ← (I − [ω]×dt)·J − I·dt (integration_base F)
        wx = np.array([[0, -un_w[2], un_w[1]],
                       [un_w[2], 0, -un_w[0]],
                       [-un_w[1], un_w[0], 0]])
        J_q_bg = (np.eye(3) - wx * dt) @ J_q_bg - np.eye(3) * dt
        dq = dq_new
        a_prev, w_prev = a1, w1
        t += dt
    return HostPreintegration(dp, dq, dv, t, J_q_bg)


# ----------------------------------------------------------------------------
# Two-view geometry
# ----------------------------------------------------------------------------


def essential_8pt(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Least-squares essential matrix from normalized correspondences
    [N,2] each (z=1 plane). Enforces the (1,1,0) singular structure."""
    n = len(x1)
    A = np.zeros((n, 9))
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A[:, 0] = u2 * u1
    A[:, 1] = u2 * v1
    A[:, 2] = u2
    A[:, 3] = v2 * u1
    A[:, 4] = v2 * v1
    A[:, 5] = v2
    A[:, 6] = u1
    A[:, 7] = v1
    A[:, 8] = 1.0
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt2 = np.linalg.svd(E)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt2


def _triangulate_pair(R, t, x1, x2):
    """Linear triangulation in frame 1; P2 = [R|t] maps frame1→frame2."""
    n = len(x1)
    X = np.zeros((n, 3))
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t[:, None]])
    for k in range(n):
        A = np.stack([
            x1[k, 0] * P1[2] - P1[0],
            x1[k, 1] * P1[2] - P1[1],
            x2[k, 0] * P2[2] - P2[0],
            x2[k, 1] * P2[2] - P2[1]])
        _, _, Vt = np.linalg.svd(A)
        Xh = Vt[-1]
        X[k] = Xh[:3] / (Xh[3] if abs(Xh[3]) > 1e-12 else 1e-12)
    return X


def recover_pose(E, x1, x2):
    """Cheirality-checked (R, t) decomposition (solve_5pts.cpp:5-110
    semantics, operating on normalized coords). Returns (R, t, n_good) with
    frame1→frame2 convention."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            X = _triangulate_pair(R, t, x1, x2)
            z1 = X[:, 2]
            z2 = (X @ R.T + t)[:, 2]
            good = int(np.sum((z1 > 0) & (z2 > 0)))
            cands.append((good, R, t))
    good, R, t = max(cands, key=lambda c: c[0])
    return R, t, good


def rotation_only_fit(x1, x2):
    """Kabsch alignment of unit bearings: R with x2 ≈ R x1 (pure-rotation
    model) + mean angular residual. The right relative-rotation estimator for
    rotation-dominant / tiny-baseline frame pairs where the essential matrix
    carries no signal."""
    b1 = np.hstack([x1, np.ones((len(x1), 1))])
    b2 = np.hstack([x2, np.ones((len(x2), 1))])
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    B = b2.T @ b1
    U, _, Vt = np.linalg.svd(B)
    S = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    R = U @ S @ Vt
    resid = float(np.mean(np.linalg.norm(b2 - b1 @ R.T, axis=1)))
    return R, resid


def recover_pose_candidates(E, x1, x2):
    """All four (R, t) decompositions with their cheirality counts."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            X = _triangulate_pair(R, t, x1, x2)
            z1 = X[:, 2]
            z2 = (X @ R.T + t)[:, 2]
            good = int(np.sum((z1 > 0) & (z2 > 0)))
            cands.append((good, R, t))
    return cands


def relative_pose_ransac(x1, x2, iters=100, thresh=3e-3, seed=0):
    """RANSAC essential + recoverPose. Returns (R, t, inlier_mask) or None.

    Mirrors MotionEstimator::solveRelativeRT (solve_5pts.cpp:193-230):
    threshold 0.3/460 ≈ 6.5e-4 in normalized units; we use a slightly looser
    default for synthetic tracks.
    """
    n = len(x1)
    if n < 15:
        return None
    rng = np.random.default_rng(seed)
    best_mask, best_cnt = None, -1
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        try:
            E = essential_8pt(x1[idx], x2[idx])
        except np.linalg.LinAlgError:
            continue
        # Sampson error
        x1h = np.hstack([x1, np.ones((n, 1))])
        x2h = np.hstack([x2, np.ones((n, 1))])
        Ex1 = x1h @ E.T
        Etx2 = x2h @ E
        d = np.abs(np.sum(x2h * Ex1, axis=1)) / np.sqrt(
            Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2 + 1e-18)
        mask = d < thresh
        if mask.sum() > best_cnt:
            best_cnt, best_mask = int(mask.sum()), mask
    if best_cnt < 12:
        return None
    E = essential_8pt(x1[best_mask], x2[best_mask])
    R, t, good = recover_pose(E, x1[best_mask], x2[best_mask])
    if good < 0.7 * best_cnt:
        return None
    return R, t, best_mask


def pnp_gn(X_w, x_obs, R0, p0, iters=10, huber=3.0 / 460.0):
    """Huber-IRLS Gauss-Newton PnP: camera pose (R_cw, p_wc) from 3D-2D
    matches.

    Replaces cv::solvePnP with iterative-refinement init
    (initial_sfm.cpp:23-72), robustified: residual rows beyond `huber`
    (normalized units; 3 px default) are down-weighted 1/|r| so a few
    slipped/mismatched tracks can't steer the pose — the role RANSAC plays
    around solvePnP in the reference (keyframe.cpp PnPRANSAC).
    Returns None on a degenerate/non-finite system — the caller treats it
    like the reference treats a solvePnP failure (initial_sfm.cpp:159-163:
    abandon this init attempt, try again on a later frame).
    """
    R, p = R0.copy(), p0.copy()
    for _ in range(iters):
        Pc = (X_w - p) @ R.T
        z = np.maximum(Pc[:, 2], 1e-6)
        pred = Pc[:, :2] / z[:, None]
        res2 = pred - x_obs
        # Huber sqrt-weights per FEATURE (2 rows share one weight)
        rn = np.linalg.norm(res2, axis=1)
        w = np.sqrt(np.where(rn > huber, huber / np.maximum(rn, 1e-12), 1.0))
        r = (res2 * w[:, None]).reshape(-1)
        # Jacobian wrt (dtheta (cam frame), dp_world)
        n = len(X_w)
        J = np.zeros((2 * n, 6))
        for k in range(n):
            x, y, iz = Pc[k, 0] / z[k], Pc[k, 1] / z[k], 1.0 / z[k]
            d_proj = w[k] * np.array([[iz, 0, -x * iz], [0, iz, -y * iz]])
            # left perturbation: Pc = exp(θ̂)·R·(X−p) ⇒ dPc/dθ = −[Pc]×
            d_rot = -np.cross(np.eye(3), Pc[k])
            J[2 * k: 2 * k + 2, 0:3] = d_proj @ d_rot
            J[2 * k: 2 * k + 2, 3:6] = d_proj @ (-R)
        H = J.T @ J + 1e-9 * np.eye(6)
        if not np.all(np.isfinite(H)):
            return None
        try:
            dx = np.linalg.solve(H, -J.T @ r)
        except np.linalg.LinAlgError:
            return None
        dth, dp = dx[:3], dx[3:]
        R = _quat_to_R(_lie(lie.exp_so3_quat, dth)) @ R
        p = p + dp
    return R, p


# ----------------------------------------------------------------------------
# Windowed structure (SfM-lite)
# ----------------------------------------------------------------------------


def construct_sfm(pts, mask, nf, min_parallax=30.0 / 460.0, seed=0):
    """Up-to-scale structure over the window.

    pts/mask: [F,NF,3]/[F,NF] feature tracks (normalized plane).
    Follows GlobalSFM::construct (initial_sfm.cpp:117-244): find frame l
    with enough parallax & correspondences vs the newest frame
    (estimator.cpp:433-462), fix l as origin, recover l↔newest, triangulate,
    PnP the middle frames forward and frames [0,l) backward.

    Returns None or dict with camera rotations R_cw[NF] (world=frame-l cam),
    camera centers p_c[NF], and per-feature 3-D points + validity.
    """
    F = len(pts)
    newest = nf - 1
    # --- find reference frame l
    rel = None
    for l in range(nf - 1):
        both = (mask[:, l] > 0) & (mask[:, newest] > 0)
        if both.sum() < 20:
            continue
        par = np.linalg.norm(pts[both, l, :2] - pts[both, newest, :2], axis=1)
        if np.mean(par) < min_parallax:
            continue
        got = relative_pose_ransac(pts[both, l, :2], pts[both, newest, :2],
                                   seed=seed)
        if got is not None:
            rel = (l, both, got)
            break
    if rel is None:
        return None
    l, both_l, (R_rel, t_rel, inl) = rel

    R_cw = np.tile(np.eye(3), (nf, 1, 1))   # world→cam
    c_w = np.zeros((nf, 3))                 # camera centers in world
    R_cw[newest] = R_rel
    c_w[newest] = -R_rel.T @ t_rel

    X = np.zeros((F, 3))
    X_ok = np.zeros(F, bool)

    def tri(f1, f2, gate=8.0 / 460.0):
        """Triangulate features seen in both f1,f2 lacking a 3D point.
        A reprojection gate (8 px) rejects slipped/mismatched tracks —
        corrupted structure here poisons every downstream PnP and the
        VI alignment (the reference gets this robustness from ceres BA
        convergence inside GlobalSFM::construct, initial_sfm.cpp:199-232)."""
        need = (mask[:, f1] > 0) & (mask[:, f2] > 0) & ~X_ok
        ids = np.nonzero(need)[0]
        if not ids.size:
            return
        R12 = R_cw[f2] @ R_cw[f1].T
        t12 = R_cw[f2] @ (c_w[f1] - c_w[f2])
        Xl = _triangulate_pair(R12, t12, pts[ids, f1, :2], pts[ids, f2, :2])
        ok = Xl[:, 2] > 0.05
        # reproject into f2 (f1 reprojection is near-exact by construction)
        X2 = Xl @ R12.T + t12
        z2 = np.maximum(X2[:, 2], 1e-6)
        err = np.linalg.norm(X2[:, :2] / z2[:, None] - pts[ids, f2, :2],
                             axis=1)
        ok &= (X2[:, 2] > 0.05) & (err < gate)
        Xw = (Xl @ R_cw[f1]) + c_w[f1]   # cam_f1 → world
        X[ids[ok]] = Xw[ok]
        X_ok[ids[ok]] = True

    tri(l, newest)
    # forward pass l+1..newest-1: PnP from previous, then triangulate w/ newest
    for f in range(l + 1, newest):
        vis = (mask[:, f] > 0) & X_ok
        if vis.sum() < 6:
            return None
        got = pnp_gn(X[vis], pts[vis, f, :2], R_cw[f - 1], c_w[f - 1])
        if got is None:
            return None
        R_cw[f], c_w[f] = got
        tri(f, newest)
    # backward pass l-1..0: PnP from next, triangulate with l
    for f in range(l - 1, -1, -1):
        vis = (mask[:, f] > 0) & X_ok
        if vis.sum() < 6:
            return None
        got = pnp_gn(X[vis], pts[vis, f, :2], R_cw[f + 1], c_w[f + 1])
        if got is None:
            return None
        R_cw[f], c_w[f] = got
        tri(f, l)
    # triangulate anything else with ≥2 views
    for f in range(nf - 1):
        tri(f, newest)
    # structure-quality metric: median reprojection error of the recovered
    # structure across ALL observations — the acceptance signal the
    # reference reads off ceres summary.termination_type
    # (initial_sfm.cpp:226-232); callers gate on it
    errs = []
    for f in range(nf):
        vis = (mask[:, f] > 0) & X_ok
        if vis.sum() < 1:
            continue
        Pc = (X[vis] - c_w[f]) @ R_cw[f].T
        z = np.maximum(Pc[:, 2], 1e-6)
        errs.append(np.linalg.norm(Pc[:, :2] / z[:, None] - pts[vis, f, :2],
                                   axis=1))
    med_err = float(np.median(np.concatenate(errs))) if errs else np.inf
    return {"R_cw": R_cw, "c_w": c_w, "X": X, "X_ok": X_ok, "l": l,
            "med_reproj": med_err}


# ----------------------------------------------------------------------------
# Inertial alignment
# ----------------------------------------------------------------------------


def solve_gyro_bias(q_bw: np.ndarray, pres: list) -> np.ndarray:
    """LS gyro bias from SfM rotations vs preintegrated Δq
    (initial_aligment.cpp:3-37). q_bw: body→world quats per frame [NF,4];
    pres[i]: Preintegrated for pair (i,i+1)."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for i, pre in enumerate(pres):
        q_ij = _lie(lambda a, b: lie.quat_mul(lie.quat_conj(a), b),
                    q_bw[i], q_bw[i + 1])
        J_q_bg = np.asarray(pre.J)[3:6, 12:15]
        resid = 2.0 * _lie(lambda a, b: lie.quat_mul(lie.quat_conj(a), b),
                           pre.dq, q_ij)[1:4]
        A += J_q_bg.T @ J_q_bg
        b += J_q_bg.T @ resid
    return np.linalg.solve(A + 1e-9 * np.eye(3), b)


def linear_alignment(R_bw: np.ndarray, p_cw: np.ndarray, pres: list,
                     tic: np.ndarray):
    """Solve per-frame body velocities, gravity (world=SfM frame), and
    metric scale (initial_aligment.cpp:125-197, incl. /100 conditioning).

    R_bw: body→world rotations [NF,3,3]; p_cw: *camera* positions in the SfM
    frame (unscaled) [NF,3]. Returns (vel_body [NF,3], g_w [3], s) or None.
    """
    nf = len(R_bw)
    n_state = nf * 3 + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    for i, pre in enumerate(pres):
        j = i + 1
        dt = float(np.asarray(pre.dt_sum))
        Ri = R_bw[i]
        Rj = R_bw[j]
        tA = np.zeros((6, 10))
        tb = np.zeros(6)
        tA[0:3, 0:3] = -dt * np.eye(3)
        tA[0:3, 6:9] = 0.5 * Ri.T * dt * dt
        tA[0:3, 9] = Ri.T @ (p_cw[j] - p_cw[i]) / 100.0
        tb[0:3] = np.asarray(pre.dp) + Ri.T @ Rj @ tic - tic
        tA[3:6, 0:3] = -np.eye(3)
        tA[3:6, 3:6] = Ri.T @ Rj
        tA[3:6, 6:9] = Ri.T * dt
        tb[3:6] = np.asarray(pre.dv)
        # scatter into the global system
        idx = np.concatenate([np.arange(3 * i, 3 * i + 6),
                              np.arange(nf * 3, nf * 3 + 4)])
        A[np.ix_(idx, idx)] += tA.T @ tA * 1000.0
        b[idx] += tA.T @ tb * 1000.0
    x = np.linalg.solve(A + 1e-10 * np.eye(n_state), b)
    s = x[-1] / 100.0
    g = x[nf * 3: nf * 3 + 3]
    if s <= 0 or not (8.0 < np.linalg.norm(g) < 12.0):
        return None
    vel = x[: nf * 3].reshape(nf, 3)
    g, vel, s, rms = refine_gravity(R_bw, p_cw, pres, tic, g)
    if s is None:
        return None
    return vel, g, s, rms


def _tangent_basis(g0):
    a = g0 / np.linalg.norm(g0)
    tmp = np.array([0.0, 0.0, 1.0])
    if abs(a @ tmp) > 0.9:
        tmp = np.array([1.0, 0.0, 0.0])
    b = tmp - a * (a @ tmp)
    b /= np.linalg.norm(b)
    c = np.cross(a, b)
    return np.stack([b, c], axis=1)  # 3x2


def refine_gravity(R_bw, p_cw, pres, tic, g0, iters=4):
    """Fix |g| and refine on the 2-dof tangent (initial_aligment.cpp:55-123)."""
    nf = len(R_bw)
    g = g0 / np.linalg.norm(g0) * GRAVITY_MAG
    n_state = nf * 3 + 2 + 1
    rows = []
    for _ in range(iters):
        basis = _tangent_basis(g)
        A = np.zeros((n_state, n_state))
        b = np.zeros(n_state)
        rows = []
        for i, pre in enumerate(pres):
            j = i + 1
            dt = float(np.asarray(pre.dt_sum))
            Ri, Rj = R_bw[i], R_bw[j]
            tA = np.zeros((6, 9))
            tb = np.zeros(6)
            tA[0:3, 0:3] = -dt * np.eye(3)
            tA[0:3, 6:8] = 0.5 * Ri.T @ basis * dt * dt
            tA[0:3, 8] = Ri.T @ (p_cw[j] - p_cw[i]) / 100.0
            tb[0:3] = (np.asarray(pre.dp) + Ri.T @ Rj @ tic - tic
                       - 0.5 * Ri.T @ g * dt * dt)
            tA[3:6, 0:3] = -np.eye(3)
            tA[3:6, 3:6] = Ri.T @ Rj
            tA[3:6, 6:8] = Ri.T @ basis * dt
            tb[3:6] = np.asarray(pre.dv) - Ri.T @ g * dt
            idx = np.concatenate([np.arange(3 * i, 3 * i + 6),
                                  np.arange(nf * 3, nf * 3 + 3)])
            A[np.ix_(idx, idx)] += tA.T @ tA * 1000.0
            b[idx] += tA.T @ tb * 1000.0
            rows.append((tA, tb, idx))
        x = np.linalg.solve(A + 1e-10 * np.eye(n_state), b)
        dg = basis @ x[nf * 3: nf * 3 + 2]
        g = (g + dg) / np.linalg.norm(g + dg) * GRAVITY_MAG
    s = x[-1] / 100.0
    # alignment fit quality: RMS of the LS rows at the solution — how well
    # (v, g, s) explain the preintegrated Δp/Δv given the SfM poses. A
    # geometrically-corrupted or excitation-starved window fits poorly;
    # accepting it bakes ~meters of early-trajectory error into the run
    # (the MH_04 "mid-scale failure" cells, results/r5/init_quality.json)
    res = np.concatenate([tA @ x[idx] - tb for tA, tb, idx in rows])
    rms = float(np.sqrt(np.mean(res ** 2)))
    if s <= 0:
        return g, None, None, rms
    return g, x[: nf * 3].reshape(nf, 3), s, rms


# ----------------------------------------------------------------------------
# Online camera-IMU extrinsic rotation calibration
# ----------------------------------------------------------------------------


class ExtrinsicRotationCalibrator:
    """Online R_ic estimation from rotation-consistency across frame pairs.

    Parity with InitialEXRotation::CalibrationExRotation
    (vins_estimator/src/initial/initial_ex_rotation.cpp:11-60+):
    for every frame pair, the camera-frame relative rotation (from the
    essential matrix) and the body-frame preintegrated rotation must satisfy
    q_cam ⊗ q_ic = q_ic ⊗ q_imu. Stacking Qleft(q_cam) − Qright(q_imu) rows
    with Huber-style angular-distance weights and solving by SVD yields
    q_ic; convergence is declared when the second-smallest singular value
    exceeds 0.25 after ≥ WINDOW_SIZE pairs.
    """

    def __init__(self, window: int = 10):
        self.window = window
        self.q_cam: list = []   # camera relative rotations (wxyz)
        self.q_imu: list = []   # preintegrated body rotations
        self.ric = np.eye(3)

    def add_pair(self, corres_prev: np.ndarray, corres_cur: np.ndarray,
                 q_imu: np.ndarray):
        """corres_*: [N,2] normalized correspondences between the frame pair;
        q_imu: preintegrated Δq between the same frames (body). Returns
        (ric, converged)."""
        if len(corres_prev) < 15:
            return self.ric, False
        # rotation-only bearing alignment: if pure rotation explains the
        # flow (tiny baseline — the common calibration regime), use it;
        # otherwise fall back to essential decomposition
        R_rot, resid = rotation_only_fit(corres_prev, corres_cur)
        if resid < 3.0 / 460.0:
            R_rel = R_rot
        else:
            got = relative_pose_ransac(corres_prev, corres_cur,
                                       seed=len(self.q_cam))
            if got is None:
                return self.ric, False
            R_rel, _, _ = got
        self.q_cam.append(_R_to_quat(R_rel.T))
        self.q_imu.append(np.asarray(q_imu, float))

        n = len(self.q_cam)
        A = np.zeros((4 * n, 4))
        q_ic = _R_to_quat(self.ric)
        for i in range(n):
            qc, qi = self.q_cam[i], self.q_imu[i]
            # consistency: q_ic ⊗ q_cam = q_imu ⊗ q_ic
            # ⇒ (Qleft(q_imu) − Qright(q_cam))·q_ic = 0
            # weight by the angular residual at the current estimate
            dq = _lie(lambda c, i_, q: lie.quat_mul(lie.quat_conj(
                lie.quat_mul(lie.quat_mul(lie.quat_conj(q), i_), q)), c),
                qc, qi, q_ic)
            ang = float(np.degrees(2 * np.arctan2(
                np.linalg.norm(dq[1:]), abs(float(dq[0])))))
            w = 1.0 if ang < 5.0 else 5.0 / ang   # Huber-like kernel (:33-37)
            L = _lie(lie.q_left, qi)
            R = _lie(lie.q_right, qc)
            A[4 * i: 4 * i + 4] = w * (L - R)
        _, svals, Vt = np.linalg.svd(A)
        q_sol = Vt[-1]
        q_sol = q_sol / np.linalg.norm(q_sol)
        if q_sol[0] < 0:
            q_sol = -q_sol
        self.ric = _quat_to_R(q_sol)
        converged = n >= self.window and svals[-2] > 0.25
        return self.ric, bool(converged)
