"""Synthetic VIO scenario generation — ground truth + measurements.

Counterpart of the window-problem half of
`anticipated_vins_mono_tpu/utils/synthetic.py`: an analytic smooth
trajectory, the multi-lap circuit (`loop_trajectory`), simulated 200 Hz IMU
(specific force + body rates, optional noise/bias), and landmark
observations with FOV masks, packed into the static-shape
`WindowMeasurements`. All randomness comes from
`numpy.random.default_rng(seed)`, drawn in the same order as the JAX
package draws it, so the same seed gives the same problem.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from anticipated_vins_mono_torch.ops import factors, lie
from anticipated_vins_mono_torch.ops.preintegration import ImuNoise, preintegrate
from anticipated_vins_mono_torch.ops.window import (
    PriorFactor, WindowConfig, WindowMeasurements, WindowState)
from anticipated_vins_mono_torch.utils.tree import tree_map, tree_to

G_W = np.array([0.0, 0.0, -factors.GRAVITY])  # world gravity acceleration


def _t64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    return lie.quat_to_rot(_t64(q)).numpy()


class Trajectory(NamedTuple):
    """Dense ground-truth trajectory sampled at IMU rate."""

    t: np.ndarray      # [N]
    p: np.ndarray      # [N,3]
    q: np.ndarray      # [N,4] wxyz
    v: np.ndarray      # [N,3]
    acc_body: np.ndarray  # [N,3] accelerometer (specific force)
    gyr_body: np.ndarray  # [N,3] gyro


def analytic_trajectory(duration: float, imu_rate: float = 200.0,
                        scale: float = 1.0) -> Trajectory:
    """Smooth sinusoidal trajectory with analytic derivatives. Position is
    analytic (exact v, a); orientation integrates an analytic body rate ω(t)
    with fine exact-exponential steps."""
    dt = 1.0 / imu_rate
    n = int(round(duration * imu_rate)) + 1
    t = np.arange(n) * dt

    w1, w2, w3 = 0.7, 0.5, 0.9
    A = np.array([1.2, 0.8, 0.4]) * scale

    p = np.stack([A[0] * np.sin(w1 * t), A[1] * np.cos(w2 * t),
                  A[2] * np.sin(w3 * t)], axis=-1)
    v = np.stack([A[0] * w1 * np.cos(w1 * t), -A[1] * w2 * np.sin(w2 * t),
                  A[2] * w3 * np.cos(w3 * t)], axis=-1)
    a = np.stack([-A[0] * w1 * w1 * np.sin(w1 * t),
                  -A[1] * w2 * w2 * np.cos(w2 * t),
                  -A[2] * w3 * w3 * np.sin(w3 * t)], axis=-1)

    def omega(tt):
        return np.array([0.25 * np.sin(0.9 * tt),
                         0.2 * np.cos(0.7 * tt),
                         0.3 * np.sin(0.5 * tt) + 0.1])

    q = np.zeros((n, 4))
    q[0] = [1, 0, 0, 0]
    sub = 4  # fine substeps per IMU sample for GT orientation accuracy
    for k in range(1, n):
        qq = _t64(q[k - 1])
        for s in range(sub):
            tm = t[k - 1] + (s + 0.5) * dt / sub
            qq = lie.quat_mul(qq, lie.exp_so3_quat(_t64(omega(tm) * dt / sub)))
        q[k] = lie.quat_normalize(qq).numpy()

    gyr = np.stack([omega(tt) for tt in t])
    R = _quat_to_rot_np(q)
    acc_body = np.einsum("nij,nj->ni", R.transpose(0, 2, 1), a - G_W)
    return Trajectory(t, p, q, v, acc_body, gyr)


def stopped_trajectory(duration: float, stop_after: float,
                       imu_rate: float = 200.0) -> Trajectory:
    """The analytic trajectory, stopped dead after `stop_after` seconds: it
    hovers from then on (pose held, zero velocity and rate, the accelerometer
    reading gravity alone). A hover gives low parallax, hence non-keyframe
    slides."""
    tr = analytic_trajectory(duration, imu_rate)
    k = int(stop_after * imu_rate)
    p, q, v = tr.p.copy(), tr.q.copy(), tr.v.copy()
    acc, gyr = tr.acc_body.copy(), tr.gyr_body.copy()
    p[k:], q[k:], v[k:] = p[k], q[k], 0.0
    acc[k:] = _quat_to_rot_np(q[k]).T @ -G_W
    gyr[k:] = 0.0
    return Trajectory(tr.t, p, q, v, acc, gyr)


def loop_trajectory(duration: float, laps: float = 3.0, radius: float = 3.0,
                    imu_rate: float = 200.0, bob: float = 0.25,
                    wobble: float = 0.12, rate_mod: float = 0.4,
                    rate_mod_freq: float = 2.0, wiggle: float = 0.0,
                    wiggle_freq: float = 3.0) -> Trajectory:
    """Multi-lap circuit with the camera (body +z) looking radially outward
    — the loop-closure scenario: every lap revisits the same poses. Analytic
    p/v/a; orientation is pure yaw following the base-circle tangent
    (ω_body = (0, −θ̇, 0) with body y down).

    The radius wobbles at 3θ and the height bobs at 2θ (functions of the lap
    angle, so revisits stay exact) so that the body-frame accelerometer is
    not constant: a pure circle at constant rate is a degenerate case for
    visual-inertial alignment. `rate_mod` modulates the lap rate in time,
    θ̇(t) = ω̄·(1 + m·cos(ω_m t)), for the same reason; `wiggle` adds a
    time-domain radial wiggle u(t)·e_r(θ) that keeps the specific force
    finite on slow laps.
    """
    dt = 1.0 / imu_rate
    n = int(round(duration * imu_rate)) + 1
    t = np.arange(n) * dt
    th_rate = 2.0 * np.pi * laps / duration
    if rate_mod != 0.0:
        wm = rate_mod_freq
        th = th_rate * (t + (rate_mod / wm) * np.sin(wm * t))
        th_dot = th_rate * (1.0 + rate_mod * np.cos(wm * t))
        th_ddot = -th_rate * rate_mod * wm * np.sin(wm * t)
    else:
        th = th_rate * t
        th_dot = np.full(n, th_rate)
        th_ddot = np.zeros(n)

    a3 = wobble * radius
    r = radius + a3 * np.sin(3 * th)
    dr = 3 * a3 * np.cos(3 * th)          # d r / dθ
    ddr = -9 * a3 * np.sin(3 * th)
    cth, sth = np.cos(th), np.sin(th)
    # v = p′(θ)·θ̇, a = p″(θ)·θ̇² + p′(θ)·θ̈
    x, y = r * cth, r * sth
    dx = dr * cth - r * sth
    dy = dr * sth + r * cth
    ddx = ddr * cth - 2 * dr * sth - r * cth
    ddy = ddr * sth + 2 * dr * cth - r * sth
    z = bob * np.sin(2 * th)
    dz = 2 * bob * np.cos(2 * th)
    ddz = -4 * bob * np.sin(2 * th)
    p = np.stack([x, y, z], axis=-1)
    dp = np.stack([dx, dy, dz], axis=-1)
    ddp = np.stack([ddx, ddy, ddz], axis=-1)
    v = dp * th_dot[:, None]
    a = ddp * th_dot[:, None] ** 2 + dp * th_ddot[:, None]

    if wiggle != 0.0:
        #   p += u·e_r,  e_r = (cosθ, sinθ, 0),  ė_r = θ̇·e_t
        #   v += u̇·e_r + u·θ̇·e_t
        #   a += (ü − u·θ̇²)·e_r + (2·u̇·θ̇ + u·θ̈)·e_t
        w = wiggle_freq
        u = wiggle * np.sin(w * t)
        du = wiggle * w * np.cos(w * t)
        ddu = -wiggle * w * w * np.sin(w * t)
        e_r = np.stack([cth, sth, np.zeros(n)], -1)
        e_t = np.stack([-sth, cth, np.zeros(n)], -1)
        p = p + u[:, None] * e_r
        v = v + du[:, None] * e_r + (u * th_dot)[:, None] * e_t
        a = a + (ddu - u * th_dot ** 2)[:, None] * e_r \
            + (2 * du * th_dot + u * th_ddot)[:, None] * e_t

    # R_wb(θ) = Rz(θ)·R0 with the camera (+z body) pointing radially outward
    # and body y down: R0 = [[0,0,1],[−1,0,0],[0,−1,0]]
    R0 = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    q0 = lie.rot_to_quat(_t64(R0))
    half = 0.5 * th
    c, s = np.cos(half), np.sin(half)
    qz = np.stack([c, np.zeros_like(c), np.zeros_like(c), s], -1)
    q = lie.quat_mul(_t64(qz), q0.expand(n, 4)).numpy()

    gyr = np.stack([np.zeros(n), -th_dot, np.zeros(n)], axis=-1)
    R = _quat_to_rot_np(q)
    acc_body = np.einsum("nij,nj->ni", R.transpose(0, 2, 1), a - G_W)
    return Trajectory(t, p, q, v, acc_body, gyr)


def wall_landmarks(world_lo: np.ndarray, world_hi: np.ndarray, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Landmarks on the box-world walls (`utils.render.BoxWorld` AABB):
    points a camera anywhere inside sees at consistent surface texture, as
    cross-visit BRIEF matching needs. The JAX package's draws, in its
    order."""
    lo, hi = np.asarray(world_lo, float), np.asarray(world_hi, float)
    face = rng.integers(0, 6, size=n)
    u = rng.uniform(size=(n, 3))
    pts = lo + u * (hi - lo)
    axis = face % 3
    side = face // 3
    pts[np.arange(n), axis] = np.where(side == 0, lo[axis], hi[axis])
    return pts


def add_imu_noise(traj: Trajectory, noise: ImuNoise, rng: np.random.Generator,
                  ba: np.ndarray, bg: np.ndarray, imu_rate: float = 200.0
                  ) -> Trajectory:
    """Discrete-time noise: σ_d = σ_c·√rate, plus constant biases."""
    sq = np.sqrt(imu_rate)
    acc = traj.acc_body + ba + rng.normal(size=traj.acc_body.shape) * noise.acc_n * sq
    gyr = traj.gyr_body + bg + rng.normal(size=traj.gyr_body.shape) * noise.gyr_n * sq
    return traj._replace(acc_body=acc, gyr_body=gyr)


def sample_landmarks(traj: Trajectory, n: int, rng: np.random.Generator,
                     depth_range=(3.0, 12.0)) -> np.ndarray:
    """World landmarks scattered in front of the trajectory's viewing cone."""
    idx = rng.integers(0, len(traj.t), size=n)
    R = _quat_to_rot_np(traj.q[idx])
    depth = rng.uniform(*depth_range, size=n)
    dirs = np.stack([rng.uniform(-0.45, 0.45, n),
                     rng.uniform(-0.35, 0.35, n),
                     np.ones(n)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    # camera looks along body +z here (identity-ish extrinsic assumed)
    return traj.p[idx] + np.einsum("nij,nj->ni", R, dirs * depth[:, None])


# a EuRoC-like start stamp [ns] for `write_euroc_csv`
EUROC_T0_NS = 1403636579758555392


def write_euroc_csv(path: str, traj: Trajectory,
                    bg=(0.002, -0.001, 0.0015), ba=(0.03, -0.02, 0.01)) -> None:
    """Write `traj`'s states as a EuRoC `state_groundtruth_estimate0` CSV
    (timestamp [ns], p, q wxyz, v, bg, ba; one header line), with constant
    gyro / accelerometer biases `bg` / `ba`: the layout
    `utils.euroc.load_gt_csv` reads, for runs without the EuRoC files."""
    ns = EUROC_T0_NS + np.round(np.asarray(traj.t) * 1e9).astype(np.int64)
    n = len(ns)
    cols = np.concatenate([traj.p, traj.q, traj.v, np.tile(bg, (n, 1)),
                           np.tile(ba, (n, 1))], axis=1)
    with open(path, "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], "
                "v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], v_RS_R_z [m s^-1], "
                "b_w_RS_S_x [rad s^-1], b_w_RS_S_y [rad s^-1], "
                "b_w_RS_S_z [rad s^-1], b_a_RS_S_x [m s^-2], "
                "b_a_RS_S_y [m s^-2], b_a_RS_S_z [m s^-2]\n")
        for k in range(n):
            f.write(f"{ns[k]}," + ",".join(repr(float(x)) for x in cols[k])
                    + "\n")


class WindowProblem(NamedTuple):
    gt: WindowState
    init: WindowState
    meas: WindowMeasurements
    frame_times: np.ndarray


def make_window_problem(cfg: WindowConfig,
                        seed: int = 0,
                        frame_hz: float = 10.0,
                        imu_rate: float = 200.0,
                        pixel_noise: float = 0.0,
                        imu_noise: Optional[ImuNoise] = None,
                        bias_scale: float = 0.0,
                        perturb: float = 0.0,
                        dtype=torch.float64,
                        tic: Optional[np.ndarray] = None,
                        qic: Optional[np.ndarray] = None,
                        device="cuda") -> WindowProblem:
    """Build one full sliding-window problem with GT and a perturbed init.

    - `pixel_noise`: std of observation noise on the normalized plane,
      in *pixels* (divided by FOCAL_LENGTH internally).
    - `perturb`: magnitude of the initial-state perturbation.
    - `device`: where the returned tensors live. The problem is generated
      with numpy on the host and moved there; a CUDA device that is not
      present raises.
    """
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    nf = cfg.nf
    duration = cfg.window / frame_hz
    traj = analytic_trajectory(duration + 0.01, imu_rate)
    noise = imu_noise or ImuNoise()

    ba_true = rng.normal(size=3) * 0.05 * bias_scale
    bg_true = rng.normal(size=3) * 0.01 * bias_scale
    traj_meas = add_imu_noise(traj, noise if imu_noise else
                              ImuNoise(0, 0, 0, 0), rng, ba_true, bg_true,
                              imu_rate)

    stride = int(round(imu_rate / frame_hz))
    fidx = np.arange(nf) * stride
    frame_times = traj.t[fidx]

    if tic is None:
        tic = np.array([0.05, 0.02, 0.0])
    if qic is None:
        qic = np.array([1.0, 0, 0, 0])

    as_t = lambda x: torch.as_tensor(np.asarray(x)).to(dtype)

    # --- preintegrate all adjacent pairs at once (equal sample counts)
    starts = fidx[:-1]
    samp = starts[:, None] + 1 + np.arange(stride)[None, :]      # [W,stride]
    pre_stack = preintegrate(
        as_t(np.full((cfg.window, stride), 1.0 / imu_rate)),
        as_t(traj_meas.acc_body[samp]), as_t(traj_meas.gyr_body[samp]),
        as_t(traj_meas.acc_body[starts]), as_t(traj_meas.gyr_body[starts]),
        as_t(np.zeros((cfg.window, 3))), as_t(np.zeros((cfg.window, 3))),
        noise)

    # --- landmarks + observations
    F = cfg.max_feats
    lms = sample_landmarks(traj, F, rng)
    R_bw = _quat_to_rot_np(traj.q[fidx])  # [NF,3,3]
    R_ic = _quat_to_rot_np(qic)
    pts = np.zeros((F, nf, 3))
    mask = np.zeros((F, nf))
    for j in range(nf):
        P_b = np.einsum("ij,nj->ni", R_bw[j].T, lms - traj.p[fidx[j]])
        P_c = np.einsum("ij,nj->ni", R_ic.T, P_b - tic)
        z = P_c[:, 2]
        ok = (z > 0.5) & (np.abs(P_c[:, 0] / np.maximum(z, 1e-6)) < 0.55) & \
             (np.abs(P_c[:, 1] / np.maximum(z, 1e-6)) < 0.42)
        ptsj = P_c / np.maximum(z[:, None], 1e-6)
        if pixel_noise > 0:
            ptsj[:, :2] += rng.normal(size=(F, 2)) * pixel_noise / factors.FOCAL_LENGTH
        ptsj[:, 2] = 1.0
        pts[:, j] = ptsj
        mask[:, j] = ok

    # landmarks need >= 2 observations; anchor = first observed frame
    nobs = mask.sum(1)
    feat_valid = (nobs >= 2).astype(float)
    anchor = np.argmax(mask > 0, axis=1).astype(np.int32)

    # GT inverse depth in anchor camera
    inv_depth = np.ones(F)
    for l in range(F):
        a = anchor[l]
        P_b = R_bw[a].T @ (lms[l] - traj.p[fidx[a]])
        P_c = R_ic.T @ (P_b - tic)
        inv_depth[l] = 1.0 / max(P_c[2], 0.1)

    gt = WindowState(
        p=as_t(traj.p[fidx]), q=as_t(traj.q[fidx]), v=as_t(traj.v[fidx]),
        ba=as_t(ba_true).repeat(nf, 1), bg=as_t(bg_true).repeat(nf, 1),
        tic=as_t(tic), qic=as_t(qic),
        td=torch.zeros((), dtype=dtype), inv_depth=as_t(inv_depth))

    # --- perturbed initial guess (first pose kept = gauge)
    def pert(shape, s):
        out = rng.normal(size=shape) * s
        out[0] = 0
        return out

    dth = pert((nf, 3), perturb * 0.02)
    q_init = lie.quat_mul(gt.q.to(torch.float64),
                          lie.exp_so3_quat(_t64(dth))).numpy()
    init = WindowState(
        p=as_t(gt.p.numpy() + pert((nf, 3), perturb * 0.05)),
        q=as_t(q_init),
        v=as_t(gt.v.numpy() + pert((nf, 3), perturb * 0.05)),
        ba=torch.zeros((nf, 3), dtype=dtype),
        bg=torch.zeros((nf, 3), dtype=dtype),
        tic=gt.tic.clone(), qic=gt.qic.clone(), td=gt.td.clone(),
        inv_depth=as_t(inv_depth * (1 + rng.normal(size=F) * 0.05 * perturb)))

    meas = WindowMeasurements(
        pre=pre_stack,
        pre_valid=torch.ones(cfg.window, dtype=dtype),
        pts=as_t(pts),
        vel=torch.zeros((F, nf, 2), dtype=dtype),
        mask=as_t(mask),
        anchor=torch.as_tensor(anchor),
        feat_valid=as_t(feat_valid),
        prior=PriorFactor.empty(cfg, dtype))
    return WindowProblem(tree_to(gt, device), tree_to(init, device),
                         tree_to(meas, device), frame_times)


def batched(tree, B: int):
    """Every leaf of `tree` repeated B times along a new leading dimension:
    one scenario → a `[B, ...]` batch for `lm_solve`."""
    return tree_map(lambda x: x[None].expand((B,) + x.shape).contiguous(), tree)


def window_batch(cfg: WindowConfig, B: int, seed: int = 0,
                 prior_weight: float = 1.0, zupt: bool = True,
                 pin_rp: Optional[float] = 0.5, feat_w: bool = True,
                 td: bool = False, dtype=torch.float64, device="cuda"):
    """B distinct scenarios of one window for holding the normal equations'
    kernel against its plain version: `make_window_problem(cfg, seed)` at its
    perturbed start, each scenario's state moved by its own noise; a dense
    prior (random J0 and r0, linearized near the state) of weight
    `prior_weight`; ZUPT weights, a roll/pitch pin and feature weights where
    asked; one IMU pair invalid in odd scenarios; the last two landmark slots
    empty; slot 0 seen in every frame and anchored in the last. With `td`
    the time offset's inputs besides: image velocities (~0.2 /s in
    normalized coordinates, a tracker's) and td at each frame's capture
    (~3 ms), drawn after everything else. Returns (state, meas), every leaf
    [B, ...]."""
    rng = np.random.default_rng(seed)
    prob = make_window_problem(cfg, seed=seed, pixel_noise=0.5, perturb=1.0,
                               bias_scale=1.0, device="cpu")
    NF, F, D, W = cfg.nf, cfg.max_feats, cfg.dim, cfg.window
    noise = lambda *shape: torch.from_numpy(rng.normal(size=(B,) + shape))
    st = batched(prob.init, B)
    st = st._replace(
        p=st.p + 0.02 * noise(NF, 3),
        q=lie.quat_normalize(st.q + 0.01 * noise(NF, 4)),
        v=st.v + 0.02 * noise(NF, 3), ba=st.ba + 0.01 * noise(NF, 3),
        bg=st.bg + 0.002 * noise(NF, 3), tic=st.tic + 0.01 * noise(3),
        qic=lie.quat_normalize(st.qic + 0.01 * noise(4)),
        td=st.td + 0.001 * noise(),
        inv_depth=st.inv_depth * (1.0 + 0.05 * noise(F)))
    ms = batched(prob.meas, B)
    pre_valid = ms.pre_valid.clone()
    pre_valid[1::2, W // 2] = 0.0
    pts, mask, fv = ms.pts.clone(), ms.mask.clone(), ms.feat_valid.clone()
    anchor = ms.anchor.long().clone()
    pts[:, F - 2:] = 0.0
    mask[:, F - 2:] = 0.0
    fv[:, F - 2:] = 0.0
    mask[:, 0] = 1.0
    fv[:, 0] = 1.0
    anchor[:, 0] = NF - 1
    lin = st._replace(p=st.p + 0.01 * noise(NF, 3),
                      q=lie.quat_normalize(st.q + 0.005 * noise(NF, 4)),
                      v=st.v + 0.01 * noise(NF, 3),
                      tic=st.tic + 0.005 * noise(3))
    prior = PriorFactor(J0=0.3 * noise(D, D), r0=0.1 * noise(D), lin=lin,
                        weight=torch.full((B,), float(prior_weight),
                                          dtype=torch.float64))
    ms = ms._replace(
        pre_valid=pre_valid, pts=pts, mask=mask, feat_valid=fv, anchor=anchor,
        prior=prior,
        zupt_w=torch.from_numpy(rng.uniform(0, 3, (B, NF))) if zupt else None,
        anchor_pin_rp=None if pin_rp is None else torch.full(
            (B,), float(pin_rp), dtype=torch.float64),
        feat_w=torch.from_numpy(rng.uniform(0.5, 1.5, (B, F))) if feat_w
        else None)
    if td:
        ms = ms._replace(vel=0.2 * noise(F, NF, 2), td_obs=0.003 * noise(NF))
    cast = lambda x: x.to(device=device, dtype=dtype) \
        if x.is_floating_point() else x.to(device)
    return tree_map(cast, st), tree_map(cast, ms)


def selector_inputs(prob: WindowProblem, cfg: WindowConfig, probs_seed: int = 1):
    """The tensor arguments of `feature_selector.device_select` for the newest
    frame of a window problem, with no tracker in front: its state, one IMU
    sample, identity extrinsics, empty used / landmark sets (depth 5.0, zero
    masks), and as candidates the problem's own newest-frame observations
    with tracking probabilities uniform in [0.5, 1) from `probs_seed`.
    Returns (cand_probs [F], the 18 arguments after `dt_imu`)."""
    F, nf1 = cfg.max_feats, cfg.nf - 1
    init, meas = prob.init, prob.meas
    kw = dict(dtype=init.p.dtype, device=init.p.device)
    zeros = lambda *s: torch.zeros(*s, **kw)
    probs = torch.from_numpy(
        np.random.default_rng(probs_seed).uniform(0.5, 1.0, F)).to(**kw)
    args = (init.p[nf1], init.q[nf1], init.v[nf1],
            torch.tensor([0.2, 0.1, 9.9], **kw),
            torch.tensor([0.02, -0.01, 0.05], **kw),
            init.ba[nf1], init.bg[nf1],
            zeros(3), torch.tensor([1.0, 0, 0, 0], **kw),
            meas.pts[:, nf1], probs, meas.mask[:, nf1] * meas.feat_valid,
            zeros(F, 3), torch.full((F,), 5.0, **kw), zeros(F),
            zeros(F, 2), torch.full((F,), 5.0, **kw), zeros(F))
    return probs, args


# ----------------------------------------------------------------------------
# Inputs for holding the two kernels against their plain versions
# ----------------------------------------------------------------------------


def psd_batch(B: int, N: int, seed: int, device="cuda") -> torch.Tensor:
    """[B,N,N] float32 well-conditioned PSD matrices (logdet ~ 1.2 N)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N)).astype(np.float32) * 0.2
    return torch.from_numpy(
        A @ A.transpose(0, 2, 1) + 3 * np.eye(N, dtype=np.float32)).to(device)


def schur_system(D: int, F: int, seed: int, lam: float):
    """Jacobian-consistent system (numpy, float32): rows touch the pose block
    and at most one landmark column, so H − H_lpᵀ diag⁻¹ H_lp is a true PSD
    Schur complement. Returns (H, g, H_lp, h_ll, g_l, lam)."""
    rng = np.random.default_rng(seed)
    N = 4 * D
    Jp = (rng.normal(size=(N, D)) * 0.3).astype(np.float32)
    lm_of_row = rng.integers(0, F, size=N)
    Jl = (rng.normal(size=N) * 0.8).astype(np.float32)
    Jl[lm_of_row >= F - 10] = 0.0
    r = rng.normal(size=N).astype(np.float32)
    H = Jp.T @ Jp + 0.1 * np.eye(D, dtype=np.float32)
    onehot = np.zeros((N, F), np.float32)
    onehot[np.arange(N), lm_of_row] = Jl
    return (H, Jp.T @ r, onehot.T @ Jp, (onehot * onehot).sum(0),
            onehot.T @ r, np.float32(lam))


def schur_batch(B: int, D: int, F: int, device="cuda"):
    """B scenarios for `schur_solve_fused` (up to six distinct systems,
    damping 1e-1, 1e-2, 1e-3 in turn), as a list of six tensors."""
    lams = (1e-1, 1e-2, 1e-3)
    systems = [schur_system(D, F, seed=3 + b, lam=lams[b % 3])
               for b in range(min(B, 6))]
    systems = [systems[b % len(systems)] for b in range(B)]
    return [torch.from_numpy(np.stack([s[i] for s in systems])).to(device)
            for i in range(6)]


def imu_pairs(seed: int, batch=(10,), n: int = 64, real: int = 20,
              interior=(), dtype=torch.float32, device="cuda"):
    """Padded IMU pairs as the frame step holds them: `real` rows of 5 ms
    (200 Hz over a 10 Hz frame), then dt = 0 padding to `n` with zero
    samples, as `pack_frame` leaves it; the rows in `interior` get dt = 0
    but keep their samples. Returns `preintegrate`'s first seven arguments
    (dts, accs, gyrs, acc0, gyr0, ba, bg)."""
    rng = np.random.default_rng(seed)
    batch = tuple(batch)
    dts = np.zeros(batch + (n,))
    dts[..., :real] = 0.005
    dts[..., list(interior)] = 0.0
    accs = rng.normal(size=batch + (n, 3)) * 0.5 + [0.0, 0.0, 9.8]
    gyrs = rng.normal(size=batch + (n, 3)) * 0.5
    accs[..., real:, :] = 0.0
    gyrs[..., real:, :] = 0.0
    acc0 = rng.normal(size=batch + (3,)) * 0.5 + [0.0, 0.0, 9.8]
    gyr0 = rng.normal(size=batch + (3,)) * 0.5
    ba = rng.normal(size=batch + (3,)) * 0.02
    bg = rng.normal(size=batch + (3,)) * 0.005
    return [torch.tensor(x, dtype=dtype, device=device)
            for x in (dts, accs, gyrs, acc0, gyr0, ba, bg)]
