"""Sliding-window VIO estimator — host orchestration over batched device steps.

Counterpart of `anticipated_vins_mono_tpu/models/estimator.py`, method for
method. Capability parity with the reference Estimator + estimator_node
(vins_estimator/src/estimator.cpp, estimator_node.cpp):

- measurement alignment & IMU-rate propagation   (estimator_node.cpp:44-141)
- keyframe decision → marginalization flag       (estimator.cpp:117-120)
- triangulation of new landmarks                 (estimator.cpp:471)
- windowed optimization (one LM solve)           (estimator.cpp:661-994)
- marginalization + window slide                 (:817-990, 996-1081)
- failure detection + reboot                     (:612-658, 186-194)
- outlier rejection                              (f_manager.removeOutlier)

Where the work runs is the reference's own split. The batched numerics —
preintegration of the window's pairs, triangulation, the LM solve,
marginalization, the selector — run on `device` (the card unless the caller
asks for the CPU). The host mutates the padded feature DB, shuffles window
slots, decides branches and does the scalar bookkeeping (quaternion ↔
rotation, gravity alignment, the ypr gauge): that runs the port's `ops/lie`
on float64 CPU tensors (`_host_op`), as the JAX package steers the same ops
to its CPU backend. It is not a fallback.

Where the two differ:

- every array the host later mutates in place goes to the device as a copy
  (`torch.tensor`, never `torch.as_tensor` / `torch.from_numpy`, which share
  memory with a CPU tensor), and `_adopt` copies back;
- `lm_solve` takes a leading batch axis: the window is a batch of one;
- after the solve the diagnostics and the new state are read to the host
  once (the JAX code reads them leaf by leaf);
- the extrinsic calibration's single-pair preintegration runs on the host
  in float64.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from anticipated_vins_mono_torch.models import initialization as vi_init
from anticipated_vins_mono_torch.models.estimator_device import \
    MAX_IMU_PER_PAIR
from anticipated_vins_mono_torch.models.feature_db import FeatureDB
from anticipated_vins_mono_torch.models.feature_selector import (
    _np_exp_quat, _np_quat_mul, _np_quat_rot)
from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.ops import marginalization as mg
from anticipated_vins_mono_torch.ops.factors import GRAVITY
from anticipated_vins_mono_torch.ops.preintegration import (
    ImuNoise, preintegrate)
from anticipated_vins_mono_torch.ops.triangulation import triangulate
from anticipated_vins_mono_torch.ops.window import (
    PriorFactor, WindowConfig, WindowMeasurements, WindowState, lm_solve)
from anticipated_vins_mono_torch.utils.sequence import FrameMeasurement
from anticipated_vins_mono_torch.utils.tree import tree_map


def _host_op(fn, *args):
    """Run a small op of the port's `ops/lie` on float64 CPU tensors and
    return numpy. The per-frame bookkeeping (quaternion conversions, gravity
    alignment, ypr gauge math) is scalar-sized; on the card every call would
    be a launch and a read back."""
    return fn(*[torch.tensor(np.asarray(a, np.float64), dtype=torch.float64)
                for a in args]).numpy()


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array that owns its memory (a CPU tensor's
    `.numpy()` shares it)."""
    return x.detach().cpu().numpy().copy()


def _fuse_to_cap(dts, acc, gyr, cap: int = MAX_IMU_PER_PAIR):
    """Fuse adjacent IMU samples (dt-summed, dt-weighted averaged) until the
    buffer fits the static pad. Only long stationary/non-keyframe streaks or
    IMU-rate spikes ever hit this, where the coarser quadrature is harmless
    (noise is inflated by (dt/dt_ref)^2 at preintegration time)."""
    while len(dts) > cap:
        n = len(dts) // 2 * 2
        d2 = dts[:n].reshape(-1, 2)
        w = d2 / np.maximum(d2.sum(1, keepdims=True), 1e-12)
        acc2 = (acc[:n].reshape(-1, 2, 3) * w[..., None]).sum(1)
        gyr2 = (gyr[:n].reshape(-1, 2, 3) * w[..., None]).sum(1)
        dts = np.concatenate([d2.sum(1), dts[n:]])
        acc = np.concatenate([acc2, acc[n:]])
        gyr = np.concatenate([gyr2, gyr[n:]])
    return dts, acc, gyr


def _merge_imu_pairs(a: dict, b: dict) -> dict:
    """Concatenate two raw-IMU pair buffers (non-keyframe slide merges the
    dropped interval into its successor, reference slideWindowNew +
    IntegrationBase::push_back), fusing down to the static pad on overflow."""
    dts, acc, gyr = _fuse_to_cap(
        np.concatenate([a["dts"], b["dts"]]),
        np.concatenate([a["acc"], b["acc"]]),
        np.concatenate([a["gyr"], b["gyr"]]))
    return {"dts": dts, "acc": acc, "gyr": gyr,
            "acc0": a["acc0"], "gyr0": a["gyr0"]}


@dataclass
class EstimatorDiagnostics:
    solves: int = 0
    failures: int = 0
    keyframes: int = 0
    costs: list = field(default_factory=list)
    # per-frame wall times [s]: selector / window solve incl. the read back
    # (the reference's per-stage TicToc table, results.tex:74-83)
    sel_s: list = field(default_factory=list)
    solve_s: list = field(default_factory=list)
    # solves where no LM iteration was accepted despite a large cost0
    lm_stalls: int = 0
    # per-solve mean whitened IMU chi² (window.imu_chi2_mean): noise-model
    # consistency diagnostic; a rigid drift of the whole window is
    # residual-free, which is why the failure tripwire uses `speeds`
    imu_chi2s: list = field(default_factory=list)
    # per-solve ‖v‖ of the newest frame — the failure detector's
    # slow-runaway statistic (see VioEstimator.max_speed_fail)
    speeds: list = field(default_factory=list)
    # per-solve marginalization-prior chi² (window.prior_chi2): the tension
    # between the solution and the marginalized history
    prior_chi2s: list = field(default_factory=list)


class VioEstimator:
    """Host-side sliding-window estimator.

    The JAX constructor's arguments, plus `device` (where the batched
    numerics run; default the card). `dtype` is the device state's type."""

    def __init__(self, cfg: WindowConfig, noise: ImuNoise = ImuNoise(),
                 dtype=torch.float64,
                 init_state: Optional[dict] = None,
                 tic: Optional[np.ndarray] = None,
                 qic: Optional[np.ndarray] = None,
                 selector=None,
                 calibrate_extrinsic: bool = False,
                 zupt: bool = True,
                 zupt_weight: float = 30.0,
                 zupt_gyr_thresh: float = 0.05,
                 zupt_gyr_mean_thresh: float = 0.03,
                 zupt_acc_thresh: float = 1.0,
                 demote_px: float = 5.0,
                 prob_weight: bool = False,
                 prob_floor: float = 0.2,
                 max_speed_fail: float = 10.0,
                 init_align_rms_max: float = float("inf"),
                 adaptive_speed_ratio: float = 2.0,
                 adaptive_speed_floor: float = 4.0,
                 device="cuda"):
        # slow-runaway tripwire (extension beyond the reference's
        # failureDetection jump thresholds, estimator.cpp:612-658): reboot
        # when the rolling median-of-8 of the newest frame's speed ‖v‖
        # exceeds this [m/s] — a scale runaway moves each solve's newest
        # pose < 5 m (the jump check's blind spot) but needs a velocity far
        # beyond the platform's
        self.max_speed_fail = max_speed_fail
        self.init_align_rms_max = init_align_rms_max
        self.init_diag: Optional[dict] = None
        # self-calibrating tripwire (see _failure); ratio 0 disables. On by
        # default, as in the JAX package.
        self.adaptive_speed_ratio = adaptive_speed_ratio
        self.adaptive_speed_floor = adaptive_speed_floor
        # prob-weighted projection factors (see WindowMeasurements.feat_w):
        # sqrt-info scaled by sqrt(max(prob, floor))
        self.prob_weight = prob_weight
        self.prob_floor = prob_floor
        # landmark demotion threshold [px mean reprojection]
        self.demote_px = demote_px
        self.zupt_gyr_mean_thresh = zupt_gyr_mean_thresh
        # zero-velocity updates when the IMU flags a frame stationary
        self.zupt = zupt
        self.zupt_weight = zupt_weight
        self.zupt_gyr_thresh = zupt_gyr_thresh
        self.zupt_acc_thresh = zupt_acc_thresh
        # ESTIMATE_EXTRINSIC=2 mode (parameters.cpp:96-107): estimate the
        # camera-IMU rotation online from rotation consistency before init
        self.calibrate_extrinsic = calibrate_extrinsic
        self._ex_calibrator = None
        self.cfg = cfg
        # optional anticipation/attention selector (models.feature_selector.
        # AttentionSelector) — applied to incoming features like the
        # reference's f_selector->select() call (estimator_node.cpp:340)
        self.selector = selector
        self.noise = noise
        self.dtype = dtype
        self.device = torch.device(device)
        self.init_hint = init_state or {}
        # oracle_init: trust the provided first-frame state + zero biases and
        # skip the visual-inertial initialization chain
        self.oracle_init = bool(init_state) and init_state.get("oracle", True)
        self.tic0 = np.zeros(3) if tic is None else np.asarray(tic, float)
        self.qic0 = np.array([1.0, 0, 0, 0]) if qic is None else np.asarray(qic, float)
        self.reset()

    # ------------------------------------------------------------------

    def reset(self):
        cfg = self.cfg
        self.db = FeatureDB(cfg.max_feats, cfg.nf)
        self.p = np.zeros((cfg.nf, 3))
        self.q = np.tile(np.array([1.0, 0, 0, 0]), (cfg.nf, 1))
        self.v = np.zeros((cfg.nf, 3))
        self.ba = np.zeros((cfg.nf, 3))
        self.bg = np.zeros((cfg.nf, 3))
        self.td = 0.0
        self.tic = self.tic0.copy()
        self.qic = self.qic0.copy()
        self.prior = PriorFactor.empty(cfg, self.dtype, self.device)
        self.n_frames = 0
        self.imu_pairs: list = []   # raw IMU per adjacent pair
        self.stationary = np.zeros(cfg.nf)  # per-frame ZUPT flags
        self.td_at_frame = np.zeros(cfg.nf)  # td at capture (cur_td parity)
        self.frame_times: list = []
        self.trajectory: list = []  # (t, p, q, v) of the newest frame
        # diagnostics survive failure reboots
        if not hasattr(self, "diag"):
            self.diag = EstimatorDiagnostics()
        self.initialized = False
        # rolling speed statistic (cleared on reboot)
        self._speed_hist: list = []
        self.pending_relo = None   # (p, q, {feature_id: pt3 in relo frame})
        self.relo_result = None    # (relative_t, relative_q) after the solve
        # keyframe snapshot for the pose-graph consumer (pubKeyframe,
        # visualization.cpp:343-428): set after each keyframe solve
        self.last_keyframe = None

    # ------------------------------------------------------------------
    # IMU-rate propagation (midpoint, matching estimator_node predict(),
    # estimator_node.cpp:44-80)
    # ------------------------------------------------------------------

    @staticmethod
    def _propagate(p, q, v, ba, bg, dts, accs, gyrs, acc0, gyr0):
        """Midpoint IMU propagation — pure numpy (~20 samples a frame)."""
        g = np.array([0.0, 0.0, -GRAVITY])
        a_prev, w_prev = np.asarray(acc0, float), np.asarray(gyr0, float)
        q = np.asarray(q, float)
        for dt, a, w in zip(dts, accs, gyrs):
            un_w = 0.5 * (w_prev + w) - bg
            q_new = _np_quat_mul(q, _np_exp_quat(un_w * dt))
            q_new /= np.linalg.norm(q_new)
            R0 = _np_quat_rot(q)
            R1 = _np_quat_rot(q_new)
            un_a = 0.5 * (R0 @ (a_prev - ba) + R1 @ (a - ba)) + g
            p = p + v * dt + 0.5 * un_a * dt * dt
            v = v + un_a * dt
            q = q_new
            a_prev, w_prev = a, w
        return p, q, v

    # ------------------------------------------------------------------

    def process_frame(self, fm: FrameMeasurement):
        cfg = self.cfg
        k = self.n_frames
        self.last_keyframe = None

        if k == 0:
            # first frame: align roll/pitch with measured gravity
            # (initialStructure's g2R usage, estimator.cpp:416-426)
            if "p" in self.init_hint:
                self.p[0] = self.init_hint["p"]
                self.q[0] = self.init_hint["q"]
                self.v[0] = self.init_hint.get("v", np.zeros(3))
            else:
                R0 = _host_op(lie.gravity_to_rot, fm.acc0)
                self.q[0] = _host_op(lie.rot_to_quat, R0.T)
            self.db.add_frame(0, fm.feats)
            self.td_at_frame[0] = 0.0
            self.frame_times.append(fm.t)
            self.n_frames = 1
            self._record_output(fm.t, 0)
            return

        # store raw IMU for pair (k-1 → k) and propagate the new frame state
        self.imu_pairs.append({
            "dts": np.asarray(fm.imu_dts, float),
            "acc": np.asarray(fm.imu_acc, float),
            "gyr": np.asarray(fm.imu_gyr, float),
            "acc0": np.asarray(fm.acc0, float),
            "gyr0": np.asarray(fm.gyr0, float),
        })
        if self.zupt and len(fm.imu_gyr):
            gyr = np.asarray(fm.imu_gyr)
            gyr_fluct = np.abs(gyr - gyr.mean(0)).max()
            gyr_mean = np.linalg.norm(gyr.mean(0) - self.bg[k - 1])
            acc = np.asarray(fm.imu_acc)
            acc_fluct = np.abs(acc - acc.mean(0)).max()
            self.stationary[k] = float(
                gyr_fluct < self.zupt_gyr_thresh
                and gyr_mean < self.zupt_gyr_mean_thresh
                and acc_fluct < self.zupt_acc_thresh)
        else:
            self.stationary[k] = 0.0
        self.p[k], self.q[k], self.v[k] = self._propagate(
            self.p[k - 1], self.q[k - 1], self.v[k - 1],
            self.ba[k - 1], self.bg[k - 1],
            fm.imu_dts, fm.imu_acc, fm.imu_gyr, fm.acc0, fm.gyr0)
        self.ba[k] = self.ba[k - 1]
        self.bg[k] = self.bg[k - 1]

        feats = fm.feats
        if self.selector is not None and len(fm.imu_acc):
            # "t" enables the ground-truth horizon mode (use_ground_truth_hgen,
            # horizon_generator.cpp:73-123)
            state_k1 = {
                "t": fm.t,
                "p": self.p[k], "q": self.q[k], "v": self.v[k],
                "ba": self.ba[k], "bg": self.bg[k],
                "acc": np.asarray(fm.imu_acc[-1], float),
                "gyr": np.asarray(fm.imu_gyr[-1], float),
            }
            _t0 = time.perf_counter()
            feats = self.selector.select(feats, state_k1, self.db,
                                         initialized=self.initialized,
                                         dtype=self.dtype)
            self.diag.sel_s.append(time.perf_counter() - _t0)
        keyframe = self.db.add_frame(k, feats)
        # td stored per observation frame is 0: this pipeline never
        # re-stamps measurements, so the factor applies the absolute
        # correction td·vel (cur_td parity, feature_manager.h)
        self.td_at_frame[k] = 0.0
        self.frame_times.append(fm.t)
        self.n_frames += 1

        if self.calibrate_extrinsic:
            self._run_extrinsic_calibration(k)

        if self.n_frames < cfg.nf:
            self._record_output(fm.t, k)
            return

        if not self.initialized and not self.oracle_init:
            # initialization waits for extrinsic calibration
            # (estimator.cpp:151-156: init only once ESTIMATE_EXTRINSIC != 2)
            if self.calibrate_extrinsic or not self._try_initialize():
                # stay in INITIAL: slide without building a prior
                # (estimator.cpp:151-179 — init retried as frames arrive)
                if keyframe:
                    self._slide_oldest_db()
                    self._shift_state(0)
                    self.imu_pairs.pop(0)
                    self.frame_times.pop(0)
                else:
                    self.db.slide_second_newest()
                    self._shift_state(cfg.nf - 2)
                    a = self.imu_pairs.pop(cfg.nf - 3)
                    b = self.imu_pairs[cfg.nf - 3]
                    self.imu_pairs[cfg.nf - 3] = _merge_imu_pairs(a, b)
                    self.frame_times.pop(cfg.nf - 2)
                self.n_frames = cfg.nf - 1
                self._record_output(fm.t, cfg.nf - 2)
                return

        # ---- window full: triangulate, solve, marginalize, slide
        state = self._device_state()
        meas = self._measurements(state)

        inv_d, good = triangulate(state, meas.pts, meas.mask, meas.anchor, cfg)
        fresh = (self.db.solved < 0.5) & (self.db.feat_valid > 0)
        self.db.inv_depth[fresh] = _np(inv_d)[fresh]
        self.db.solved[fresh] = _np(good)[fresh]
        state = state._replace(inv_depth=self._tensor(self.db.inv_depth))
        # only solved landmarks participate in the BA
        meas = meas._replace(feat_valid=meas.feat_valid *
                             self._tensor(self.db.solved))

        relo_active = False
        if self.pending_relo is not None:
            rp, rq, matches = self.pending_relo
            relo_pts = np.zeros((cfg.max_feats, 3))
            relo_valid = np.zeros(cfg.max_feats)
            for fid, pt in matches.items():
                slot = self.db._find(fid)
                if slot >= 0 and self.db.solved[slot] > 0:
                    relo_pts[slot] = pt
                    relo_valid[slot] = 1.0
            if relo_valid.sum() >= 6:
                relo_active = True
                state = state._replace(relo_p=self._tensor(rp),
                                       relo_q=self._tensor(rq))
                meas = meas._replace(relo_pts=self._tensor(relo_pts),
                                     relo_valid=self._tensor(relo_valid))

        _t0 = time.perf_counter()
        # the window is a batch of one
        new_state, sdiag = lm_solve(tree_map(lambda x: x[None], state),
                                    tree_map(lambda x: x[None], meas), cfg,
                                    device=self.device)
        new_state = tree_map(lambda x: x[0], new_state)
        # one read back of the diagnostics and one of the new state
        cost, cost0, imu_chi2, prior_chi2 = torch.cat(
            [sdiag[n] for n in ("cost", "cost0", "imu_chi2", "prior_chi2")]
        ).double().cpu().tolist()
        new_np = tree_map(_np, new_state)
        self.diag.solves += 1
        self.diag.costs.append(cost)
        self.diag.imu_chi2s.append(imu_chi2)
        self.diag.prior_chi2s.append(prior_chi2)
        speed = float(np.linalg.norm(new_np.v[cfg.nf - 1]))
        self.diag.speeds.append(speed)
        self._speed_hist.append(speed)
        if len(self._speed_hist) > 8:
            self._speed_hist.pop(0)
        # a solve whose cost never improved means every LM iteration was
        # rejected — truly converged (tiny cost0) or a silently-dead solver
        if cost >= cost0 and cost0 > 1e3:
            self.diag.lm_stalls += 1
        self.diag.solve_s.append(time.perf_counter() - _t0)
        self.last_solve = (state, meas, new_state)  # diagnostics hook

        if self._failure(new_np):
            self.diag.failures += 1
            self.reset()
            return

        if relo_active:
            # relative transform: optimized relo pose → newest window frame
            # (relo_relative_t/q, estimator.cpp:1117-1127)
            r_p, r_q = new_np.relo_p, new_np.relo_q
            R_r = _host_op(lie.quat_to_rot, r_q)
            nf1 = cfg.nf - 1
            rel_t = R_r.T @ (new_np.p[nf1] - r_p)
            rel_q = _host_op(
                lambda a, b: lie.quat_mul(lie.quat_conj(a), b),
                r_q, new_np.q[nf1])
            self.relo_result = (rel_t, rel_q)
            self.pending_relo = None
            new_np = new_np._replace(relo_p=None, relo_q=None)

        self._adopt(new_np)
        # as in the JAX package, the window is not rigidly re-anchored after
        # the solve (the reference's double2vector yaw fix): the
        # marginalization prior carries the gauge
        self._reject_outliers()
        self.initialized = True

        # marginalize + slide (estimator.cpp:817-990 + slideWindow :996-1081)
        state_sol = self._device_state()
        if keyframe:
            self.diag.keyframes += 1
            self.last_keyframe = self._keyframe_snapshot(fm.t)
            self.prior = mg.marginalize_oldest(
                state_sol, self._measurements(state_sol), cfg)
            self._slide_oldest_db()
            self._shift_state(0)
            self.imu_pairs.pop(0)
            self.frame_times.pop(0)
        else:
            self.prior = mg.marginalize_second_newest(state_sol, self.prior,
                                                      cfg)
            self.db.slide_second_newest()
            self._shift_state(cfg.nf - 2)
            # merge the IMU of the dropped pair into its successor
            a = self.imu_pairs.pop(cfg.nf - 3)
            b = self.imu_pairs[cfg.nf - 3]
            self.imu_pairs[cfg.nf - 3] = _merge_imu_pairs(a, b)
            self.frame_times.pop(cfg.nf - 2)
        self.n_frames = cfg.nf - 1
        self._record_output(fm.t, cfg.nf - 2)

    def _slide_oldest_db(self):
        R0 = _host_op(lie.quat_to_rot, self.q[0])
        R1 = _host_op(lie.quat_to_rot, self.q[1])
        Ric = _host_op(lie.quat_to_rot, self.qic)
        self.db.slide_oldest(R0, self.p[0], R1, self.p[1], self.tic, Ric)

    def _run_extrinsic_calibration(self, k: int):
        """Feed (frame-pair correspondences, preintegrated Δq) to the
        online rotation calibrator (CalibrationExRotation usage at
        estimator.cpp:123-149); adopt R_ic once converged. The one pair is
        preintegrated on the host in float64."""
        if self._ex_calibrator is None:
            self._ex_calibrator = vi_init.ExtrinsicRotationCalibrator(
                self.cfg.window)
        db = self.db
        both = (db.mask[:, k - 1] > 0) & (db.mask[:, k] > 0)
        if both.sum() < 20 or not self.imu_pairs:
            return
        pair = self.imu_pairs[-1]
        f64 = lambda x: torch.tensor(np.asarray(x, np.float64),
                                     dtype=torch.float64)
        pre = preintegrate(
            f64(pair["dts"]), f64(pair["acc"]), f64(pair["gyr"]),
            f64(pair["acc0"]), f64(pair["gyr0"]),
            torch.zeros(3, dtype=torch.float64), f64(self.bg[k]),
            self.noise, with_cov=False)
        ric, done = self._ex_calibrator.add_pair(
            db.pts[both, k - 1, :2], db.pts[both, k, :2], pre.dq.numpy())
        if done:
            self.qic = _host_op(lie.rot_to_quat, ric)
            self.calibrate_extrinsic = False   # calibrated; switch to refine

    # ------------------------------------------------------------------
    # relocalization input (setReloFrame parity, estimator.cpp:1095-1129)
    # ------------------------------------------------------------------

    def set_relo_frame(self, relo_p, relo_q, matches: dict):
        """Attach a relocalization frame: its (drift-free, loop-corrected)
        pose and {feature_id: normalized pt3 observed in that frame}. The
        next window solve jointly optimizes the relo pose via projection
        factors (estimator.cpp:760-792) and leaves the relative transform
        in `self.relo_result` for the pose-graph consumer."""
        self.pending_relo = (np.asarray(relo_p, float),
                             np.asarray(relo_q, float), dict(matches))

    def _keyframe_snapshot(self, t: float):
        """Pose + solved landmarks of the newest window frame, in world
        coordinates — the content of the reference's keyframe_pose +
        keyframe_point topics (visualization.cpp:343-428)."""
        cfg = self.cfg
        nf1 = cfg.nf - 1
        db = self.db
        sel = np.nonzero((db.ids >= 0) & (db.solved > 0.5)
                         & (db.mask[:, nf1] > 0))[0]
        Ric = _host_op(lie.quat_to_rot, self.qic)
        X = np.zeros((len(sel), 3))
        anchors = db.anchor
        for row, s in enumerate(sel):
            a = int(anchors[s])
            pt_c = db.pts[s, a] / max(db.inv_depth[s], 1e-6)
            R_a = _host_op(lie.quat_to_rot, self.q[a])
            X[row] = R_a @ (Ric @ pt_c + self.tic) + self.p[a]
        return {
            "t": float(t),
            "p": self.p[nf1].copy(), "q": self.q[nf1].copy(),
            "ids": db.ids[sel].copy(),
            "X": X,
            "uv": db.pts[sel, nf1, :2].copy(),
        }

    # ------------------------------------------------------------------
    # visual-inertial initialization (initialStructure + visualInitialAlign,
    # estimator.cpp:211-431)
    # ------------------------------------------------------------------

    def _try_initialize(self) -> bool:
        cfg = self.cfg
        nf = cfg.nf
        self._init_attempts = getattr(self, "_init_attempts", 0) + 1

        sfm = vi_init.construct_sfm(self.db.pts, self.db.mask, nf,
                                    seed=self._init_attempts)
        if sfm is None:
            return False
        # structure-quality gate (GlobalSFM BA-convergence analog,
        # initial_sfm.cpp:226-232)
        if sfm["med_reproj"] > 2.5 / 460.0:
            return False
        R_cw, c_w = sfm["R_cw"], sfm["c_w"]
        Ric = _host_op(lie.quat_to_rot, self.qic)  # cam→body
        # body→world rotations: R_wb = R_cwᵀ · Ricᵀ
        R_wb = np.einsum("nij->nji", R_cw) @ Ric.T
        q_wb = np.stack([_host_op(lie.rot_to_quat, R) for R in R_wb])

        # gyro bias LS + repropagation (initial_aligment.cpp:3-37) — host
        # f64 preintegration
        def host_pres():
            return [vi_init.preintegrate_host(
                pr["dts"], pr["acc"], pr["gyr"], pr["acc0"], pr["gyr0"],
                np.zeros(3), self.bg[i].copy())
                for i, pr in enumerate(self.imu_pairs[:cfg.window])]

        pres = host_pres()
        dbg = vi_init.solve_gyro_bias(q_wb, pres)
        if not np.all(np.isfinite(dbg)) or np.linalg.norm(dbg) > 1.0:
            return False
        self.bg[:] = self.bg + dbg
        pres = host_pres()

        out = vi_init.linear_alignment(R_wb, c_w, pres, self.tic)
        if out is None:
            return False
        vel_body, g_w, s, align_rms = out
        self.init_diag = {"attempt": self._init_attempts,
                          "med_reproj": float(sfm["med_reproj"]),
                          "dbg_norm": float(np.linalg.norm(dbg)),
                          "scale": float(s),
                          "align_rms": float(align_rms)}
        # alignment-quality gate: wait for a window whose (v, g, s) solution
        # explains the preintegration
        if align_rms > self.init_align_rms_max:
            return False

        # apply (visualInitialAlign, estimator.cpp:355-431): metric scale,
        # gravity-aligned world with zero initial yaw
        p_b = s * c_w - np.einsum("nij,j->ni", R_wb, self.tic)
        p_b = p_b - p_b[0]
        R0 = _host_op(lie.gravity_to_rot, g_w)
        yaw0 = float(_host_op(lie.rot_to_ypr, R0 @ R_wb[0])[0])
        Rfix = _host_op(lie.ypr_to_rot, np.asarray([-yaw0, 0.0, 0.0])) @ R0
        self.p[:] = p_b @ Rfix.T
        for i in range(nf):
            self.q[i] = _host_op(lie.rot_to_quat, Rfix @ R_wb[i])
            self.v[i] = Rfix @ (R_wb[i] @ vel_body[i])
        self.ba[:] = 0.0
        # depths: force re-triangulation with the metric poses
        self.db.solved[:] = 0
        self.db.inv_depth[:] = 1.0
        self.trajectory.clear()   # outputs restart at initialization
        self.initialized = True
        return True

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        """A copy of host data on the device in the state's dtype.
        `torch.tensor` always copies: `torch.as_tensor` / `torch.from_numpy`
        would share memory with the host array on a CPU device, and the host
        mutates these arrays in place (slides, `_shift_state`) while the
        device state is still in use."""
        return torch.tensor(np.asarray(x, np.float64), dtype=self.dtype,
                            device=self.device)

    def _device_state(self) -> WindowState:
        t = self._tensor
        return WindowState(
            p=t(self.p), q=t(self.q), v=t(self.v), ba=t(self.ba),
            bg=t(self.bg), tic=t(self.tic), qic=t(self.qic), td=t(self.td),
            inv_depth=t(self.db.inv_depth))

    def _preintegrate_pairs(self):
        """One batched preintegration over all W pairs (padded to
        MAX_IMU_PER_PAIR samples, dt = 0 rows are no-ops)."""
        cfg = self.cfg
        W, S = cfg.window, MAX_IMU_PER_PAIR
        dts = np.zeros((W, S))
        acc = np.zeros((W, S, 3))
        gyr = np.zeros((W, S, 3))
        a0 = np.zeros((W, 3))
        g0 = np.zeros((W, 3))
        for i in range(W):
            pair = self.imu_pairs[i]
            if len(pair["dts"]) > S:
                # graceful degradation instead of a hard assert: fuse down
                # to the pad
                pd, pa, pg = _fuse_to_cap(pair["dts"], pair["acc"],
                                          pair["gyr"])
                pair = dict(pair, dts=pd, acc=pa, gyr=pg)
                self.imu_pairs[i] = pair
            n = len(pair["dts"])
            dts[i, :n] = pair["dts"]
            acc[i, :n] = pair["acc"]
            gyr[i, :n] = pair["gyr"]
            a0[i] = pair["acc0"]
            g0[i] = pair["gyr0"]
        t = self._tensor
        return preintegrate(t(dts), t(acc), t(gyr), t(a0), t(g0),
                            t(self.ba[:W]), t(self.bg[:W]), self.noise)

    def _measurements(self, state: WindowState) -> WindowMeasurements:
        cfg, t = self.cfg, self._tensor
        return WindowMeasurements(
            pre=self._preintegrate_pairs(),
            pre_valid=torch.ones(cfg.window, dtype=self.dtype,
                                 device=self.device),
            pts=t(self.db.pts), vel=t(self.db.vel), mask=t(self.db.mask),
            anchor=torch.tensor(self.db.anchor, device=self.device),
            feat_valid=t(self.db.feat_valid),
            prior=self.prior,
            zupt_w=t(self.stationary * self.zupt_weight)
            if self.zupt else None,
            td_obs=t(self.td_at_frame) if cfg.estimate_td else None,
            feat_w=t(np.sqrt(np.maximum(self.db.prob, self.prob_floor)))
            if self.prob_weight else None)

    def _adopt(self, st: WindowState):
        """Take the solved state (numpy leaves that own their memory)."""
        self.p = st.p.copy()
        self.q = st.q.copy()
        self.v = st.v.copy()
        self.ba = st.ba.copy()
        self.bg = st.bg.copy()
        self.tic = st.tic.copy()
        self.qic = st.qic.copy()
        self.td = float(st.td)
        self.db.inv_depth = st.inv_depth.copy()

    def _shift_state(self, drop: int):
        for arr in (self.p, self.q, self.v, self.ba, self.bg):
            arr[drop:-1] = arr[drop + 1:]
        self.stationary[drop:-1] = self.stationary[drop + 1:]
        self.td_at_frame[drop:-1] = self.td_at_frame[drop + 1:]

    def _failure(self, st: WindowState) -> bool:
        """failureDetection (estimator.cpp:612-658) on the solved state read
        back to the host."""
        nf = self.cfg.nf
        ba = st.ba[nf - 1]
        bg = st.bg[nf - 1]
        if np.linalg.norm(ba) > 2.5 or np.linalg.norm(bg) > 1.0:
            return True
        dp = st.p[nf - 1] - self.p[nf - 1]
        if np.linalg.norm(dp) > 5.0 or abs(dp[2]) > 1.0:
            return True
        if not np.all(np.isfinite(st.p)):
            return True
        # slow-runaway tripwire: the rolling MEDIAN of ‖v[newest]‖ so one
        # aggressive-turn transient can't reboot a healthy run
        if len(self._speed_hist) == 8 and \
                float(np.median(self._speed_hist)) > self.max_speed_fail:
            return True
        # self-calibrating tripwire: trip when the rolling median exceeds
        # adaptive_speed_ratio × the 95th percentile of the previous few
        # hundred solves (floor adaptive_speed_floor)
        if self.adaptive_speed_ratio and len(self._speed_hist) == 8 \
                and len(self.diag.speeds) > 160:
            # the last 8 s are excluded so a slow ramp cannot launder
            # itself into its own baseline
            ref = float(np.percentile(self.diag.speeds[-600:-80], 95))
            thresh = max(self.adaptive_speed_ratio * ref,
                         self.adaptive_speed_floor)
            if float(np.median(self._speed_hist)) > thresh:
                return True
        return False

    def _reject_outliers(self, demote_px: float = None):
        """Depth-failure handling (reference removeFailures semantics).

        Features whose depth collapsed to the clamp, or whose reprojection is
        grossly wrong, are DEMOTED (solved=0, depth reset → re-triangulated
        next frame with their full track history) — never deleted.
        """
        if demote_px is None:
            demote_px = self.demote_px
        db = self.db
        R = _host_op(lie.quat_to_rot, self.q)
        Ric = _host_op(lie.quat_to_rot, self.qic)
        valid = np.nonzero(db.feat_valid * db.solved)[0]
        anchor = db.anchor
        for s in valid:
            a = anchor[s]
            demote = db.inv_depth[s] <= self.cfg.min_inv_depth * 1.001
            if not demote:
                ptc = db.pts[s, a] / db.inv_depth[s]
                pw = R[a] @ (Ric @ ptc + self.tic) + self.p[a]
                errs = []
                for j in np.nonzero(db.mask[s])[0]:
                    if j == a:
                        continue
                    pc = Ric.T @ (R[j].T @ (pw - self.p[j]) - self.tic)
                    if pc[2] < 1e-3:
                        errs.append(100.0)
                        continue
                    e = pc[:2] / pc[2] - db.pts[s, j, :2]
                    errs.append(np.linalg.norm(e) * 460.0)
                demote = bool(errs and np.mean(errs) > demote_px)
            if demote:
                db.solved[s] = 0
                db.inv_depth[s] = 0.2

    def _record_output(self, t: float, slot: int):
        self.trajectory.append((
            t, self.p[slot].copy(), self.q[slot].copy(), self.v[slot].copy()))
