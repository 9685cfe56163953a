"""The simulated measurement stream of the streaming cells.

A copy of the port's `utils/sequence.SequenceSimulator` (itself the JAX
package's, drawing its random streams in the same order), numpy only: a
persistent landmark field is projected per frame; tracked ids that stay in
view are kept, and the set is topped up to `max_features` with new ids. The
knobs for degraded tracking (track loss, slips, quality-scaled noise) are
kept, so that a traffic file can turn them on. `pack_stream` lays the
frames out as the fixed arrays the estimator's step consumes, stacked over
frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np

from benchmark.traffic.trajectories import Trajectory
from benchmark.traffic.trajectories import quat_to_rot as _quat_to_rot_np

# raw IMU samples held per frame interval (the estimator's pair buffer)
MAX_IMU_PER_PAIR = 64


class FrameMeasurement(NamedTuple):
    t: float
    feats: dict          # id -> (pt3 normalized, vel2, prob)
    imu_dts: np.ndarray  # [S] dt of samples since previous frame
    imu_acc: np.ndarray  # [S,3]
    imu_gyr: np.ndarray  # [S,3]
    acc0: np.ndarray     # sample at previous frame time
    gyr0: np.ndarray


@dataclass
class SequenceSimulator:
    traj: Trajectory
    seed: int = 0
    max_features: int = 150
    frame_stride: int = 20          # 200 Hz IMU / 10 Hz frames
    n_landmarks: int = 4000
    fov_x: float = 0.55             # half-angle tangents (≈ EuRoC pinhole)
    fov_y: float = 0.42
    depth_range: tuple = (0.8, 40.0)
    pixel_noise: float = 0.0        # std in pixels (÷460 internally)
    # per-landmark tracking quality → emitted as the prob channel (the
    # GFTT-score channel of the reference tracker) and, when
    # track_loss_rate > 0, features stochastically drop with rate
    # loss_rate·(1−quality) per frame — making selection policies that use
    # p_ℓ (quality / anticipate) meaningfully different from random
    track_loss_rate: float = 0.0
    # localization error scales with (1−quality): a weak corner localizes
    # worse under LK — per-feature pixel noise std becomes
    # pixel_noise·(1 + quality_noise_scale·(1−q)). 0 = uniform noise.
    quality_noise_scale: float = 0.0
    # track SLIP: with per-frame probability slip_rate·(1−q)² a tracked
    # feature drifts to a nearby wrong point and keeps being tracked THERE
    # (persistent offset) — the classic LK aperture/edge failure that
    # produces the outliers the reference's prob channel exists to predict
    # (feature_tracker.cpp:300-343). slip_px must stay SMALL (≲3 px):
    # gross slips fail the tracker's own F-RANSAC (feature_tracker.cpp:
    # 62-98, 1 px epipolar threshold) and become track LOSS, already
    # modeled above; what reaches the backend is the sub-threshold bias
    # that Cauchy down-weights but cannot reject. The tracker doesn't know
    # it slipped: prob stays at the feature's quality and the measurement
    # is silently wrong.
    slip_rate: float = 0.0
    slip_px: float = 2.5
    # degradation onset time [s]: slip / track-loss / quality-scaled noise
    # all activate at t > degrade_after. The κ-policy experiments set ~8 s:
    # the selector is pass-through until the backend initializes
    # (feature_selector.cpp:172-187 parity), so degradation during init
    # only injects POLICY-INDEPENDENT initializer failures that swamp the
    # between-policy comparison with common-mode divergence (measured:
    # 7-9/10 seeds diverge identically across policies on V2_03 when
    # degradation is active from t=0)
    degrade_after: float = 0.0
    # "spatial": quality varies smoothly over the world (real GFTT scores
    # are spatially correlated — corner-rich texture patches score high
    # together), so a pure top-κ-by-score policy concentrates its budget in
    # clusters with degenerate geometry at small κ, exactly the regime where
    # the reference's Quality variant diverges (results.tex:41-43).
    # "iid": quality independent per landmark.
    quality_mode: str = "spatial"
    # spatial correlation length as a fraction of the world extent. Small
    # fractions = patch-scale clusters (real GFTT: corner-rich texture
    # patches score high together) — keeps quality VARIANCE inside each
    # view (needed for any policy separation) while still clustering the
    # top-κ in image space. Large fractions make whole regions uniform,
    # which erases in-view variance and with it the separation.
    quality_wavelen_frac: tuple = (0.04, 0.15)
    # quality marginal Beta(a,b): (5,2) = mostly-good trackers; (2,2) =
    # wide spread (harsh track-loss separation between policies)
    quality_beta: tuple = (5.0, 2.0)
    tic: np.ndarray | None = None
    qic: np.ndarray | None = None
    # true camera-IMU time offset: image content is sampled at t+cam_td
    # while the frame is STAMPED t (the reference models exactly this skew,
    # estimator_node.cpp's td handling + projection_td_factor.cpp:50-52) —
    # lets a grid cell exercise online td estimation end-to-end
    cam_td: float = 0.0
    # velocity channel from CLEAN projections (td-recovery validation):
    # with velocities differenced from noisy points, the observation noise
    # appears in both the residual and the regressor — a classic
    # errors-in-variables bias of sigma^2/dt / (v^2 + sigma^2/dt^2), which
    # measured +11 ms on slow MH_05 at 0.5 px noise (results/r3/
    # td_recovery.json). True of any real tracker too; this knob isolates
    # the estimator's td machinery from the artifact.
    clean_velocity: bool = False
    # explicit landmark positions [N,3]; None → uniform box around the
    # trajectory (wall_landmarks() gives revisit-consistent surface points
    # for loop-closure scenarios)
    landmarks: np.ndarray | None = None
    # IMU corruption (per-sample white noise std + constant bias magnitude)
    # — drives realistic odometry drift for loop-closure evaluation; on its
    # own rng stream so enabling it never shifts the track-selection draws
    imu_acc_sigma: float = 0.0
    imu_gyr_sigma: float = 0.0
    imu_acc_bias: float = 0.0
    imu_gyr_bias: float = 0.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        t = self.traj
        lo, hi = t.p.min(0) - 4.0, t.p.max(0) + 4.0
        if self.landmarks is None:
            self.landmarks = rng.uniform(lo, hi, size=(self.n_landmarks, 3))
        else:
            self.landmarks = np.asarray(self.landmarks, float)
            self.n_landmarks = len(self.landmarks)
        # quality field on its OWN rng stream: the track-selection draws
        # below must not depend on quality_mode (keeps scenarios comparable
        # across modes and releases)
        qrng = np.random.default_rng(self.seed + 777_001)
        qa, qb = self.quality_beta
        marginal = np.sort(qrng.beta(qa, qb, size=self.n_landmarks))
        if self.quality_mode == "spatial":
            # smooth random field over position; rank-map onto the same
            # beta marginal so only the spatial structure changes
            k = qrng.normal(size=(6, 3))
            k /= np.linalg.norm(k, axis=1, keepdims=True)
            extent = float(np.linalg.norm(hi - lo))
            w_lo, w_hi = self.quality_wavelen_frac
            wavelen = qrng.uniform(w_lo * extent, w_hi * extent, size=6)
            phase = qrng.uniform(0, 2 * np.pi, size=6)
            amp = qrng.uniform(0.5, 1.0, size=6)
            raw = sum(a * np.cos(2 * np.pi / w * self.landmarks @ kk + ph)
                      for a, w, kk, ph in zip(amp, wavelen, k, phase))
            self.lm_quality = marginal[np.argsort(np.argsort(raw))]
        else:
            self.lm_quality = marginal[qrng.permutation(self.n_landmarks)]
        # corrupted IMU streams, precomputed so adjacent frames share the
        # exact boundary sample (acc0 of frame f == last sample of f-1)
        nrng = np.random.default_rng(self.seed + 777_002)
        n_s = len(t.t)
        self._acc = np.asarray(t.acc_body, float)
        self._gyr = np.asarray(t.gyr_body, float)
        if (self.imu_acc_sigma or self.imu_gyr_sigma
                or self.imu_acc_bias or self.imu_gyr_bias):
            ba = nrng.normal(size=3) * self.imu_acc_bias
            bg = nrng.normal(size=3) * self.imu_gyr_bias
            self._acc = (self._acc + ba
                         + nrng.normal(size=(n_s, 3)) * self.imu_acc_sigma)
            self._gyr = (self._gyr + bg
                         + nrng.normal(size=(n_s, 3)) * self.imu_gyr_sigma)
        self.rng = rng
        self.tracked: dict = {}
        # landmark-idx → feature id; ids are MONOTONICALLY increasing like
        # the reference tracker's n_id++ (a re-entering landmark gets a
        # fresh id — the selector's id watermark depends on this contract)
        self._id_of: dict = {}
        self._next_id = 0
        self.R_all = _quat_to_rot_np(t.q)
        if self.tic is None:
            self.tic = np.zeros(3)
        if self.qic is None:
            self.qic = np.array([1.0, 0, 0, 0])
        self.R_ic = _quat_to_rot_np(self.qic)
        self._prev_pts: dict = {}
        self._slip: dict = {}   # landmark idx -> persistent normalized offset

    def _visible(self, k: int):
        """Landmark ids visible from frame-index k (into the IMU-rate traj)."""
        R, p = self.R_all[k], self.traj.p[k]
        P_c = np.einsum("ij,nj->ni", self.R_ic.T,
                        np.einsum("ij,nj->ni", R.T, self.landmarks - p) - self.tic)
        z = P_c[:, 2]
        ok = (z > self.depth_range[0]) & (z < self.depth_range[1])
        zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
        x, y = P_c[:, 0] / zs, P_c[:, 1] / zs
        ok &= (np.abs(x) < self.fov_x) & (np.abs(y) < self.fov_y)
        return ok, np.stack([x, y, np.ones_like(x)], -1)

    def frames(self, n_frames: int | None = None) -> Iterator[FrameMeasurement]:
        t = self.traj
        stride = self.frame_stride
        total = (len(t.t) - 1) // stride
        if n_frames is not None:
            total = min(total, n_frames)
        dt_frame = None
        td_samp = int(round(self.cam_td * 200.0))
        for f in range(total):
            k = f * stride
            k_img = int(np.clip(k + td_samp, 0, len(t.t) - 1))
            ok, pts = self._visible(k_img)
            vis_ids = set(np.nonzero(ok)[0].tolist())

            degrade = float(t.t[k] - t.t[0]) >= self.degrade_after
            kept = {i for i in self.tracked if i in vis_ids}
            if self.track_loss_rate > 0 and degrade:
                kept = {i for i in kept
                        if self.rng.random() >=
                        self.track_loss_rate * (1.0 - self.lm_quality[i])}
            budget = self.max_features - len(kept)
            if budget > 0:
                fresh = list(vis_ids - kept)
                self.rng.shuffle(fresh)
                newly = fresh[:budget]
                for i in newly:
                    self._id_of[i] = self._next_id
                    self._next_id += 1
                kept |= set(newly)
            self.tracked = {i: self.tracked.get(i, 0) + 1 for i in kept}

            if self._slip:
                self._slip = {i: o for i, o in self._slip.items() if i in kept}
            feats = {}
            dt_f = stride / 200.0
            for i in kept:
                pt = pts[i].copy()
                q_i = float(self.lm_quality[i])
                if degrade and self.slip_rate > 0 and \
                        self.tracked.get(i, 0) > 1 and \
                        self.rng.random() < self.slip_rate * (1.0 - q_i) ** 2:
                    self._slip[i] = self._slip.get(i, 0.0) + \
                        self.rng.normal(size=2) * self.slip_px / 460.0
                if i in self._slip:
                    pt[:2] += self._slip[i]
                if self.pixel_noise > 0:
                    sigma = self.pixel_noise * \
                        (1.0 + (self.quality_noise_scale * (1.0 - q_i)
                                if degrade else 0.0))
                    pt[:2] += self.rng.normal(size=2) * sigma / 460.0
                prev = self._prev_pts.get(i)
                vsrc = pts[i][:2] if self.clean_velocity else pt[:2]
                vel = (vsrc - prev[:2]) / dt_f if prev is not None else np.zeros(2)
                feats[self._id_of[i]] = (pt, vel, float(self.lm_quality[i]))
            self._prev_pts = {i: pts[i].copy() for i in kept}

            s = max(k - stride, 0)
            yield FrameMeasurement(
                t=float(t.t[k]), feats=feats,
                imu_dts=np.diff(t.t[s:k + 1]) if k > 0 else np.zeros(0),
                imu_acc=self._acc[s + 1:k + 1] if k > 0 else np.zeros((0, 3)),
                imu_gyr=self._gyr[s + 1:k + 1] if k > 0 else np.zeros((0, 3)),
                acc0=self._acc[s], gyr0=self._gyr[s])


class PackedStream(NamedTuple):
    """Frames as fixed arrays, stacked over frames [T, ...]."""
    ids: np.ndarray      # [T,N] int32, -1 = empty slot
    pts: np.ndarray      # [T,N,3] normalized rays
    vel: np.ndarray      # [T,N,2]
    prob: np.ndarray     # [T,N]
    active: np.ndarray   # [T,N] bool
    imu_dts: np.ndarray  # [T,S]
    imu_acc: np.ndarray  # [T,S,3]
    imu_gyr: np.ndarray  # [T,S,3]
    acc0: np.ndarray     # [T,3]
    gyr0: np.ndarray     # [T,3]


def pack_stream(frames, n_slots: int) -> PackedStream:
    """The frames in the layout of the port's `estimator_device.pack_frame`
    (features in insertion order, IMU samples dt-padded to
    `MAX_IMU_PER_PAIR`), for every frame at once."""
    T, S = len(frames), MAX_IMU_PER_PAIR
    out = PackedStream(
        ids=np.full((T, n_slots), -1, np.int32), pts=np.zeros((T, n_slots, 3)),
        vel=np.zeros((T, n_slots, 2)), prob=np.ones((T, n_slots)),
        active=np.zeros((T, n_slots), bool), imu_dts=np.zeros((T, S)),
        imu_acc=np.zeros((T, S, 3)), imu_gyr=np.zeros((T, S, 3)),
        acc0=np.zeros((T, 3)), gyr0=np.zeros((T, 3)))
    for t, fm in enumerate(frames):
        for j, (fid, (pt, vl, pb)) in enumerate(fm.feats.items()):
            if j >= n_slots:
                break
            out.ids[t, j] = fid
            out.pts[t, j] = pt
            out.vel[t, j] = vl
            out.prob[t, j] = pb
            out.active[t, j] = True
        n = min(len(fm.imu_dts), S)
        out.imu_dts[t, :n] = fm.imu_dts[:n]
        out.imu_acc[t, :n] = fm.imu_acc[:n]
        out.imu_gyr[t, :n] = fm.imu_gyr[:n]
        out.acc0[t] = fm.acc0
        out.gyr0[t] = fm.gyr0
    return out
