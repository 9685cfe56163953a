"""The reference deployment at full width, in one place.

`chip_smoke.py` and `utils/profile_slice.py` both drive the port at these
sizes and take them from here, so that the two cannot drift apart: a
10-keyframe window (NF = 11), 128 landmark slots, 128 input feature slots,
D = 178, 8 LM iterations, 64 IMU samples per pair buffer; the anticipation
gate with κ̄ = 30 over a 13-frame horizon of 20 IMU substeps of 5 ms, scored
with "chol" (the batched log-det kernel in float32 on the card). The image
path's front end: the EuRoC `cam0` camera (752×480, radtan), a tracker of
`N_INPUT` slots with min-distance 30 px over a 4-level pyramid (the sizes
of the JAX package's `utils/image_benchmark.py`), frames at 10 Hz and IMU
samples at 200 Hz.
"""

from __future__ import annotations

import torch

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models import estimator_device as ed
from anticipated_vins_mono_torch.models import tracker_device as td
from anticipated_vins_mono_torch.ops import cameras, lie
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import render
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
from anticipated_vins_mono_torch.utils.synthetic import (Trajectory,
                                                        loop_trajectory)

WINDOW, MAX_FEATS, LM_ITERS = 10, 128, 8
N_INPUT = 128                      # feature slots of one incoming frame
KAPPA, N_IMU, DT_IMU = 30, 20, 0.005
TRACKER_MIN_DIST, TRACKER_LEVELS = 30, 4
FRAME_HZ, IMU_HZ = 10.0, 200.0


def camera(device="cuda") -> cameras.PinholeCamera:
    """The EuRoC cam0 intrinsics and distortion, float32."""
    return cameras.euroc_camera(device=device)


def image_scene(device="cuda", seed: int = 0):
    """The image path's scene on `device`: the circuit trajectory (20 s, two
    laps of radius 3 m, the camera looking outward), the textured box world
    around it (`make_box_world(traj.p, seed=seed)`), the EuRoC camera and its
    per-pixel rays. Returns (traj, cam, world, rays, R_wb of every IMU
    sample [N,3,3], IMU samples per frame); the camera frame is the body
    frame (identity extrinsics, the `VioEstimator` default)."""
    traj = loop_trajectory(20.0, laps=2.0, radius=3.0)
    cam = camera(device)
    world = render.make_box_world(traj.p, seed=seed, device=device)
    R_all = lie.quat_to_rot(torch.tensor(traj.q)).numpy()
    stride = int(round(IMU_HZ / FRAME_HZ))
    return traj, cam, world, render.camera_rays(cam), R_all, stride


def tracker_params() -> td.TrackerDeviceParams:
    """The device tracker at the deployment's width: `N_INPUT` slots."""
    return td.TrackerDeviceParams(max_features=N_INPUT,
                                  min_dist=TRACKER_MIN_DIST,
                                  levels=TRACKER_LEVELS)


def window_config(fused_schur: bool = True) -> WindowConfig:
    return WindowConfig(window=WINDOW, max_feats=MAX_FEATS, iters=LM_ITERS,
                        fused_schur=fused_schur)


def vio_params(fused_schur: bool = True) -> ed.DeviceVioParams:
    """The per-frame step with the anticipation gate on. `fused_schur=True`
    is the float32 configuration in which every frame launches both kernels;
    False is the float64 `torch.linalg` route."""
    return ed.DeviceVioParams(
        wcfg=window_config(fused_schur),
        sel_cfg=ant.SelectorConfig(max_features=KAPPA),
        sel_n_imu=N_IMU, sel_dt_imu=DT_IMU, sel_impl="chol")


def vio_sequence(traj: Trajectory, dtype, seed: int = 0, device="cuda"):
    """The simulated measurement stream over `traj` (0.3 px noise, up to
    `N_INPUT` features a frame): (frames, the same frames packed for
    `vio_step` in `dtype` on `device`)."""
    sim = SequenceSimulator(traj, seed=seed, pixel_noise=0.3,
                            max_features=N_INPUT)
    frames = list(sim.frames())
    return frames, [ed.pack_frame(fm, N_INPUT, dtype=dtype, device=device)
                    for fm in frames]


def vio_start(pr: ed.DeviceVioParams, traj: Trajectory, packed,
              device="cuda") -> ed.DeviceVioState:
    """The state before the first full-window frame, from the trajectory's
    own first state (`vio_init_oracle` on the first NF−1 frames)."""
    init = {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}
    return ed.vio_init_oracle(pr, init, packed[:pr.wcfg.nf - 1], device=device)
