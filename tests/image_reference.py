"""Reference readings of the image path at the deployment's full width
(752×480 EuRoC cam0, 128 tracker slots, min-distance 30, 4 levels, window
10, κ̄ = 30), on the CPU: the numbers that `chip_smoke.py`'s `image` bounds
are set from. The scene is `utils/deployment.image_scene`'s: the box world
(seed 0) around `loop_trajectory(20, laps=2, radius=3)`, 10 Hz frames,
200 Hz IMU, identity extrinsics.

    python tests/image_reference.py ate --dtype float32 --seeds 0 1 2 3 4
    python tests/image_reference.py ate --dtype float64 --trajectory analytic
    python tests/image_reference.py lk --frames 8

`ate`: the JAX package's own image path, render → `DeviceFeatureTracker`
(its PRNG seed) → `VioNode` → `VioEstimator(dtype)` with the "chol"
`AttentionSelector`, from the first ground-truth state; one JSON line per
tracker seed (the seed picks the RANSAC draws and nothing else).
`--trajectory analytic` puts the same box world around
`analytic_trajectory(12.0)` instead of the circuit.

`lk`: the first frames of the same scene through the JAX tracker; before
each frame its state is copied into the port, and both packages run
`_prep` + `lk_track` on the CPU on the same image. One JSON line per
frame: the LK-tracked points (active before, `ok` after, in both), how
many part by more than 0.05 px, the largest parting, and whether `ok`
agrees; and how many of them are rounding-sensitive (the port's LK in
float64 on its own pyramids parts from its float32 result by more than
1e-3 px) and the partings of the others.

A script, not a test (pytest collects `test_*.py` only): at this size it
takes minutes. It runs JAX on the CPU with x64 enabled, as the test suite
does.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from anticipated_vins_mono_tpu.utils.jaxenv import force_cpu_f64  # noqa: E402

force_cpu_f64(threads=int(os.environ.get("REF_THREADS", "4")))
os.environ.setdefault("ANT_SELECT_IMPL", "chol")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from anticipated_vins_mono_tpu.models import frontend as jfe  # noqa: E402
from anticipated_vins_mono_tpu.models import tracker_device as jtd  # noqa
from anticipated_vins_mono_tpu.ops import cameras as jcam  # noqa: E402
from anticipated_vins_mono_tpu.ops import lie as jlie  # noqa: E402
from anticipated_vins_mono_tpu.utils import render as jrender  # noqa: E402
from anticipated_vins_mono_tpu.utils.synthetic import (  # noqa: E402
    analytic_trajectory, loop_trajectory)

WINDOW, MAX_FEATS, LM_ITERS, KAPPA, N_INPUT = 10, 128, 8, 30, 128
MIN_DIST, LEVELS, STRIDE = 30, 4, 20          # 200 Hz IMU / 10 Hz frames
SENSITIVE_PX = 1e-3


def scene(trajectory: str = "loop"):
    traj = loop_trajectory(20.0, laps=2.0, radius=3.0) \
        if trajectory == "loop" else analytic_trajectory(12.0)
    cam = jcam.euroc_camera()
    world = jrender.make_box_world(traj.p, seed=0)
    rays = jrender.camera_rays(cam)
    R_all = np.asarray(jlie.quat_to_rot(jnp.asarray(traj.q)))
    return traj, cam, world, rays, R_all


def tracker_params():
    return jtd.TrackerDeviceParams(max_features=N_INPUT, min_dist=MIN_DIST,
                                   levels=LEVELS)


def run_ate(dtype: str, seed: int, frames: int,
            trajectory: str = "loop") -> dict:
    from anticipated_vins_mono_tpu.models.anticipation import SelectorConfig
    from anticipated_vins_mono_tpu.models.estimator import VioEstimator
    from anticipated_vins_mono_tpu.models.feature_selector import \
        AttentionSelector
    from anticipated_vins_mono_tpu.models.node import VioNode
    from anticipated_vins_mono_tpu.ops.window import WindowConfig
    from anticipated_vins_mono_tpu.utils.metrics import ate_rmse

    traj, cam, world, rays, R_all = scene(trajectory)
    tracker = jtd.DeviceFeatureTracker(cam, tracker_params(), seed=seed)
    sel = AttentionSelector(SelectorConfig(max_features=KAPPA),
                            max_candidates=N_INPUT)
    est = VioEstimator(WindowConfig(window=WINDOW, max_feats=MAX_FEATS,
                                    iters=LM_ITERS),
                       dtype=getattr(jnp, dtype), selector=sel,
                       init_state={"p": traj.p[0], "q": traj.q[0],
                                   "v": traj.v[0]})
    node = VioNode(est)
    t0 = time.perf_counter()
    for f in range(frames):
        k = f * STRIDE
        for j in range(k - STRIDE + 1 if f else 0, k + 1):
            node.push_imu(traj.t[j], traj.acc_body[j], traj.gyr_body[j])
        img = jrender.render_frame(world, cam, rays, traj.p[k], R_all[k])
        node.push_features(float(traj.t[k]),
                           tracker.process(img, float(traj.t[k])))
    tr = est.trajectory
    est_t = np.array([x[0] for x in tr])
    est_p = np.stack([x[1] for x in tr])
    return {"part": "ate", "trajectory": trajectory, "dtype": dtype,
            "tracker_seed": seed,
            "frames": frames, "solves": est.diag.solves,
            "failures": est.diag.failures,
            "ate_rmse_m": float(ate_rmse(est_t, est_p, traj.t, traj.p)),
            "seconds": time.perf_counter() - t0}


def run_lk(frames: int) -> list:
    from anticipated_vins_mono_torch.models import frontend as tfe
    from anticipated_vins_mono_torch.models import tracker_device as ttd
    from anticipated_vins_mono_torch.utils import convert

    traj, cam, world, rays, R_all = scene()
    tp = tracker_params()
    out, state = [], None
    for f in range(frames):
        k = f * STRIDE
        img = jrender.render_frame(world, cam, rays, traj.p[k], R_all[k])
        t = float(traj.t[k])
        if state is None:
            state = jtd.tracker_init(cam, tp, jnp.asarray(img, jnp.float32),
                                     t, 0)
            continue
        _, pyr_j = jtd._prep(jnp.asarray(img, jnp.float32), LEVELS)
        pts_j, ok_j = jfe.lk_track(state.pyr, pyr_j, state.pts,
                                   state.active.astype(state.pts.dtype),
                                   levels=LEVELS)
        st = convert.tracker_state_from_numpy(
            jax_tree_to_numpy(state), device="cpu")
        _, pyr_t = ttd._prep(torch.tensor(np.asarray(img), device="cpu"),
                             LEVELS)
        pts_t, ok_t = tfe.lk_track(st.pyr, pyr_t, st.pts,
                                   st.active.to(st.pts.dtype), levels=LEVELS)
        # the port's LK in float64 on its own pyramids: a point whose float32
        # and float64 results part by more than SENSITIVE_PX is rounding-
        # sensitive (ill-conditioned)
        pts_d, ok_d = tfe.lk_track(
            tuple(x.double() for x in st.pyr),
            tuple(x.double() for x in pyr_t), st.pts.double(),
            st.active.double(), levels=LEVELS)
        act = np.asarray(state.active)
        ok_j, ok_t = np.asarray(ok_j) & act, ok_t.numpy() & act
        both = ok_j & ok_t
        dev = np.abs(np.asarray(pts_j) - pts_t.numpy()).max(-1)[both]
        sens = (np.abs(pts_d.numpy() - pts_t.numpy()).max(-1)
                > SENSITIVE_PX)[both] | ~ok_d.numpy()[both]
        out.append({"part": "lk", "frame": f, "tracked": int(both.sum()),
                    "ok_equal": bool((ok_j == ok_t).all()),
                    "over_0.05px": int((dev > 0.05).sum()),
                    "max_abs_px": float(dev.max()),
                    "median_abs_px": float(np.median(dev)),
                    "sensitive": int(sens.sum()),
                    "over_0.05px_not_sensitive": int(
                        (dev[~sens] > 0.05).sum()),
                    "max_abs_px_not_sensitive": float(dev[~sens].max())})
        state, _ = jtd.tracker_step(cam, tp, state,
                                    jnp.asarray(img, jnp.float32), t)
    return out


def jax_tree_to_numpy(state):
    return type(state)(*(tuple(np.asarray(x) for x in v)
                         if isinstance(v, tuple) else np.asarray(v)
                         for v in state))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("part", choices=("ate", "lk"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--trajectory", default="loop",
                    choices=("loop", "analytic"))
    args = ap.parse_args()
    torch.set_num_threads(int(os.environ.get("REF_THREADS", "4")))
    if args.part == "ate":
        for s in args.seeds:
            print(json.dumps(run_ate(args.dtype, s, args.frames or 60,
                                     args.trajectory)), flush=True)
    else:
        for line in run_lk(args.frames or 5):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
