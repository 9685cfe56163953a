"""Camera-to-trajectory VIO on the device (the capstone bench):
`tracker_device` + `estimator_device` per frame — a raw 752×480 image + the
IMU batch in, the next trajectory pose out.

Counterpart of `anticipated_vins_mono_tpu/utils/device_vio_bench.py`. The
protocol: the rendered box-world circuit (pinhole camera fx = 0.6·W), IMU
from the ground truth at 200 Hz; the host estimator (oracle start) consumes
the device tracker's measurements until its window is full, then
`vio_init_from_host` hands the window to the device and the rest of the
sequence runs `tracker_step` → `vio_step` per frame. The latency is measured
together with the accuracy (ATE against the ground truth), so it cannot be
bought with a broken estimate.

Where the two differ: the JAX package fuses the per-frame step under
`lax.scan`; here it is a Python loop over frames that reads nothing on the
host beyond what `vio_step` reads itself (the keyframe flag, `eigh`), and
synchronises after each stage to time the split (`tracker_ms_per_frame`,
`vio_step_ms_per_frame`). There is no compile: `compile_plus_first_run_s`
is the first device frame's time (the kernels' build included when it is
the process's first launch) and `device_ms_per_frame` the mean of the
others. `accum` defaults to "f64" (the JAX package's "df32" maps to f64
here), `slot_evict` and `sel_impl` are arguments (the JAX package reads
`ANT_SLOT_EVICT` / `ANT_SELECT_IMPL`), `backend` is the torch device, and
`device` says where it runs; `window` / `max_feats` shrink the window for
tests (the deployment's 10 and 128 by default), `tracker_seed` is the seed
of the tracker's RANSAC key (the JAX runner's tracker takes seed 0: the
same seed draws the same values in both packages), and
`fused_schur` picks the window solve's Schur step (default: the float32
kernel for float32 on the card; False takes the float64 Schur path, the
JAX runner's default `pallas_schur=False`). The default mode's row adds
`handoff_frame`, `host_solves` (the warm-up's window solves) and the stage
split.

    python3 -m anticipated_vins_mono_torch.utils.device_vio_bench \
        --duration 20 --kappa 30
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models import estimator_device as ed
from anticipated_vins_mono_torch.models import tracker_device as td
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.models.feature_selector import \
    AttentionSelector
from anticipated_vins_mono_torch.ops import cameras, lie
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import render
from anticipated_vins_mono_torch.utils.metrics import ate_rmse
from anticipated_vins_mono_torch.utils.sequence import FrameMeasurement
from anticipated_vins_mono_torch.utils.synthetic import loop_trajectory


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_circuit(duration: float, width: int, height: int, laps,
                   device):
    """The circuit and its frames: (cam, traj, imgs [T,H,W] on `device`,
    frame times, the IMU per frame padded to `MAX_IMU_PER_PAIR` as numpy
    (dts, acc, gyr, acc0, gyr0))."""
    fx = 0.6 * width
    cam = cameras.PinholeCamera.create(fx, fx, width / 2.0, height / 2.0,
                                       width=width, height=height,
                                       device=device)
    # default 1 lap / 10 s; the corruption-recovery protocol uses slower
    # laps (--laps): the real SfM init chain needs frame pairs that share
    # ≥ 20 tracks (initial_sfm.cpp:117-244)
    traj = loop_trajectory(duration,
                           laps=duration / 10.0 if laps is None else laps,
                           radius=3.0)
    world = render.make_box_world(traj.p, margin=5.0, seed=0, device=device)
    crays = render.camera_rays(cam)
    R_all = lie.quat_to_rot(torch.tensor(traj.q)).numpy()

    stride = 20                     # 200 Hz IMU / 10 Hz frames
    n_total = (len(traj.t) - 1) // stride
    ks = np.arange(n_total) * stride
    imgs = torch.stack([render.render_frame(world, cam, crays, traj.p[k],
                                            R_all[k]) for k in ks])
    ts = traj.t[ks]
    S = ed.MAX_IMU_PER_PAIR
    imu = (np.zeros((n_total, S)), np.zeros((n_total, S, 3)),
           np.zeros((n_total, S, 3)), np.zeros((n_total, 3)),
           np.zeros((n_total, 3)))
    dts, acc, gyr, acc0, gyr0 = imu
    for f in range(1, n_total):
        s, k = ks[f - 1], ks[f]
        n = k - s
        dts[f, :n] = np.diff(traj.t[s:k + 1])
        acc[f, :n] = traj.acc_body[s + 1:k + 1]
        gyr[f, :n] = traj.gyr_body[s + 1:k + 1]
        acc0[f] = traj.acc_body[s]
        gyr0[f] = traj.gyr_body[s]
    return cam, traj, imgs, ts, imu


def _frame_measurement(tracker, imgs, ts, imu, g) -> FrameMeasurement:
    dts, acc, gyr, acc0, gyr0 = imu
    feats = tracker.process(imgs[g], float(ts[g]))
    n = np.count_nonzero(dts[g])
    return FrameMeasurement(t=float(ts[g]), feats=feats, imu_dts=dts[g, :n],
                            imu_acc=acc[g, :n], imu_gyr=gyr[g, :n],
                            acc0=acc0[g], gyr0=gyr0[g])


def warm_up(est, tracker, imgs, ts, imu, f: int, min_left: int) -> int:
    """Step the host estimator on the device tracker's measurements from
    frame `f` until it is initialized with a window one frame short of full;
    returns the next frame."""
    nf = est.cfg.nf
    while not (est.initialized and est.n_frames == nf - 1):
        est.process_frame(_frame_measurement(tracker, imgs, ts, imu, f))
        f += 1
        if f >= len(ts) - min_left:
            raise RuntimeError("the estimator never initialized")
    return f


def run_device(cam, tparams, pr, tst, vst, imgs, ts, imu, lo: int, hi: int,
               dtype, timed: bool = False):
    """`tracker_step` → `vio_step` over frames [lo, hi). Returns the final
    (tracker state, vio state), the outputs stacked over the frames (p, q,
    cost, keyframe, fail; on the device) and, when `timed`, the per-frame
    seconds of the two stages (a synchronise after each)."""
    device = vst.p.device
    j = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    dts, acc, gyr, acc0, gyr0 = (j(x[lo:hi]) for x in imu)
    outs, t_track, t_step = [], [], []
    for n, g in enumerate(range(lo, hi)):
        t0 = time.perf_counter()
        tst, (ids, rays, vel, prob, active) = td.tracker_step(
            cam, tparams, tst, imgs[g], float(ts[g]))
        if timed:
            _sync(device)
        t1 = time.perf_counter()
        vst, o = ed.vio_step(pr, vst, ids, rays.to(dtype), vel.to(dtype),
                             prob.to(dtype), active, dts[n], acc[n], gyr[n],
                             acc0[n], gyr0[n], device=device)
        if timed:
            _sync(device)
            t_track.append(t1 - t0)
            t_step.append(time.perf_counter() - t1)
        outs.append((o["p"], o["q"], o["cost"].reshape(()),
                     o["keyframe"], o["fail"]))
    stacked = tuple(torch.stack([o[i] for o in outs]) for i in range(5))
    return (tst, vst), stacked, (t_track, t_step)


def main(duration: float = 20.0, width: int = 752, height: int = 480,
         n_feats: int = 150, out: str | None = None, dtype_str: str = None,
         kappa: int = 0, accum: str = "f64", host_control: bool = False,
         corrupt_at: float = 0.0, laps: float = None,
         corrupt_debug: bool = False, slot_evict: bool = True,
         sel_impl: str = None, device="cuda", window: int = 10,
         max_feats: int = 128, tracker_seed: int = 0,
         fused_schur: bool = None):
    device = torch.device(device)
    dtype = torch.float32 if dtype_str is None else getattr(torch, dtype_str)
    print(f"rendering {int(duration * 10)} frames...", flush=True)
    cam, traj, imgs, ts, imu = render_circuit(duration, width, height, laps,
                                              device)
    n_total = len(ts)

    # ---- host warm-up through the DEVICE tracker's measurements
    if fused_schur is None:
        fused_schur = dtype == torch.float32 and device.type == "cuda"
    wcfg = WindowConfig(window=window, max_feats=max_feats, iters=8,
                        accum=accum, fused_schur=fused_schur)
    tparams = td.TrackerDeviceParams(max_features=n_feats)
    tracker = td.DeviceFeatureTracker(cam, tparams, seed=tracker_seed)
    oracle = {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}
    est = VioEstimator(wcfg, dtype=dtype, init_state=oracle, device=device)
    f = warm_up(est, tracker, imgs, ts, imu, 0, 10)
    if host_control:
        # the host-path selector + estimator on the same circuit and the
        # same device-tracker measurements: isolates the on-device gate
        # (_select_stage) from the budget itself
        sel = None
        if kappa:
            sel = AttentionSelector(ant.SelectorConfig(max_features=kappa),
                                    max_candidates=n_feats,
                                    policy="anticipate", seed=0,
                                    impl=sel_impl, device=device)
        est_c = VioEstimator(wcfg, dtype=dtype, selector=sel,
                             init_state=oracle, device=device)
        t0 = time.perf_counter()
        for g in range(n_total):
            est_c.process_frame(_frame_measurement(tracker, imgs, ts, imu, g))
        wall = time.perf_counter() - t0
        t_e = np.array([x[0] for x in est_c.trajectory])
        p_e = np.stack([x[1] for x in est_c.trajectory])
        rows = {
            "backend": str(device), "mode": "host_control",
            "duration_s": duration, "kappa": kappa,
            "ate_rmse_m": float(ate_rmse(t_e, p_e, traj.t, traj.p)),
            "failures": est_c.diag.failures,
            "keyframe_fraction": (est_c.diag.keyframes
                                  / max(est_c.diag.solves, 1)),
            "host_ms_per_frame": wall / n_total * 1e3,
        }
        return _emit(rows, out)

    vst = ed.vio_init_from_host(est)
    sel_cfg = ant.SelectorConfig(max_features=kappa) if kappa else None
    pr = ed.DeviceVioParams(wcfg=wcfg, sel_cfg=sel_cfg, slot_evict=slot_evict,
                            sel_impl=sel_impl)
    print(f"hand-off at frame {f}", flush=True)

    def run(tst, vst_, lo, hi, timed=False):
        return run_device(cam, tparams, pr, tst, vst_, imgs, ts, imu, lo, hi,
                          dtype, timed)

    if corrupt_at:
        # ---- failure injection: run, corrupt the device carry mid-run
        # (+30 m/s velocity, +50 m position — the reference's
        # failureDetection regime), let the device reboot fire and keep the
        # loop finite, then re-run the REAL host initialization chain from
        # the failure point and hand back to the device. Recovery metric:
        # ATE of the post-reinit segment, aligned on its own
        kc = max(f + 1, int(n_total * corrupt_at))
        (tst1, vst1), _, _ = run(tracker.state, vst, f, kc)
        vst_bad = vst1._replace(v=vst1.v + 30.0, p=vst1.p + 50.0)
        if corrupt_debug:
            # step-by-step forensics of the device recovery
            tst_d, vst_d = tst1, vst_bad
            j = lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                       device=device)
            for gdbg in range(kc, min(kc + 40, n_total)):
                tst_d, (ids_, rays_, vel_, prob_, act_) = td.tracker_step(
                    cam, tparams, tst_d, imgs[gdbg], float(ts[gdbg]))
                vst_d, o = ed.vio_step(
                    pr, vst_d, ids_, rays_.to(dtype), vel_.to(dtype),
                    prob_.to(dtype), act_, *(j(x[gdbg]) for x in imu),
                    device=device)
                print(f"dbg g={gdbg} fail={int(bool(o['fail']))} "
                      f"speed={float(o['speed']):.2f} "
                      f"cost={float(o['cost']):.3g} "
                      f"tracked={float(o['tracked']):.0f} "
                      f"n_solved={int(o['n_solved'])} "
                      f"sf={int(vst_d.since_fail)}", flush=True)
            return {}
        (tst2, vst2), outs2, _ = run(tst1, vst_bad, kc, n_total)
        fails = outs2[4].cpu().numpy()
        assert fails.any(), "corruption never tripped the device detector"
        k_fail = kc + int(np.argmax(fails))
        # supervisor: full host re-initialization from the failure point
        # (the real chain, no oracle); the tracker restarts fresh
        est_r = VioEstimator(wcfg, dtype=dtype, device=device)
        tracker.state = None
        g = warm_up(est_r, tracker, imgs, ts, imu, k_fail, 5)
        vst_r = ed.vio_init_from_host(est_r)
        _, outs3, _ = run(tracker.state, vst_r, g, n_total)
        p3 = outs3[0].double().cpu().numpy()
        assert np.all(np.isfinite(p3))
        ate_rec = ate_rmse(ts[g:], p3, traj.t, traj.p)
        rows = {
            "backend": str(device), "mode": "corruption_recovery",
            "duration_s": duration, "kappa": kappa,
            "corrupt_frame": int(kc), "fail_frame": int(k_fail),
            "frames_to_detect": int(k_fail - kc),
            "reinit_frames": int(g - k_fail),
            "recovered_frames": int(n_total - g),
            "ate_recovered_m": float(ate_rec),
            "device_fail_flags": int(fails.sum()),
            "post_corruption_finite": bool(
                torch.isfinite(outs2[0]).all()),
        }
        return _emit(rows, out)

    n_run = n_total - f
    t0 = time.perf_counter()
    _, outs, (t_track, t_step) = run(tracker.state, vst, f, n_total,
                                     timed=True)
    _sync(device)
    wall = time.perf_counter() - t0
    first_s = t_track[0] + t_step[0]
    p_est = outs[0].double().cpu().numpy()
    fails = outs[4].cpu().numpy()
    costs = outs[2].double().cpu().numpy()
    assert np.all(np.isfinite(p_est)), "non-finite trajectory"
    ate = ate_rmse(ts[f:], p_est, traj.t, traj.p)
    device_ms = (wall - first_s) / max(n_run - 1, 1) * 1e3

    rows = {
        "backend": str(device),
        "dtype": str(dtype).split(".")[-1],
        "resolution": [height, width],
        "n_frames_total": int(n_total),
        "n_frames_device": int(n_run),
        "handoff_frame": int(f),
        "host_solves": est.diag.solves,
        "duration_s": duration,
        "device_ms_per_frame": device_ms,
        "tracker_ms_per_frame": float(np.median(t_track[1:] or t_track)) * 1e3,
        "vio_step_ms_per_frame": float(np.median(t_step[1:] or t_step)) * 1e3,
        "compile_plus_first_run_s": first_s,
        "ate_rmse_m": float(ate),
        "fail_flags": int(fails.sum()),
        "keyframe_fraction": float(outs[3].double().mean()),
        "cost_final_mean": float(costs.mean()),
        "kappa": kappa,
        "accum": accum,
        "reference_ms_per_frame": 57.0,
        "vs_reference": 57.0 / device_ms,
    }
    return _emit(rows, out)


def _emit(rows: dict, out) -> dict:
    print(json.dumps(rows, indent=1))
    if out:
        with open(out, "w") as fo:
            json.dump(rows, fo, indent=1)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--kappa", type=int, default=0)
    ap.add_argument("--accum", default="f64")
    ap.add_argument("--host-control", action="store_true")
    ap.add_argument("--corrupt-at", type=float, default=0.0,
                    help="fraction of the run at which to corrupt the "
                         "device state (failure-injection protocol)")
    ap.add_argument("--laps", type=float, default=None)
    ap.add_argument("--corrupt-debug", action="store_true")
    ap.add_argument("--no-slot-evict", action="store_true")
    ap.add_argument("--sel-impl", default=None, choices=("chol", "lowrank"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tracker-seed", type=int, default=0)
    ap.add_argument("--no-fused-schur", action="store_true")
    a = ap.parse_args()
    main(a.duration, a.width, a.height, out=a.out, dtype_str=a.dtype,
         kappa=a.kappa, accum=a.accum, host_control=a.host_control,
         corrupt_at=a.corrupt_at, laps=a.laps,
         corrupt_debug=a.corrupt_debug, slot_evict=not a.no_slot_evict,
         sel_impl=a.sel_impl, device=a.device, tracker_seed=a.tracker_seed,
         fused_schur=False if a.no_fused_schur else None)
