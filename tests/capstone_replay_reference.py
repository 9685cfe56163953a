"""The capstone runner's device step, the port against the JAX package, on
the same tracker stream, on the CPU in float64: how far one step and a free
run part.

    python tests/capstone_replay_reference.py --width 376 --height 240 \
        --seed 0 --duration 8

The JAX package runs `device_vio_bench`'s protocol (the box-world circuit,
pinhole fx = 0.6·W, 150 tracker slots, the host warm-up on its device
tracker, `vio_init_from_host`, κ̄ = 30 "chol", window 10 with 128 slots) and
steps its `vio_step` frame by frame. At every frame the port's `vio_step`
runs twice on the JAX tracker's measurements: once from the JAX state
(one-step parity: the window's positions, the slot ids, and the prior's
information J0ᵀJ0 and J0ᵀr0 the step leaves), and once carrying its own
state from the hand-off on (a free run, compared by the position error of
each frame against the ground truth). One line per frame.

The port's `torch.linalg.eigh` on the CPU (MKL) does not converge on some of
these marginalization matrices (ROADMAP queue C 6); here it goes through
numpy's LAPACK instead. A script, not a test (pytest collects `test_*.py`
only): a run takes minutes.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from anticipated_vins_mono_tpu.utils.jaxenv import force_cpu_f64  # noqa: E402

force_cpu_f64(threads=int(os.environ.get("REF_THREADS", "2")))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(int(os.environ.get("REF_THREADS", "2")))


def eigh_lapack(A, UPLO="L"):
    w, V = np.linalg.eigh(A.detach().cpu().numpy(), UPLO=UPLO)
    return torch.return_types.linalg_eigh(
        (torch.from_numpy(w).to(A.dtype), torch.from_numpy(V).to(A.dtype)))


def information(prior):
    """(J0ᵀJ0, J0ᵀr0) of a prior factor, numpy."""
    J0, r0 = np.asarray(prior.J0), np.asarray(prior.r0)
    return J0.T @ J0, J0.T @ r0


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def run(width: int, height: int, seed: int, duration: float) -> None:
    from anticipated_vins_mono_tpu.models import anticipation as jant
    from anticipated_vins_mono_tpu.models import estimator_device as jed
    from anticipated_vins_mono_tpu.models import tracker_device as jtd
    from anticipated_vins_mono_tpu.models.estimator import VioEstimator
    from anticipated_vins_mono_tpu.ops import cameras, lie
    from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
    from anticipated_vins_mono_tpu.utils import render
    from anticipated_vins_mono_tpu.utils.sequence import FrameMeasurement
    from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
    from anticipated_vins_mono_torch.models import anticipation as tant
    from anticipated_vins_mono_torch.models import estimator_device as ted
    from anticipated_vins_mono_torch.ops.window import WindowConfig as TCfg
    from anticipated_vins_mono_torch.utils import convert

    torch.linalg.eigh = eigh_lapack
    f64 = jnp.float64
    fx = 0.6 * width
    cam = cameras.PinholeCamera.create(fx, fx, width / 2, height / 2,
                                       width=width, height=height)
    traj = loop_trajectory(duration, laps=duration / 10.0, radius=3.0)
    world = render.make_box_world(traj.p, margin=5.0, seed=0)
    rays = render.camera_rays(cam)
    R_all = np.asarray(lie.quat_to_rot(jnp.asarray(traj.q)))
    n_total = (len(traj.t) - 1) // 20
    ks = np.arange(n_total) * 20
    imgs = np.stack([render.render_frame(world, cam, rays, traj.p[k],
                                         R_all[k]) for k in ks])
    ts = traj.t[ks]
    S = jed.MAX_IMU_PER_PAIR
    imu = [np.zeros((n_total, S)), np.zeros((n_total, S, 3)),
           np.zeros((n_total, S, 3)), np.zeros((n_total, 3)),
           np.zeros((n_total, 3))]
    for f in range(1, n_total):
        s, k = ks[f - 1], ks[f]
        imu[0][f, :k - s] = np.diff(traj.t[s:k + 1])
        imu[1][f, :k - s] = traj.acc_body[s + 1:k + 1]
        imu[2][f, :k - s] = traj.gyr_body[s + 1:k + 1]
        imu[3][f], imu[4][f] = traj.acc_body[s], traj.gyr_body[s]

    wcfg = JCfg(window=10, max_feats=128, iters=8, accum="f64")
    tparams = jtd.TrackerDeviceParams(max_features=150)
    tracker = jtd.DeviceFeatureTracker(cam, tparams, seed=seed)
    est = VioEstimator(wcfg, dtype=f64, init_state={
        "p": traj.p[0], "q": traj.q[0], "v": traj.v[0]})
    f = 0
    while not (est.initialized and est.n_frames == wcfg.nf - 1):
        n = np.count_nonzero(imu[0][f])
        est.process_frame(FrameMeasurement(
            t=float(ts[f]), feats=tracker.process(imgs[f], float(ts[f])),
            imu_dts=imu[0][f, :n], imu_acc=imu[1][f, :n],
            imu_gyr=imu[2][f, :n], acc0=imu[3][f], gyr0=imu[4][f]))
        f += 1
    jst = jed.vio_init_from_host(est)
    jpr = jed.DeviceVioParams(
        wcfg=wcfg, sel_cfg=jant.SelectorConfig(max_features=30))
    tpr = ted.DeviceVioParams(
        wcfg=TCfg(window=10, max_feats=128, iters=8, accum="f64"),
        sel_cfg=tant.SelectorConfig(max_features=30), sel_impl="chol")
    tree = lambda x: jax.tree_util.tree_map(np.array, x)
    free = convert.device_vio_state_from_numpy(tree(jst), "cpu")
    tst = tracker.state
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    for g in range(f, n_total):
        tst, meas = jtd.tracker_step(cam, tparams, tst,
                                     jnp.asarray(imgs[g], jnp.float32),
                                     float(ts[g]))
        frame_imu = [x[g] for x in imu]
        from_jax = convert.device_vio_state_from_numpy(tree(jst), "cpu")
        jst, jout = jed.vio_step(jpr, jst, *meas,
                                 *(jnp.asarray(x, f64) for x in frame_imu))
        ids, rays_, vel, prob, active = (torch.from_numpy(np.array(m))
                                         for m in meas)
        port_in = [ids, rays_.double(), vel.double(), prob.double(), active,
                   *(T(x) for x in frame_imu)]
        one, _ = ted.vio_step(tpr, from_jax, *port_in, device="cpu")
        free, fout = ted.vio_step(tpr, free, *port_in, device="cpu")
        (I_t, b_t), (I_j, b_j) = information(one.prior), information(
            jst.prior)
        k = int(round(ts[g] * 200))
        print("STEP " + json.dumps({
            "seed": seed, "frame": g,
            "one_step_dp_m": float(np.abs(one.p.numpy()
                                          - np.asarray(jst.p)).max()),
            "one_step_ids_equal": bool(np.array_equal(
                one.ids.numpy(), np.asarray(jst.ids))),
            "one_step_prior_info_rel": max(rel(I_t, I_j), rel(b_t, b_j)),
            "free_ids_equal": bool(np.array_equal(free.ids.numpy(),
                                                  np.asarray(jst.ids))),
            "jax_err_m": float(np.linalg.norm(np.asarray(jout["p"])
                                              - traj.p[k])),
            "free_err_m": float(np.linalg.norm(fout["p"].numpy()
                                               - traj.p[k]))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--width", type=int, default=376)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=8.0)
    a = ap.parse_args()
    run(a.width, a.height, a.seed, a.duration)


if __name__ == "__main__":
    main()
