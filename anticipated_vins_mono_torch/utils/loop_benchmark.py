"""End-to-end loop-closure benchmark: drifting VIO around a rendered
multi-lap circuit, with and without the pose-graph feedback loop.

Counterpart of `anticipated_vins_mono_tpu/utils/loop_benchmark.py`. The
same noisy measurement stream is run twice — raw VIO (vins_result_no_loop
analog) vs VIO + `LoopClosureNode` (detectLoop → findConnection →
setReloFrame relocalization → 4-DoF PGO → drift-corrected output =
vins_result_loop analog) — and both ATEs are reported. Landmarks are
grounded at rendered-texture corners (detect → backproject to the walls), so
the simulator's feature tracks and the keyframe imagery's BRIEF descriptors
refer to the same physical wall points.

Where the two differ: `device` (where the renderer, the estimator's batched
numerics and the node run; default the card) and `dtype` (the estimator's
state type; float32 on the card takes the fused Schur kernel), and
`vio_pass=False` skips the raw-VIO pass (its readings are then NaN);
`window` / `max_feats` shrink the window for tests (10 and 192 by default).

    python3 -m anticipated_vins_mono_torch.utils.loop_benchmark \
        --duration 30 --dtype float32
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from anticipated_vins_mono_torch.models import frontend as fe
from anticipated_vins_mono_torch.models import posegraph as pg
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.models.initialization import _lie
from anticipated_vins_mono_torch.models.loop_node import LoopClosureNode
from anticipated_vins_mono_torch.ops import cameras, lie
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import render
from anticipated_vins_mono_torch.utils.metrics import ate_rmse, write_tum
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
from anticipated_vins_mono_torch.utils.synthetic import loop_trajectory


def grounded_landmarks(world, cam, rays, traj, R_all, n_views: int = 24,
                       per_view: int = 120, min_sep: float = 0.12,
                       lap_frac: float = 0.34) -> np.ndarray:
    """Detect corners in rendered views along (one lap of) the circuit and
    backproject them onto the walls → landmark field at visual anchors."""
    n = int(len(traj.t) * lap_frac)
    ks = np.linspace(0, n - 1, n_views).astype(int)
    pts, grid = [], set()
    inv = 1.0 / min_sep
    for k in ks:
        img = render.render_frame(world, cam, rays, traj.p[k], R_all[k])
        uv, _s, valid = fe.detect_features(img, torch.zeros_like(img),
                                           per_view, min_dist=10)
        uv = uv[valid].cpu().numpy()
        X = render.backproject(world, cam, uv, traj.p[k], R_all[k])
        for x in X:
            key = tuple((x * inv).astype(int))
            if key not in grid:
                grid.add(key)
                pts.append(x)
    return np.stack(pts)


def loop_scene(duration: float, laps: float, radius: float, width: int,
               height: int, seed: int, wiggle: float, wiggle_freq: float,
               n_interior: int, device):
    """The benchmark's world on `device`: (cam, traj, world, rays, R_all,
    landmarks) — grounded wall landmarks plus `n_interior` interior points
    (seed + 13), as the JAX package draws them."""
    fx = 0.6 * width
    cam = cameras.PinholeCamera.create(fx, fx, width / 2.0, height / 2.0,
                                       width=width, height=height,
                                       device=device)
    traj = loop_trajectory(duration, laps=laps, radius=radius,
                           wiggle=wiggle, wiggle_freq=wiggle_freq)
    world = render.make_box_world(traj.p, margin=5.0, seed=seed,
                                  device=device)
    rays = render.camera_rays(cam)
    R_all = lie.quat_to_rot(torch.tensor(traj.q)).numpy()
    lms_wall = grounded_landmarks(world, cam, rays, traj, R_all)
    # interior structure: wall-only landmarks give every view a single
    # plane; the interior points feed the estimator only, the wall points
    # carry the loop-closure descriptor matching
    rng = np.random.default_rng(seed + 13)
    lo, hi = traj.p.min(0) - 4.0, traj.p.max(0) + 4.0
    lms = np.concatenate([lms_wall,
                          rng.uniform(lo, hi, size=(n_interior, 3))])
    return cam, traj, world, rays, R_all, lms


def run_loop_benchmark(duration: float = 90.0, laps: float | None = None,
                       radius: float = 3.0, width: int = 752,
                       height: int = 480, seed: int = 0,
                       pixel_noise: float = 0.5,
                       imu_acc_sigma: float = 0.25,
                       imu_gyr_sigma: float = 0.012,
                       imu_acc_bias: float = 0.06,
                       imu_gyr_bias: float = 0.004,
                       sim_hi: float | None = None,
                       max_features: int = 150,
                       out_prefix: str | None = None,
                       kf_stride: int = 2, verbose: bool = False,
                       n_corners: int = 300, min_loop_inliers: int = 25,
                       wiggle: float = 0.0, wiggle_freq: float = 3.0,
                       n_interior: int = 4000, device="cuda",
                       dtype=torch.float64, vio_pass: bool = True,
                       window: int = 10, max_feats: int = 192) -> dict:
    """Returns {'ate_vio':…, 'ate_loop':…, 'loops':…} (meters) and the rest
    of the JAX package's keys, plus `ate_path_vio` (the raw VIO poses of
    the keyframes `ate_loop_path` reads), `device`, `dtype`,
    `loop_pass_frames`,
    `solves` (the loop pass's window solves),
    `first_loop_frame` (the loop pass frame of the first accepted loop),
    `relo_after_first_loop_frame` (the frame whose solve first left a
    `relo_result`), `corrected_path_finite` and `node_ms_per_keyframe`.

    laps=None keeps one lap per 10 s."""
    if laps is None:
        laps = duration / 10.0
    device = torch.device(device)
    cam, traj, world, rays, R_all, lms = loop_scene(
        duration, laps, radius, width, height, seed, wiggle, wiggle_freq,
        n_interior, device)

    def make_sim():
        fx = 0.6 * width
        return SequenceSimulator(
            traj, seed=seed, landmarks=lms, pixel_noise=pixel_noise,
            max_features=max_features, depth_range=(0.5, 30.0),
            fov_x=(width / 2.0) / fx, fov_y=(height / 2.0) / fx,
            imu_acc_sigma=imu_acc_sigma, imu_gyr_sigma=imu_gyr_sigma,
            imu_acc_bias=imu_acc_bias, imu_gyr_bias=imu_gyr_bias)

    # extrinsics are exactly known here (identity) — pinned
    # (ESTIMATE_EXTRINSIC: 0, euroc_config.yaml:22)
    wcfg = WindowConfig(window=window, max_feats=max_feats, iters=8,
                        estimate_extrinsic=False,
                        fused_schur=dtype == torch.float32
                        and device.type == "cuda")

    if verbose:
        print(f"[loop_bench] {len(lms)} grounded landmarks", flush=True)

    # ---- pass 1: raw VIO (vins_result_no_loop)
    ate_vio = float("nan")
    if vio_pass:
        est = VioEstimator(wcfg, dtype=dtype, device=device)
        for i, fm in enumerate(make_sim().frames()):
            est.process_frame(fm)
            if verbose and i % 100 == 0:
                print(f"[loop_bench] vio pass frame {i}", flush=True)
        t_v = np.array([x[0] for x in est.trajectory])
        p_v = np.stack([x[1] for x in est.trajectory])
        q_v = np.stack([x[2] for x in est.trajectory])
        ate_vio = ate_rmse(t_v, p_v, traj.t, traj.p)

    # ---- pass 2: VIO + loop closure (vins_result_loop)
    est2 = VioEstimator(wcfg, dtype=dtype, device=device)
    node = LoopClosureNode(cam=cam, graph=pg.PoseGraph(device=device),
                           sim_hi=sim_hi, skip_cnt=kf_stride - 1,
                           n_corners=n_corners,
                           min_inliers=min_loop_inliers, device=device)
    out = []
    node_s = []
    first_loop_frame, relo_after_first = None, None
    for i, fm in enumerate(make_sim().frames()):
        if verbose and i % 100 == 0:
            print(f"[loop_bench] loop pass frame {i} "
                  f"(kfs={len(node.entries)} loops={len(node.loops)})",
                  flush=True)
        n_before = len(est2.trajectory)
        est2.process_frame(fm)
        if first_loop_frame is not None and relo_after_first is None \
                and est2.relo_result is not None:
            relo_after_first = i
        if len(est2.trajectory) < n_before:
            # estimator restarted its outputs (initialization or failure
            # reboot cleared the trajectory) — restart ours identically
            out = []
            n_before = 0
        if est2.last_keyframe is not None:
            k = int(round(fm.t * 200.0))
            k = min(k, len(traj.t) - 1)
            t0 = time.perf_counter()
            img = render.render_frame(world, cam, rays, traj.p[k], R_all[k])
            n_loops = len(node.loops)
            node.on_keyframe(img, est2.last_keyframe, est2)
            node_s.append(time.perf_counter() - t0)
            if first_loop_frame is None and len(node.loops) > n_loops:
                first_loop_frame = i
        for tt, pp, qq, _vv in est2.trajectory[n_before:]:
            pc, qc = node.correct_pose(pp, qq)
            out.append((tt, pc, qc))
    n_frames = i + 1
    t_l = np.array([x[0] for x in out])
    p_l = np.stack([x[1] for x in out])
    q_l = np.stack([x[2] for x in out])
    ate_loop = ate_rmse(t_l, p_l, traj.t, traj.p)
    # updatePath parity (pose_graph.cpp:561-575 + updatePath): the whole
    # corrected keyframe path, over the NEWEST keyframe's gauge-connected
    # sequence group only; `ate_path_vio` reads the same keyframes' raw VIO
    # poses, what the path would read had the PGO moved nothing
    g = node.graph
    t_g = np.array([e.t for e in node.entries])
    ate_path = ate_path_vio = float("nan")
    n_path = 0
    if g.n >= 8:
        anchored = {int(g.seq_id[g.n - 1])}
        for _ in range(pg.MAX_SEQUENCES):
            for e in range(int(g.n_loops)):
                si = int(g.seq_id[g.loop_i[e]])
                sj = int(g.seq_id[g.loop_j[e]])
                if si in anchored or sj in anchored:
                    anchored |= {si, sj}
        sel = np.array([int(s) in anchored for s in g.seq_id[: g.n]])
        n_path = int(sel.sum())
        if n_path >= 8:
            ate_path = ate_rmse(t_g[sel], g.pos[: g.n][sel],
                                traj.t, traj.p)
            p_vio = np.stack([e.p_vio for e in node.entries])
            ate_path_vio = ate_rmse(t_g[sel], p_vio[sel], traj.t, traj.p)

    if out_prefix:
        if vio_pass:
            write_tum(out_prefix + "_vio.tum", t_v, p_v, q_v)
        write_tum(out_prefix + "_loop.tum", t_l, p_l, q_l)
    # per-edge quality vs ground truth: the exact relative pose each
    # accepted loop should have measured
    edges = []
    kf_dump = []
    if g.n:
        for en in node.entries:
            ypr = _lie(lambda q: lie.rot_to_ypr(lie.quat_to_rot(q)), en.q_vio)
            kf_dump.append({"t": round(float(en.t), 4),
                            "p": [round(float(x), 5) for x in en.p_vio],
                            "ypr": [round(float(x), 4) for x in ypr]})
        t_kf = np.array([e.t for e in node.entries])
        gt_p = np.stack([np.interp(t_kf, traj.t, traj.p[:, i])
                         for i in range(3)], -1)
        ks = np.clip(np.round(t_kf * 200.0).astype(int), 0, len(traj.t) - 1)
        gt_ypr = _lie(lie.rot_to_ypr, R_all[ks])
        for e in range(int(g.n_loops)):
            i, j = int(g.loop_i[e]), int(g.loop_j[e])
            # full rotation of keyframe i — the edge convention
            R_i = _lie(lie.ypr_to_rot, gt_ypr[i])
            t_gt = R_i.T @ (gt_p[j] - gt_p[i])
            dyaw_gt = gt_ypr[j, 0] - gt_ypr[i, 0]
            dyaw_gt = (dyaw_gt + 180.0) % 360.0 - 180.0
            dyaw_err = (float(g.loop_yaw[e]) - dyaw_gt + 180.0) % 360.0 - 180.0
            row = {
                "i": i, "j": j, "gap": j - i,
                "t_meas": [round(float(x), 4) for x in g.loop_t[e]],
                "t_gt": [round(float(x), 4) for x in t_gt],
                "t_err_m": round(float(np.linalg.norm(g.loop_t[e] - t_gt)), 4),
                "yaw_err_deg": round(dyaw_err, 3),
            }
            if e < len(node.loops):   # same insertion order as loop edges
                row.update({k: node.loops[e][k]
                            for k in ("inliers", "rms", "weight")
                            if k in node.loops[e]})
            edges.append(row)
    return {
        "benchmark": "loop_closure_runtime",
        "duration_s": duration, "laps": laps,
        "landmarks": int(len(lms)),
        "keyframes": len(node.entries),
        "loops_accepted": len(node.loops),
        "ate_vio": float(ate_vio), "ate_loop": float(ate_loop),
        "ate_loop_path": float(ate_path),
        "ate_path_vio": float(ate_path_vio),
        "path_keyframes": n_path,
        "improvement": float(ate_vio / max(ate_loop, 1e-9)),
        "improvement_path": float(ate_vio / max(ate_path, 1e-9)),
        "vio_failures": est2.diag.failures,
        "solves": est2.diag.solves,
        "funnel": dict(node.stats),
        "edges": edges,
        "keyframes_vio": kf_dump,
        "device": str(device), "dtype": str(dtype).split(".")[-1],
        "loop_pass_frames": n_frames,
        "first_loop_frame": first_loop_frame,
        "relo_after_first_loop_frame": relo_after_first,
        "corrected_path_finite": bool(np.isfinite(p_l).all()
                                      and np.isfinite(g.pos[: g.n]).all()),
        # render + node per keyframe the node saw (host clock)
        "node_ms_per_keyframe": float(np.median(node_s) * 1e3)
        if node_s else float("nan"),
    }


def main(argv=None) -> dict:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--laps", type=float, default=None)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-prefix", default=None)
    # drift-regime knobs: scale the IMU noise/bias walk
    ap.add_argument("--imu-noise-scale", type=float, default=1.0)
    ap.add_argument("--gyr-scale", type=float, default=1.0)
    ap.add_argument("--acc-scale", type=float, default=1.0)
    ap.add_argument("--pixel-noise", type=float, default=0.5)
    ap.add_argument("--max-features", type=int, default=150)
    ap.add_argument("--radius", type=float, default=3.0)
    ap.add_argument("--wiggle", type=float, default=0.0)
    ap.add_argument("--wiggle-freq", type=float, default=3.0)
    ap.add_argument("--n-interior", type=int, default=4000)
    ap.add_argument("--n-corners", type=int, default=300)
    ap.add_argument("--min-loop-inliers", type=int, default=25)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    a = ap.parse_args(argv)
    s = a.imu_noise_scale
    sa, sg = s * a.acc_scale, s * a.gyr_scale
    row = run_loop_benchmark(
        a.duration, a.laps, radius=a.radius,
        width=a.width, height=a.height, seed=a.seed,
        pixel_noise=a.pixel_noise,
        imu_acc_sigma=0.25 * sa, imu_gyr_sigma=0.012 * sg,
        imu_acc_bias=0.06 * sa, imu_gyr_bias=0.004 * sg,
        max_features=a.max_features,
        n_corners=a.n_corners, min_loop_inliers=a.min_loop_inliers,
        wiggle=a.wiggle, wiggle_freq=a.wiggle_freq,
        n_interior=a.n_interior,
        out_prefix=a.out_prefix, verbose=a.verbose, device=a.device,
        dtype=getattr(torch, a.dtype))
    row["imu_noise_scale"] = s
    row["radius"] = a.radius
    row["wiggle"] = a.wiggle
    row["gyr_scale"] = a.gyr_scale
    row["acc_scale"] = a.acc_scale
    row["pixel_noise"] = a.pixel_noise
    row["max_features"] = a.max_features
    print(json.dumps(row))
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(row, f, indent=1)
    return row


if __name__ == "__main__":
    main()
