"""Full-fidelity benchmark: pixels in → trajectory out.

Counterpart of `anticipated_vins_mono_tpu/utils/image_benchmark.py`. The
reference's evaluation runs camera images through FeatureTracker::process
at 752×480 / 10 Hz before the selector and backend see a measurement. This
runner replicates that path end-to-end: a textured world rendered along the
EuRoC GT trajectory through the real (distorted) EuRoC cam0 model → tiled
CLAHE → pyramidal LK → F-RANSAC → GFTT top-up (models.frontend) → optional
attention selector → sliding-window estimator → ATE/RTE vs GT, with
per-stage wall times (reference baselines: tracker 18 ms, selector 9 ms,
solver 30 ms per frame, results.tex).

Where it differs from the JAX runner: everything runs on `device`, the card
unless the caller passes "cpu" (the JAX `__main__` forces CPU f64; here the
estimator's dtype is the default float64 on the card).
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from anticipated_vins_mono_torch.models import frontend as fe
from anticipated_vins_mono_torch.models.anticipation import SelectorConfig
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.models.feature_selector import AttentionSelector
from anticipated_vins_mono_torch.models.pipeline import run_from_images
from anticipated_vins_mono_torch.ops import cameras, lie
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import euroc, render
from anticipated_vins_mono_torch.utils.benchmark import euroc_extrinsics
from anticipated_vins_mono_torch.utils.metrics import write_tum


class _TimedTracker:
    """Wraps FeatureTracker.process with wall-clock accounting."""

    def __init__(self, tracker):
        self.tracker = tracker
        self.times = []

    def process(self, img, t):
        t0 = time.perf_counter()
        out = self.tracker.process(img, t)
        self.times.append(time.perf_counter() - t0)
        return out


def _frame_stream(world, cam, rays, traj, R_ic, tic, stride, total,
                  render_times):
    """Generator of rendered frames at the camera poses."""
    R_all = lie.quat_to_rot(torch.as_tensor(np.asarray(traj.q))).numpy()
    for f in range(total):
        k = f * stride
        t0 = time.perf_counter()
        R_wb, p_wb = R_all[k], traj.p[k]
        p_wc = p_wb + R_wb @ tic
        R_wc = R_wb @ R_ic
        img = render.render_frame(world, cam, rays, p_wc, R_wc)
        render_times.append(time.perf_counter() - t0)
        yield img


def run_image_benchmark(sequence: str = "MH_05_difficult",
                        max_seconds: Optional[float] = 45.0,
                        policy: Optional[str] = None, kappa: int = 30,
                        max_features: int = 150,
                        frame_hz: float = 10.0, seed: int = 0,
                        levels: int = 4,
                        out_tum: Optional[str] = None,
                        device="cuda") -> dict:
    """One image-in run over `sequence`'s ground truth (module docstring);
    the renderer, tracker, selector and the estimator's batched numerics run
    on `device` (the card by default)."""
    traj = euroc.load_sequence(sequence, max_seconds=max_seconds)
    tic, qic = euroc_extrinsics()
    R_ic = lie.quat_to_rot(torch.as_tensor(qic)).numpy()
    cam = cameras.euroc_camera(device=device)
    world = render.make_box_world(traj.p, seed=seed, device=device)
    rays = render.camera_rays(cam)

    stride = int(round(200.0 / frame_hz))
    total = (len(traj.t) - 1) // stride
    frame_times = traj.t[np.arange(total) * stride]

    tracker = _TimedTracker(fe.FeatureTracker(cam, fe.TrackerParams(
        max_features=max_features, min_dist=30, levels=levels)))

    sel = None
    if policy is not None:
        scfg = SelectorConfig(horizon=10, max_features=kappa,
                              init_threshold=30)
        sel = AttentionSelector(scfg, max_candidates=max_features,
                                policy=policy, seed=seed, tic=tic, qic=qic,
                                device=device)
    est = VioEstimator(WindowConfig(window=10, max_feats=192, iters=8),
                       selector=sel, tic=tic, qic=qic, device=device)

    render_times: list = []
    stream = _frame_stream(world, cam, rays, traj, R_ic, tic, stride,
                           total, render_times)
    t0 = time.perf_counter()
    res = run_from_images(est, tracker, stream, frame_times,
                          traj.t, traj.acc_body, traj.gyr_body, gt=traj)
    wall = time.perf_counter() - t0

    tr = np.array(tracker.times[5:]) if len(tracker.times) > 5 else \
        np.array(tracker.times)
    row = {
        "benchmark": "image_pipeline",
        "sequence": sequence, "policy": policy or "all", "kappa": kappa,
        "frames": len(res.est_t),
        "ate_rmse": res.ate,
        "rte_rmse": res.rte_stats["rmse"],
        "rte_median": res.rte_stats["median"],
        "failures": res.diag.failures,
        "initialized": bool(est.initialized),
        "tracker_ms_mean": float(tr.mean() * 1e3) if len(tr) else None,
        "tracker_ms_p50": float(np.median(tr) * 1e3) if len(tr) else None,
        "selector_ms_p50": float(np.median(res.diag.sel_s[5:]) * 1e3)
        if len(res.diag.sel_s) > 5 else None,
        "solver_ms_p50": float(np.median(res.diag.solve_s[5:]) * 1e3)
        if len(res.diag.solve_s) > 5 else None,
        "render_ms_mean": float(np.mean(render_times[5:]) * 1e3),
        "wall_s": round(wall, 1),
    }
    if out_tum:
        write_tum(out_tum, res.est_t, res.est_p, res.est_q)
    return row


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", default="MH_05_difficult")
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--kappa", type=int, default=30)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--out-tum", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    row = run_image_benchmark(args.sequence, args.seconds, args.policy,
                              args.kappa, levels=args.levels,
                              out_tum=args.out_tum, device=args.device)
    print(json.dumps(row))
