"""EuRoC benchmark runner — the reference's headline experiment, automated.

Counterpart of `anticipated_vins_mono_tpu/utils/benchmark.py`. Reproduces
the experimental grid of the fork's report (results.tex):
{sequence} × {anticipate | quality | random} × feature budget κ ∈ {10, 30},
reporting ATE RMSE and RTE, writing evo-compatible TUM trajectories, as one
function over the GT-derived replay pipeline.

Realism knobs that make the policy comparison meaningful (the fork's core
claim is anticipate > quality > random):
- per-landmark tracking quality → the prob channel + stochastic track loss
  (the reference's GFTT-score channel)
- the real EuRoC camera-IMU extrinsic (euroc_config.yaml) in both the
  simulator and the estimator
- optional ground-truth horizon mode (use_ground_truth_hgen)

Where it differs from the JAX runner: `device` (the card unless the caller
passes "cpu"; pool workers too), `accum="df32"` takes the f64 path, and the
JAX package's `jaxenv` pinning is a few lines of its own here (a pool
worker is pinned to one core with one torch thread). The ground truth comes
from `euroc.REFERENCE_GT_DIR`.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from anticipated_vins_mono_torch.models.anticipation import SelectorConfig
from anticipated_vins_mono_torch.models.estimator import VioEstimator
from anticipated_vins_mono_torch.models.feature_selector import AttentionSelector
from anticipated_vins_mono_torch.models.pipeline import run_sequence
from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import euroc
from anticipated_vins_mono_torch.utils.config import EstimatorConfig
from anticipated_vins_mono_torch.utils.metrics import write_tum
from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
from anticipated_vins_mono_torch.utils.timing import TicToc


def euroc_extrinsics():
    """The real EuRoC cam-IMU transform (euroc_config.yaml:26-38) as
    (tic [3], qic [4] wxyz), float64 numpy."""
    e = EstimatorConfig()
    ric = lie.ypr_to_rot(torch.tensor(e.ric_ypr, dtype=torch.float64))
    return np.asarray(e.tic, float), lie.rot_to_quat(ric).numpy()


def make_gt_provider(traj, horizon: int, frame_dt: float = 0.1):
    """GT-horizon provider (use_ground_truth_hgen parity,
    horizon_generator.cpp:73-123): interpolate GT poses at the horizon frame
    times t, t+dt, …, t+H·dt. Returns None past the end of GT."""
    t_gt = np.asarray(traj.t)
    p_gt = np.asarray(traj.p)
    q_gt = np.asarray(traj.q)

    def provider(t: float):
        ts = t + frame_dt * np.arange(horizon + 1)
        if ts[-1] > t_gt[-1]:
            return None
        idx = np.searchsorted(t_gt, ts)
        idx = np.clip(idx, 1, len(t_gt) - 1)
        w = (ts - t_gt[idx - 1]) / np.maximum(t_gt[idx] - t_gt[idx - 1], 1e-9)
        p = p_gt[idx - 1] * (1 - w[:, None]) + p_gt[idx] * w[:, None]
        # nearest-neighbor orientation (GT is 200 Hz; slerp unnecessary)
        q = q_gt[np.where(w > 0.5, idx, idx - 1)]
        return p, q

    return provider


def run_one(sequence: str, policy: Optional[str] = "anticipate",
            kappa: int = 30, max_seconds: Optional[float] = 60.0,
            detect_count: int = 150, pixel_noise: float = 0.5,
            track_loss_rate: float = 0.0, n_landmarks: int = 8000,
            quality_beta: tuple = (5.0, 2.0),
            quality_noise_scale: float = 0.0, slip_rate: float = 0.0,
            slip_px: float = 2.5, degrade_after: float = 0.0,
            real_extrinsics: bool = False, hgen: str = "imu",
            cam_td: float = 0.0, estimate_td: bool = False,
            clean_velocity: bool = False,
            prob_weight: bool = False,
            survival_weighting: bool = False,
            validity_aware: bool = False,
            out_dir: Optional[str] = None, seed: int = 0,
            dtype: str = "f64", accum: str = None,
            device="cuda") -> dict:
    """One (sequence, policy, κ) cell. policy=None disables selection
    (all detected features go to the backend). max_seconds=None runs the
    full GT length. hgen: "imu" | "gt" horizon mode. cam_td injects a true
    camera-IMU time offset; estimate_td turns on its online estimation
    (yaml:73, projection_td_factor parity). `device`: where the selector
    and the estimator's batched numerics run (the card by default)."""
    traj = euroc.load_sequence(sequence, max_seconds=max_seconds)
    tic = qic = None
    if real_extrinsics:
        tic, qic = euroc_extrinsics()
    sim = SequenceSimulator(traj, seed=seed, pixel_noise=pixel_noise,
                            max_features=detect_count,
                            n_landmarks=n_landmarks,
                            track_loss_rate=track_loss_rate,
                            quality_beta=tuple(quality_beta),
                            quality_noise_scale=quality_noise_scale,
                            slip_rate=slip_rate, slip_px=slip_px,
                            degrade_after=degrade_after,
                            cam_td=cam_td,
                            clean_velocity=clean_velocity,
                            tic=tic, qic=qic)
    # accum: accumulation precision for the solver's delicate steps. The
    # JAX package's "df32" (double-float emulation for a chip without f64)
    # takes the genuine f64 path here (WindowConfig.accum)
    if accum is None:
        accum = "df32" if dtype == "f32" else "f64"
    wcfg = WindowConfig(window=10, max_feats=192, iters=8,
                        estimate_td=estimate_td, accum=accum)
    sel = None
    if policy is not None:
        # init_threshold=30 matches the reference euroc config
        # (euroc_config.yaml:85): below 30 tracked features pre-init the
        # whole image passes through — starving the initializer with a 0
        # threshold destabilizes the difficult sequences
        scfg = SelectorConfig(horizon=10, max_features=kappa,
                              init_threshold=30,
                              survival_weighting=survival_weighting)
        gt_provider = None
        if hgen == "gt":
            gt_provider = make_gt_provider(traj, scfg.horizon)
        sel = AttentionSelector(scfg, max_candidates=detect_count,
                                policy=policy, seed=seed,
                                tic=tic, qic=qic, gt_provider=gt_provider,
                                validity_aware=validity_aware,
                                device=device)
    est = VioEstimator(wcfg, selector=sel, tic=tic, qic=qic,
                       prob_weight=prob_weight,
                       dtype=torch.float32 if dtype == "f32" else torch.float64,
                       device=device)
    with TicToc(f"{sequence}:{policy}") as t:
        res = run_sequence(est, sim)
    row = {
        "sequence": sequence, "policy": policy or "all", "kappa": kappa,
        "dtype": dtype, "accum": accum,
        "hgen": hgen, "seed": seed,
        "track_loss_rate": track_loss_rate,
        "real_extrinsics": bool(real_extrinsics),
        "ate_rmse": res.ate,
        "rte_rmse": res.rte_stats["rmse"],
        "rte_median": res.rte_stats["median"],
        "frames": len(res.est_t),
        "failures": res.diag.failures,
        "initialized": bool(est.initialized),
        "wall_s": round(t.toc(), 1),
    }
    if estimate_td or cam_td:
        row["cam_td"] = cam_td
        row["td_est"] = float(est.td)
        row["clean_velocity"] = bool(clean_velocity)
    if quality_noise_scale or slip_rate:
        row["quality_noise_scale"] = quality_noise_scale
        row["slip_rate"] = slip_rate
        row["degrade_after"] = degrade_after
    if survival_weighting:
        row["survival_weighting"] = True
    if validity_aware and sel is not None:
        row["validity_aware"] = True
        row["fallback_frames"] = sel.diag_fallback
        row["mis_median"] = (float(np.median(sel.diag_mis))
                             if sel.diag_mis else None)
        row["mis_p90"] = (float(np.percentile(sel.diag_mis, 90))
                          if sel.diag_mis else None)
    if prob_weight:
        row["prob_weight"] = True
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_tum(os.path.join(out_dir, f"{sequence}_{policy}_k{kappa}.tum"),
                  res.est_t, res.est_p, res.est_q)
    return row


def _pin_pool_worker() -> None:
    """In a pool worker: pin the process to its own core and give torch
    one thread — unpinned, N workers × nproc threads thrash a small host
    (the JAX package measured ~10×: 75 min a cell against ~8)."""
    import multiprocessing as mp
    proc = mp.current_process()
    if proc.name == "MainProcess" or not getattr(proc, "_identity", None):
        return
    try:
        core = (proc._identity[0] - 1) % (os.cpu_count() or 1)
        os.sched_setaffinity(0, {core})
    except (AttributeError, OSError):
        pass
    torch.set_num_threads(1)


def _run_cell(kwargs):
    """Pool entry: one cell, on the device `kwargs` names (the card by
    default)."""
    _pin_pool_worker()
    row = run_one(**kwargs)
    print(json.dumps(row), flush=True)
    return row


def run_benchmark(sequences: Optional[Iterable[str]] = None,
                  policies=("anticipate", "quality", "random"),
                  kappas=(30,), max_seconds: Optional[float] = 60.0,
                  track_loss_rate: float = 0.0,
                  real_extrinsics: bool = False, hgen: str = "imu",
                  seeds=(0,), n_workers: int = 1,
                  out_dir: Optional[str] = None, **kw) -> list:
    """The full grid; returns list of result rows. n_workers>1 forks
    processes (cells are independent); `device` goes to every cell through
    `kw`."""
    sequences = list(sequences or euroc.available_sequences())
    cells = [dict(sequence=seq, policy=pol, kappa=kap, seed=seed,
                  max_seconds=max_seconds, track_loss_rate=track_loss_rate,
                  real_extrinsics=real_extrinsics, hgen=hgen,
                  out_dir=out_dir, **kw)
             for seq in sequences for kap in kappas for pol in policies
             for seed in seeds]
    if n_workers <= 1:
        rows = []
        for c in cells:
            rows.append(_run_cell(c))
        return rows
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_workers) as pool:
        rows = pool.map(_run_cell, cells)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--policies", nargs="*",
                    default=["anticipate", "quality", "random"])
    ap.add_argument("--kappas", nargs="*", type=int, default=[30])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--full-length", action="store_true")
    ap.add_argument("--track-loss", type=float, default=0.0)
    ap.add_argument("--quality-noise-scale", type=float, default=0.0)
    ap.add_argument("--slip-rate", type=float, default=0.0)
    ap.add_argument("--slip-px", type=float, default=2.5)
    ap.add_argument("--degrade-after", type=float, default=0.0)
    ap.add_argument("--survival", action="store_true")
    ap.add_argument("--validity-aware", action="store_true")
    ap.add_argument("--quality-beta", nargs=2, type=float,
                    default=[5.0, 2.0])
    ap.add_argument("--real-extrinsics", action="store_true")
    ap.add_argument("--hgen", default="imu", choices=["imu", "gt"])
    ap.add_argument("--seeds", nargs="*", type=int, default=[0])
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--cam-td", type=float, default=0.0)
    ap.add_argument("--estimate-td", action="store_true")
    ap.add_argument("--clean-velocity", action="store_true")
    ap.add_argument("--prob-weight", action="store_true")
    ap.add_argument("--out", default=None, help="directory for TUM files")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    # CLI spelling of the no-selection policy (grid "no budget" column)
    policies = [None if p in ("None", "none", "all") else p
                for p in args.policies]
    rows = run_benchmark(
        args.sequences, policies, kappas=args.kappas,
        max_seconds=None if args.full_length else args.seconds,
        track_loss_rate=args.track_loss,
        quality_noise_scale=args.quality_noise_scale,
        slip_rate=args.slip_rate, slip_px=args.slip_px,
        degrade_after=args.degrade_after,
        quality_beta=tuple(args.quality_beta),
        real_extrinsics=args.real_extrinsics, hgen=args.hgen,
        cam_td=args.cam_td, estimate_td=args.estimate_td,
        clean_velocity=args.clean_velocity,
        prob_weight=args.prob_weight,
        survival_weighting=args.survival,
        validity_aware=args.validity_aware,
        seeds=args.seeds, n_workers=args.workers, out_dir=args.out,
        device=args.device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
