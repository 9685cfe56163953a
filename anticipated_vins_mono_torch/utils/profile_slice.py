"""Where the time of the main path goes, stage by stage, on one GPU.

    python3 -m anticipated_vins_mono_torch.utils.profile_slice [--reps 3]

Times each stage of the selector (horizon, Ω, Δ_ℓ, greedy) and of one LM
iteration (projection rows, IMU rows, normal equations, cost pass, Schur
solve, retraction) at the reference deployment's full size, float32, with a
host clock around work that ends in `torch.cuda.synchronize()`, and reads the
device's busy share over one solve and one selection from `torch.profiler`.
Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models.feature_selector import device_select
from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.utils.synthetic import (
    batched, make_window_problem, selector_inputs)


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds of `fn()` including the device work it queued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_busy(fn) -> dict:
    """Wall time of `fn()` and the sum of its kernels' device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_us, n_kernels = 0.0, 0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0:
            busy_us += dev
            n_kernels += ev.count
    return {"wall_ms_under_profiler": wall, "device_busy_ms": busy_us / 1e3,
            "device_events": n_kernels,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall if wall else None}


def profile_selector(prob, cfg, reps: int) -> dict:
    dev = torch.device("cuda")
    scfg = ant.SelectorConfig()
    _, a = selector_inputs(prob, cfg)
    p, q, v, acc, gyr, ba, bg, tic, qic, pts, probs, valid = a[:12]
    with torch.no_grad():
        ps, qs, _ = ant.imu_horizon(p, q, v, acc, gyr, ba, bg,
                                    scfg.horizon, 20, 0.005)
        p_wc = ps + lie.quat_rotate(qs, tic.expand_as(ps))
        q_wc = lie.quat_mul(qs, qic.expand_as(qs))
        Omega = ant.add_omega_prior(ant.omega_from_motion(qs, 20, 0.005, scfg))
        depth = torch.full((cfg.max_feats,), 5.0, device=dev)
        Deltas, nvis = ant.delta_ell(pts, depth, p_wc, q_wc, scfg)
        out = {
            "imu_horizon_ms": host_ms(lambda: ant.imu_horizon(
                p, q, v, acc, gyr, ba, bg, scfg.horizon, 20, 0.005), reps),
            "omega_from_motion_ms": host_ms(
                lambda: ant.omega_from_motion(qs, 20, 0.005, scfg), reps),
            "delta_ell_x2_ms": 2 * host_ms(
                lambda: ant.delta_ell(pts, depth, p_wc, q_wc, scfg), reps),
            "greedy_chol_ms": host_ms(lambda: ant.select_informative(
                Omega, Deltas, probs, valid, 30, impl="chol"), reps),
            "greedy_lowrank_ms": host_ms(lambda: ant.select_informative(
                Omega, Deltas, probs, valid, 30, impl="lowrank"), reps),
        }
    whole = lambda: device_select(scfg, 30, 20, 0.005, *a, impl="chol")
    out["device_select_chol_ms"] = host_ms(whole, reps)
    out["device_select_chol_profile"] = device_busy(whole)
    return out


def profile_solver(prob, cfg, B: int, reps: int) -> dict:
    st, ms = batched(prob.init, B), batched(prob.meas, B)
    ref = (st.p[..., 0, :], st.q[..., 0, :])
    off = cfg._replace(fused_schur=False)
    with torch.no_grad():
        H, g, H_lp, h_ll, g_l = win.normal_equations_fast(st, ms, cfg, ref)
        lam = torch.full((B,), 1e-4, device="cuda")
        dx, d_rho, _ = hk.schur_solve_fused(H, g, H_lp, h_ll, g_l, lam)
        out = {
            "proj_rows_ms": host_ms(
                lambda: win._proj_factor_rows(st, ms, cfg), reps),
            "imu_rows_ms": host_ms(
                lambda: win._imu_factor_rows(st, ms, cfg), reps),
            "normal_equations_fast_ms": host_ms(
                lambda: win.normal_equations_fast(st, ms, cfg, ref), reps),
            "robust_cost_ms": host_ms(
                lambda: win.robust_cost(st, ms, cfg, ref), reps),
            "schur_fused_ms": host_ms(
                lambda: hk.schur_solve_fused(H, g, H_lp, h_ll, g_l, lam), reps),
            "schur_f64_ms": host_ms(
                lambda: win.schur_solve(H, g, H_lp, h_ll, g_l, lam, off), reps),
            "retract_ms": host_ms(
                lambda: win.retract(st, dx, d_rho, cfg), reps),
        }
    fused = lambda: win.lm_solve(st, ms, cfg)
    out["lm_solve_fused_ms"] = host_ms(fused, reps)
    out["lm_solve_f64_schur_ms"] = host_ms(
        lambda: win.lm_solve(st, ms, off), reps)
    out["lm_solve_fused_profile"] = device_busy(fused)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = win.WindowConfig(window=10, max_feats=128, iters=8, fused_schur=True)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               dtype=torch.float32)
    hk.build_kernels()
    print(json.dumps({
        "card": smi, "torch": torch.__version__, "reps": args.reps,
        "selector": profile_selector(prob, cfg, args.reps),
        "solver_B1": profile_solver(prob, cfg, 1, args.reps),
        "solver_B64": profile_solver(prob, cfg, 64, args.reps),
    }, indent=1))


if __name__ == "__main__":
    main()
