"""Where the time of the main paths goes, stage by stage, on one GPU.

    python3 -m anticipated_vins_mono_torch.utils.profile_slice [--reps 3]

Times each stage of the selector (horizon, Ω, Δ_ℓ, greedy), of one LM
iteration (projection rows, IMU rows, normal equations, cost pass, Schur
solve, retraction) and of one whole frame of the estimator (`vio_step`:
propagate, gate, DB insert, triangulate, measurements, solve, demote, both
marginalizations, both slides) and of one frame of the host estimator chain
(`VioEstimator.process_frame` with the `AttentionSelector`: selector,
preintegration, triangulation, solve, marginalization and the numpy
bookkeeping around them) and of one frame of the image path (render, CLAHE
+ pyramid, LK, RANSAC, occupancy + detection, packaging, the node's
alignment and `process_frame`) and of the JAX package's runners (the
same `vio_step` split on the capstone runner's frame, with its 150-slot
device tracker; the loop pass's `process_frame` and the loop node's stages)
at the reference deployment's full size
(`utils/deployment.py`), float32, with a host clock around work that ends in
`torch.cuda.synchronize()`, and reads the device's busy share over one
solve, one selection, one frame and one tracker step from
`torch.profiler`.
Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import types
from collections import defaultdict

import torch

from anticipated_vins_mono_torch.models import anticipation as ant
from anticipated_vins_mono_torch.models import estimator as hest
from anticipated_vins_mono_torch.models import estimator_device as ed
from anticipated_vins_mono_torch.models.feature_selector import device_select
from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.ops import marginalization as mg
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.ops.triangulation import triangulate
from anticipated_vins_mono_torch.utils import deployment as dep
from anticipated_vins_mono_torch.utils.synthetic import (
    analytic_trajectory, batched, make_window_problem, selector_inputs)
from anticipated_vins_mono_torch.utils.tree import tree_map


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
                                    scfg.horizon, dep.N_IMU, dep.DT_IMU)
        p_wc = ps + lie.quat_rotate(qs, tic.expand_as(ps))
        q_wc = lie.quat_mul(qs, qic.expand_as(qs))
        Omega = ant.add_omega_prior(
            ant.omega_from_motion(qs, dep.N_IMU, dep.DT_IMU, scfg))
        depth = torch.full((cfg.max_feats,), 5.0, device=dev)
        Deltas, nvis = ant.delta_ell(pts, depth, p_wc, q_wc, scfg)
        out = {
            "imu_horizon_ms": host_ms(lambda: ant.imu_horizon(
                p, q, v, acc, gyr, ba, bg, scfg.horizon, dep.N_IMU,
                dep.DT_IMU), reps),
            "omega_from_motion_ms": host_ms(
                lambda: ant.omega_from_motion(qs, dep.N_IMU, dep.DT_IMU,
                                              scfg), reps),
            "delta_ell_x2_ms": 2 * host_ms(
                lambda: ant.delta_ell(pts, depth, p_wc, q_wc, scfg), reps),
            "greedy_chol_ms": host_ms(lambda: ant.select_informative(
                Omega, Deltas, probs, valid, dep.KAPPA, impl="chol"), reps),
            "greedy_lowrank_ms": host_ms(lambda: ant.select_informative(
                Omega, Deltas, probs, valid, dep.KAPPA, impl="lowrank"), reps),
        }
    whole = lambda: device_select(scfg, dep.KAPPA, dep.N_IMU, dep.DT_IMU, *a,
                                  impl="chol")
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


def vio_step_stages(pr, st, pk, reps: int) -> dict:
    """Per-stage host times of one `vio_step` from state `st` on the frame
    inputs `pk` (ids, rays, velocities, probabilities, active, the padded
    IMU), each stage on the inputs the step would hand it; both
    marginalizations and both slides are timed on the same state, whichever
    the frame would take."""
    cfg = pr.wcfg
    k = cfg.nf - 1
    ids, pts, vel, prob, active, dts, acc, gyr, acc0, gyr0 = pk
    with torch.no_grad():
        entered = ed._enter_frame(pr, st, k, dts, acc, gyr, acc0, gyr0)
        gated, _ = ed._select_stage(pr, entered, k, *pk[:8])
        added, keyframe, _ = ed._db_add_frame(entered, k, ids, pts, vel, prob,
                                              gated, pr.min_parallax)
        fv = ed._feat_valid(added)
        wstate = ed._window_state(added, cfg)
        meas = ed._measurements(added, pr, fv * added.solved)
        one = lambda tree: tree_map(lambda x: x[None], tree)
        W = cfg.window
        out = {
            # which marginalization the profiled `vio_step` below takes
            "keyframe": bool(keyframe),
            "propagate_ms": host_ms(lambda: ed._propagate(
                st.p[k - 1], st.q[k - 1], st.v[k - 1], st.ba[k - 1],
                st.bg[k - 1], dts, acc, gyr, acc0, gyr0), reps),
            "enter_frame_ms": host_ms(lambda: ed._enter_frame(
                pr, st, k, dts, acc, gyr, acc0, gyr0), reps),
            "select_stage_ms": host_ms(lambda: ed._select_stage(
                pr, entered, k, *pk[:8]), reps),
            "db_add_frame_ms": host_ms(lambda: ed._db_add_frame(
                entered, k, ids, pts, vel, prob, gated, pr.min_parallax),
                reps),
            "triangulate_ms": host_ms(lambda: triangulate(
                wstate, added.pts, added.mask, ed._anchor(added), cfg), reps),
            "measurements_ms": host_ms(lambda: ed._measurements(
                added, pr, fv * added.solved), reps),
            "lm_solve_ms": host_ms(lambda: win.lm_solve(
                one(wstate), one(meas), cfg), reps),
            "demote_outliers_ms": host_ms(lambda: ed._demote_outliers(
                added, pr), reps),
            "marginalize_oldest_ms": host_ms(lambda: mg.marginalize_oldest(
                wstate, meas._replace(feat_valid=fv), cfg), reps),
            "marginalize_second_newest_ms": host_ms(
                lambda: mg.marginalize_second_newest(wstate, added.prior, cfg),
                reps),
            "margin_old_whole_ms": host_ms(lambda: ed._margin_old(pr, added),
                                           reps),
            "margin_second_whole_ms": host_ms(
                lambda: ed._margin_second(pr, added), reps),
            "slide_oldest_db_ms": host_ms(lambda: ed._slide_oldest_db(
                added, cfg), reps),
            "merge_pair_buffers_ms": host_ms(lambda: ed._merge_pair_buffers(
                added.imu_dts[W - 2], added.imu_acc[W - 2],
                added.imu_gyr[W - 2], added.imu_dts[W - 1],
                added.imu_acc[W - 1], added.imu_gyr[W - 1]), reps),
        }
    whole = lambda: ed.vio_step(pr, st, *pk)
    out["vio_step_ms"] = host_ms(whole, reps)
    out["vio_step_profile"] = device_busy(whole)
    return out


def profile_frame(reps: int, warm_frames: int = 15) -> dict:
    """`vio_step_stages` on a steady state of the simulated sequence: the
    state after `warm_frames` frames (prior built) and the next frame."""
    pr = dep.vio_params(fused_schur=True)
    k = pr.wcfg.nf - 1
    traj = analytic_trajectory((pr.wcfg.nf + warm_frames + 2) / 10.0)
    _, packed = dep.vio_sequence(traj, torch.float32)
    st = dep.vio_start(pr, traj, packed)
    for pk in packed[k:k + warm_frames]:
        st, out = ed.vio_step(pr, st, *pk)
    return {"tracked": float(out["tracked"]), "n_solved": int(out["n_solved"]),
            **vio_step_stages(pr, st, packed[k + warm_frames], reps)}


def profile_capstone(reps: int, warm_frames: int = 15) -> dict:
    """`vio_step_stages` on the capstone runner's frame
    (`utils/device_vio_bench`: the circuit rendered at 752×480, the
    150-slot device tracker, the host warm-up and hand-off, κ̄ = 30 "chol",
    float32, both kernels): the state after `warm_frames` device frames and
    the tracker's next measurement; the tracker step's own time beside."""
    from anticipated_vins_mono_torch.models import tracker_device as td
    from anticipated_vins_mono_torch.utils import device_vio_bench as dvb
    f32 = torch.float32
    cam, traj, imgs, ts, imu = dvb.render_circuit(4.0, 752, 480, None,
                                                  "cuda")
    wcfg = win.WindowConfig(window=10, max_feats=128, iters=8,
                            fused_schur=True)
    tparams = td.TrackerDeviceParams(max_features=150)
    tracker = td.DeviceFeatureTracker(cam, tparams)
    est = hest.VioEstimator(wcfg, dtype=f32, device="cuda", init_state={
        "p": traj.p[0], "q": traj.q[0], "v": traj.v[0]})
    f = dvb.warm_up(est, tracker, imgs, ts, imu, 0, 10)
    pr = ed.DeviceVioParams(wcfg=wcfg,
                            sel_cfg=ant.SelectorConfig(max_features=30),
                            sel_impl="chol")
    (tst, st), outs, _ = dvb.run_device(
        cam, tparams, pr, tracker.state, ed.vio_init_from_host(est), imgs,
        ts, imu, f, f + warm_frames, f32)
    g = f + warm_frames
    step = lambda: td.tracker_step(cam, tparams, tst, imgs[g], float(ts[g]))
    _, (ids, rays, vel, prob, active) = step()
    pk = (ids, rays, vel, prob, active) + tuple(
        torch.tensor(x[g], dtype=f32, device="cuda") for x in imu)
    return {"tracker_step_ms": host_ms(step, reps),
            "tracked_active": int(active.sum()),
            "n_solved": int((st.solved > 0).sum()),
            **vio_step_stages(pr, st, pk, reps)}


def profile_loop(duration: float = 13.0) -> dict:
    """Where a frame of the loop pass goes (`utils/loop_benchmark`'s second
    pass over `duration` s of the circuit, float32, the Schur kernel at
    F = 192): `process_frame`, and the node's stages at each keyframe it
    sees (render, corners + BRIEF, retrieval, verification, PGO), each
    between two synchronises; totals over the pass, and the node's share of
    the pass."""
    from anticipated_vins_mono_torch.models import loop_node as ln
    from anticipated_vins_mono_torch.models import posegraph as pg
    from anticipated_vins_mono_torch.utils import loop_benchmark as lb
    spent, calls = defaultdict(float), defaultdict(int)

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            calls[name] += 1
            return out
        return run

    patched = [(hest.VioEstimator, "process_frame"),
               (lb.render, "render_frame"),
               (ln.LoopClosureNode, "on_keyframe"),
               (ln.LoopClosureNode, "keyframe_features"),
               (ln.LoopClosureNode, "_detect_loop"),
               (ln.LoopClosureNode, "_verify"),
               (pg.PoseGraph, "optimize")]
    saved = [getattr(obj, name) for obj, name in patched]
    for obj, name in patched:
        setattr(obj, name, timed(name.lstrip("_"), getattr(obj, name)))
    try:
        t0 = time.perf_counter()
        run = lb.run_loop_benchmark(duration=duration, device="cuda",
                                    dtype=torch.float32, vio_pass=False)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for (obj, name), fn in zip(patched, saved):
            setattr(obj, name, fn)
    # one render per keyframe offered to the node; the renders before the
    # pass build the landmark field
    renders_in_pass = calls["on_keyframe"]
    render_ms = spent["render_frame"] / max(calls["render_frame"], 1)
    out = {f"{name}_total_ms": ms for name, ms in sorted(spent.items())}
    out.update({f"{name}_calls": n for name, n in sorted(calls.items())})
    out.update({
        "frames": run["loop_pass_frames"], "keyframes": run["keyframes"],
        "loops_accepted": run["loops_accepted"], "funnel": run["funnel"],
        "wall_ms": wall,
        "process_frame_ms_per_frame": spent["process_frame"] / max(
            calls["process_frame"], 1),
        "node_ms_per_keyframe": spent["on_keyframe"] / max(
            calls["on_keyframe"], 1),
        "render_ms_per_call": render_ms,
        "node_share_of_pass": (spent["on_keyframe"]
                               + render_ms * renders_in_pass)
        / (spent["process_frame"] + spent["on_keyframe"]
           + render_ms * renders_in_pass)})
    return out


def profile_host(frames: int = 10, warm_frames: int = 15) -> dict:
    """Per-stage host times of the host estimator chain: `VioEstimator`
    (float32, both kernels) with the `AttentionSelector` ("chol") in front,
    from the first ground-truth state, warmed for `warm_frames` frames past
    the first full window; then `frames` more frames with every stage wrapped
    in a timer that synchronises before and after it. "bookkeeping" is the
    rest of `process_frame`: the FeatureDB insert, the numpy propagation and
    outlier test, the reads back, the host-side quaternion arithmetic.
    `measurements_ms` includes `preintegrate_pairs_ms`."""
    from anticipated_vins_mono_torch.models.feature_selector import \
        AttentionSelector
    from anticipated_vins_mono_torch.utils.sequence import SequenceSimulator
    cfg = dep.window_config(fused_schur=True)
    n = cfg.nf - 1 + warm_frames + frames + 2
    traj = analytic_trajectory(n / 10.0 + 0.2)
    stream = SequenceSimulator(traj, seed=0, pixel_noise=0.3,
                               max_features=dep.N_INPUT).frames(n)
    sel = AttentionSelector(ant.SelectorConfig(max_features=dep.KAPPA),
                            max_candidates=dep.N_INPUT, impl="chol")
    est = hest.VioEstimator(cfg, dtype=torch.float32, selector=sel,
                            init_state={"p": traj.p[0], "q": traj.q[0],
                                        "v": traj.v[0]})
    for _ in range(cfg.nf - 1 + warm_frames):
        est.process_frame(next(stream))
    spent = defaultdict(float)

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    module = {"triangulate": hest.triangulate, "lm_solve": hest.lm_solve,
              "mg": hest.mg}
    hest.triangulate = timed("triangulate", hest.triangulate)
    hest.lm_solve = timed("lm_solve", hest.lm_solve)
    hest.mg = types.SimpleNamespace(
        marginalize_oldest=timed("marginalize_oldest",
                                 module["mg"].marginalize_oldest),
        marginalize_second_newest=timed("marginalize_second_newest",
                                        module["mg"].marginalize_second_newest))
    for name in ("_propagate", "_device_state", "_measurements",
                 "_preintegrate_pairs", "_reject_outliers", "_slide_oldest_db",
                 "_keyframe_snapshot"):
        setattr(est, name, timed(name.lstrip("_"), getattr(est, name)))
    sel.select = timed("select", sel.select)
    whole = []
    try:
        for _ in range(frames):
            fm = next(stream)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.process_frame(fm)
            torch.cuda.synchronize()
            whole.append((time.perf_counter() - t0) * 1e3)
    finally:
        hest.triangulate, hest.lm_solve, hest.mg = (
            module["triangulate"], module["lm_solve"], module["mg"])
    out = {f"{name}_ms": ms / frames for name, ms in sorted(spent.items())}
    out["process_frame_ms"] = sum(whole) / frames
    out["process_frame_min_max_ms"] = [min(whole), max(whole)]
    nested = ("preintegrate_pairs",)
    out["bookkeeping_ms"] = out["process_frame_ms"] - sum(
        ms for name, ms in spent.items() if name not in nested) / frames
    out["keyframe_fraction"] = est.diag.keyframes / max(est.diag.solves, 1)
    out["process_frame_profile"] = device_busy(
        lambda: est.process_frame(next(stream)))
    return out


def profile_image(frames: int = 10, warm_frames: int = 15) -> dict:
    """Per-stage host times of the image path (`utils/deployment.image_scene`
    at 752×480, the 128-slot device tracker, `VioNode` with the native
    aligner, `VioEstimator` in float32 with both kernels and the "chol"
    `AttentionSelector`, from the first ground-truth state): `warm_frames`
    frames past the first full window through the facades, then `frames`
    frames with the tracker's step taken apart into its stages (the step's
    own functions on its own inputs, each run once), each between two
    synchronises. `ransac_draws_ms` is the key's split and the RANSAC's
    uniforms (`utils/threefry`); `occupancy_detect_ms` is `_detect_free`
    (occupancy + detection); `packaging_ms` is `_refill` (slot
    bookkeeping, undistortion, velocity, probability); `node_ms` is
    `push_features` (alignment + `process_frame`)."""
    from anticipated_vins_mono_torch.models import frontend as fe
    from anticipated_vins_mono_torch.models import tracker_device as td
    from anticipated_vins_mono_torch.models.feature_selector import \
        AttentionSelector
    from anticipated_vins_mono_torch.models.node import VioNode
    from anticipated_vins_mono_torch.ops import cameras
    from anticipated_vins_mono_torch.utils import render, threefry
    traj, cam, world, rays, R_all, stride = dep.image_scene("cuda")
    tp = dep.tracker_params()
    tracker = td.DeviceFeatureTracker(cam, tp)
    sel = AttentionSelector(ant.SelectorConfig(max_features=dep.KAPPA),
                            max_candidates=dep.N_INPUT, impl="chol",
                            device="cuda")
    est = hest.VioEstimator(dep.window_config(True), dtype=torch.float32,
                            selector=sel, device="cuda", init_state={
                                "p": traj.p[0], "q": traj.q[0],
                                "v": traj.v[0]})
    node = VioNode(est)
    spent = defaultdict(float)

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        spent[name] += (time.perf_counter() - t0) * 1e3
        return out

    align = node.aligner.frame_batch
    node.aligner.frame_batch = lambda *a, **kw: timed("node_alignment",
                                                      align, *a, **kw)
    pf = est.process_frame
    est.process_frame = lambda fm: timed("process_frame", pf, fm)

    def frame(f, staged):
        k = f * stride
        for j in range(k - stride + 1 if f else 0, k + 1):
            node.push_imu(traj.t[j], traj.acc_body[j], traj.gyr_body[j])
        t = float(traj.t[k])
        img = timed("render", render.render_frame, world, cam, rays,
                    traj.p[k], R_all[k])
        st = tracker.state
        if not staged or st is None:
            feats = timed("tracker", tracker.process, img, t)
        else:
            eq, pyr = timed("prep", td._prep, img, tp.levels)
            new_pts, lk_ok = timed("lk_track", fe.lk_track, st.pyr, pyr,
                                   st.pts, st.active.float(),
                                   levels=tp.levels)
            key, k1 = timed("ransac_draws", threefry.split, st.key)
            u = timed("ransac_draws", td.ransac_uniforms, k1, tp.ransac_iters,
                      tp.max_features)
            st = st._replace(key=key)
            ok = timed("ransac", lambda: td.ransac_essential_mask(
                st.norm, cameras.lift_projective(cam, new_pts)[:, :2],
                lk_ok & st.active, u, thresh=tp.ransac_thresh_px / cam.fx))
            det = timed("occupancy_detect", td._detect_free, tp, eq,
                        new_pts, ok)
            tracker.state, meas = timed(
                "packaging", td._refill, cam, tp, st, pyr, new_pts, ok,
                torch.tensor(t, dtype=torch.float32, device="cuda"), det)
            ids, rays_, vel, prob, active = timed(
                "read_measurement", lambda: [m.cpu().numpy() for m in meas])
            feats = {int(i): (rays_[n], vel[n], float(prob[n]))
                     for n, i in enumerate(ids) if active[n]}
        timed("node", node.push_features, t, feats)

    warm = dep.WINDOW + warm_frames
    for f in range(warm):
        frame(f, staged=False)
    spent.clear()
    whole = []
    for f in range(warm, warm + frames):
        t0 = time.perf_counter()
        frame(f, staged=True)
        whole.append((time.perf_counter() - t0) * 1e3)
    out = {f"{name}_ms": ms / frames for name, ms in sorted(spent.items())}
    out["tracker_stages_ms"] = sum(out[f"{n}_ms"] for n in (
        "prep", "lk_track", "ransac_draws", "ransac", "occupancy_detect",
        "packaging", "read_measurement"))
    out["frame_ms"] = sum(whole) / frames
    out["frame_min_max_ms"] = [min(whole), max(whole)]
    out["active_slots"] = int(tracker.state.active.sum())
    k = (warm + frames) * stride
    img = render.render_frame(world, cam, rays, traj.p[k], R_all[k])
    out["tracker_step_profile"] = device_busy(lambda: td.tracker_step(
        cam, tp, tracker.state, img, float(traj.t[k])))
    out["render_profile"] = device_busy(lambda: render.render_frame(
        world, cam, rays, traj.p[k], R_all[k]))
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
    cfg = dep.window_config(fused_schur=True)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               dtype=torch.float32)
    hk.build_kernels()
    print(json.dumps({
        "card": smi, "torch": torch.__version__, "reps": args.reps,
        "selector": profile_selector(prob, cfg, args.reps),
        "solver_B1": profile_solver(prob, cfg, 1, args.reps),
        "solver_B64": profile_solver(prob, cfg, 64, args.reps),
        "frame": profile_frame(args.reps),
        "host": profile_host(),
        "image": profile_image(),
        "capstone": profile_capstone(args.reps),
        "loop": profile_loop(),
    }, indent=1))


if __name__ == "__main__":
    main()
