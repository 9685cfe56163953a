"""Where the time of the main paths goes, stage by stage, on one GPU.

    python3 -m anticipated_vins_mono_torch.utils.profile_slice [--reps 3]

Times each stage of the selector (horizon, Ω, Δ_ℓ, greedy); splits whole
LM solves into their phases (normal equations, Schur solve, cost and
accept) and whole frames of the estimator (`vio_step`: propagate, gate, DB
insert, triangulate, measurements, solve, demote, marginalization) into
their stages, from the program's own spans (`utils/timing.span`) recorded
under `torch.profiler`: per stage its host time, the card's busy time
inside it and the host synchronisations counted in it; and times one frame
of the host estimator chain
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
`torch.profiler` (the union of the card's kernel, copy and set intervals
over the call).
Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
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
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.utils import deployment as dep
from anticipated_vins_mono_torch.utils import timing
from anticipated_vins_mono_torch.utils.synthetic import (
    analytic_trajectory, batched, make_window_problem, selector_inputs)


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds of `fn()` including the device work it queued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# host calls that wait for the card (a synchronous device-to-host copy is a
# `cudaMemcpyAsync` followed by `cudaStreamSynchronize`)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _profiler():
    """A profiler of the card's activity and the host's CUDA calls (the
    host's operators only where there is no card): recording each host
    operator as well slows the host-bound step by about two thirds (on an
    H100, a frame of the benchmark's `moving` cell: 1,987 ms, against
    1,273 ms with this profiler and 1,201 ms with none), and the spans
    would time the profiler."""
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    return profile(activities=[ProfilerActivity.CUDA if card
                               else ProfilerActivity.CPU])


def _on_device(e) -> bool:
    """Whether a profiler event is work the card ran: a kernel, a copy or a
    set (not a range the host annotated)."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in ("kernel", "gpu_memcpy", "gpu_memset")
    annotated = e.is_user_annotation() if hasattr(
        e, "is_user_annotation") else False
    return str(e.device_type()).endswith("CUDA") and not annotated


class _Busy:
    """The union of the card's work intervals in a profile, as disjoint
    sorted intervals; `within(lo, hi)` is the time it covers in [lo, hi]
    (ns on the profiler's clock)."""

    def __init__(self, events):
        merged = []
        for a, b in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                           for e in events if _on_device(e)):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.lo = [a for a, _ in merged]
        self.iv = merged

    def within(self, lo: int, hi: int) -> int:
        i = max(bisect.bisect_right(self.lo, lo) - 1, 0)
        got = 0
        for a, b in self.iv[i:]:
            if a >= hi:
                break
            got += max(0, min(b, hi) - max(a, lo))
        return got


def device_busy(fn) -> dict:
    """Host time of `fn()` to its synchronised end under the profiler and the
    card's busy time over it: the union of its kernel, copy and set
    intervals inside the call."""
    fn()
    _sync()
    with _profiler() as prof:
        t0 = time.time_ns()
        fn()
        _sync()
        t1 = time.time_ns()
    events = list(prof.profiler.kineto_results.events())
    busy = _Busy(events).within(t0, t1)
    wall = t1 - t0
    return {"wall_ms_under_profiler": wall * 1e-6,
            "device_busy_ms": busy * 1e-6,
            "device_events": sum(1 for e in events if _on_device(e)),
            "device_idle_share": 1.0 - busy / wall if wall else None}


def span_split(fn, reps: int, top: str) -> dict:
    """Where `reps` calls of `fn()` go, from the spans the program records
    in them under the profiler (`utils/timing.span`; `top` is the name of
    the call's outermost span): `split_of` over them."""
    fn()
    _sync()
    timing.reset_recorded()
    with _profiler() as prof:
        for _ in range(reps):
            fn()
            _sync()
    out = split_of(timing.recorded(), prof, top)
    timing.reset_recorded()
    return out


def split_of(spans: list, prof, top: str) -> dict:
    """The split of recorded `spans` (`timing.recorded()`) whose outermost
    spans are named `top`, over the events of the profile `prof` that
    recorded them. Per span name, per call, each span with what nests in
    it: `host_ms`; `device_busy_ms`, the card's busy time inside the spans;
    `syncs`, the host synchronisations the program's counter saw;
    `profiler_syncs`, the host calls that wait for the card as the profiler
    saw them (`SYNC_CALLS`); `launches`, the host's kernel and graph launch
    calls; `spans`, how many ran. Beside: the share of the outermost spans
    that no child span covers (`uncovered_share`) and the counted syncs
    per call by the line that made them (`sync_sites`)."""
    events = list(prof.profiler.kineto_results.events())
    busy = _Busy(events)
    stamps = lambda names: sorted(  # noqa: E731
        e.start_ns() for e in events if e.name() in names)
    waits, launches = stamps(SYNC_CALLS), stamps(LAUNCH_CALLS)
    inside = lambda xs, sp: (  # noqa: E731
        bisect.bisect_left(xs, sp.end_ns)
        - bisect.bisect_left(xs, sp.start_ns))
    # the counter's syncs of each span with those of the spans in it
    syncs = {sp.id: sp.syncs for sp in spans}
    for sp in reversed(spans):
        if sp.parent is not None:
            syncs[sp.parent] += syncs[sp.id]
    outer = [sp for sp in spans if sp.parent is None and sp.name == top]
    n = len(outer)
    total = defaultdict(lambda: [0, 0, 0, 0, 0, 0])
    for sp in spans:
        row = total[sp.name]
        for i, x in enumerate((
                sp.end_ns - sp.start_ns, busy.within(sp.start_ns, sp.end_ns),
                syncs[sp.id], inside(waits, sp), inside(launches, sp), 1)):
            row[i] += x
    split = {name: {"host_ms": t * 1e-6 / n, "device_busy_ms": b * 1e-6 / n,
                    "syncs": k / n, "profiler_syncs": w / n,
                    "launches": la / n, "spans": c / n}
             for name, (t, b, k, w, la, c) in total.items()}
    ids = {sp.id for sp in outer}
    child = sum(sp.end_ns - sp.start_ns for sp in spans if sp.parent in ids)
    whole = sum(sp.end_ns - sp.start_ns for sp in outer)
    return {"calls": n, "split": split,
            "uncovered_share": 1.0 - child / whole if whole else None,
            "sync_sites": {site: c / n
                           for site, c in timing.sync_sites().items()}}


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
    """Whole batched solves of B copies of the problem: host ms on both
    routes of the linear solve, and the fused route's split into its phases
    from the spans, and the card's busy share over one solve."""
    st, ms = batched(prob.init, B), batched(prob.meas, B)
    off = cfg._replace(fused_schur=False)
    fused = lambda: win.lm_solve(st, ms, cfg)
    return {"lm_solve_fused_ms": host_ms(fused, reps),
            "lm_solve_f64_schur_ms": host_ms(
                lambda: win.lm_solve(st, ms, off), reps),
            "lm_solve_fused_phases": span_split(fused, reps, "lm.solve"),
            "lm_solve_fused_profile": device_busy(fused)}


def vio_step_stages(pr, st, pk, reps: int) -> dict:
    """`reps` whole `vio_step`s from state `st` on the frame inputs `pk`
    (ids, rays, velocities, probabilities, active, the padded IMU), split
    into their stages by the step's spans (`span_split`), its host time
    without the profiler, and the card's busy share over one step."""
    whole = lambda: ed.vio_step(pr, st, *pk)
    with torch.no_grad():
        _, out = whole()
    return {"keyframe": bool(out["keyframe"]),
            "vio_step_ms": host_ms(whole, reps),
            "stages": span_split(whole, reps, "vio.step"),
            "vio_step_profile": device_busy(whole)}


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
