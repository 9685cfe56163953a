"""Runner of the rolling-shutter streaming cells: `vio_stream`'s loop over
`models/estimator_device.vio_step` with the camera-IMU time offset td
estimated online and the rolling shutter compensated in every projection
factor (`WindowConfig.estimate_td`, `tr_over_row`, `row_fy`, `row_c0`, set
from the configuration's VINS-Mono keys).

Set-up simulates the traffic's stream from the seed with a real rolling
shutter and a true offset (`traffic.rolling_shutter`), moves it to the card
in one copy per field, starts the estimator from the trajectory's own first
state (`vio_init_oracle` on the first NF−1 frames, td at the source's 0)
and runs the warm-up frames. The window and `frame_ms`,
`frame_ms_p80` and `setup_s` are `vio_stream`'s.

The check is `vio_stream`'s, step by step from the program's own state
against the float64 reference (`reference/estimator_device`) with the
program's picks: `prior_rgap_p75`, and `db_mismatch`, `admit_diff` and
`fail_frames` exact; and `td_gap_s`, the largest gap between the td the
program returned and the td of the reference's step over the compared
frames. Read and not compared: the td the program holds against the true
offset (`td_error_s`), the window positions, the start's positions, the
cost's gap, the gate's shortfall.

`--control tf32` / `f32` as in `vio_stream`. `--fault no_rs` leaves the
row shift out of the program's window (`tr_over_row` 0), `--fault td_held`
holds td in the program's window (`estimate_td` off); the reference keeps
the configuration's. `vio_stream`'s own faults pass through.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import convert, trace
from benchmark.harness import Check, HostWatch, RunResult, note, stage
from benchmark.reference import anticipation as ref_ant
from benchmark.reference import estimator_device as ref_ed
from benchmark.reference import window as ref_window
from benchmark.runners.vio_stream import (DTYPES, REF_TYPES, _faulty,
                                          _inserted, _prior_info, _sync)
from benchmark.traffic import rolling_shutter, stream, trajectories

# faults planted in the program's window configuration only
WINDOW_FAULTS = {"no_rs": dict(tr_over_row=0.0),
                 "td_held": dict(estimate_td=False)}
# the td instances' launch counters (none at a port without them)
TD_COUNTERS = ("normal_eq_fused_td", "lm_cost_fused_td")


def _params(ed, ant, window_mod, cfg, fault=None):
    wcfg = window_mod.WindowConfig(
        window=cfg["WINDOW_SIZE"], max_feats=cfg["max_feats"],
        iters=cfg["max_num_iterations"], fused_schur=cfg["fused_schur"],
        estimate_td=cfg["estimate_td"], tr_over_row=cfg["tr_over_row"],
        row_fy=cfg["row_fy"], row_c0=cfg["row_c0"])
    wcfg = wcfg._replace(**WINDOW_FAULTS.get(fault, {}))
    return ed.DeviceVioParams(
        wcfg=wcfg,
        sel_cfg=ant.SelectorConfig(max_features=cfg["max_features"],
                                   horizon=cfg["HORIZON"]),
        sel_n_imu=cfg["sel_n_imu"], sel_dt_imu=cfg["sel_dt_imu"],
        min_parallax=cfg["keyframe_parallax"] / cfg["focal_px"],
        sel_impl=cfg["sel_impl"])


def _program(cell, device):
    """(params, step, init) of the program, or of the control (as
    `vio_stream._program`)."""
    if cell.control in ("tf32", "f32"):
        torch.backends.cuda.matmul.allow_tf32 = cell.control == "tf32"
        ed, ant, window_mod = ref_ed, ref_ant, ref_window
    elif cell.control is not None:
        raise ValueError(f"unknown control {cell.control!r}")
    else:
        from anticipated_vins_mono_torch.models import anticipation as ant
        from anticipated_vins_mono_torch.models import estimator_device as ed
        from anticipated_vins_mono_torch.ops import window as window_mod
    pr = _params(ed, ant, window_mod, cell.config, cell.fault)

    def step(st, frame):
        return ed.vio_step(pr, st, *frame, device=device)

    def init(first, frames):
        return ed.vio_init_oracle(pr, first, frames, device=device)
    return pr, step, init


def simulator(traj, cfg, tr, seed):
    """The traffic's rolling-shutter stream: the rig's field of view from
    the configuration's intrinsics, its pixel noise in the rig's pixels."""
    rs = tr["rolling_shutter"]
    return rolling_shutter.RollingShutterSimulator(
        traj, seed=seed, max_features=cfg["max_cnt"],
        n_landmarks=tr["n_landmarks"],
        # the simulator's noise is in pixels of a 460 px focal length
        pixel_noise=tr["pixel_noise_px"] * 460.0 / cfg["fx"],
        fov_x=cfg["cx"] / cfg["fx"], fov_y=cfg["cy"] / cfg["fy"],
        cam_td=rs["cam_td_s"], readout=rs["readout_s"], rows=rs["rows"],
        fy=cfg["fy"], cy=cfg["cy"])


def run(cell) -> RunResult:
    cfg, tr = cell.config, cell.traffic
    device = torch.device(cell.device)
    dtype = DTYPES[cfg["dtype"]]
    nf = cfg["WINDOW_SIZE"] + 1

    # -- set-up: the stream from the seed, on the card; the start; warm-up
    traj = trajectories.trajectory(tr["trajectory"])
    sim = simulator(traj, cfg, tr, cell.seed)
    packed = stream.pack_stream(list(sim.frames()), cfg["max_cnt"])
    T = packed.ids.shape[0]
    stage(cell.t0, "stream made")
    on_card = [torch.from_numpy(x).to(device) if x.dtype.kind in "ib"
               else torch.from_numpy(x).to(device=device, dtype=dtype)
               for x in packed]
    frame = lambda t: tuple(x[t] for x in on_card)
    _sync(device)
    stage(cell.t0, "stream on the device")
    fault = None if cell.fault in WINDOW_FAULTS else cell.fault
    pr, step, init = _program(cell, device)
    step = _faulty(step, fault, nf)
    first = {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}
    st = st0 = init(first, [frame(t) for t in range(nf - 1)])
    _sync(device)
    stage(cell.t0, "program imported, started")
    t = nf - 1
    for _ in range(tr["warmup_frames"]):
        st, _ = step(st, frame(t))
        t += 1
    _sync(device)
    setup_s = time.monotonic() - cell.t0
    note(f"set-up {setup_s:.3f} s: stream of {T} frames, "
         f"{tr['warmup_frames']} warm-up frames")

    # -- the window
    hk = None
    if device.type == "cuda" and cell.control is None:
        from anticipated_vins_mono_torch.ops import hopper_kernels as hk
    n_trace = tr["trace_frames"] if cell.trace else 0
    prof = trace.profiler(n_trace) if n_trace else None
    counts0 = counts = None
    states, outs, lat, first_t = [st], [], [], t
    if prof is not None:
        prof.start()
    watch = HostWatch()
    t_start = time.monotonic()
    while t < T:
        ts = time.monotonic()
        i = t - first_t
        if prof is not None and i <= n_trace:
            if i == 1 and hk is not None:
                counts0 = dict(hk.launch_counts)
            with torch.profiler.record_function("bench.frame"):
                st, out = step(st, frame(t))
                _sync(device)
            prof.step()
            if i == n_trace:
                prof.stop()
                counts = ({k: hk.launch_counts.get(k, 0) - counts0.get(k, 0)
                           for k in set(counts0) | set(TD_COUNTERS)}
                          if hk is not None else {})
        else:
            st, out = step(st, frame(t))
            _sync(device)
        lat.append(time.monotonic() - ts)
        watch.unit_done()
        states.append(st)
        outs.append(out)
        t += 1
        if time.monotonic() - t_start >= cell.seconds:
            break
    window_s = time.monotonic() - t_start
    watch.note("frames")
    n = len(lat)
    if t >= T:
        note(f"the stream ran out: {n} frames in {window_s:.3f} s")
    note(f"window {window_s:.3f} s: {n} frames, "
         f"{sum(bool(o['keyframe']) for o in outs)} keyframes")
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    tr_red = trace.Trace.from_profile(prof) if prof is not None else None
    counters = {"frames": 0}
    if tr_red is not None:
        counters = {"frames": tr_red.spans, "kernel_launches": counts}
        note(f"trace: {tr_red.spans} frames, {tr_red.launches} launch calls, "
             f"{len(tr_red.kernels)} kernels, window {tr_red.window_s:.6f} s,"
             f" busy {tr_red.busy_s:.6f} s; launch_counts delta {counts}")

    # -- the check
    torch.backends.cuda.matmul.allow_tf32 = False
    fails = sum(bool(o["fail"]) for o in outs)
    rng = np.random.default_rng([cell.seed % 2**63, 1])
    sample = sorted(rng.choice(n, size=min(tr["check_frames"], n),
                               replace=False).tolist())
    kept = {i: (states[i], states[i + 1], outs[i]) for i in sample}
    td_last = float(states[-1].td)
    del states, outs, st
    rpr = _params(ref_ed, ref_ant, ref_window, cfg)
    f64 = torch.float64
    to_ref = lambda tree: convert.retype(tree, REF_TYPES,
                                         convert.floats_to(f64, device))
    ref_frame = lambda t: to_ref(frame(t))

    # the start, by itself
    rst0 = ref_ed.vio_init_oracle(rpr, first, [ref_frame(t) for t in
                                               range(nf - 1)], device=device)
    start_gap = float(torch.linalg.norm(st0.p.to(f64) - rst0.p, dim=-1).max())
    db_mis = int((st0.ids != rst0.ids).sum()) \
        + int((st0.mask.to(f64) != rst0.mask).sum())
    pose_gap = cost_rgap = td_gap = 0.0
    prior_gaps, sel_gaps = [], []
    admit_diff = 0
    for i in sample:
        s_in, s_out, out = kept[i]
        fr = ref_frame(first_t + i)
        r_in = to_ref(s_in)
        picks = _inserted(r_in, to_ref(s_out), fr)
        r_out, r_o = ref_ed.vio_step(rpr, r_in, *fr, device=device,
                                     picks=picks)
        gap = float(torch.linalg.norm(s_out.p.to(f64) - r_out.p,
                                      dim=-1).max())
        tg = abs(float(s_out.td) - float(r_out.td))
        H_p, H_r = _prior_info(s_out.prior), _prior_info(r_out.prior)
        rg = float(torch.linalg.norm(H_p - H_r) /
                   torch.clamp(torch.linalg.norm(H_r), min=1e-300))
        mis = int((s_out.ids != r_out.ids).sum()) \
            + int((s_out.mask.to(f64) != r_out.mask).sum()) \
            + int(bool(out["keyframe"]) != bool(r_o["keyframe"]))
        # the selection by itself: the reference's own float64 step, and the
        # gate's objective at the program's picks against the reference's
        own, _ = ref_ed.vio_step(rpr, r_in, *fr, device=device)
        ref_picks = _inserted(r_in, own, fr)
        d = abs(int(picks.sum()) - int(ref_picks.sum()))
        (f_ref, f_prog), f_0 = ref_ed.gate_objective(
            rpr, r_in, *fr, torch.stack([ref_picks, picks]))
        gain = float(f_ref - f_0)
        short = float((f_ref - f_prog) / (f_ref - f_0)) if gain > 1e-9 \
            else None
        note(f"frame {first_t + i}: pose gap {gap:.3e} m, td gap {tg:.3e} s "
             f"(program {float(s_out.td):.6e} s), prior {rg:.3e}, "
             f"db mismatches {mis}, admitted {int(picks.sum())} (reference "
             f"{int(ref_picks.sum())}), shortfall "
             f"{'none' if short is None else f'{short:.3e}'}, "
             f"keyframe {bool(out['keyframe'])}")
        cg = float(abs(out["cost"].to(f64) - r_o["cost"]) / r_o["cost"])
        pose_gap = max(pose_gap, gap)
        td_gap = max(td_gap, tg)
        prior_gaps.append(rg)
        if short is not None:
            sel_gaps.append(short)
        cost_rgap = max(cost_rgap, cg)
        db_mis += mis
        admit_diff += d
    q = lambda x, p: float(np.quantile(x, p)) if len(x) else 0.0
    readings = {"prior_rgap_median": q(prior_gaps, 0.5),
                "prior_rgap_p75": q(prior_gaps, 0.75),
                "prior_rgap_max": q(prior_gaps, 1.0),
                "td_gap_s": td_gap,
                "td_error_s": abs(td_last - tr["rolling_shutter"]["cam_td_s"]),
                "gate_shortfall_max": q(sel_gaps, 1.0),
                "gate_frames": len(sel_gaps),
                "pose_gap_m": pose_gap, "cost_rgap": cost_rgap,
                "start_gap_m": start_gap}
    note(f"readings {readings}")
    checks = [Check(k, v, tr["limits"][k]) for k, v in readings.items()
              if k in tr["limits"]] + [
              Check("db_mismatch", db_mis, 0),
              Check("admit_diff", admit_diff, 0),
              Check("fail_frames", fails, 0)]
    return RunResult(
        attempted=n, failed=fails,
        e2e={"frame_ms": window_s / n * 1e3,
             "frame_ms_p80": float(np.percentile(lat, 80)) * 1e3,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=mem, trace=tr_red,
        counters=counters)
