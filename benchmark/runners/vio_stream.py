"""Runner of the streaming cells: `models/estimator_device.vio_step`, one
robot, frame after frame in a closed loop (an offline replay of a bag at
full speed).

Set-up simulates the traffic's stream from the seed (`traffic.stream`),
moves it to the card in one copy per field, starts the estimator from the
trajectory's own first state (`vio_init_oracle` on the first NF−1 frames)
and runs the traffic's warm-up frames. The window then runs `vio_step`s
back to back, each from the packed frame on the card to the synchronised
output, until `--seconds` have passed or the stream ends: `frame_ms` is the
window time over the frames completed, `frame_ms_p80` the 80th percentile
of the frames' latencies.

The check follows the program step by step from its own state: for frames
drawn from the seed, the reference (`reference/estimator_device`, float64)
steps from the state the program was given, with the same frame, and with
the selection the program made (float32 cannot resolve the selector's
gains, so its picks are not the float64 greedy's; they are read from the
program's output as the candidates it inserted); it is compared with the
state the program returned: the marginalization prior's information
matrix J0ᵀJ0 (built at the solved state), its relative gap's 75th
percentile over the frames drawn (`prior_rgap_p75`), the feature DB's ids
and observation masks and the keyframe decision (`db_mismatch`, exact).
The selection is checked by itself as far as float32 allows: the
reference's own float64 step admits as many new features as the program
did (`admit_diff`, exact); the gate's float64 objective at the program's
picks against the reference greedy's (`gate_shortfall_max`), the window
positions (`pose_gap_m`) and the start's positions (`start_gap_m`) are
read and not compared: the control and planted faults read no further
from the reference there than the program does (see PERF.md). The start is
checked by itself: the reference's `vio_init_oracle` from the same frames,
its DB in `db_mismatch`. A frame whose fail flag is set is a failed frame
(`fail_frames`, exact).

`--control tf32` puts the reference in float32 with TF32 products in the
program's place (the control); `--control f32` in float32 with TF32 off,
a witness of what float32 itself does to the step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import convert, trace
from benchmark.harness import Check, HostWatch, RunResult, note, stage
from benchmark.reference import anticipation as ref_ant
from benchmark.reference import estimator_device as ref_ed
from benchmark.reference import preintegration as ref_pre
from benchmark.reference import window as ref_window
from benchmark.traffic import stream, trajectories

DTYPES = {"float32": torch.float32, "float64": torch.float64}
REF_TYPES = convert.types_of(ref_ed, ref_window, ref_pre, ref_ant)


def _params(ed, ant, window_mod, cfg):
    return ed.DeviceVioParams(
        wcfg=window_mod.WindowConfig(
            window=cfg["WINDOW_SIZE"], max_feats=cfg["max_feats"],
            iters=cfg["max_num_iterations"], fused_schur=cfg["fused_schur"]),
        sel_cfg=ant.SelectorConfig(max_features=cfg["max_features"],
                                   horizon=cfg["HORIZON"]),
        sel_n_imu=cfg["sel_n_imu"], sel_dt_imu=cfg["sel_dt_imu"],
        min_parallax=cfg["keyframe_parallax"] / cfg["focal_px"],
        sel_impl=cfg["sel_impl"])


def _program(cell, device):
    """(params, step, init) of the program: the port's estimator step, or
    with `--control tf32` the reference's in float32 with TF32 matrix
    products (the control), with `--control f32` in float32 with TF32 off
    (a witness)."""
    if cell.control in ("tf32", "f32"):
        torch.backends.cuda.matmul.allow_tf32 = cell.control == "tf32"
        ed, ant, window_mod = ref_ed, ref_ant, ref_window
    elif cell.control is not None:
        raise ValueError(f"unknown control {cell.control!r}")
    else:
        from anticipated_vins_mono_torch.models import anticipation as ant
        from anticipated_vins_mono_torch.models import estimator_device as ed
        from anticipated_vins_mono_torch.ops import window as window_mod
    pr = _params(ed, ant, window_mod, cell.config)

    def step(st, frame):
        return ed.vio_step(pr, st, *frame, device=device)

    def init(first, frames):
        return ed.vio_init_oracle(pr, first, frames, device=device)
    return pr, step, init


def _faulty(step, fault, nf):
    """The step with a planted fault, for the benchmark's own tests."""
    if fault is None:
        return step

    def broken(st, frame):
        new, out = step(st, frame)
        if fault == "unchanged":
            return st, out
        if fault == "altered":
            # the marginalization's answer, its square-root information
            # 1 % off
            prior = new.prior._replace(J0=new.prior.J0 * 1.01)
            return new._replace(prior=prior), out
        raise ValueError(f"unknown fault {fault!r}")
    return broken


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _prior_info(prior):
    J0 = prior.J0.to(torch.float64)
    return (J0.mT @ J0) * prior.weight.to(torch.float64)


def _inserted(st_in, st_out, frame):
    """[N] bool: the candidates of `frame` that the step inserted into the
    DB (its selection, as far as it took effect)."""
    ids, active = frame[0], frame[4]
    cand = ref_ed.candidates(st_in, ids, active)
    live = st_out.ids[st_out.ids >= 0]
    return cand & torch.isin(ids, live)


def run(cell) -> RunResult:
    cfg, tr = cell.config, cell.traffic
    device = torch.device(cell.device)
    dtype = DTYPES[cfg["dtype"]]
    nf = cfg["WINDOW_SIZE"] + 1

    # -- set-up: the stream from the seed, on the card; the start; warm-up
    traj = trajectories.trajectory(tr["trajectory"])
    sim = stream.SequenceSimulator(
        traj, seed=cell.seed, pixel_noise=tr["pixel_noise_px"],
        max_features=cfg["max_cnt"], n_landmarks=tr["n_landmarks"],
        **tr.get("simulator", {}))
    packed = stream.pack_stream(list(sim.frames()), cfg["max_cnt"])
    T = packed.ids.shape[0]
    stage(cell.t0, "stream made")
    on_card = [torch.from_numpy(x).to(device) if x.dtype.kind in "ib"
               else torch.from_numpy(x).to(device=device, dtype=dtype)
               for x in packed]
    frame = lambda t: tuple(x[t] for x in on_card)
    _sync(device)
    stage(cell.t0, "stream on the device")
    pr, step, init = _program(cell, device)
    step = _faulty(step, cell.fault, nf)
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
    counts0 = None
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
                counts = ({k: hk.launch_counts[k] - counts0[k]
                           for k in counts0} if hk is not None else {})
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
        by = {k: sum(1 for kn, _, _ in tr_red.kernels if k in kn)
              for k in ("logdet_psd_kernel", "schur_solve_fused_kernel")}
        note(f"trace: {tr_red.spans} frames, {tr_red.launches} launch calls, "
             f"{len(tr_red.kernels)} kernels, window {tr_red.window_s:.6f} s,"
             f" busy {tr_red.busy_s:.6f} s; kernels in the trace {by}, "
             f"launch_counts delta {counts}")

    # -- the check
    torch.backends.cuda.matmul.allow_tf32 = False
    fails = sum(bool(o["fail"]) for o in outs)
    rng = np.random.default_rng([cell.seed % 2**63, 1])
    sample = sorted(rng.choice(n, size=min(tr["check_frames"], n),
                               replace=False).tolist())
    kept = {i: (states[i], states[i + 1], outs[i]) for i in sample}
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
    pose_gap = cost_rgap = 0.0
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
        n_cand = int(ref_ed.candidates(r_in, fr[0], fr[4]).sum())
        note(f"frame {first_t + i}: pose gap {gap:.3e} m, prior {rg:.3e}, "
             f"db mismatches {mis}, candidates {n_cand}, admitted "
             f"{int(picks.sum())} "
             f"(reference {int(ref_picks.sum())}, same set "
             f"{bool(torch.equal(picks, ref_picks))}), gate gain "
             f"{gain:.6g}, shortfall "
             f"{'none' if short is None else f'{short:.3e}'}, "
             f"keyframe {bool(out['keyframe'])}")
        cg = float(abs(out["cost"].to(f64) - r_o["cost"]) / r_o["cost"])
        pose_gap = max(pose_gap, gap)
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
