"""Runner of the tracker cells: `models/tracker_device.tracker_step`, one
camera, frame after frame in a closed loop (an offline replay of a camera
at full speed).

Set-up renders the traffic's circuit from the seed (`traffic.circuit`: the
box world's texture from the seed) through the configuration's camera on
the device, rounds every frame to 8 bits and holds them all in page-locked
host memory, starts the tracker on the first frame (its RANSAC key from the
seed) and runs the traffic's warm-up frames. The window then runs
`tracker_step`s back to back, each from the frame's uint8 host buffer
(copied to the card inside the step) to the synchronised measurement, until
`--seconds` have passed or the stream ends: `frame_ms` is the window time
over the frames completed, `frame_ms_p80` the 80th percentile of the
frames' latencies. The set-up's rendering is not counted in the memory
peak, which is the tracker's.

The check follows the program frame by frame: for frames drawn from the
seed, the reference (`reference/tracker`, float64) steps from the state the
program was given, its pyramid built anew from the previous uint8 frame,
with the current uint8 frame and the same RANSAC draws (the state's key),
and is compared with what the program returned. A slot is kept where it
was active before and after the step under the same id; the rest of the
active slots were refilled. Compared: the 95th percentile of the position
gap of the points both keep (`kept_gap_px_p95`), the count of slots whose
kept or dropped decision differs (`kept_diff`), the share of the program's
refilled corners with no corner within 1 px among those the reference
detects around the program's own kept tracks (`refill_unmatched_share`:
the detection held by itself, since a slot kept on one side and dropped on
the other frees another region), and on the slots both keep the 95th
percentile of the rays' and of the velocities' gaps (`ray_gap_p95`,
`vel_gap_p95`), the 95th percentile of the relative gap of the refilled
corners' scores where the reference detects the same pixel
(`refill_score_rgap_p95`), and the largest gap of the probabilities
(`prob_gap_max`) in the frames whose largest active scores agree to 1e-3
(a probability is a score over that largest one, which a slot kept on one
side and dropped on the other can change; NaN, so not `correct`, where no
frame was compared). Read, not compared: the largest
position gap, the frames whose probabilities were compared, and the share
of the program's kept tracks that lie within 1 px of where the rendered
world puts the point they were at in the previous frame
(`truth_share_1px`).

`--control bf16` puts the reference with its images in bfloat16 in the
program's place (the control). `--fault` plants a fault in the program:
`jax_lk` (LK in the JAX package's form, `follow_flow` off), `moved` (every
kept point 0.5 px off), `no_clahe` (detection on the image without CLAHE),
`no_ransac` (every point LK tracks is kept), `ransac_hypothesis` (each
hypothesis's null vector tilted by a tenth of the next eigenvector).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import convert, trace
from benchmark.harness import Check, HostWatch, RunResult, note, stage
from benchmark.reference import cameras as ref_cam
from benchmark.reference import tracker as ref_tr
from benchmark.traffic import circuit

DTYPES = {"float32": torch.float32, "float64": torch.float64}
FAULTS = (None, "jax_lk", "no_clahe", "moved", "no_ransac",
          "ransac_hypothesis")
REF_TYPES = convert.types_of(ref_tr)
# what the port's LK runs with and the configuration has to state
PORT_LK = {"lk_half": 7, "lk_iters": 10, "lk_pad": 8}


def _camera(create, cfg, dtype, device):
    c = cfg["camera"]
    return create(c["fx"], c["fy"], c["cx"], c["cy"], c["k1"], c["k2"],
                  c["p1"], c["p2"], width=c["width"], height=c["height"],
                  dtype=dtype, device=device)


def _ref_params(cfg):
    return ref_tr.TrackerParams(
        max_features=cfg["max_features"], min_dist=cfg["min_dist"],
        ransac_thresh_px=cfg["ransac_thresh_px"], levels=cfg["levels"],
        ransac_iters=cfg["ransac_iters"], **{k: cfg[k] for k in PORT_LK})


def _program(cell, device):
    """(init, step) of the program: the port's tracker, or with `--control
    bf16` the reference with bfloat16 images; a planted fault where
    `--fault` names one."""
    cfg = cell.config
    if cell.fault not in FAULTS:
        raise ValueError(f"unknown fault {cell.fault!r}")
    if cell.control == "bf16":
        cam = _camera(ref_cam.PinholeCamera.create, cfg, torch.float64,
                      device)
        rp = _ref_params(cfg)
        bf = torch.bfloat16

        def init(img, t):
            return ref_tr.tracker_init(cam, rp, img, t, cell.seed,
                                       img_dtype=bf)

        def step(st, img, t):
            new, meas, _ = ref_tr.tracker_step(cam, rp, st, img, t,
                                               img_dtype=bf)
            return new, meas
        return init, step
    if cell.control is not None:
        raise ValueError(f"unknown control {cell.control!r}")
    from anticipated_vins_mono_torch.models import tracker_device as td
    from anticipated_vins_mono_torch.ops import cameras
    if not cfg["clahe"] or any(cfg[k] != v for k, v in PORT_LK.items()):
        raise ValueError("the port's tracker runs CLAHE and LK with "
                         f"{PORT_LK}; the configuration states otherwise")
    cam = _camera(cameras.PinholeCamera.create, cfg, DTYPES[cfg["dtype"]],
                  device)
    pr = td.TrackerDeviceParams(
        max_features=cfg["max_features"], min_dist=cfg["min_dist"],
        ransac_thresh_px=cfg["ransac_thresh_px"], levels=cfg["levels"],
        ransac_iters=cfg["ransac_iters"],
        follow_flow=cfg["follow_flow"] and cell.fault != "jax_lk",
        ransac_f64=cfg["ransac_fit_dtype"] == "float64")
    if cell.fault == "no_clahe":
        prep = td._prep
        td._prep = lambda img, levels: (img, prep(img, levels)[1])
    if cell.fault == "no_ransac":
        td.ransac_essential_mask = lambda x1, x2, ok, u, thresh: ok
    if cell.fault == "ransac_hypothesis":
        eigh = td.lie.eigh_or_nan

        def tilted(A):
            w, V = eigh(A)
            v = V[..., 0] + 0.1 * V[..., 1]
            v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
            return w, torch.cat([v[..., None], V[..., 1:]], -1)
        td.lie.eigh_or_nan = tilted

    def init(img, t):
        return td.tracker_init(cam, pr, img, t, seed=cell.seed)

    def step(st, img, t):
        new, meas = td.tracker_step(cam, pr, st, img, t)
        if cell.fault == "moved":
            kept = _kept(st, new)
            shift = torch.tensor([0.5, 0.0], dtype=new.pts.dtype,
                                 device=new.pts.device)
            new = new._replace(pts=torch.where(kept[:, None],
                                               new.pts + shift, new.pts))
        return new, meas
    return init, step


def _kept(s_in, s_out):
    """[N] bool: the slots the step kept (active before and after, same
    id); the other active slots of `s_out` were refilled."""
    return s_in.active & s_out.active & (s_out.ids == s_in.ids)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell) -> RunResult:
    cfg, tr = cell.config, cell.traffic
    device = torch.device(cell.device)
    c = tr["circuit"]

    # -- set-up: the frames from the seed, in page-locked host memory
    circ, p_all = circuit.circuit(c["duration_s"], c["laps"], c["radius_m"],
                                  c["frame_hz"])
    world = circuit.make_box_world(p_all, cell.seed, c["margin_m"], device)
    rcam32 = _camera(ref_cam.PinholeCamera.create, cfg, torch.float32,
                     device)
    frames = circuit.frames_uint8(world, rcam32, circ,
                                  pin=device.type == "cuda")
    T = frames.shape[0]
    ts = circ.t
    _sync(device)
    stage(cell.t0, "frames rendered")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    init, step = _program(cell, device)
    st = init(frames[0], float(ts[0]))
    _sync(device)
    stage(cell.t0, "program imported, started")
    t = 1
    for _ in range(tr["warmup_frames"]):
        st, _ = step(st, frames[t], float(ts[t]))
        t += 1
    _sync(device)
    setup_s = time.monotonic() - cell.t0
    note(f"set-up {setup_s:.3f} s: {T} frames of {tuple(frames.shape[1:])} "
         f"uint8, {frames.numel() / 1e6:.1f} MB on the host, "
         f"{tr['warmup_frames']} warm-up frames")

    # -- the window
    n_trace = tr["trace_frames"] if cell.trace else 0
    prof = trace.profiler(n_trace) if n_trace else None
    small = lambda s: s._replace(pyr=())
    states, outs, lat, first_t = [small(st)], [], [], t
    if prof is not None:
        prof.start()
    watch = HostWatch()
    t_start = time.monotonic()
    while t < T:
        ts0 = time.monotonic()
        i = t - first_t
        if prof is not None and i <= n_trace:
            with torch.profiler.record_function("bench.frame"):
                st, out = step(st, frames[t], float(ts[t]))
                _sync(device)
            prof.step()
            if i == n_trace:
                prof.stop()
        else:
            st, out = step(st, frames[t], float(ts[t]))
            _sync(device)
        lat.append(time.monotonic() - ts0)
        watch.unit_done()
        states.append(small(st))
        outs.append(out)
        t += 1
        if time.monotonic() - t_start >= cell.seconds:
            break
    window_s = time.monotonic() - t_start
    watch.note("frames")
    n = len(lat)
    if t >= T:
        note(f"the stream ran out: {n} frames in {window_s:.3f} s")
    note(f"window {window_s:.3f} s: {n} frames, active slots of the last "
         f"{int(st.active.sum())}")
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    tr_red = trace.Trace.from_profile(prof) if prof is not None else None
    counters = {"frames": 0}
    if tr_red is not None:
        counters = {"frames": tr_red.spans}
        note(f"trace: {tr_red.spans} frames, {tr_red.launches} launch calls, "
             f"{len(tr_red.kernels)} kernels, window {tr_red.window_s:.6f} s,"
             f" busy {tr_red.busy_s:.6f} s")
        if cell.control is None:
            from anticipated_vins_mono_torch.utils import profile_slice, timing
            split = profile_slice.split_of(timing.recorded(), prof,
                                           "track.step")
            note(f"spans per frame: {split}")

    # -- the check
    rng = np.random.default_rng([cell.seed % 2**63, 1])
    sample = sorted(rng.choice(n, size=min(tr["check_frames"], n),
                               replace=False).tolist())
    f64 = torch.float64
    rcam = _camera(ref_cam.PinholeCamera.create, cfg, f64, device)
    rp = _ref_params(cfg)
    to_ref = lambda tree: convert.retype(tree, REF_TYPES,
                                         convert.floats_to(f64, device))
    gaps, ray_gaps, vel_gaps, prob_gaps, score_gaps = [], [], [], [], []
    kept_diff = n_refill = unmatched = n_kept = n_true = prob_frames = 0
    for i in sample:
        s_in, s_out, meas = states[i], states[i + 1], outs[i]
        k = first_t + i
        r_in = to_ref(s_in)._replace(pyr=ref_tr.prep(
            ref_tr.fe.as_image(frames[k - 1], device), rp.levels)[1])
        u = ref_tr.ransac_uniforms(s_in.key.to(device), rp.ransac_iters,
                                   rp.max_features)
        r_out, r_meas, r_eq = ref_tr.tracker_step(
            rcam, rp, r_in, frames[k], float(ts[k]), u=u)
        kp, kr = _kept(s_in, s_out), _kept(r_in, r_out)
        both = kp & kr
        kept_diff += int((kp != kr).sum())
        dist = lambda a, b: torch.linalg.norm(a.to(f64) - b, dim=-1)
        gaps += dist(s_out.pts[both], r_out.pts[both]).tolist()
        ray_gaps += (meas[1][both].to(f64) - r_meas[1][both]).abs() \
            .amax(-1).tolist()
        vel_gaps += (meas[2][both].to(f64) - r_meas[2][both]).abs() \
            .amax(-1).tolist()
        smax = float(s_out.score[s_out.active].max())
        r_smax = float(r_out.score[r_out.active].max())
        if abs(smax - r_smax) <= 1e-3 * r_smax:
            prob_gaps += (meas[3][both].to(f64) - r_meas[3][both]).abs() \
                .tolist()
            prob_frames += 1
        # the program's refilled corners among the corners the reference
        # detects around the program's kept tracks
        fill = s_out.active & ~kp
        r_uv, r_sc, r_val = ref_tr.detect(rp, r_eq, s_out.pts.to(f64), kp)
        if int(fill.sum()) and int(r_val.sum()):
            near, j = torch.cdist(s_out.pts[fill].to(f64),
                                  r_uv[r_val]).min(dim=1)
            unmatched += int((near > 1.0).sum())
            same = near < 0.5
            sc = r_sc[r_val][j[same]]
            score_gaps += ((s_out.score[fill][same].to(f64) - sc).abs()
                           / sc).tolist()
        n_refill += int(fill.sum())
        # the kept tracks against the rendered world
        if int(kp.sum()):
            X = circuit.backproject(world, rcam, s_in.pts[kp].to(f64),
                                    circ.p[k - 1], circ.R[k - 1])
            uv = circuit.project(rcam, X, circ.p[k], circ.R[k])
            err = np.linalg.norm(s_out.pts[kp].to(f64).cpu().numpy() - uv,
                                 axis=-1)
            n_true += int((err < 1.0).sum())
            n_kept += int(kp.sum())
        note(f"frame {k}: kept {int(kp.sum())} (reference {int(kr.sum())}, "
             f"both {int(both.sum())}), refilled {int(fill.sum())}, "
             f"largest active score {smax!r} (reference {r_smax!r})")
    q = lambda x, p: float(np.quantile(x, p)) if len(x) else 0.0
    nan = float("nan")
    readings = {"kept_gap_px_p95": q(gaps, 0.95),
                "kept_gap_px_max": q(gaps, 1.0),
                "kept_diff": kept_diff,
                "refill_unmatched_share": unmatched / max(n_refill, 1),
                "ray_gap_p95": q(ray_gaps, 0.95),
                "vel_gap_p95": q(vel_gaps, 0.95),
                "refill_score_rgap_p95": q(score_gaps, 0.95),
                "prob_gap_max": q(prob_gaps, 1.0) if prob_frames else nan,
                "prob_frames": prob_frames,
                "truth_share_1px": n_true / max(n_kept, 1),
                "kept_tracks": n_kept, "refilled": n_refill}
    note(f"readings {readings}")
    checks = [Check(k, v, tr["limits"][k]) for k, v in readings.items()
              if k in tr["limits"]]
    return RunResult(
        attempted=n, failed=0,
        e2e={"frame_ms": window_s / n * 1e3,
             "frame_ms_p80": float(np.percentile(lat, 80)) * 1e3,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=mem, trace=tr_red,
        counters=counters)
