"""Where the capstone's tracker streams part, and what the JAX estimator
reads on each: the JAX package's device tracker on the CPU, the port's on
the CPU, and the port's on the card, on the capstone runner's circuit, per
tracker seed.

    python tests/tracker_stream_reference.py --seeds 0 1 2 3 4 \
        --cache build/streams --card chiprun_out
    python tests/tracker_stream_reference.py --estimate port_card \
        --seeds 0 --cache build/streams --card chiprun_out

The circuit is `device_vio_bench.main`'s at its defaults cut to 8 s, as the
`capstone` phase of `chip_smoke.py` runs it: pinhole fx = 0.6·W at
752×480, the box world around `loop_trajectory(D, laps = D/10, r = 3)`,
frames at 10 Hz, 150 tracker slots. The JAX package renders the frames;
both trackers on the CPU take the same images and start from
`tracker_init(seed=k)`, so both draw the same RANSAC values from the same
keys. `--cache DIR` keeps each seed's two CPU streams there (an `.npz` a
seed and tracker) and reads them back on the next run. `--card DIR` adds
the port's tracker on the card: the measurements recorded by
`chip_smoke.py --capstone-seeds float32_schur_kernel SEED ...
--record-tracker` (`DIR/capstone_tracker_float32_schur_kernel_seed{k}.npz`;
that run renders its own frames on the card).

Compare (the default): for each frame and each pair of trackers, the slots
whose ids differ, the slots whose active flags differ, and the rays (of
slots active in both with equal ids) more than 1e-5 apart; for each pair
the first frame on which the ids differ and the first on which a ray does,
and on the first frame whose ids differ, the slots kept by one tracker and
refilled by the other (one: the float32 RANSAC's flip, ROADMAP queue C
5(c)); per frame the corners of one tracker with no corner of the other
within 1e-4 on the normalized plane (ids are slot bookkeeping: after one
shift they differ for the same corners), and each stream's mean track
length. One JSON line per seed, then a summary line.

`--estimate STREAM` (`jax_cpu`, `port_cpu`, `port_card`, or the name of
any stream `{STREAM}_seed{k}.npz` in the cache directory): the JAX
package's capstone runner (`device_vio_bench.main(duration, kappa=30)`,
float32, its CPU defaults: "chol" by a Cholesky, the float64 Schur path)
with its tracker's measurements replaced, frame by frame, by that stream
of the seed: what the JAX estimator reads on each tracker's measurements.
One JSON line a seed.

`--handoff STREAM`: both packages' host estimators (`VioEstimator`,
float32, window 10 with 128 slots, the runner's oracle start) warmed up on
that stream as the capstone runner warms its own up, to the hand-off: the
camera-IMU extrinsic (`tic`, `qic`) each leaves in the device state, the
landmarks solved, and the window positions against the ground truth. The
port runs on the CPU with numpy's LAPACK `eigh` (ROADMAP queue C 6). The
two are stepped in lockstep: `frames` has, per frame, the largest
difference of each host field (p, q, v, ba, bg, tic, qic and the feature
database's inverse depths and solved flags). `first_solve` takes the
inputs of JAX's first window solve and solves them with both packages'
`lm_solve` (so the solvers are compared on the same inputs), and gives
H[tic_y, tic_y] and g[tic_y] of the first LM iteration in float32 from
both packages and in float64 from JAX's: the extrinsic's translation along
the circuit's yaw axis, which the planar circuit cannot observe.
`--truth STREAM`: the stream's tracks against the ground truth: each slot
kept from one frame to the next, its earlier corner backprojected onto the
box world (`render.backproject`) and projected into the later frame from
the true poses; the median motion of those corners in pixels, and the
share of tracked corners within 1 px and 3 px of where they should be.
`--pin-extrinsic` holds the extrinsic at its known value (identity) in the
warm-up, `--estimate` and `--handoff` runs alike (`WindowConfig(
estimate_extrinsic=False)`, as the JAX package's loop benchmark runs).

A script, not a test (pytest collects `test_*.py` only): a seed takes
minutes on the CPU, an `--estimate` run about ten.
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

RAY_TOL = 1e-5
MATCH_TOL = 1e-4        # 0.045 px at fx = 451.2
N_SLOTS = 150
FIELDS = ("ids", "rays", "vel", "prob", "active")


def render(duration: float, width: int, height: int):
    from anticipated_vins_mono_tpu.ops import cameras, lie
    from anticipated_vins_mono_tpu.utils import render as jrender
    from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
    fx = 0.6 * width
    cam = cameras.PinholeCamera.create(fx, fx, width / 2.0, height / 2.0,
                                       width=width, height=height)
    traj = loop_trajectory(duration, laps=duration / 10.0, radius=3.0)
    world = jrender.make_box_world(traj.p, margin=5.0, seed=0)
    rays = jrender.camera_rays(cam)
    R_all = np.asarray(lie.quat_to_rot(jnp.asarray(traj.q)))
    ks = np.arange((len(traj.t) - 1) // 20) * 20
    imgs = [np.asarray(jrender.render_frame(world, cam, rays, traj.p[k],
                                            R_all[k]), np.float32)
            for k in ks]
    return cam, imgs, traj.t[ks]


def _first(ids, norm, score, active):
    """The first frame's measurement as `DeviceFeatureTracker.process`
    forms it."""
    rays = np.concatenate([norm, np.ones_like(norm[:, :1])], -1)
    return (ids, rays, np.zeros_like(norm),
            score / max(float(score.max()), 1e-9), active)


def jax_stream(cam, imgs, ts, seed):
    from anticipated_vins_mono_tpu.models import tracker_device as jtd
    tp = jtd.TrackerDeviceParams(max_features=N_SLOTS)
    st = jtd.tracker_init(cam, tp, jnp.asarray(imgs[0]), float(ts[0]), seed)
    out = [_first(*(np.asarray(x) for x in (st.ids, st.norm, st.score,
                                            st.active)))]
    for img, t in zip(imgs[1:], ts[1:]):
        st, m = jtd.tracker_step(cam, tp, st, jnp.asarray(img), float(t))
        out.append(tuple(np.asarray(x) for x in m))
    return out


def port_stream(cam, imgs, ts, seed):
    from anticipated_vins_mono_torch.models import tracker_device as td
    from anticipated_vins_mono_torch.utils import convert
    tcam = convert.camera_from_numpy(jax.tree_util.tree_map(np.asarray, cam),
                                     device="cpu")
    tp = td.TrackerDeviceParams(max_features=N_SLOTS)
    st = td.tracker_init(tcam, tp, imgs[0], float(ts[0]), seed=seed)
    out = [_first(*(x.numpy() for x in (st.ids, st.norm, st.score,
                                        st.active)))]
    for img, t in zip(imgs[1:], ts[1:]):
        st, m = td.tracker_step(tcam, tp, st, img, float(t))
        out.append(tuple(x.numpy() for x in m))
    return out


def _load(path):
    z = np.load(path)
    return list(zip(*(z[f] for f in FIELDS)))


def card_stream(card_dir: str, seed: int):
    path = os.path.join(card_dir, "capstone_tracker_float32_schur_kernel_"
                        f"seed{seed}.npz")
    return _load(path) if os.path.exists(path) else None


def cached(cache_dir, name: str, seed: int, make):
    """`make()`, kept in `cache_dir/{name}_seed{seed}.npz` when a
    directory is given."""
    path = cache_dir and os.path.join(cache_dir, f"{name}_seed{seed}.npz")
    if path and os.path.exists(path):
        return _load(path)
    out = make()
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, **{f: np.stack(x)
                                     for f, x in zip(FIELDS, zip(*out))})
    return out


def track_life(stream) -> float:
    """Mean length (frames) of the active tracks over the stream."""
    life, total, n = None, 0, 0
    prev = None
    for ids, _, _, _, active in stream:
        kept = active & (ids == prev) if prev is not None else active & False
        life = np.where(kept, life + 1, active.astype(int)) \
            if life is not None else active.astype(int)
        total, n, prev = total + life[active].sum(), n + active.sum(), ids
    return float(total / max(n, 1))


def compare(a, b) -> dict:
    """Per-frame counts between two streams, where they first part, and
    the kept-vs-refilled slots on the first frame whose ids differ. Ids are
    slot bookkeeping, so after one shift they differ for the same corners:
    `unmatched` counts instead the active points of `a` with no active
    point of `b` within MATCH_TOL on the normalized plane."""
    from scipy.spatial import cKDTree
    per_frame, first_ids, first_ray, flips = [], None, None, None
    for f, (ma, mb) in enumerate(zip(a, b)):
        (ia, ra, aa), (ib, rb, ab) = ((m[0], m[1], m[4]) for m in (ma, mb))
        same = (ia == ib) & aa & ab
        diff = np.abs(ra - rb).max(-1)
        dist, _ = cKDTree(rb[ab][:, :2]).query(ra[aa][:, :2])
        row = {"ids": int((ia != ib).sum()), "active": int((aa != ab).sum()),
               "rays_over_1e-5": int(((diff > RAY_TOL) & same).sum()),
               "largest_ray_diff": float(diff[same].max()) if same.any()
               else 0.0,
               "unmatched": int((dist > MATCH_TOL).sum())}
        per_frame.append(row)
        if first_ray is None and row["rays_over_1e-5"]:
            first_ray = f
        if first_ids is None and row["ids"]:
            first_ids = f
            prev = a[f - 1][0]
            flips = int(((aa & (ia == prev)) != (ab & (ib == prev))).sum())
    unmatched = [r["unmatched"] for r in per_frame]
    return {"first_ids_differ": first_ids, "first_ray_over_1e-5": first_ray,
            "kept_vs_refilled_at_first_ids_differ": flips,
            "frames_ids_differ": sum(r["ids"] > 0 for r in per_frame),
            "unmatched_first_11_frames": unmatched[:11],
            "unmatched_mean": float(np.mean(unmatched)),
            "track_life_mean": [track_life(a), track_life(b)],
            "per_frame": per_frame}


def streams_of(a, cam, imgs, ts, seed) -> dict:
    streams = {name: cached(a.cache, name, seed,
                            lambda f=f: f(cam, imgs, ts, seed))
               for name, f in (("jax_cpu", jax_stream),
                               ("port_cpu", port_stream))}
    card = card_stream(a.card, seed) if a.card else None
    if card is not None:
        streams["port_card"] = card
    return streams


def estimate(stream, ts, duration: float, width: int, height: int,
             pin_extrinsic: bool = False) -> float:
    """ATE of the JAX capstone runner fed `stream` in place of its
    tracker's measurements (matched to the frame by its time)."""
    from anticipated_vins_mono_tpu.models import tracker_device as jtd
    from anticipated_vins_mono_tpu.ops import window
    from anticipated_vins_mono_tpu.utils import device_vio_bench as jdvb
    if pin_extrinsic:
        cfg = window.WindowConfig
        window.WindowConfig = lambda **kw: cfg(**{
            **kw, "estimate_extrinsic": False})
    rec = [jnp.asarray(np.stack(x)) for x in zip(*stream)]
    t_rec = jnp.asarray(ts, jnp.float32)
    init, step = jtd.tracker_init, jtd.tracker_step

    def frame(t):
        return jnp.argmin(jnp.abs(t_rec - jnp.asarray(t, jnp.float32)))

    def tracker_init(cam, params, img, t, seed=0):
        st = init(cam, params, img, t, seed)
        k = frame(t)
        return st._replace(ids=rec[0][k], norm=rec[1][k][:, :2],
                           score=rec[3][k], active=rec[4][k])

    def tracker_step(cam, params, state, img, t):
        st, _ = step(cam, params, state, img, t)
        k = frame(t)
        return st, tuple(x[k] for x in rec)

    jtd.tracker_init, jtd.tracker_step = tracker_init, tracker_step
    try:
        rows = jdvb.main(duration=duration, width=width, height=height,
                         kappa=30)
    finally:
        jtd.tracker_init, jtd.tracker_step = init, step
    return rows["ate_rmse_m"]


def imu_per_frame(traj, ks):
    """The capstone runner's IMU per frame: (dts, acc, gyr, acc0, gyr0),
    padded to 24 samples."""
    n = len(ks)
    imu = [np.zeros((n, 24)), np.zeros((n, 24, 3)), np.zeros((n, 24, 3)),
           np.zeros((n, 3)), np.zeros((n, 3))]
    for f in range(1, n):
        s, k = ks[f - 1], ks[f]
        imu[0][f, :k - s] = np.diff(traj.t[s:k + 1])
        imu[1][f, :k - s] = traj.acc_body[s + 1:k + 1]
        imu[2][f, :k - s] = traj.gyr_body[s + 1:k + 1]
        imu[3][f], imu[4][f] = traj.acc_body[s], traj.gyr_body[s]
    return imu


def handoff(stream, duration: float, pin_extrinsic: bool) -> dict:
    """Both host estimators warmed up on `stream` to the hand-off, in
    lockstep, and both solvers on the inputs of JAX's first window solve."""
    from anticipated_vins_mono_tpu.models import estimator_device as jed
    from anticipated_vins_mono_tpu.models.estimator import VioEstimator as JE
    from anticipated_vins_mono_tpu.ops import window as jw
    from anticipated_vins_mono_tpu.utils.sequence import FrameMeasurement
    from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
    from anticipated_vins_mono_torch.models import estimator_device as ted
    from anticipated_vins_mono_torch.models.estimator import VioEstimator as TE
    from anticipated_vins_mono_torch.ops import window as tw
    from anticipated_vins_mono_torch.utils import convert

    def eigh_lapack(A, UPLO="L"):
        w, V = np.linalg.eigh(A.numpy(), UPLO=UPLO)
        return torch.return_types.linalg_eigh(
            (torch.from_numpy(w).to(A.dtype), torch.from_numpy(V).to(A.dtype)))

    def gap(a, b):
        a = np.asarray(a, float)
        b = np.asarray(b.numpy() if torch.is_tensor(b) else b, float)
        return float(np.abs(a - b).max()) if a.size else 0.0

    traj = loop_trajectory(duration, laps=duration / 10.0, radius=3.0)
    ks = np.arange((len(traj.t) - 1) // 20) * 20
    imu = imu_per_frame(traj, ks)
    oracle = {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}
    cfg = dict(window=10, max_feats=128, iters=8, accum="f64",
               estimate_extrinsic=not pin_extrinsic)
    jcfg, tcfg = jw.WindowConfig(**cfg), tw.WindowConfig(**cfg)
    je = JE(jcfg, dtype=jnp.float32, init_state=oracle)
    te = TE(tcfg, dtype=torch.float32, init_state=oracle, device="cpu")
    eigh, torch.linalg.eigh = torch.linalg.eigh, eigh_lapack
    out = {"frames": []}
    try:
        f = 0
        while not (je.initialized and je.n_frames == jcfg.nf - 1):
            ids, rays, vel, prob, active = stream[f]
            n = np.count_nonzero(imu[0][f])
            fm = FrameMeasurement(
                t=float(traj.t[ks[f]]),
                feats={int(i): (rays[k].astype(float), vel[k].astype(float),
                                float(prob[k]))
                       for k, i in enumerate(ids) if active[k]},
                imu_dts=imu[0][f, :n], imu_acc=imu[1][f, :n],
                imu_gyr=imu[2][f, :n], acc0=imu[3][f], gyr0=imu[4][f])
            je.process_frame(fm)
            te.process_frame(fm)
            row = {k: gap(getattr(je, k), getattr(te, k))
                   for k in ("p", "q", "v", "ba", "bg", "tic", "qic")}
            row.update({"db_" + k: gap(getattr(je.db, k), getattr(te.db, k))
                        for k in ("inv_depth", "solved")})
            out["frames"].append(row)
            f += 1
        assert te.initialized and te.n_frames == tcfg.nf - 1
        for name, est in (("jax", je), ("port", te)):
            st = (jax.tree_util.tree_map(np.array, jed.vio_init_from_host(est))
                  if name == "jax" else convert.device_vio_state_to_numpy(
                      ted.vio_init_from_host(est)))
            p = np.asarray(st.p, float)[:jcfg.nf - 1]
            out[name] = {
                "handoff_frame": f, "tic": np.asarray(st.tic).tolist(),
                "qic": np.asarray(st.qic).tolist(),
                "solved": int(np.asarray(st.solved).sum()),
                "window_pos_err_max_m": float(np.abs(
                    p - traj.p[ks[f - len(p):f]]).max())}
        # JAX's first solve: its inputs through both solvers
        js, jm, jn = je.last_solve
        ts_, tm = (convert.window_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js), device="cpu"),
            convert.window_measurements_from_numpy(
                jax.tree_util.tree_map(np.asarray, jm), device="cpu"))
        tn, _ = tw.lm_solve(ts_, tm, tcfg, device="cpu")
        y = 15 * jcfg.nf + 1                          # tic_y in the layout
        Hj, gj = jw.normal_equations_fast(js, jm, jcfg)[:2]
        Ht, gt = tw.normal_equations_fast(ts_, tm, tcfg)[:2]
        f64 = lambda x: jnp.asarray(x, jnp.float64) \
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x
        H6, g6 = jw.normal_equations_fast(
            jax.tree_util.tree_map(f64, js), jax.tree_util.tree_map(f64, jm),
            jcfg)[:2]
        out["first_solve"] = {
            "inputs_state_gap": {
                k: gap(getattr(js, k), getattr(te.last_solve[0], k))
                for k in js._fields if getattr(js, k) is not None},
            "tic_after_jax_lm_solve": np.asarray(jn.tic).tolist(),
            "tic_after_port_lm_solve": tn.tic.numpy().tolist(),
            "H_tic_y": [float(Hj[y, y]), float(Ht[y, y]), float(H6[y, y])],
            "g_tic_y": [float(gj[y]), float(gt[y]), float(g6[y])]}
    finally:
        torch.linalg.eigh = eigh
    return out


def truth(stream, duration: float, width: int, height: int) -> dict:
    """The stream's kept tracks against the ground-truth reprojection."""
    from anticipated_vins_mono_torch.ops import cameras, lie
    from anticipated_vins_mono_torch.utils import render as trender
    from anticipated_vins_mono_torch.utils.synthetic import loop_trajectory
    traj = loop_trajectory(duration, laps=duration / 10.0, radius=3.0)
    ks = np.arange((len(traj.t) - 1) // 20) * 20
    R = lie.quat_to_rot(torch.tensor(traj.q)).numpy()
    fx = 0.6 * width
    c = np.array([width / 2.0, height / 2.0])
    cam = cameras.PinholeCamera.create(fx, fx, *c, width=width,
                                       height=height, device="cpu")
    world = trender.make_box_world(traj.p, margin=5.0, seed=0, device="cpu")
    motion, err = [], []
    for f in range(1, len(stream)):
        (ia, ra, _, _, aa), (ib, rb, _, _, ab) = stream[f - 1], stream[f]
        kept = aa & ab & (ia == ib)
        uv0 = ra[kept, :2].astype(float) * fx + c
        X = trender.backproject(world, cam, uv0, traj.p[ks[f - 1]],
                                R[ks[f - 1]])
        pc = (X - traj.p[ks[f]]) @ R[ks[f]]
        uv1 = pc[:, :2] / pc[:, 2:] * fx + c
        motion.append(np.linalg.norm(uv1 - uv0, axis=-1))
        err.append(np.linalg.norm(uv1 - (rb[kept, :2] * fx + c), axis=-1))
    motion, err = np.concatenate(motion), np.concatenate(err)
    return {"kept_tracks": int(len(err)),
            "true_motion_px_median": float(np.median(motion)),
            "track_error_px_median": float(np.median(err)),
            "within_1px": float((err < 1).mean()),
            "within_3px": float((err < 3).mean())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--card", default=None)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--estimate", default=None)
    ap.add_argument("--handoff", default=None)
    ap.add_argument("--truth", default=None)
    ap.add_argument("--pin-extrinsic", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    cam, imgs, ts = render(a.duration, a.width, a.height)
    results = []
    for seed in a.seeds:
        streams = streams_of(a, cam, imgs, ts, seed)
        name = a.estimate or a.handoff or a.truth
        if name:
            stream = streams.get(name) or _load(os.path.join(
                a.cache, f"{name}_seed{seed}.npz"))
            res = {"seed": seed, "stream": name,
                   "pin_extrinsic": a.pin_extrinsic}
            if a.estimate:
                res["jax_estimator_ate_m"] = estimate(
                    stream, ts, a.duration, a.width, a.height,
                    a.pin_extrinsic)
            elif a.handoff:
                res["handoff"] = handoff(stream, a.duration, a.pin_extrinsic)
            else:
                res["truth"] = truth(stream, a.duration, a.width, a.height)
            print(json.dumps(res), flush=True)
            results.append(res)
            continue
        names = list(streams)
        res = {"seed": seed, "frames": len(imgs)}
        for i, x in enumerate(names):
            for y in names[i + 1:]:
                res[f"{x}_vs_{y}"] = compare(streams[x], streams[y])
        print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                               if kk != "per_frame"}
                              if isinstance(v, dict) else v)
                          for k, v in res.items()}), flush=True)
        results.append(res)
    if not (a.estimate or a.handoff or a.truth):
        print(json.dumps({"summary": {
            r["seed"]: {k: v["first_ids_differ"] for k, v in r.items()
                        if isinstance(v, dict)} for r in results}}),
              flush=True)
    if a.out:
        with open(a.out, "w") as fo:
            json.dump(results, fo, indent=1)


if __name__ == "__main__":
    main()
