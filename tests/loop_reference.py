"""Reference readings of the loop-closure benchmark and the capstone runner
at full width (752×480), on the CPU: the numbers that `chip_smoke.py`'s
`loop` and `capstone` bounds are set from (1.5 × the largest reading).

    python tests/loop_reference.py loop --duration 15 --seeds 0 1 2 3 4
    python tests/loop_reference.py loop --duration 30 --dtype float64
    python tests/loop_reference.py capstone --duration 8 --seeds 0 1 2 3 4

`loop`: the JAX package's `utils.loop_benchmark.run_loop_benchmark` with its
default arguments (pinhole camera fx = 0.6·W, the box world around
`loop_trajectory(D, laps=D/10, r=3)`, grounded + 4000 interior landmarks,
0.5 px pixel noise, window 10 with 192 slots, real initialization, a
`LoopClosureNode` on every second keyframe), one JSON line per `seed` (the
seed picks the world, the landmarks and the measurement noise). Besides the
runner's own readings it prints when the first loop was accepted (the
keyframe time and the frame (10 Hz) of the first loop edge's newer end), the
largest translation and yaw error of an accepted edge against the ground
truth, and `ate_path_vio`: the ATE of the raw VIO poses of the keyframes
that `ate_loop_path` reads after the PGO.
`--dtype` is the estimator's state type (the runner's own default is
float64; the card runs float32).

`capstone`: the JAX package's `utils.device_vio_bench.main` (κ̄ = 30 unless
`--kappa` says otherwise), one JSON line per tracker seed (the seed picks the RANSAC draws and nothing
else); `--host-control` and `--corrupt-at` run its other two modes, and
`--pallas-schur` sends its window solve through the JAX package's Pallas
Schur kernel in interpret mode (the runner's own default is the float64
Schur path; the port's float32 runs on the card take the Schur kernel).

A script, not a test (pytest collects `test_*.py` only): a 15 s loop run
takes minutes a seed. It runs JAX on the CPU with x64 enabled, as the test
suite does.
"""

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from anticipated_vins_mono_tpu.utils.jaxenv import force_cpu_f64  # noqa: E402

force_cpu_f64(threads=int(os.environ.get("REF_THREADS", "4")))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def path_ate_vio(node, traj) -> float:
    """ATE of the raw VIO poses of the keyframes whose corrected poses make
    the runner's `ate_loop_path` (the newest keyframe's gauge-connected
    sequence group): what the path reads if the PGO moves nothing."""
    from anticipated_vins_mono_tpu.models import posegraph as pg
    from anticipated_vins_mono_tpu.utils.metrics import ate_rmse
    g = node.graph
    if g.n < 8:
        return float("nan")
    anchored = {int(g.seq_id[g.n - 1])}
    for _ in range(pg.MAX_SEQUENCES):
        for e in range(int(g.n_loops)):
            si, sj = int(g.seq_id[g.loop_i[e]]), int(g.seq_id[g.loop_j[e]])
            if si in anchored or sj in anchored:
                anchored |= {si, sj}
    sel = np.array([int(s) in anchored for s in g.seq_id[: g.n]])
    if sel.sum() < 8:
        return float("nan")
    t = np.array([e.t for e in node.entries])[sel]
    p = np.stack([e.p_vio for e in node.entries])[sel]
    return float(ate_rmse(t, p, traj.t, traj.p))


def run_loop(duration: float, seed: int, dtype: str) -> dict:
    from anticipated_vins_mono_tpu.models.estimator import VioEstimator
    from anticipated_vins_mono_tpu.utils import loop_benchmark as lb
    lb.VioEstimator = functools.partial(VioEstimator,
                                        dtype=getattr(jnp, dtype))
    # keep the runner's node and trajectory for the readings it does not
    # return
    seen = {}
    node_cls, traj_fn = lb.LoopClosureNode, lb.loop_trajectory
    lb.LoopClosureNode = lambda *a, **k: seen.setdefault(
        "node", node_cls(*a, **k))
    lb.loop_trajectory = lambda *a, **k: seen.setdefault(
        "traj", traj_fn(*a, **k))
    t0 = time.perf_counter()
    try:
        row = lb.run_loop_benchmark(duration=duration, seed=seed)
    finally:
        lb.LoopClosureNode, lb.loop_trajectory = node_cls, traj_fn
    first_t = None
    if row["edges"]:
        first_t = min(row["keyframes_vio"][e["j"]]["t"] for e in row["edges"])
    t_err = [abs(e["t_err_m"]) for e in row["edges"]]
    yaw_err = [abs(e["yaw_err_deg"]) for e in row["edges"]]
    return {"part": "loop", "duration_s": duration, "seed": seed,
            "dtype": dtype,
            "keyframes": row["keyframes"],
            "loops_accepted": row["loops_accepted"],
            "first_loop_t": first_t,
            "first_loop_frame": None if first_t is None
            else int(round(first_t * 10.0)),
            "ate_vio": row["ate_vio"], "ate_loop": row["ate_loop"],
            "ate_loop_path": row["ate_loop_path"],
            "ate_path_vio": path_ate_vio(seen["node"], seen["traj"]),
            "edge_t_err_max_m": max(t_err, default=None),
            "edge_yaw_err_max_deg": max(yaw_err, default=None),
            "vio_failures": row["vio_failures"], "funnel": row["funnel"],
            "seconds": time.perf_counter() - t0}


_TRACKER = None   # the JAX tracker class before it is given a seed


def pallas_schur_on_cpu() -> None:
    """Make the JAX runner's window solve take its Pallas Schur kernel
    (`pallas_schur=True`, the JAX counterpart of the port's float32 Schur
    kernel), run in interpret mode on the CPU."""
    from anticipated_vins_mono_tpu.ops import pallas_kernels as pk
    from anticipated_vins_mono_tpu.ops import window as jwin
    cfg = jwin.WindowConfig
    jwin.WindowConfig = lambda **kw: cfg(**{**kw, "pallas_schur": True})

    def interpreted(H, g, H_lp, h_ll, g_l, lam):
        dx, d_rho, pred = pk._schur_solve_fused_batched(
            H[None], g[None], H_lp[None], h_ll[None], g_l[None],
            jnp.reshape(lam, (1,)), interpret=True)
        return dx[0], d_rho[0], pred[0]
    pk.schur_solve_fused = interpreted


def run_capstone(duration: float, seed: int, dtype: str, kappa: int,
                 host_control: bool, corrupt_at: float, laps,
                 pin_extrinsic: bool = False) -> dict:
    from anticipated_vins_mono_tpu.models import tracker_device as jtd
    from anticipated_vins_mono_tpu.ops import window
    from anticipated_vins_mono_tpu.utils import device_vio_bench as dvb
    if pin_extrinsic:
        cfg = window.WindowConfig
        window.WindowConfig = lambda **kw: cfg(**{
            **kw, "estimate_extrinsic": False})
    global _TRACKER
    _TRACKER = _TRACKER or jtd.DeviceFeatureTracker
    jtd.DeviceFeatureTracker = functools.partial(_TRACKER, seed=seed)
    t0 = time.perf_counter()
    row = dvb.main(duration=duration, kappa=kappa, dtype_str=dtype,
                   host_control=host_control, corrupt_at=corrupt_at,
                   laps=laps)
    row = {"part": "capstone", "tracker_seed": seed, "dtype": dtype, **row,
           "seconds": time.perf_counter() - t0}
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("part", choices=("loop", "capstone"))
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--kappa", type=int, default=30)
    ap.add_argument("--host-control", action="store_true")
    ap.add_argument("--corrupt-at", type=float, default=0.0)
    ap.add_argument("--laps", type=float, default=None)
    ap.add_argument("--pin-extrinsic", action="store_true",
                    help="capstone: the camera-IMU extrinsic held at its "
                         "known value (WindowConfig(estimate_extrinsic="
                         "False), as the loop benchmark runs)")
    ap.add_argument("--pallas-schur", action="store_true",
                    help="capstone: the window solve through the JAX "
                         "package's Pallas Schur kernel (interpret mode)")
    args = ap.parse_args()
    if args.pallas_schur:
        pallas_schur_on_cpu()
    for s in args.seeds:
        if args.part == "loop":
            row = run_loop(args.duration, s, args.dtype)
        else:
            row = run_capstone(args.duration, s, args.dtype, args.kappa,
                               args.host_control, args.corrupt_at, args.laps,
                               args.pin_extrinsic)
            row["pallas_schur"] = args.pallas_schur
            row["pin_extrinsic"] = args.pin_extrinsic
        print("REF " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
