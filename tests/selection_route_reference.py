"""Reference readings of the capstone runner on the route a TPU takes for the
selector's log-determinants, on the CPU: the numbers that `chip_smoke.py`'s
`capstone` bound is set from (1.5 × the largest reading).

    python tests/selection_route_reference.py --duration 8 --seeds 0 1 2 3 4
    python tests/selection_route_reference.py --route cpu --duration 8 --seeds 0
    python tests/selection_route_reference.py --parity \
        chiprun_out/capstone_f32_steps_seed0.npz [--free]

The JAX package's "chol" scoring takes two routes. On the CPU
`pallas_kernels.logdet_psd` is `lie.logdet_psd`, a Cholesky: in float32 at
the deployment's size Ω_acc + p·Δ is indefinite for every candidate, the
gains are NaN, the greedy admits nothing and `_device_select` backfills the
κ̄ most probable features. On a TPU it is the Pallas elimination kernel,
whose pivots are floored at 1e-30: every gain is finite and the greedy picks
by the float32 gains. The port's kernel on the card takes the TPU route.

`--route tpu` (the default) puts the TPU route in on the CPU: the JAX
`pallas_kernels.logdet_psd` becomes `logdet_psd_batched(M, interpret=True)`
for [B,N,N] inputs (the kernel in interpret mode), before anything is traced.
`--route cpu` keeps the Cholesky. Both routes send the window solve through
the Pallas Schur kernel in interpret mode (`loop_reference.pallas_schur_on_cpu`),
as the card's float32 capstone runs both kernels.

It runs the JAX package's `utils/device_vio_bench.main` at the `capstone`
phase's settings (752×480, κ̄ = 30 "chol", float32, 150 tracker slots), one
JSON line per tracker seed with the ATE, the fail flags and the run time.

`--parity STEPS.npz` replays instead the card's float32 capstone run that
`chip_smoke.py --capstone-step-parity SEED float32` recorded: at every device
frame the JAX package's `vio_step` (on the route `--route` names, float32,
Pallas Schur) steps from the card's state before that frame on the card's
tracker measurements and IMU, and its state is held against the card's state
after it: the slot ids (which features the gate admitted), the window's
positions and the prior's information. One line per frame, then the first
frame where the two part. With `--free` the JAX `vio_step` carries its own
state from the card's hand-off state over the same recorded inputs instead,
and the line holds both ATEs (`--duration` must be the recorded run's).

A script, not a test (pytest collects `test_*.py` only): the TPU route costs
~10 s of interpreted kernel a device frame at REF_THREADS=1. It runs JAX on
the CPU with x64 enabled, as the test suite does.
"""

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from loop_reference import pallas_schur_on_cpu, run_capstone  # noqa: E402

import numpy as np  # noqa: E402


def tpu_logdet_route() -> None:
    """The JAX package's selector log-determinants through its Pallas kernel
    in interpret mode (the route a TPU takes), for batched inputs."""
    from anticipated_vins_mono_tpu.ops import lie
    from anticipated_vins_mono_tpu.ops import pallas_kernels as pk

    def logdet_psd(M, use_pallas: bool = True):
        if use_pallas and M.ndim == 3:
            return pk.logdet_psd_batched(M, interpret=True)
        return lie.logdet_psd(M)
    pk.logdet_psd = logdet_psd


def _jax_tree(arrays, prefix: str, cls):
    """The JAX NamedTuple `cls` from the arrays `chip_smoke.py` saved under
    `prefix/<field>` (a missing field is `None`)."""
    import jax.numpy as jnp
    from anticipated_vins_mono_tpu.ops import window as jwin
    nested = {"prior": jwin.PriorFactor, "lin": jwin.WindowState}
    fields = []
    for name in cls._fields:
        key = f"{prefix}/{name}"
        if name in nested:
            fields.append(_jax_tree(arrays, key, nested[name]))
        else:
            fields.append(jnp.asarray(arrays[key]) if key in arrays else None)
    return cls(*fields)


def _information(prior):
    J0, r0 = np.asarray(prior.J0, np.float64), np.asarray(prior.r0, np.float64)
    return J0.T @ J0, J0.T @ r0


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _recorded_run(path: str):
    """(arrays, hand-off frame, step indices, the JAX `vio_step` at the
    capstone's settings, jitted) for a run `chip_smoke.py` recorded."""
    import jax
    from anticipated_vins_mono_tpu.models import anticipation as jant
    from anticipated_vins_mono_tpu.models import estimator_device as jed
    from anticipated_vins_mono_tpu.ops import window as jwin
    os.environ["ANT_SELECT_IMPL"] = "chol"
    os.environ["ANT_SELECT_GROUP"] = "1"
    d = dict(np.load(path))
    steps = sorted({int(k.split("/")[0]) for k in d if k[0].isdigit()})
    pr = jed.DeviceVioParams(
        wcfg=jwin.WindowConfig(window=10, max_feats=128, iters=8,
                               accum="f64"),
        sel_cfg=jant.SelectorConfig(max_features=30))
    return d, int(d["handoff_frame"]), steps, jax.jit(
        functools.partial(jed.vio_step, pr))


def free_run(path: str, duration: float) -> None:
    """The JAX `vio_step` carrying its own state from the card's hand-off
    state over the card's recorded tracker measurements and IMU: its ATE
    beside the card's (the trackers of the two packages draw RANSAC
    differently; here both estimators see the same measurements)."""
    from anticipated_vins_mono_tpu.models import estimator_device as jed
    from anticipated_vins_mono_tpu.utils.metrics import ate_rmse
    from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
    d, handoff, steps, step = _recorded_run(path)
    t0 = time.perf_counter()
    jst = _jax_tree(d, "0/before", jed.DeviceVioState)
    p_jax, p_card, fails = [], [], 0
    for n in steps:
        jst, out = step(jst, *(d[f"{n}/in/{i}"] for i in range(10)))
        p_jax.append(np.asarray(out["p"], np.float64))
        p_card.append(np.asarray(d[f"{n}/after/p"], np.float64)[-2])
        fails += int(out["fail"])
    traj = loop_trajectory(duration, laps=duration / 10.0, radius=3.0)
    ts = traj.t[(handoff + np.asarray(steps)) * 20]
    print("FREE " + json.dumps({
        "path": path, "steps": len(steps), "handoff_frame": handoff,
        "jax_ate_rmse_m": float(ate_rmse(ts, np.stack(p_jax), traj.t,
                                         traj.p)),
        "card_ate_rmse_m": float(ate_rmse(ts, np.stack(p_card), traj.t,
                                          traj.p)),
        "card_ate_recorded_m": float(d["ate_rmse_m"]), "jax_fails": fails,
        "seconds": time.perf_counter() - t0}), flush=True)


def parity(path: str, dp_tol_m: float) -> None:
    """The JAX `vio_step` from each recorded state of the card's run, on the
    same inputs, against the card's next state."""
    from anticipated_vins_mono_tpu.models import estimator_device as jed
    d, handoff, steps, step = _recorded_run(path)
    first = None
    for n in steps:
        t0 = time.perf_counter()
        before = _jax_tree(d, f"{n}/before", jed.DeviceVioState)
        card = _jax_tree(d, f"{n}/after", jed.DeviceVioState)
        jst, _ = step(before, *(d[f"{n}/in/{i}"] for i in range(10)))
        ids_b = set(np.asarray(before.ids).tolist()) - {-1}
        adm_j = sorted(set(np.asarray(jst.ids).tolist()) - ids_b - {-1})
        adm_c = sorted(set(np.asarray(card.ids).tolist()) - ids_b - {-1})
        (I_j, b_j), (I_c, b_c) = _information(jst.prior), _information(
            card.prior)
        row = {"frame": handoff + n, "step": n,
               "ids_equal": bool(np.array_equal(np.asarray(jst.ids),
                                                np.asarray(card.ids))),
               "admitted_jax": len(adm_j), "admitted_card": len(adm_c),
               "admitted_shared": len(set(adm_j) & set(adm_c)),
               "dp_m": float(np.abs(np.asarray(jst.p, np.float64)
                                    - np.asarray(card.p, np.float64)).max()),
               "prior_info_rel": max(_rel(I_j, I_c), _rel(b_j, b_c)),
               "seconds": time.perf_counter() - t0}
        print("STEP " + json.dumps(row), flush=True)
        if first is None and not (row["ids_equal"]
                                  and row["dp_m"] <= dp_tol_m):
            first = row
    print("PARTS " + json.dumps({"path": path, "steps": len(steps),
                                 "dp_tol_m": dp_tol_m, "first": first}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--route", choices=("tpu", "cpu"), default="tpu")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--parity", metavar="STEPS.npz")
    ap.add_argument("--dp-tol", type=float, default=1e-3,
                    help="--parity: window positions that differ by more "
                         "than this (m) part")
    ap.add_argument("--free", action="store_true",
                    help="--parity: carry the JAX state from the hand-off "
                         "instead, and compare the ATE")
    args = ap.parse_args()
    if args.route == "tpu":
        tpu_logdet_route()
    pallas_schur_on_cpu()
    if args.parity and args.free:
        free_run(args.parity, args.duration)
        return
    if args.parity:
        parity(args.parity, args.dp_tol)
        return
    for s in args.seeds:
        row = run_capstone(args.duration, s, "float32", 30, False, 0.0, None)
        row = {"part": "capstone", "route": args.route, "pallas_schur": True,
               **row}
        print("REF " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
