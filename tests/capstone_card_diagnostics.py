"""The capstone runner on the card with one input substituted: what
decides its ATE. Needs one CUDA card; runs from the root of a checkout.

    python tests/capstone_card_diagnostics.py --replay-tracker PREFIX \
        --seeds 0 1 2 3 4
    python tests/capstone_card_diagnostics.py --cpu-render --seeds 0 1 2 3 4
    python tests/capstone_card_diagnostics.py --pin-extrinsic --seeds 0

Each seed is one run of `chip_smoke.capstone_run` (float32, both kernels,
8 s at 752×480, κ̄ = 30 "chol"), a process of its own, five at once, with:

`--replay-tracker PREFIX`: the estimator takes the measurements recorded in
`{PREFIX}_seed{SEED}.npz` (ids, rays, vel, prob, active a frame, as
`tests/tracker_stream_reference.py --cache` and `chip_smoke.py
--capstone-seeds ... --record-tracker` write them) in place of the
tracker's own; the tracker still runs. `--cpu-render`: the circuit's
frames are rendered on the CPU and moved to the card (the tracker and the
estimator still run on the card). `--pin-extrinsic`: the runner's window
holds the camera-IMU extrinsic at its known value
(`WindowConfig(estimate_extrinsic=False)`, as the loop benchmark runs).

One line `{"capstone_run": {...}}` a seed, then a summary line with the
ATEs. A script, not a test: pytest collects `test_*.py` only.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIELDS = ("ids", "rays", "vel", "prob", "active")


def replay_tracker_stream(td, path: str):
    """Wrap `tracker_init` and `tracker_step` of the tracker module `td` so
    that frame after frame they hand on the measurements recorded in `path`
    in place of their own."""
    import numpy as np
    import torch
    z = np.load(path)
    rec = [torch.from_numpy(z[f]).cuda() for f in FIELDS]
    init, step, n = td.tracker_init, td.tracker_step, [0]

    def tracker_init(*args, **kw):
        st = init(*args, **kw)
        n[0] = 1
        return st._replace(ids=rec[0][0], norm=rec[1][0][:, :2],
                           score=rec[3][0], active=rec[4][0])

    def tracker_step(*args, **kw):
        st, _ = step(*args, **kw)
        n[0] += 1
        return st, tuple(x[n[0] - 1] for x in rec)

    td.tracker_init, td.tracker_step = tracker_init, tracker_step


def one_run(a) -> int:
    """One seed in this process, with the substitutions of `a` in place."""
    import chip_smoke
    from anticipated_vins_mono_torch.models import tracker_device as td
    from anticipated_vins_mono_torch.utils import device_vio_bench as dvb
    seed = a.seeds[0]
    if a.replay_tracker:
        replay_tracker_stream(td, f"{a.replay_tracker}_seed{seed}.npz")
    if a.pin_extrinsic:
        window_config = dvb.WindowConfig
        dvb.WindowConfig = lambda **kw: window_config(
            **kw, estimate_extrinsic=False)
    if a.cpu_render:
        render_circuit = dvb.render_circuit

        def cpu_rendered(duration, width, height, laps, device):
            cam, traj, _, ts, imu = render_circuit(duration, width, height,
                                                   laps, device)
            imgs = render_circuit(duration, width, height, laps, "cpu")[2]
            return cam, traj, imgs.to(device), ts, imu
        dvb.render_circuit = cpu_rendered
    return chip_smoke.capstone_run("float32_schur_kernel", seed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--replay-tracker", default=None)
    ap.add_argument("--cpu-render", action="store_true")
    ap.add_argument("--pin-extrinsic", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        return one_run(a)
    flags = [x for x, on in (("--cpu-render", a.cpu_render),
                             ("--pin-extrinsic", a.pin_extrinsic)) if on]
    if a.replay_tracker:
        flags += ["--replay-tracker", a.replay_tracker]
    ates = {}
    for lo in range(0, len(a.seeds), 5):
        procs = [(seed, subprocess.Popen(
            [sys.executable, __file__, "--one", "--seeds", str(seed), *flags],
            cwd=ROOT, stdout=subprocess.PIPE, text=True))
            for seed in a.seeds[lo:lo + 5]]
        try:
            for seed, proc in procs:
                out, _ = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    raise SystemExit(f"seed {seed}: exit {proc.returncode}")
                line = out.strip().splitlines()[-1]
                print(line, flush=True)
                ates[seed] = json.loads(line)["capstone_run"]["rows"][
                    "ate_rmse_m"]
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    print(json.dumps({"flags": flags, "ate_rmse_m": ates}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
