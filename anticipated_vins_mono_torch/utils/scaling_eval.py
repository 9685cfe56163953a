"""Multi-rank scaling-efficiency measurement.

Counterpart of `anticipated_vins_mono_tpu/utils/scaling_eval.py`: weak
scaling of `parallel.sharded.sharded_lm_solve` over dp = 1, 2, 4 ranks
(fp = 1), a fixed batch per rank of the flagship problem in float64,
aggregate solves/s from `parallel.distributed.scaling_report`. dp sharding
carries no collectives inside the solve, so the efficiency lost is the
ranks' contention for what they share. The JAX version forces 8 virtual
CPU devices; here each rank is a process (`spawn_ranks`) on `device`.

Caveat printed with the result: on one card every rank shares the device
(and the host's cores), so one card cannot show scaling; the curve is a
lower bound of what ranks on cards of their own would reach.

    python3 -m anticipated_vins_mono_torch.utils.scaling_eval --out scaling.json
"""

from __future__ import annotations

import json
import os

import torch

DPS = (1, 2, 4)
CAVEAT = ("every rank shares one device and the host's cores: one card "
          "cannot show scaling, this curve is a lower bound")


def scaling_rank(rank, n_ranks, per_device_batch: int, reps: int, device):
    """Worker: this rank's `per_device_batch` flagship scenarios through
    `scaling_report` on a (n_ranks, 1) mesh."""
    from anticipated_vins_mono_torch.ops.window import WindowConfig
    from anticipated_vins_mono_torch.parallel.distributed import (
        scaling_report)
    from anticipated_vins_mono_torch.parallel.sharded import (
        make_mesh, sharded_lm_solve)
    from anticipated_vins_mono_torch.utils.synthetic import (
        batched, make_window_problem)
    cfg = WindowConfig(window=10, max_feats=128, iters=8)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               device=device)
    mesh = make_mesh(n_ranks, 1)
    state = batched(prob.init, per_device_batch)
    meas = batched(prob.meas, per_device_batch)
    return scaling_report(sharded_lm_solve(cfg, mesh), state, meas, reps=reps)


def main(per_device_batch: int = 8, reps: int = 10, out: str | None = None,
         device="cuda"):
    from anticipated_vins_mono_torch.parallel.distributed import spawn_ranks
    rows = []
    for dp in DPS:
        rep = spawn_ranks(scaling_rank, dp, per_device_batch, reps,
                          str(device))[0]
        rep["dp"] = dp
        rows.append(rep)
        print(json.dumps(rep), flush=True)

    base = rows[0]["solves_per_s"]
    for r in rows:
        r["efficiency"] = r["solves_per_s"] / (base * r["dp"])
    result = {"per_device_batch": per_device_batch,
              "physical_cores": os.cpu_count(),
              "device": str(device),
              "cards": torch.cuda.device_count(),
              "rows": rows,
              "efficiency_dp2": rows[1]["efficiency"],
              # the JAX module's `efficiency_dp8`: its sweep ends at 8
              # virtual devices, this one at the last of DPS
              "efficiency_dp_max": rows[-1]["efficiency"],
              "caveat": CAVEAT}
    print(json.dumps(result))
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.per_device_batch, a.reps, a.out, device=a.device)
