"""Batch-scaling curve of the window solver on one card.

Counterpart of `anticipated_vins_mono_tpu/utils/bench_curve.py`: aggregate
LM iterations/s of the batched `lm_solve` across scenario-batch sizes (the
scaling axis of batching) at the flagship shape — 10-keyframe window, 128
landmark slots, 8 LM iterations, `make_window_problem(seed 0, perturb 0.3,
pixel_noise 0.5)` in float32 — and the share of the card's FP32 peak the
solve reaches. B = 64 is the row `bench.py` reports.

`fused_schur=True` (the counterpart of the JAX `pallas_schur`) solves every
LM iteration's reduced system with one launch of the fused Schur kernel
over the whole batch; `False` takes the f64 `schur_solve`.

The operation count is not XLA's `cost_analysis()` (there is none): it is
`torch.utils.flop_counter.FlopCounterMode` over one solve — the products,
batched products and einsums of the aten part — plus, on a CUDA device,
`hopper_kernels.schur_work`'s count for every Schur kernel launch, which
the counter cannot see (on the CPU the wrapper runs its plain version, whose
products the counter sees). It leaves out the linear algebra library calls
(`cholesky`, `cholesky_solve`, `eigh`) and all elementwise work, so the
share of the peak is a lower bound.

Rows carry the JAX row's keys, with two renamed: `xla_flops_per_solve` →
`flops_per_solve` (the count above) and `compile_s` → `first_solve_s` (the
untimed first solve: kernel build at first use, allocator, cuSOLVER
handles; there is no compile step). Each row also carries the card's name
and power limit as `nvidia-smi` prints them.

    python3 -m anticipated_vins_mono_torch.utils.bench_curve 16 64 128 256 512 \
        --out bench_curve.json [--f64-schur]
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

import torch

from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops.window import WindowConfig, lm_solve
from anticipated_vins_mono_torch.utils.synthetic import (batched,
                                                         make_window_problem)

CERES_BASELINE_ITERS_PER_S = 8 / 0.030
# one H100 SXM's published FP32 peak without tensor cores (NVIDIA data
# sheet): the solve runs float32 CUDA-core arithmetic
PEAK_F32_FLOPS = 67e12

FLAGSHIP = WindowConfig(window=10, max_feats=128, iters=8, fast_chol=True)


def nvidia_smi() -> Optional[str]:
    """The card's name and power limit, as `nvidia-smi` prints them; None
    without a CUDA device."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def count_flops(state, meas, cfg: WindowConfig, device) -> float:
    """Operations of one `lm_solve` of the batch, as the module docstring
    says: the aten products counted by `FlopCounterMode`, plus the Schur
    kernel's `schur_work` per launch on a CUDA device."""
    from torch.utils.flop_counter import FlopCounterMode
    device = torch.device(device)
    before = hk.launch_counts["schur_solve_fused"]
    with FlopCounterMode(display=False) as counter:
        lm_solve(state, meas, cfg, device=device)
    _sync(device)
    flops = float(counter.get_total_flops())
    if device.type == "cuda":
        B = state.p.shape[0]
        launches = hk.launch_counts["schur_solve_fused"] - before
        flops += launches * B * hk.schur_work(cfg.dim, cfg.max_feats)[1]
    return flops


def run_curve(batch_sizes=(16, 64, 128, 256, 512), reps: int = 10,
              out_path: Optional[str] = None, fused_schur: bool = True,
              device="cuda", cfg: Optional[WindowConfig] = None,
              dtype=torch.float32, return_outputs: bool = False):
    """One row per batch size B (module docstring). `cfg` defaults to the
    flagship shape (tests pass a smaller one), `dtype` to float32; the
    kernel route needs float32. Writes the rows as JSON to `out_path` when
    one is given. With `return_outputs`, also returns {B: (state, diag)} of
    the last timed solve."""
    device = torch.device(device)
    cfg = (cfg or FLAGSHIP)._replace(fused_schur=fused_schur)
    prob = make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                               dtype=dtype, device=device)
    smi = nvidia_smi() if device.type == "cuda" else None
    rows, outputs = [], {}
    for B in batch_sizes:
        state, meas = batched(prob.init, B), batched(prob.meas, B)
        launches0 = hk.launch_counts["schur_solve_fused"]
        _sync(device)
        t0 = time.perf_counter()
        lm_solve(state, meas, cfg, device=device)
        _sync(device)
        first_s = time.perf_counter() - t0
        flops = count_flops(state, meas, cfg, device)
        # launches back to back, one synchronisation at the end
        t0 = time.perf_counter()
        for _ in range(reps):
            out = lm_solve(state, meas, cfg, device=device)
        _sync(device)
        dt = (time.perf_counter() - t0) / reps
        iters_per_s = B * cfg.iters / dt
        row = {
            "B": B,
            "iters_per_s": iters_per_s,
            "vs_ceres": iters_per_s / CERES_BASELINE_ITERS_PER_S,
            "ms_per_batched_solve": dt * 1e3,
            "flops_per_solve": flops,
            "mfu_f32": flops / dt / PEAK_F32_FLOPS,
            "first_solve_s": first_s,
            "fused_schur": fused_schur,
            "solves": reps + 2,
            "schur_launches": hk.launch_counts["schur_solve_fused"] - launches0,
            "device": str(device),
            "nvidia_smi": smi,
        }
        rows.append(row)
        outputs[B] = out
        print(json.dumps(row), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1)
    return (rows, outputs) if return_outputs else rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("batch_sizes", nargs="*", type=int,
                    default=[16, 64, 128, 256, 512])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    ap.add_argument("--f64-schur", action="store_true",
                    help="the f64 schur_solve instead of the fused kernel")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run_curve(tuple(a.batch_sizes), a.reps, a.out,
              fused_schur=not a.f64_schur, device=a.device)
