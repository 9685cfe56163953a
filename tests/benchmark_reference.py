"""Reference readings of the JAX package's EuRoC benchmark runner on the
CPU, over a ground-truth CSV written from `analytic_trajectory` (the EuRoC
files are not in the repository): the numbers `chip_smoke.py`'s `euroc`
bound is set from.

    python tests/benchmark_reference.py benchmark --seeds 0 1 2 3 4
    python tests/benchmark_reference.py parting --seeds 0 1 2 3 4

`benchmark`: the JAX `utils.benchmark.run_one` as `chip_smoke.py`'s `euroc`
phase calls the port's — 12 s of `analytic_trajectory` written as
`SIM/data.csv` (`utils.synthetic.write_euroc_csv`, its default biases),
`policy="anticipate"`, κ̄ = 30, `max_seconds=8`, `dtype="f32"` (the JAX
package's f32 path accumulates in df32, the port's in f64), the runner's own
window (10 keyframes, 192 slots) — one JSON line per `seed` (the
simulator's and the selector's seed). The card's bound is 1.5 × the
largest ATE.

`parting`: where the two packages' `run_one` part, at the size of
`tests/test_torch_benchmark.py` (window 4 with 48 slots, 1.6 s, κ̄ = 10
over 40 detections, float64), per `seed` at 0.3 and 0.5 px (`--pixel-noise`).
It runs the port twice, at 1 and 4 torch threads (another summation order
in `eigh` and the products), and the JAX package once, and prints per
frame the largest position difference port − JAX and port − port. It also
reads the first marginalization: the largest eigenvalue of the port's
dropped block H_dd, the count of H_dd eigenvalues kept by the reference's
absolute cut (`EIG_EPS` = 1e-8) yet below 1e-4 (under f64 rounding
of λmax ≈ 1e11, eps·λmax ≈ 2e-5), and the rank of each package's prior.

A script, not a test (pytest collects `test_*.py` only). It runs JAX on the
CPU with x64 enabled, as the test suite does; `REF_THREADS` sets its
thread count (default 4).
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEQ = "SIM"
# chip_smoke.py's `euroc` call
BENCH = dict(policy="anticipate", kappa=30, max_seconds=8.0, dtype="f32")
BENCH_GT_SECONDS = 12.0
# tests/test_torch_benchmark.py's size
PARTING_WINDOW = dict(window=4, max_feats=48)
PARTING_RUN = dict(policy="anticipate", kappa=10, max_seconds=1.6,
                   detect_count=40, n_landmarks=3000, dtype="f64")
PARTING_GT_SECONDS = 3.0


def write_sequence(root: str, seconds: float) -> None:
    """`<root>/SIM/data.csv`: `seconds` of the analytic trajectory."""
    from anticipated_vins_mono_torch.utils.synthetic import (
        analytic_trajectory, write_euroc_csv)
    os.makedirs(os.path.join(root, SEQ), exist_ok=True)
    write_euroc_csv(os.path.join(root, SEQ, "data.csv"),
                    analytic_trajectory(seconds))


def run_benchmark(seed: int) -> dict:
    from anticipated_vins_mono_tpu.utils import benchmark, euroc
    root = tempfile.mkdtemp()
    write_sequence(root, BENCH_GT_SECONDS)
    euroc.REFERENCE_GT_DIR = root
    t0 = time.perf_counter()
    row = benchmark.run_one(SEQ, seed=seed, **BENCH)
    return {"part": "benchmark", **row, "seconds": time.perf_counter() - t0}


def run_parting(seed: int, pixel_noise: float) -> dict:
    import numpy as np
    import torch
    from anticipated_vins_mono_tpu.models import estimator as jest
    from anticipated_vins_mono_tpu.ops import window as jwindow
    from anticipated_vins_mono_tpu.utils import benchmark as jbench
    from anticipated_vins_mono_tpu.utils import euroc as jeuroc
    from anticipated_vins_mono_torch.models import estimator as test
    from anticipated_vins_mono_torch.ops import marginalization as tmg
    from anticipated_vins_mono_torch.ops import window as twindow
    from anticipated_vins_mono_torch.utils import benchmark, euroc
    root = tempfile.mkdtemp()
    write_sequence(root, PARTING_GT_SECONDS)
    for mod in (euroc, jeuroc):
        mod.REFERENCE_GT_DIR = root
    for mod, cfg in ((benchmark, twindow.WindowConfig),
                     (jbench, jwindow.WindowConfig)):
        mod.WindowConfig = (lambda _c: lambda **kw: _c(**{**kw, **PARTING_WINDOW}))(cfg)
    seen = {}

    def capture(tag, mod):
        def write_tum(path, t, p, q):
            seen[tag] = np.asarray(p, float)
        mod.write_tum = write_tum

    def first_prior(tag, mod):
        orig = mod.mg.marginalize_oldest

        def wrap(*a, **k):
            prior = orig(*a, **k)
            J0 = prior.J0
            J0 = J0.cpu().numpy() if torch.is_tensor(J0) else np.asarray(J0)
            seen.setdefault(tag + "_rank", int(np.linalg.matrix_rank(
                J0, 1e-12 * np.abs(J0).max())))
            return prior
        mod.mg.marginalize_oldest = wrap

    orig_schur = tmg._masked_schur

    def masked_schur(H, b, drop_mask):
        if "hdd" not in seen:
            m = drop_mask.to(torch.float64)
            w = torch.linalg.eigvalsh(H.to(torch.float64) * m[:, None]
                                      * m[None, :]).cpu().numpy()
            seen["hdd"] = (float(w.max()), int(((w > tmg.EIG_EPS)
                                                & (w < 1e-4)).sum()))
        return orig_schur(H, b, drop_mask)

    tmg._masked_schur = masked_schur
    first_prior("port", test)
    first_prior("jax", jest)
    run = dict(PARTING_RUN, seed=seed, pixel_noise=pixel_noise,
               out_dir=os.path.join(root, "out"))
    threads = torch.get_num_threads()
    rows = {}
    for tag, mod, kw in (("port", benchmark, dict(device="cpu")),
                         ("jax", jbench, {})):
        capture(tag, mod)
        torch.set_num_threads(1)
        rows[tag] = mod.run_one(SEQ, **run, **kw)
    hdd = seen["hdd"]
    capture("port4", benchmark)
    torch.set_num_threads(4)
    benchmark.run_one(SEQ, device="cpu", **run)
    torch.set_num_threads(threads)
    tmg._masked_schur = orig_schur

    def dev(a, b):
        if a.shape != b.shape:
            return None
        return [float(x) for x in np.abs(a - b).max(axis=1)]

    vs_jax, vs_self = dev(seen["port"], seen["jax"]), dev(seen["port"],
                                                          seen["port4"])
    first = None if vs_jax is None else next(
        (k for k, x in enumerate(vs_jax) if x > 1e-6), None)
    return {"part": "parting", "seed": seed, "pixel_noise": pixel_noise,
            "frames": [rows["port"]["frames"], rows["jax"]["frames"]],
            "failures": [rows["port"]["failures"], rows["jax"]["failures"]],
            "first_frame_over_1e-6_vs_jax": first,
            "max_dp_vs_jax_m": None if vs_jax is None else max(vs_jax),
            "max_dp_vs_port_4_threads_m":
                None if vs_self is None else max(vs_self),
            "dp_vs_jax_m": vs_jax, "dp_vs_port_4_threads_m": vs_self,
            "first_margin_hdd_max_eig": hdd[0],
            "first_margin_hdd_kept_below_1e-4": hdd[1],
            "first_prior_rank": [seen["port_rank"], seen["jax_rank"]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("part", choices=("benchmark", "parting"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--pixel-noise", type=float, nargs="+",
                    default=[0.3, 0.5])
    args = ap.parse_args()
    from anticipated_vins_mono_tpu.utils.jaxenv import force_cpu_f64
    force_cpu_f64(threads=int(os.environ.get("REF_THREADS", "4")))
    if args.part == "parting":
        for px in args.pixel_noise:
            for s in args.seeds:
                print("REF " + json.dumps(run_parting(s, px)), flush=True)
        return
    for s in args.seeds:
        print("REF " + json.dumps(run_benchmark(s)), flush=True)


if __name__ == "__main__":
    main()
