"""Run one cell several times, one process after another, and keep each
run's result: for the spreads behind the bounds and the readings behind
the correctness limits.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \
        --seconds 45 [--trace 1] [--control tf32] [--fault unchanged] \
        [--out <file>.jsonl]

Each run is `benchmark/run.py` in a process of its own; its result line,
its exit code and the end of its standard error go to `--out`, one JSON
object a line, and one summary line a run is printed.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    out = open(a.out, "a") if a.out else None
    worst = 0
    for seed in a.seeds:
        cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
               "--workload", a.workload, "--seed", str(seed),
               "--seconds", str(a.seconds), "--trace", str(a.trace)]
        if a.control:
            cmd += ["--control", a.control]
        if a.fault:
            cmd += ["--fault", a.fault]
        t0 = time.monotonic()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        rec = {"workload": a.workload, "seed": seed, "trace": a.trace,
               "control": a.control, "fault": a.fault, "rc": p.returncode,
               "wall_s": time.monotonic() - t0, "result": res,
               "stderr": p.stderr[-6000:]}
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        worst = max(worst, p.returncode)
        if res is None:
            print(f"{a.workload} seed {seed}: rc {p.returncode}, no result\n"
                  + p.stderr[-3000:], flush=True)
            continue
        ms = {k: v["value"] for k, v in res["metrics"].items()}
        cs = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"cell": a.workload, "seed": seed,
                          "correct": res["correct"], "wall_s":
                          round(rec["wall_s"], 1), "metrics": ms,
                          "checks": cs}), flush=True)
    if out:
        out.close()
    return worst


if __name__ == "__main__":
    sys.exit(main())
