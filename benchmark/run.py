"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With `--trace 0` the result's metrics are the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read from
a `torch.profiler` trace of the first units of the window. The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`: each
number the correctness check compared, with its limit); the same numbers
are the last lines of standard error. The run exits 1 and prints no result
where there is no CUDA device or fewer than the cell asks for, and where a
module of JAX or of the JAX package is loaded once the window has closed.

`--device cpu`, `--control` and `--fault` serve the benchmark's own tests
and the calibration of its limits; the benchmark's runs never pass them.
"""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode cache, like every build cache, at a fixed path inside
# the checkout: where the installed packages have no bytecode and may not
# be written to, or the environment forbids writing it, every run would
# compile the sources of torch's modules again (seconds of set-up)
PYCACHE = str(ROOT / "build" / "pycache")
sys.pycache_prefix = PYCACHE
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import argparse  # noqa: E402


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--control", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")
    # one host thread for the CPU work of set-up and the check (traffic,
    # the check's reductions): a pool of spinning threads on the host's
    # shared cores makes set-up's time swing with the other tenants' load
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness
    return harness.run(args, ROOT, T0)


if __name__ == "__main__":
    sys.exit(main())
