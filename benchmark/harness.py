"""The harness: finds a cell's pieces by name, runs its runner, reads the
per-layer metrics and prints the result.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. Its
configuration's file `configs/<config>.json` names the runner
(`runners/<runner>.py`) that runs that kind of work; its traffic file is
`workloads/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`, whose `read(ctx)` returns a number or None. Adding a
cell, a configuration or a metric therefore adds files and entries and
edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "anticipated_vins_mono_tpu")
HERE = Path(__file__).resolve().parent


@dataclass
class Check:
    """One number the correctness check compared, and its limit: the check
    passes where value ≤ limit (an exact comparison has the limit 0)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    control: str = None
    fault: str = None
    t0: float = 0.0


@dataclass
class RunResult:
    attempted: int
    failed: int
    e2e: dict                        # end-to-end metric name → value
    checks: list                     # [Check]
    memory_peak_bytes: int = 0
    trace: object = None             # trace.Trace of the traced units
    counters: dict = field(default_factory=dict)


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, name: str, bench_dir: Path = HERE):
    """(workload entry, configuration entry, configuration file, traffic
    file, end-to-end metric entries, per-layer metric entries) of cell
    `name`, each found by its name."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((bench_dir / "configs" / f"{cfg['name']}.json")
                        .read_text())
    traffic = json.loads((bench_dir / "workloads" / f"{name}.json")
                         .read_text())
    mine = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in spec["end_to_end"] if mine(m)]
    per_layer = [m for m in spec["per_layer"] if mine(m)]
    return wl, cfg, config, traffic, e2e, per_layer


def reader(metric: str, bench_dir: Path = HERE):
    """The `read` function of `metrics/<metric>.py`."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(name: str):
    return importlib.import_module(f"benchmark.runners.{name}")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def run(args, root: Path, t0: float) -> int:
    spec = load_spec(root)
    wl, _, config, traffic, e2e, per_layer = cell_parts(spec, args.workload)
    import torch
    stage(t0, "torch imported")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only",
                  file=sys.stderr)
            return 1
        if torch.cuda.device_count() < wl["chips"]:
            print(f"the cell needs {wl['chips']} devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
    cell = Cell(name=args.workload, config=config, traffic=traffic,
                seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                device=args.device, control=args.control, fault=args.fault,
                t0=t0)
    res = runner(config["runner"]).run(cell)
    if args.device == "cuda":
        # read after the run: `nvidia-smi` is a process of its own and
        # would count in set-up
        note(f"card: {_card_line()}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")

    bad = forbidden_modules()
    if bad:
        print("modules of JAX or of the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 1

    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    metrics = {}
    if cell.trace:
        ctx = SimpleNamespace(trace=res.trace, counters=res.counters,
                              config=config, traffic=traffic, cell=cell.name)
        for m in per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in e2e:
            if m["name"] in res.e2e:
                metrics[m["name"]] = {"value": res.e2e[m["name"]],
                                      "unit": units[m["name"]]}
    correct = all(c.ok for c in res.checks) and bool(res.checks)
    device = {"platform": "gpu" if cell.device == "cuda" else cell.device,
              "kind": torch.cuda.get_device_name() if cell.device == "cuda"
              else cell.device,
              "count": wl["chips"],
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    out = {"correct": correct, "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": device}
    if cell.trace and res.trace is not None:
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.window_s
        out["breakdown"] = {"device_ops": res.trace.device_ops,
                            "idle_gaps": res.trace.idle_gaps}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in res.checks}
    for c in res.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


class HostWatch:
    """What the host gave the process over the window, for the notes: the
    share of the window's wall time the process ran on a core, the context
    switches the scheduler forced on it, the load average, and the rate of
    units in each fifth of the window. None of it is a metric."""

    def __init__(self):
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu = time.process_time()
        self.t0 = time.monotonic()
        self.ends = []

    def unit_done(self):
        self.ends.append(time.monotonic())

    def note(self, unit: str) -> None:
        wall = time.monotonic() - self.t0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        fifths = [0] * 5
        for t in self.ends:
            fifths[min(4, int(5 * (t - self.t0) / wall))] += 1
        note(f"host over the window: cpu {time.process_time() - self.cpu:.3f}"
             f" s of {wall:.3f} s wall, involuntary switches "
             f"{ru.ru_nivcsw - self.ru.ru_nivcsw}, voluntary "
             f"{ru.ru_nvcsw - self.ru.ru_nvcsw}, load "
             f"{' '.join(f'{x:.2f}' for x in os.getloadavg())}, cores "
             f"{len(os.sched_getaffinity(0))}; {unit} per fifth of the "
             f"window {fifths}")


def stage(t0: float, name: str) -> None:
    """A note of how far set-up has come: wall seconds since the process
    started, the process's CPU seconds and its major page faults (pages
    read from disk) so far. Not a metric."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    note(f"set-up stage {name}: {time.monotonic() - t0:.3f} s wall, cpu "
         f"{time.process_time():.3f} s, major faults {ru.ru_majflt}")


def note(text: str) -> None:
    """An earlier line of the run's standard error."""
    print(text, file=sys.stderr, flush=True)
