"""The benchmark of `anticipated_vins_mono_torch` on one NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json` once. Everything a cell is made
of is found by name: a configuration in `configs/<config>.json`, a traffic
mix in `workloads/<cell>.json`, the runner that runs the configuration's
kind of work in `runners/<runner>.py`, and each per-layer metric's reader
in `metrics/<metric>.py`. The yardstick lives here too: the traffic
generators (`traffic/`), the plain float64 reference (`reference/`), the
work functions and peaks (`work.py`) and the reduction of the profiler's
trace (`trace.py`).
"""
