"""Nothing the benchmark runs imports JAX or the JAX package: the runner,
the harness, every runner and every reader, imported in a fresh process,
leave no module whose top-level name is one of them."""

from __future__ import annotations

import subprocess
import sys

from benchmark.tests.conftest import REPO

PROBE = r"""
import sys, pathlib
sys.path.insert(0, {repo!r})
import benchmark.run, benchmark.harness as h, benchmark.calibrate
for p in pathlib.Path({repo!r}, "benchmark", "runners").glob("*.py"):
    h.runner(p.stem) if p.stem != "__init__" else None
for p in pathlib.Path({repo!r}, "benchmark", "metrics").glob("*.py"):
    h.reader(p.stem) if p.stem != "__init__" else None
import anticipated_vins_mono_torch.models.estimator_device
import anticipated_vins_mono_torch.ops.window
import anticipated_vins_mono_torch.ops.hopper_kernels
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in h.FORBIDDEN)))
"""


def test_nothing_imports_jax():
    p = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(REPO))
    from benchmark import harness
    sys.modules.setdefault("anticipated_vins_mono_torch_fake", sys)
    try:
        assert "anticipated_vins_mono_torch_fake" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["anticipated_vins_mono_torch_fake"]
