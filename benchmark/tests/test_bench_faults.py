"""The correctness check fails a broken timed path. Each run skips the
look for a card (`--device cpu`) and drives the rest of a run at a size the
CPU holds (`conftest.TINY_LIMITS`); one fault is planted underneath the
timed path: a step that returns its state unchanged, half of the batch left
out (its answers copied from the other half), answers altered where they are
produced (every scenario's newest position 1 cm off; the prior's square-root
information 1 % off). The cells run on one chip: there is no exchange between chips to
leave out. The sound run of each cell passes."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import run_cell

CASES = [("tiny_ba.b4", None, True), ("tiny_ba.b4", "unchanged", False),
         ("tiny_ba.b4", "half_batch", False), ("tiny_ba.b4", "altered", False),
         ("tiny_vio.moving", None, True),
         ("tiny_vio.moving", "unchanged", False),
         ("tiny_vio.moving", "altered", False)]


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_fault_is_caught(checkout, cell, fault, correct):
    extra = ("--fault", fault) if fault else ()
    rc, res, err = run_cell(checkout, cell, *extra, seconds=1.0, seed=11)
    assert rc == 0, err
    assert res["correct"] is correct, err


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["euroc_vio.moving", "euroc_window_ba.b64",
                                  "euroc_window_ba.b512"])
def test_control_is_not_correct(card, cell):
    """The control (the reference in float32 with TF32 products in the
    program's place) on the card at the cell's own size, three seeds: it
    exists only on the card, where TF32 does."""
    import json
    import subprocess
    import sys
    from benchmark.tests.conftest import REPO
    for seed in (9001, 9002, 9003):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
             str(seed), "--seconds", "10", "--trace", "0", "--control",
             "tf32"], cwd=REPO, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr
        assert json.loads(p.stdout.splitlines()[-1])["correct"] is False
