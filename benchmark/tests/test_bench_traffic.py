"""Each traffic generator at a tiny size: deterministic in the seed, and
equal (to rounding) to the port's generator it was copied from."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import REPO

sys.path.insert(0, str(REPO))

BIG_SEED = 2**31 + 12345


def test_trajectories_equal_the_ports():
    from anticipated_vins_mono_torch.utils import synthetic
    from benchmark.traffic import trajectories
    for mine, port in ((trajectories.analytic_trajectory(3.0),
                        synthetic.analytic_trajectory(3.0)),
                       (trajectories.stopped_trajectory(3.0, 1.2),
                        synthetic.stopped_trajectory(3.0, 1.2))):
        for a, b in zip(mine, port):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["analytic", "stopped"])
def test_stream_is_deterministic_and_the_ports(kind):
    from anticipated_vins_mono_torch.models import estimator_device as ed
    from anticipated_vins_mono_torch.utils import sequence, synthetic
    from benchmark.traffic import stream, trajectories
    spec = {"kind": kind, "duration_s": 2.0, "stop_after_s": 1.2}
    traj = trajectories.trajectory(spec)
    make = lambda seed: stream.pack_stream(list(stream.SequenceSimulator(
        traj, seed=seed, pixel_noise=0.3, max_features=40).frames()), 40)
    a, b, c = make(BIG_SEED), make(BIG_SEED), make(BIG_SEED + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.pts, c.pts)
    port_traj = synthetic.analytic_trajectory(2.0) if kind == "analytic" \
        else synthetic.stopped_trajectory(2.0, 1.2)
    frames = list(sequence.SequenceSimulator(
        port_traj, seed=BIG_SEED, pixel_noise=0.3, max_features=40).frames())
    for t, fm in enumerate(frames):
        for x, y in zip(a, ed.pack_frame(fm, 40, device="cpu")):
            np.testing.assert_allclose(np.asarray(x[t], float),
                                       y.numpy().astype(float), atol=1e-12)


def test_window_problem_is_the_ports():
    from anticipated_vins_mono_torch.ops.window import WindowConfig
    from anticipated_vins_mono_torch.utils import synthetic
    from benchmark.traffic import window_problems as wp
    mine = wp.window_problem(4, 32, BIG_SEED, 0.5, 0.3)
    port = synthetic.make_window_problem(
        WindowConfig(window=4, max_feats=32), seed=BIG_SEED, pixel_noise=0.5,
        perturb=0.3, device="cpu")
    for k in wp.STATE_KEYS:
        torch.testing.assert_close(mine["gt"][k], getattr(port.gt, k),
                                   rtol=0, atol=1e-12)
        torch.testing.assert_close(mine["init"][k], getattr(port.init, k),
                                   rtol=0, atol=1e-12)
    for k, v in mine["meas"]["pre"].items():
        if v is not None:
            torch.testing.assert_close(v, getattr(port.meas.pre, k),
                                       rtol=0, atol=1e-12)
    for k in ("pts", "mask", "feat_valid", "anchor"):
        torch.testing.assert_close(mine["meas"][k].double(),
                                   getattr(port.meas, k).double(),
                                   rtol=0, atol=1e-12)


def test_scenario_batch_is_deterministic_and_distinct():
    from benchmark.traffic import window_problems as wp
    probs = [wp.window_problem(4, 32, s, 0.5, 0.3)
             for s in wp.problem_seeds(BIG_SEED, 2)]
    a = wp.scenario_batch(probs, 5, BIG_SEED, 0.3, "cpu")
    b = wp.scenario_batch(probs, 5, BIG_SEED, 0.3, "cpu")
    torch.testing.assert_close(a["init"]["p"], b["init"]["p"], rtol=0, atol=0)
    # elements 0 and 2 share a problem and differ in their perturbation
    torch.testing.assert_close(a["gt"]["p"][0], a["gt"]["p"][2])
    assert not torch.equal(a["init"]["p"][0], a["init"]["p"][2])
    # the gauge: the first pose is the ground truth's
    torch.testing.assert_close(a["init"]["p"][:, 0], a["gt"]["p"][:, 0])
