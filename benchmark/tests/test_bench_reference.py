"""The reference (the frozen float64 copy) against the port's float64 path
on the CPU at a small size: the batched window solve, the streaming step
from the same state (with its own selection, and with the selection given),
and the start."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import REPO

sys.path.insert(0, str(REPO))
F64 = torch.float64


def test_lm_solve_equals_the_ports():
    from anticipated_vins_mono_torch.ops import preintegration, window
    from benchmark.runners import window_ba
    from benchmark.reference import preintegration as rpre
    from benchmark.reference import window as rwin
    from benchmark.traffic import window_problems as wp
    probs = [wp.window_problem(4, 32, s, 0.5, 0.3)
             for s in wp.problem_seeds(3, 2)]
    batch = wp.scenario_batch(probs, 3, 3, 0.3, "cpu")
    kw = dict(window=4, max_feats=32, iters=3)
    pc, rc = window.WindowConfig(**kw), rwin.WindowConfig(**kw)
    ps, pm = window_ba._containers(window, preintegration, batch, pc, F64,
                                   "cpu")
    rs, rm = window_ba._containers(rwin, rpre, batch, rc, F64, "cpu")
    po, pd = window.lm_solve(ps, pm, pc, device="cpu")
    ro, rd = rwin.lm_solve(rs, rm, rc, device="cpu")
    torch.testing.assert_close(ro.p, po.p, rtol=0, atol=1e-10)
    torch.testing.assert_close(rd["cost"], pd["cost"], rtol=1e-10, atol=0)


@pytest.fixture(scope="module")
def stream_case():
    from anticipated_vins_mono_torch.models import anticipation as ant
    from anticipated_vins_mono_torch.models import estimator_device as ed
    from anticipated_vins_mono_torch.ops import window
    from benchmark.runners import vio_stream
    from benchmark.reference import anticipation as rant
    from benchmark.reference import estimator_device as red
    from benchmark.reference import window as rwin
    from benchmark.traffic import stream, trajectories
    cfg = dict(WINDOW_SIZE=4, max_feats=64, max_cnt=40, max_features=40,
               max_num_iterations=2, HORIZON=13, sel_n_imu=20,
               sel_dt_imu=0.005, keyframe_parallax=10.0, focal_px=460.0,
               fused_schur=False, sel_impl="chol")
    traj = trajectories.analytic_trajectory(2.0)
    packed = stream.pack_stream(list(stream.SequenceSimulator(
        traj, seed=5, pixel_noise=0.3, max_features=40).frames()), 40)
    frames = [tuple(torch.from_numpy(np.asarray(x[t])) if x.dtype.kind in "ib"
                    else torch.from_numpy(x[t]).to(F64) for x in packed)
              for t in range(len(packed.ids))]
    pp = vio_stream._params(ed, ant, window, cfg)
    rp = vio_stream._params(red, rant, rwin, cfg)
    first = {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}
    ps = ed.vio_init_oracle(pp, first, frames[:4], device="cpu")
    rs = red.vio_init_oracle(rp, first, frames[:4], device="cpu")
    return dict(ed=ed, red=red, pp=pp, rp=rp, ps=ps, rs=rs, frames=frames,
                to_ref=lambda tree: vio_stream.convert.retype(
                    tree, vio_stream.REF_TYPES))


def test_start_equals_the_ports(stream_case):
    c = stream_case
    for a, b in zip(c["ps"][:15], c["rs"][:15]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-12)


def test_step_equals_the_ports(stream_case):
    """Four steps: the reference's own selection, and the selection given
    as the port's inserted candidates, both equal the port's step."""
    from benchmark.runners import vio_stream
    c = stream_case
    ps = c["ps"]
    admitted = 0
    for t in range(4, 8):
        fr = c["frames"][t]
        new, out = c["ed"].vio_step(c["pp"], ps, *fr, device="cpu")
        rin = c["to_ref"](ps)
        own, rout = c["red"].vio_step(c["rp"], rin, *fr, device="cpu")
        picks = vio_stream._inserted(rin, c["to_ref"](new), fr)
        given, _ = c["red"].vio_step(c["rp"], rin, *fr, device="cpu",
                                     picks=picks)
        for ref in (own, given):
            torch.testing.assert_close(ref.p, new.p, rtol=0, atol=1e-9)
            assert torch.equal(ref.ids, new.ids)
            torch.testing.assert_close(ref.prior.J0.T @ ref.prior.J0,
                                       new.prior.J0.T @ new.prior.J0,
                                       rtol=1e-7, atol=1e-6)
        assert bool(out["keyframe"]) == bool(rout["keyframe"])
        admitted += int(picks.sum())
        ps = new
    assert admitted > 0
