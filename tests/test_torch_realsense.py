"""VINS-Mono's RealSense deployment on the CPU: a rolling-shutter camera
whose clock is offset from the IMU's, with td estimated online
(`benchmark/configs/realsense_vio.json`, the cell `realsense_vio.moving`).

- The rolling-shutter traffic (`benchmark/traffic/rolling_shutter.py`)
  gives `SequenceSimulator`'s frames with no readout and no offset, and
  otherwise takes each observation from the pose at its own row's time.
- The port's `vio_step` with the configuration's keys (td estimated, the
  row shift in every projection factor) equals the benchmark's float64
  reference step (`benchmark/reference/estimator_device.vio_step`), frame
  after frame, at a small window: td, the positions and the prior to
  rounding, the feature DB and the keyframe decision exactly.

(The td kernels against their plain versions on the card are
`tests/test_torch_normal_eq_kernel.py`'s and
`tests/test_torch_lm_cost_kernel.py`'s.)"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import convert
from benchmark.reference import anticipation as ref_ant
from benchmark.reference import estimator_device as ref_ed
from benchmark.reference import preintegration as ref_pre
from benchmark.reference import window as ref_window
from benchmark.runners import vio_stream_rs
from benchmark.traffic import rolling_shutter, stream, trajectories

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "realsense_vio.json").read_text())
TRAFFIC = json.loads((BENCH / "workloads" / "realsense_vio.moving.json")
                     .read_text())
# the step at a size the CPU holds: a window of 4, 32 landmark slots, in
# float64 (the fused Schur kernel is float32 only)
SMALL = dict(WINDOW_SIZE=4, max_feats=32, max_cnt=40, max_features=8,
             max_num_iterations=2, dtype="float64", fused_schur=False)
REF_TYPES = convert.types_of(ref_ed, ref_window, ref_pre, ref_ant)


def _traj(seconds=3.0):
    return trajectories.analytic_trajectory(seconds)


def _frames(sim, n):
    return list(sim.frames(n))


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_no_readout_no_offset_gives_the_sequence_simulators_frames(noise):
    """readout 0 and cam_td 0: every frame's ids, rays, velocities,
    probabilities and IMU samples are `SequenceSimulator`'s, bit for bit."""
    traj = _traj()
    kw = dict(seed=11, max_features=60, n_landmarks=1500, pixel_noise=noise)
    got = _frames(rolling_shutter.RollingShutterSimulator(
        traj, readout=0.0, cam_td=0.0, fy=610.0, cy=240.0, **kw), 25)
    want = _frames(stream.SequenceSimulator(traj, **kw), 25)
    assert len(got) == len(want) == 25
    for a, b in zip(got, want):
        assert a.t == b.t and list(a.feats) == list(b.feats)
        for fid in a.feats:
            (pa, va, qa), (pb, vb, qb) = a.feats[fid], b.feats[fid]
            assert np.array_equal(pa, pb) and np.array_equal(va, vb)
            assert qa == qb
        for x, y in zip(a[2:], b[2:]):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("cam_td", [0.01, 0.0123])
def test_each_observation_reprojects_from_its_row_time_pose(cam_td):
    """No pixel noise, a 33 ms readout over 480 rows at fy 610: each
    observation of a frame stamped at sample k is the landmark's projection
    from the pose at t_k + cam_td + readout · (v − 240) / 480 of its own row
    v, to 1e-9; the rows of a frame spread its observations' times over
    most of the readout."""
    traj = _traj()
    sim = rolling_shutter.RollingShutterSimulator(
        traj, seed=5, max_features=80, n_landmarks=1500, cam_td=cam_td,
        readout=0.033, fy=610.0, cy=240.0, fov_x=320 / 610, fov_y=240 / 610)
    lm_of = {}
    spans = []
    for f, fm in enumerate(sim.frames(20)):
        lm_of.update({fid: i for i, fid in sim._id_of.items()})
        k = f * sim.frame_stride
        ids = list(fm.feats)
        pts = np.array([fm.feats[i][0] for i in ids])
        off = cam_td + 0.033 * (610.0 * pts[:, 1] + 240.0 - 240.0) / 480
        p, R = sim.pose_at(np.full(len(ids), k), off)
        P_c = sim._project(R, p, sim.landmarks[[lm_of[i] for i in ids]])
        ray = P_c[:, :2] / P_c[:, 2:3]
        assert np.abs(ray - pts[:, :2]).max() < 1e-9, f
        spans.append(off.max() - off.min())
    assert max(spans) > 0.02


def _ported_and_reference(seed):
    from anticipated_vins_mono_torch.models import anticipation as ant
    from anticipated_vins_mono_torch.models import estimator_device as ed
    from anticipated_vins_mono_torch.ops import window as win
    cfg = dict(CONFIG, **SMALL)
    tr = dict(TRAFFIC, trajectory=dict(TRAFFIC["trajectory"], duration_s=2.5))
    traj = trajectories.trajectory(tr["trajectory"])
    sim = vio_stream_rs.simulator(traj, cfg, tr, seed)
    packed = stream.pack_stream(list(sim.frames()), cfg["max_cnt"])
    frames = [tuple(torch.from_numpy(x[t]) for x in packed)
              for t in range(packed.ids.shape[0])]
    pr = vio_stream_rs._params(ed, ant, win, cfg)
    rpr = vio_stream_rs._params(ref_ed, ref_ant, ref_window, cfg)
    return cfg, traj, frames, pr, rpr, ed


def test_vio_step_with_the_realsense_keys_equals_the_reference():
    """float64 on the CPU, window 4, 32 slots: from the same start the
    port's step and the reference's, each frame from the port's state, six
    frames: td within 1e-12 s, positions within 1e-9 m, the prior's
    information within 1e-9 relative, the DB's ids and masks and the
    keyframe flag equal; td estimated (it moves from its start at the
    source's 0) and the window's td column in the prior."""
    cfg, traj, frames, pr, rpr, ed = _ported_and_reference(2147484201)
    assert pr.wcfg.estimate_td and pr.wcfg.tr_over_row == 0.033 / 480
    nf = cfg["WINDOW_SIZE"] + 1
    first = {"p": traj.p[0], "q": traj.q[0], "v": traj.v[0]}
    st = ed.vio_init_oracle(pr, first, frames[:nf - 1], device="cpu")
    to_ref = lambda tree: convert.retype(tree, REF_TYPES)
    info = lambda prior: (prior.J0.mT @ prior.J0) * prior.weight
    tds = []
    for t in range(nf - 1, nf + 5):
        new, out = ed.vio_step(pr, st, *frames[t], device="cpu")
        r_new, r_out = ref_ed.vio_step(rpr, to_ref(st), *frames[t],
                                       device="cpu")
        assert abs(float(new.td) - float(r_new.td)) < 1e-12, t
        assert float((new.p - r_new.p).abs().max()) < 1e-9, t
        H, H_r = info(new.prior), info(r_new.prior)
        assert float((H - H_r).abs().max()) <= 1e-9 * float(H_r.abs().max())
        assert torch.equal(new.ids, r_new.ids), t
        assert torch.equal(new.mask, r_new.mask), t
        assert bool(out["keyframe"]) == bool(r_out["keyframe"])
        assert not bool(out["fail"])
        tds.append(float(new.td))
        st = new
    T = 15 * nf + 6
    assert tds[-1] != 0.0 and float(info(st.prior)[T, T]) > 0
