"""The port's device tracker with `follow_flow` on against the benchmark's
plain reference of it (`benchmark/reference/tracker.py`), on the CPU.

Frames: the benchmark's circuit (`benchmark/traffic/circuit.py`) rendered
at 160×120 through the EuRoC distortion, two laps in 10 s (a frame shifts
up to ~17 px, past LK's ±8 px window), rounded to 8 bits; the tracker at
40 slots, min-distance 10 px, three levels, its RANSAC key from seed
2**31 + 5. Each frame the reference steps from the state the port was
given (its pyramid made anew from the previous 8-bit frame) with the same
frame and the same draws (the state's key), as the cell's check does.

Tolerances and their reasons:

- the reference in float32 is the port's arithmetic in the port's order:
  the same kept slots and ids exactly, points within 1e-4 px and rays
  within 1e-6 (equal bit for bit on these frames; the margin is for
  summation orders inside `torch.sum` and `einsum` on other builds);
- against the float64 reference: points both keep within 2e-3 px at the
  95th percentile (the cell's limit; 1.1e-5 px measured here, the
  bfloat16 control reads 2.2e-2 px at this size) and 5e-2 px at most (an
  ill-conditioned window amplifies rounding: 1.0e-3 px measured); at most
  2 of the 40 × 6 kept or dropped decisions differ (the float32 8-point
  RANSAC can gate a borderline point on the other side of the threshold,
  ROADMAP queue C; none measured on these frames).

With `ransac_f64` on (the hypotheses fitted and gated in float64, as the
`euroc_tracker` configuration runs them) every kept or dropped decision
equals the float64 reference's.

A planted fault fails: LK in the JAX form (`follow_flow` off: the points
both keep are tens of pixels apart), every kept point moved by 0.5 px, no
RANSAC (every point LK tracks kept) and each hypothesis's null vector
tilted by a tenth of the next eigenvector (the decisions differ).
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from anticipated_vins_mono_torch.models import tracker_device as td
from anticipated_vins_mono_torch.ops import cameras
from benchmark import convert
from benchmark.reference import cameras as rcameras
from benchmark.reference import tracker as rtr
from benchmark.traffic import circuit

torch.set_num_threads(1)

SEED = 2 ** 31 + 5
SCALE = 160 / 752
CAM = dict(fx=461.6 * SCALE, fy=460.3 * SCALE, cx=363.0 * SCALE,
           cy=248.1 * 0.25, k1=-0.2917, k2=0.08228, p1=5.333e-05,
           p2=-0.0001578, width=160, height=120)
PARAMS = dict(max_features=40, min_dist=10, ransac_thresh_px=1.0, levels=3,
              ransac_iters=64)
RPARAMS = rtr.TrackerParams(**PARAMS, lk_half=7, lk_iters=10, lk_pad=8)
FRAMES = 7
REF_TYPES = convert.types_of(rtr)


@pytest.fixture(scope="module")
def stream():
    """The 8-bit frames and their times, and the port's run over them:
    the state before each step, the state and measurement after it."""
    circ, p_all = circuit.circuit(10.0, 2.0, 3.0, 10.0)
    world = circuit.make_box_world(p_all, SEED, 4.0)
    cam32 = rcameras.PinholeCamera.create(**CAM, dtype=torch.float32)
    circ = circuit.Circuit(*(x[:FRAMES] for x in circ))
    frames = circuit.frames_uint8(world, cam32, circ)
    return dict(frames=frames, ts=circ.t, runs={}, world=world, circ=circ)


def _planted(fault):
    """A context that plants a RANSAC fault in the port, or none."""
    if fault == "no_ransac":
        return mock.patch.object(td, "ransac_essential_mask",
                                 lambda x1, x2, ok, u, thresh: ok)
    if fault == "ransac_hypothesis":
        eigh = td.lie.eigh_or_nan

        def tilted(A):
            w, V = eigh(A)
            v = V[..., 0] + 0.1 * V[..., 1]
            v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
            return w, torch.cat([v[..., None], V[..., 1:]], -1)
        return mock.patch.object(td.lie, "eigh_or_nan", tilted)
    return contextlib.nullcontext()


def _port_run(stream, follow_flow=True, moved=False, ransac_f64=False,
              fault=None):
    key = (follow_flow, moved, ransac_f64, fault)
    if key not in stream["runs"]:
        cam = cameras.PinholeCamera.create(**CAM, device="cpu")
        tp = td.TrackerDeviceParams(**PARAMS, follow_flow=follow_flow,
                                    ransac_f64=ransac_f64)
        frames, ts = stream["frames"], stream["ts"]
        st = td.tracker_init(cam, tp, frames[0], float(ts[0]), seed=SEED)
        steps = []
        for k in range(1, FRAMES):
            with _planted(fault):
                new, meas = td.tracker_step(cam, tp, st, frames[k],
                                            float(ts[k]))
            if moved:
                kept = _kept(st, new)
                new = new._replace(pts=torch.where(
                    kept[:, None], new.pts + torch.tensor([0.5, 0.0]),
                    new.pts))
            steps.append((st, new, meas))
            st = new
        stream["runs"][key] = steps
    return stream["runs"][key]


def _kept(s_in, s_out):
    return s_in.active & s_out.active & (s_out.ids == s_in.ids)


def _reference_steps(stream, steps, dtype):
    """Per frame: (port's kept, reference's kept, port's points, reference's
    points, the reference's measurement) from the state the port was
    given."""
    cam = rcameras.PinholeCamera.create(**CAM, dtype=dtype)
    to_ref = lambda tree: convert.retype(tree, REF_TYPES,
                                         convert.floats_to(dtype, "cpu"))
    out = []
    for k, (s_in, s_out, meas) in enumerate(steps, start=1):
        prev = rtr.fe.as_image(stream["frames"][k - 1], "cpu", dtype)
        r_in = to_ref(s_in._replace(pyr=()))._replace(
            pyr=rtr.prep(prev, RPARAMS.levels)[1])
        u = rtr.ransac_uniforms(s_in.key, RPARAMS.ransac_iters,
                                RPARAMS.max_features)
        r_out, r_meas, _ = rtr.tracker_step(
            cam, RPARAMS, r_in, stream["frames"][k], float(stream["ts"][k]),
            u=u, img_dtype=dtype)
        out.append((_kept(s_in, s_out), _kept(r_in, r_out), s_out, r_out,
                    meas, r_meas))
    return out


def _gaps(rows):
    gaps, diff = [], 0
    for kp, kr, s_out, r_out, _, _ in rows:
        both = kp & kr
        diff += int((kp != kr).sum())
        gaps += torch.linalg.norm(s_out.pts[both].double()
                                  - r_out.pts[both].double(), dim=-1).tolist()
    return np.asarray(gaps), diff


def test_reference_in_float32_is_the_port(stream):
    rows = _reference_steps(stream, _port_run(stream), torch.float32)
    for kp, kr, s_out, r_out, meas, r_meas in rows:
        assert torch.equal(kp, kr)
        assert torch.equal(s_out.active, r_out.active)
        assert torch.equal(s_out.ids, r_out.ids)
        a = s_out.active
        np.testing.assert_allclose(s_out.pts[a], r_out.pts[a], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(meas[1][a], r_meas[1][a], rtol=0,
                                   atol=1e-6)
    gaps, _ = _gaps(rows)
    assert len(gaps) >= 150


def test_port_against_the_float64_reference(stream):
    rows = _reference_steps(stream, _port_run(stream), torch.float64)
    gaps, diff = _gaps(rows)
    assert len(gaps) >= 150
    assert np.quantile(gaps, 0.95) < 2e-3 and gaps.max() < 5e-2, gaps.max()
    assert diff <= 2


@pytest.mark.parametrize("fault", ["jax_lk", "moved"])
def test_planted_fault_is_seen(stream, fault):
    steps = _port_run(stream, follow_flow=fault != "jax_lk",
                      moved=fault == "moved")
    gaps, diff = _gaps(_reference_steps(stream, steps, torch.float64))
    assert np.quantile(gaps, 0.95) > 0.4, (np.quantile(gaps, 0.95), diff)


def test_float64_hypotheses_decide_as_the_float64_reference(stream):
    rows = _reference_steps(stream, _port_run(stream, ransac_f64=True),
                            torch.float64)
    gaps, diff = _gaps(rows)
    assert len(gaps) >= 150
    assert np.quantile(gaps, 0.95) < 2e-3 and gaps.max() < 5e-2, gaps.max()
    assert diff == 0


@pytest.mark.parametrize("fault", ["no_ransac", "ransac_hypothesis"])
def test_planted_ransac_fault_is_seen(stream, fault):
    steps = _port_run(stream, ransac_f64=True, fault=fault)
    _, diff = _gaps(_reference_steps(stream, steps, torch.float64))
    assert diff > 0
