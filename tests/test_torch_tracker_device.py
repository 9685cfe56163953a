"""Port vs JAX: the device tracker (models/tracker_device.py), float32, CPU.

The trackers run on five frames of the textured box world rendered at
160×120 along the circuit of `tests/test_tracker_device.py`, 10 Hz, with 40
slots. Before every frame the port's tracker is started from the JAX
tracker's state (`convert.tracker_state_from_numpy`, the PRNG key
included), and its RANSAC gets the uniform draws the JAX step draws from
its key; the port's own draws from that key are those draws, bit for bit.
Free runs from `tracker_init(seed=k)` with no draws handed over: see
`test_seeded_free_run_equals_jax`.

Tolerances: each stage from the same inputs — LK `ok` exact and points
1e-3 px, RANSAC masks exact, and after them ids and active flags exact,
rays 1e-5, velocities 1e-3 (float32 on both sides, sums in another order);
the occupancy mask exact. `track_sequence` equals the stepwise run exactly.
The whole step from the carried state: see
`test_tracker_step_whole_frame_equals_jax`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.models import frontend as jfe
from anticipated_vins_mono_tpu.models import tracker_device as jtd
from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.utils import render as jrender
from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
from anticipated_vins_mono_torch.models import frontend as tfe
from anticipated_vins_mono_torch.models import tracker_device as ttd
from anticipated_vins_mono_torch.ops import cameras as tcam
from anticipated_vins_mono_torch.utils import convert, threefry

torch.set_num_threads(1)

PARAMS = dict(max_features=40, min_dist=10)


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _jax_draws(key, iters, n):
    """The uniforms `tracker_step` of the JAX package draws from `key`."""
    _, k1 = jax.random.split(key)
    return np.asarray(jax.random.uniform(k1, (iters, n), dtype=jnp.float32,
                                         minval=1e-7, maxval=1.0 - 1e-7))


@pytest.fixture(scope="module")
def run():
    """Five rendered 160×120 frames and the JAX tracker's state before each
    of them with its measurement after it."""
    W, H = 160, 120
    fx = 0.6 * W
    cam = jcam.PinholeCamera.create(fx, fx, W / 2, H / 2, width=W, height=H)
    traj = loop_trajectory(20.0, laps=2.0, radius=3.0)
    world = jrender.make_box_world(traj.p, margin=5.0, seed=0)
    rays = jrender.camera_rays(cam)
    R_all = np.asarray(jlie.quat_to_rot(jnp.asarray(traj.q)))
    ks = [0, 20, 40, 60, 80]
    imgs = [jrender.render_frame(world, cam, rays, traj.p[k], R_all[k])
            for k in ks]
    ts = [float(traj.t[k]) for k in ks]
    params = jtd.TrackerDeviceParams(**PARAMS)
    st = jtd.tracker_init(cam, params, jnp.asarray(imgs[0]), ts[0])
    states, meas = [st], []
    for img, t in zip(imgs[1:], ts[1:]):
        st, m = jtd.tracker_step(cam, params, st, jnp.asarray(img), t)
        states.append(st)
        meas.append(_np_tree(m))
    tcam = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    return dict(cam=cam, tcam=tcam, imgs=imgs, ts=ts, states=states,
                meas=meas, params=params)


def _same_measurement(out, ref):
    ids, rays, vel, prob, active = (m.numpy() for m in out)
    r_ids, r_rays, r_vel, r_prob, r_active = ref
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(active, r_active)
    a = r_active
    np.testing.assert_allclose(rays[a], r_rays[a], atol=1e-5, rtol=0)
    np.testing.assert_allclose(vel[a], r_vel[a], atol=1e-3, rtol=0)
    np.testing.assert_allclose(prob, r_prob, atol=1e-5, rtol=0)


def test_tracker_init_equals_jax(run):
    tp = ttd.TrackerDeviceParams(**PARAMS)
    st = ttd.tracker_init(run["tcam"], tp, run["imgs"][0], run["ts"][0])
    ref = _np_tree(run["states"][0])
    for name in ("pts", "active", "ids", "life", "next_id"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      getattr(ref, name))
    np.testing.assert_allclose(st.score.numpy(), ref.score, rtol=1e-5,
                               atol=1e-5 * ref.score.max())
    np.testing.assert_allclose(st.norm.numpy(), ref.norm, atol=1e-6, rtol=0)
    assert st.t.dtype == torch.float32 and float(st.t) == float(ref.t)
    for lvl, r in zip(st.pyr, ref.pyr):
        np.testing.assert_allclose(lvl.numpy(), r, atol=1e-6, rtol=0)


def _stages(run, k):
    """Frame k+1 from the JAX state before it: the JAX stages (LK, RANSAC
    on its LK points with its draws) and the carried port state."""
    tp = ttd.TrackerDeviceParams(**PARAMS)
    jst = run["states"][k]
    img = run["imgs"][k + 1]
    _, jpyr = jtd._prep(jnp.asarray(img, jnp.float32), tp.levels)
    jnew, jok = jfe.lk_track(jst.pyr, jpyr, jst.pts,
                             jst.active.astype(jst.pts.dtype),
                             levels=tp.levels, impl="gather")
    jok = jok & jst.active
    u = _jax_draws(jst.key, tp.ransac_iters, tp.max_features)
    jmask = jtd.ransac_essential_mask(
        jst.norm, jcam.lift_projective(run["cam"], jnew)[:, :2], jok,
        jax.random.split(jst.key)[1], iters=tp.ransac_iters,
        thresh=tp.ransac_thresh_px / run["cam"].fx)
    st = convert.tracker_state_from_numpy(_np_tree(jst), device="cpu")
    return tp, st, img, torch.tensor(u), _np_tree((jnew, jok, jmask))


def test_draws_from_a_converted_jax_state_equal_jax(run):
    """The port's draws from the key of a converted JAX state are the JAX
    step's, bit for bit, and its step carries the key the JAX step
    carries."""
    tp = ttd.TrackerDeviceParams(**PARAMS)
    for k, t in enumerate(run["ts"][1:]):
        jst = run["states"][k]
        st = convert.tracker_state_from_numpy(_np_tree(jst), device="cpu")
        key, k1 = threefry.split(st.key)
        u = ttd.ransac_uniforms(k1, tp.ransac_iters, tp.max_features,
                                st.norm.dtype).numpy()
        ref = _jax_draws(jst.key, tp.ransac_iters, tp.max_features)
        np.testing.assert_array_equal(u.view(np.int32), ref.view(np.int32))
        st2, _ = ttd.tracker_step(run["tcam"], tp, st, run["imgs"][k + 1], t)
        nxt = np.asarray(run["states"][k + 1].key)
        np.testing.assert_array_equal(st2.key.numpy(), nxt.astype(np.int64))
        np.testing.assert_array_equal(key.numpy(), nxt.astype(np.int64))
        back = convert.tracker_state_to_numpy(st2)
        assert back.key.dtype == np.uint32
        np.testing.assert_array_equal(back.key, nxt)


def test_tracker_step_stages_equal_jax_every_frame(run):
    """Each stage of the step from the same inputs: LK from the carried
    state (`ok` exact, points 1e-3 px), the RANSAC on the JAX LK points with
    the JAX draws (mask exact), and top-up + slot bookkeeping + packaging
    from the JAX mask (ids, active exact; rays 1e-5, velocities 1e-3)."""
    kept = []
    for k, t in enumerate(run["ts"][1:]):
        tp, st, img, u, (jnew, jok, jmask) = _stages(run, k)
        eq, pyr = ttd._prep(torch.tensor(img), tp.levels)
        new_pts, lk_ok = tfe.lk_track(st.pyr, pyr, st.pts,
                                      st.active.float(), levels=tp.levels)
        np.testing.assert_array_equal((lk_ok & st.active).numpy(), jok)
        np.testing.assert_allclose(new_pts.numpy()[jok], jnew[jok],
                                   atol=1e-3, rtol=0)
        mask = ttd.ransac_essential_mask(
            st.norm, tcam_lift(run, jnew), torch.tensor(jok), u,
            thresh=tp.ransac_thresh_px / run["tcam"].fx)
        np.testing.assert_array_equal(mask.numpy(), jmask)
        st2, out = ttd._top_up(run["tcam"], tp, st, eq, pyr,
                               torch.tensor(jnew), torch.tensor(jmask),
                               torch.tensor(t, dtype=torch.float32))
        _same_measurement(out, run["meas"][k])
        nxt = _np_tree(run["states"][k + 1])
        np.testing.assert_array_equal(st2.life.numpy(), nxt.life)
        assert int(st2.next_id) == int(nxt.next_id)
        kept.append(int((st2.life.numpy() > 1).sum()))
    assert min(kept) >= 10          # tracks persist through every frame


def tcam_lift(run, pts):
    return tcam.lift_projective(run["tcam"], torch.tensor(pts))[:, :2]


def test_tracker_step_whole_frame_equals_jax(run):
    """The whole step from the carried state, the JAX draws. Where the
    port's RANSAC decides on its own LK points as on the JAX LK points the
    measurement equals JAX's (ids, active exact). Measured on this fixture:
    three frames of four; on the second the LK points differ by 4.6e-5 px,
    and the float32 8-point hypotheses turn that into a 1.4 % change of one
    point's Sampson distance across the threshold (1.0116 vs 0.9974 of it:
    ROADMAP queue C), so one slot is kept by the port and refilled by JAX.
    Held: such a flip on at most one frame, of at most one point."""
    flips = 0
    for k, t in enumerate(run["ts"][1:]):
        tp, st, img, u, (jnew, jok, jmask) = _stages(run, k)
        st2, out = ttd.tracker_step(run["tcam"], tp, st, img, t, u=u)
        _, pyr = ttd._prep(torch.tensor(img), tp.levels)
        new_pts, lk_ok = tfe.lk_track(st.pyr, pyr, st.pts,
                                      st.active.float(), levels=tp.levels)
        own = ttd.ransac_essential_mask(
            st.norm, tcam_lift(run, new_pts.numpy()), lk_ok & st.active, u,
            thresh=tp.ransac_thresh_px / run["tcam"].fx).numpy()
        if np.array_equal(own, jmask):
            _same_measurement(out, run["meas"][k])
        else:
            flips += 1
            assert (own != jmask).sum() == 1
    assert flips <= 1


def test_device_feature_tracker_process_is_the_step(run):
    """The host facade: the first frame's dict equals the JAX facade's; a
    later frame's dict is the step's measurement, active slots only."""
    tp = ttd.TrackerDeviceParams(**PARAMS)
    jt = jtd.DeviceFeatureTracker(run["cam"], run["params"])
    tt = ttd.DeviceFeatureTracker(run["tcam"], tp)
    ref = jt.process(run["imgs"][0], run["ts"][0])
    out = tt.process(run["imgs"][0], run["ts"][0])
    assert sorted(out) == sorted(ref) and len(out) >= 30
    for fid, (ray, vel, prob) in ref.items():
        np.testing.assert_allclose(out[fid][0], ray, atol=1e-6, rtol=0)
        assert not out[fid][1].any() and abs(out[fid][2] - prob) < 1e-5
    u = ttd.ransac_uniforms(threefry.prng_key(1, "cpu"), tp.ransac_iters,
                            tp.max_features)
    state = tt.state
    _, (ids, rays, vel, prob, active) = ttd.tracker_step(
        run["tcam"], tp, state, run["imgs"][1], run["ts"][1], u=u)
    out = tt.process(run["imgs"][1], run["ts"][1], u=u)
    want = {int(i): k for k, i in enumerate(ids.numpy()) if active[k]}
    assert sorted(out) == sorted(want)
    for fid, k in want.items():
        np.testing.assert_array_equal(out[fid][0], rays[k].numpy())
        np.testing.assert_array_equal(out[fid][1], vel[k].numpy())
        assert out[fid][2] == float(prob[k])


def test_track_sequence_equals_stepwise(run):
    tp = ttd.TrackerDeviceParams(**PARAMS)
    st0 = ttd.tracker_init(run["tcam"], tp, run["imgs"][0], run["ts"][0])
    keys = threefry.split(threefry.prng_key(3, "cpu"), len(run["imgs"]) - 1)
    u = torch.stack([ttd.ransac_uniforms(k, tp.ransac_iters, tp.max_features)
                     for k in keys])
    st, step_meas = st0, []
    for k, (img, t) in enumerate(zip(run["imgs"][1:], run["ts"][1:])):
        st, m = ttd.tracker_step(run["tcam"], tp, st, img, t, u=u[k])
        step_meas.append(m)
    imgs = torch.tensor(np.stack(run["imgs"][1:]))
    st_seq, meas = ttd.track_sequence(run["tcam"], tp, st0, imgs,
                                      run["ts"][1:], u=u)
    for a, b in zip(convert.tracker_state_to_numpy(st_seq),
                    convert.tracker_state_to_numpy(st)):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    assert meas[1].shape == (len(run["imgs"]) - 1, tp.max_features, 3)
    for k, m in enumerate(step_meas):
        for x, y in zip(meas, m):
            assert torch.equal(x[k], y)


def test_generator_draws_make_a_working_tracker(run):
    """Without caller draws the facade draws from the key its seed makes:
    the same seed gives the same ids, and the slots keep tracking."""
    tp = ttd.TrackerDeviceParams(**PARAMS)
    outs = []
    for _ in range(2):
        tt = ttd.DeviceFeatureTracker(run["tcam"], tp, seed=5)
        outs.append([tt.process(img, t)
                     for img, t in zip(run["imgs"], run["ts"])])
    assert [sorted(o) for o in outs[0]] == [sorted(o) for o in outs[1]]
    assert all(len(set(a) & set(b)) >= 10
               for a, b in zip(outs[0][:-1], outs[0][1:]))


LK_PX = 1e-3      # the stage test's LK tolerance from the same state


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_free_run_equals_jax(run, seed):
    """`tracker_init(seed=k)` → `tracker_step` frame after frame (the loop
    of `track_sequence`, held equal to it above) in both packages, no draws
    handed over: the two keys draw the same values, so the two trackers
    run the same RANSAC. Each frame: ids, active flags and the carried key
    exact; rays within the stage test's LK tolerance (1e-3 px, 1.04e-5 on
    the normalized plane at fx = 96) for each LK step the slot's track has
    taken since it was detected (a fresh detection is exact): a free run
    carries its own points on, and one rounding-sensitive point on this
    fixture reaches 1.07e-3 px after two steps. Allowed: the one known
    flip, the float32 8-point RANSAC keeping or dropping a borderline
    point on rounding-level LK differences (ROADMAP queue C 5(c); see
    `test_tracker_step_whole_frame_equals_jax`): on at most one frame, at
    most one slot kept by one tracker and refilled by the other, after
    which the port takes the JAX state on. Measured here: no flip for
    either seed."""
    tp = ttd.TrackerDeviceParams(**PARAMS)
    jst = jtd.tracker_init(run["cam"], run["params"],
                           jnp.asarray(run["imgs"][0]), run["ts"][0], seed)
    st = ttd.tracker_init(run["tcam"], tp, run["imgs"][0], run["ts"][0],
                          seed=seed)
    np.testing.assert_array_equal(st.key.numpy(),
                                  np.asarray(jst.key).astype(np.int64))
    flips = 0
    for k, (img, t) in enumerate(zip(run["imgs"][1:], run["ts"][1:])):
        jst, ref = jtd.tracker_step(run["cam"], run["params"], jst,
                                    jnp.asarray(img), t)
        ref = _np_tree(ref)
        st, out = ttd.tracker_step(run["tcam"], tp, st, img, t)
        kept = (st.life.numpy() > 1) != (np.asarray(jst.life) > 1)
        if kept.any():
            flips += 1
            assert kept.sum() == 1 and flips == 1, (k, kept.sum())
            st = convert.tracker_state_from_numpy(_np_tree(jst), "cpu")
            continue
        ids, rays, _, _, active = (m.numpy() for m in out)
        np.testing.assert_array_equal(ids, ref[0])
        np.testing.assert_array_equal(active, ref[4])
        steps = np.maximum(np.asarray(jst.life) - 1, 1)[ref[4]]
        err = np.abs(rays[ref[4]] - ref[1][ref[4]]).max(-1)
        assert (err <= steps * LK_PX / float(run["tcam"].fx)).all(), \
            (k, err.max())
        np.testing.assert_array_equal(st.key.numpy(),
                                      np.asarray(jst.key).astype(np.int64))
    assert flips <= 1


def _ransac_problem():
    rng = np.random.default_rng(3)
    N = 100
    t = np.array([0.3, -0.1, 0.05])
    ang = 0.1 * rng.normal(size=3)
    th = np.linalg.norm(ang)
    q = np.concatenate([[np.cos(th / 2)], ang / max(th, 1e-9) * np.sin(th / 2)])
    R = np.asarray(jlie.quat_to_rot(jnp.asarray(q)))
    X = np.concatenate([rng.uniform(-1, 1, (N, 2)),
                        rng.uniform(2, 6, (N, 1))], 1)
    x1 = X[:, :2] / X[:, 2:]
    Xc2 = (X - t) @ R
    x2 = Xc2[:, :2] / Xc2[:, 2:]
    out_idx = rng.choice(N, 20, replace=False)
    x2[out_idx] += rng.uniform(0.05, 0.2, (20, 2)) * rng.choice(
        [-1, 1], (20, 2))
    return x1.astype(np.float32), x2.astype(np.float32), out_idx


@pytest.mark.parametrize("n_ok", [100, 90])
def test_ransac_rejects_planted_outliers_as_jax(n_ok):
    x1, x2, out_idx = _ransac_problem()
    ok = np.zeros(len(x1), bool)
    ok[:n_ok] = True
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jtd.ransac_essential_mask(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ok), key, iters=128,
        thresh=2e-3))
    u = jax.random.uniform(key, (128, len(x1)), dtype=jnp.float32,
                           minval=1e-7, maxval=1.0 - 1e-7)
    out = ttd.ransac_essential_mask(torch.tensor(x1), torch.tensor(x2),
                                    torch.tensor(ok),
                                    torch.tensor(np.asarray(u)), thresh=2e-3)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref[out_idx].sum() <= 2 and ref[ok].sum() >= 0.7 * n_ok


def test_ransac_degenerate_passes_through_as_jax():
    N = 30
    x = np.zeros((N, 2), np.float32)
    ok = np.zeros(N, bool)
    ok[:5] = True
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jtd.ransac_essential_mask(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(ok), key))
    u = jax.random.uniform(key, (64, N), dtype=jnp.float32, minval=1e-7,
                           maxval=1.0 - 1e-7)
    out = ttd.ransac_essential_mask(torch.tensor(x), torch.tensor(x),
                                    torch.tensor(ok),
                                    torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), ok)


@pytest.mark.parametrize("min_dist", [10, 16, 30])
def test_occupancy_equals_jax_with_inactive_slots(min_dist):
    """An inactive slot scatters at (−1, −1), which JAX wraps to
    (H−1, W−1): that corner is marked whenever a slot is inactive, and only
    then (the points stay clear of the corner's window)."""
    H, W = 120, 160
    rng = np.random.default_rng(min_dist)
    pts = rng.uniform([3, 3], [W - min_dist - 3, H - min_dist - 3],
                      (40, 2)).astype(np.float32)
    pts[0] = [10.5, 20.5]                      # round half to even
    some = rng.random(40) > 0.3
    for act in (some, np.ones(40, bool)):
        ref = np.asarray(jtd._occupancy((H, W), jnp.asarray(pts),
                                        jnp.asarray(act), min_dist))
        out = ttd._occupancy((H, W), torch.tensor(pts), torch.tensor(act),
                             min_dist).numpy()
        np.testing.assert_array_equal(out, ref)
        assert out[-1, -1] == (0.0 if act.all() else 1.0)


TRACK_SPANS = {"track.step", "track.upload", "track.prep", "track.lk",
               "track.ransac", "track.detect", "track.refill"}


@pytest.mark.parametrize("follow_flow", [False, True])
def test_tracker_step_records_its_spans_only_under_a_profiler(run,
                                                              follow_flow):
    """The step's seven spans (`track.step` the unit, the six stages inside
    it) are recorded only while a profiler records, once each a frame, and
    the step's state and measurement are the same either way; an 8-bit
    frame is taken as the same frame scaled by 1/255."""
    from anticipated_vins_mono_torch.utils import timing
    tp = ttd.TrackerDeviceParams(**PARAMS, follow_flow=follow_flow)
    st0 = ttd.tracker_init(run["tcam"], tp, run["imgs"][0], run["ts"][0])
    img = np.round(np.asarray(run["imgs"][1]) * 255).astype(np.uint8)
    step = lambda: ttd.tracker_step(run["tcam"], tp, st0, img, run["ts"][1])
    timing.reset_recorded()
    plain = step()
    assert timing.recorded() == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        traced = step()
    spans = timing.recorded()
    timing.reset_recorded()
    assert sorted(s.name for s in spans) == sorted(TRACK_SPANS)
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["track.step"]
    assert all(s.unit == top[0].id for s in spans)
    assert all(s.parent == top[0].id for s in spans if s is not top[0])
    for a, b in zip(jax.tree_util.tree_leaves(plain),
                    jax.tree_util.tree_leaves(traced)):
        assert torch.equal(a, b)
    scaled = ttd.tracker_step(run["tcam"], tp, st0, img / 255, run["ts"][1])
    for a, b in zip(jax.tree_util.tree_leaves(plain),
                    jax.tree_util.tree_leaves(scaled)):
        assert torch.equal(a, b)
