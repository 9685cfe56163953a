"""Port vs JAX: the loop-closure node (models/loop_node.py), CPU.

The unit scenarios of the JAX package's `tests/test_loop_node.py` — detectLoop
acceptance (dual threshold, second candidate, exclusion window) on BoW
histograms and on direct BRIEF retrieval, the direct-similarity oracle and
the drift application — each on the same inputs through both nodes; and a
replay: both nodes fed the same keyframe snapshots and the same
JAX-rendered images of a short circuit.

The replay's snapshots stand in for an estimator's (`VioEstimator.
last_keyframe`): every fifth frame of `loop_trajectory(12 s, 1.2 laps)` at
160×120 (pinhole, fx = 0.6·W), the pose and 64 visible landmarks of
`loop_benchmark.grounded_landmarks` (texture corners of 16 views over 85 %
of a lap, backprojected onto the box walls) as a drifting VIO would report
them — the ground truth under a rigid drift that grows with time (2 cm/s,
0.4°/s of yaw), window points in normalized coordinates with 0.3 px noise.
Every snapshot carries the same number of points inside the BRIEF margin,
so the JAX node compiles its functions once. The node runs with a 10-entry
exclusion window, 100 corners and 10 inliers (the circuit is short and
small); a relocalization consumer records what the node feeds back
(`set_relo_frame`).

Tolerances: exact for every decision — the candidate each query returns,
the funnel, the accepted loops with their inliers, the loop edges' indices
— and for the retrieval scores (integers over the query size); edge
translations, yaw, relo poses and PGO results 1e-9 (float64 numpy on the
host; PnP through each package's own `exp_so3`); the relo matches' ids
exact, points 1e-12. Images are float32 in both nodes, so a BRIEF bit could
part where two samples are equal to rounding: the replay asserts the
descriptors equal, which they are on this fixture.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import posegraph as jpg
from anticipated_vins_mono_tpu.models.loop_node import \
    KeyframeEntry as JEntry
from anticipated_vins_mono_tpu.models.loop_node import \
    LoopClosureNode as JNode
from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_tpu.utils import render as jrender
from anticipated_vins_mono_tpu.utils.loop_benchmark import \
    grounded_landmarks
from anticipated_vins_mono_tpu.utils.synthetic import loop_trajectory
from anticipated_vins_mono_tpu.utils.synthetic import \
    wall_landmarks as jwall
from anticipated_vins_mono_torch.models import posegraph as tpg
from anticipated_vins_mono_torch.models.loop_node import \
    KeyframeEntry as TEntry
from anticipated_vins_mono_torch.models.loop_node import \
    LoopClosureNode as TNode
from anticipated_vins_mono_torch.ops import cameras as tcam
from anticipated_vins_mono_torch.ops import lie as tlie
from anticipated_vins_mono_torch.utils import loop_benchmark as tlb
from anticipated_vins_mono_torch.utils import render as trender
from anticipated_vins_mono_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


def _node(pkg, **kw):
    kw.setdefault("exclude_recent", 5)
    kw.setdefault("sim_hi", 0.5)
    kw.setdefault("retrieval", "bow")   # hist-driven unit tests
    if pkg == "jax":
        cam = jcam.PinholeCamera.create(100.0, 100.0, 60.0, 40.0,
                                        width=120, height=80)
        return JNode(cam=cam, graph=jpg.PoseGraph(), **kw)
    cam = tcam.PinholeCamera.create(100.0, 100.0, 60.0, 40.0, width=120,
                                    height=80, device="cpu")
    return TNode(cam=cam, device="cpu", **kw)


def _push_hist(node, hist, p=None):
    """Insert a keyframe entry directly (bypassing imagery)."""
    Entry = JEntry if isinstance(node, JNode) else TEntry
    k = node.graph.n
    p = np.zeros(3) if p is None else p
    node.graph.add_keyframe(p, np.array([1.0, 0, 0, 0]), t=float(k))
    node.entries.append(Entry(
        t=float(k), p_vio=p, q_vio=np.array([1.0, 0, 0, 0]), hist=hist,
        corner_desc=np.zeros((1, tpg.BRIEF_BITS), bool),
        corner_norm=np.zeros((1, 2)), win_ids=np.zeros(0, np.int64),
        win_desc=np.zeros((0, tpg.BRIEF_BITS), bool),
        win_X=np.zeros((0, 3))))
    return k


def _push_desc(node, desc, p=None):
    """Insert a keyframe with a real descriptor set (direct retrieval)."""
    k = _push_hist(node, np.zeros(tpg.BOW_WORDS), p)
    if isinstance(node, JNode):
        node._desc_cat = np.concatenate([node._desc_cat,
                                         desc.astype(np.uint8)])
        node._desc_off.append(len(node._desc_cat))
    else:
        node.add_to_database(desc)
    return k


def _dummy_desc(n=1):
    return np.zeros((n, tpg.BRIEF_BITS), np.uint8)


def _rand_hist(rng, words=40):
    h = np.zeros(tpg.BOW_WORDS)
    idx = rng.choice(tpg.BOW_WORDS, words, replace=False)
    h[idx] = 0.5 + rng.random(words)
    return h


def _both(build):
    """`build(node, rng)` on a JAX node and a port node, the same draws."""
    return [build(pkg) for pkg in ("jax", "port")]


def test_detect_loop_dual_threshold_equals_jax():
    """Fires only when best > hi AND a second candidate > lo; returns the
    earliest candidate above lo — in both, with the same answers."""
    def build(pkg):
        rng = np.random.default_rng(0)
        node = _node(pkg, sim_hi=0.5, sim_lo_ratio=0.5)
        base = _rand_hist(rng)
        for h in (base, base * 1.05):
            _push_hist(node, h)
        for _ in range(8):
            _push_hist(node, _rand_hist(rng))
        k = node.graph.n
        return (node._detect_loop(k, base, _dummy_desc()),
                node._detect_loop(k, _rand_hist(rng), _dummy_desc()))
    got_j, got_t = _both(build)
    assert got_t == got_j == (0, None)


def test_detect_loop_needs_second_candidate_as_jax():
    def build(pkg):
        rng = np.random.default_rng(1)
        node = _node(pkg, sim_hi=0.5, sim_lo_ratio=0.9)
        base = _rand_hist(rng)
        _push_hist(node, base)
        for _ in range(9):
            _push_hist(node, _rand_hist(rng))
        return node._detect_loop(node.graph.n, base, _dummy_desc())
    got_j, got_t = _both(build)
    assert got_t is None and got_j is None


def test_exclusion_window_as_jax():
    def build(pkg):
        rng = np.random.default_rng(2)
        node = _node(pkg, exclude_recent=50)
        h = np.abs(rng.random(tpg.BOW_WORDS))
        for _ in range(10):
            _push_hist(node, h)
        return node._detect_loop(node.graph.n, h, _dummy_desc())
    got_j, got_t = _both(build)
    assert got_t is None and got_j is None


def test_correct_pose_equals_jax():
    """Drift application: the same corrected pose (1e-12), and the JAX
    test's oracle (90° yaw, t = (1, 2, 3))."""
    outs = []
    for pkg in ("jax", "port"):
        node = _node(pkg)
        node.graph.yaw_drift = 90.0
        node.graph.t_drift = np.array([1.0, 2.0, 3.0])
        outs.append(node.correct_pose(np.array([1.0, 0, 0]),
                                      np.array([1.0, 0, 0, 0.0])))
    (p_j, q_j), (p_t, q_t) = outs
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(p_t, [1.0, 3.0, 3.0], atol=1e-9)
    R = np.asarray(jlie.quat_to_rot(jnp.asarray(q_t)))
    np.testing.assert_allclose(R @ [1, 0, 0], [0, 1, 0], atol=1e-9)


def test_direct_similarities_oracle_and_jax():
    """`direct_similarities` == the naive per-pair min-Hamming loop (empty
    keyframes included) == JAX."""
    rng = np.random.default_rng(3)
    sizes = (5, 0, 7, 3)
    descs = [rng.integers(0, 2, (m, tpg.BRIEF_BITS)).astype(np.uint8)
             for m in sizes]
    off = np.concatenate([[0], np.cumsum(sizes)])
    cat = np.concatenate(descs)
    q = rng.integers(0, 2, (6, tpg.BRIEF_BITS)).astype(np.uint8)
    got = tpg.direct_similarities(cat, off, q, ham_thresh=120, device="cpu")
    np.testing.assert_array_equal(
        got, jpg.direct_similarities(cat, off, q, ham_thresh=120))
    for k, d in enumerate(descs):
        if len(d) == 0:
            assert got[k] == 0.0
            continue
        ham = (q[:, None, :] ^ d[None, :, :]).sum(-1)
        assert got[k] == (ham.min(1) < 120).mean()


def _flip_bits(rng, desc, n_flip):
    out = desc.copy()
    for row in out:
        idx = rng.choice(desc.shape[1], n_flip, replace=False)
        row[idx] ^= 1
    return out


def test_detect_loop_direct_retrieval_equals_jax():
    """A revisit (the same descriptors, a few bits flipped) fires and returns
    the earliest instance; unrelated descriptor sets never fire — in both,
    from the database each keeps (numpy in JAX, a tensor in the port)."""
    def build(pkg):
        rng = np.random.default_rng(4)
        node = _node(pkg, retrieval="direct", sim_hi=None)
        assert node.sim_hi == 0.9
        place = rng.integers(0, 2, (40, tpg.BRIEF_BITS)).astype(np.uint8)
        _push_desc(node, place)
        _push_desc(node, _flip_bits(rng, place, 5))
        for _ in range(8):
            _push_desc(node, rng.integers(0, 2, (40, tpg.BRIEF_BITS))
                       .astype(np.uint8))
        k = node.graph.n
        hit = node._detect_loop(k, np.zeros(tpg.BOW_WORDS),
                                _flip_bits(rng, place, 5))
        novel = rng.integers(0, 2, (40, tpg.BRIEF_BITS)).astype(np.uint8)
        return hit, node._detect_loop(k, np.zeros(tpg.BOW_WORDS), novel)
    got_j, got_t = _both(build)
    assert got_t == got_j == (0, None)


def test_database_grows_past_its_capacity_as_jax():
    """The port's retrieval database starts at 16·n_corners rows and doubles
    when a keyframe's corners do not fit: across three growths (64 → 128 →
    256 → 512 rows, 272 in use) its rows in use and offsets equal the JAX
    node's concatenation exactly, and so does the loop query answered from
    them."""
    def build(pkg):
        rng = np.random.default_rng(5)
        node = _node(pkg, retrieval="direct", sim_hi=None, n_corners=4)
        place = rng.integers(0, 2, (30, tpg.BRIEF_BITS)).astype(np.uint8)
        _push_desc(node, place)
        _push_desc(node, _flip_bits(rng, place, 5))
        for m in (0, 50, 17, 90, 3, 40, 12):
            _push_desc(node, rng.integers(0, 2, (m, tpg.BRIEF_BITS))
                       .astype(np.uint8))
        hit = node._detect_loop(node.graph.n, np.zeros(tpg.BOW_WORDS),
                                _flip_bits(rng, place, 5))
        rows = node._desc_cat
        if pkg != "jax":
            assert rows.shape[0] == 512
            rows = rows[: node._desc_off[-1]].numpy()
        return hit, list(node._desc_off), np.asarray(rows, np.uint8)
    (hit_j, off_j, rows_j), (hit_t, off_t, rows_t) = _both(build)
    assert off_t == off_j and off_t[-1] == 272
    np.testing.assert_array_equal(rows_t, rows_j)
    assert hit_t == hit_j == 0


# ----------------------------------------------------------------------------
# Replay: the same snapshots and images into both nodes
# ----------------------------------------------------------------------------

W, H = 160, 120
DURATION, LAPS = 12.0, 1.2
KF_EVERY = 5                   # a keyframe snapshot every fifth frame
N_WIN = 64                     # window points a snapshot carries
NODE_KW = dict(exclude_recent=10, min_inliers=10, n_corners=100)


class ReloRecorder:
    """Stands in for the estimator: records `set_relo_frame`."""

    def __init__(self):
        self.calls = []

    def set_relo_frame(self, p, q, matches):
        self.calls.append((np.array(p), np.array(q), dict(matches)))


def _drift(t):
    """The rigid VIO drift at time t: yaw (deg) and translation."""
    return 0.4 * t, np.array([0.02, -0.01, 0.005]) * t


@pytest.fixture(scope="module")
def replay_inputs():
    fx = 0.6 * W
    cam = jcam.PinholeCamera.create(fx, fx, W / 2.0, H / 2.0, width=W,
                                    height=H)
    traj = loop_trajectory(DURATION, laps=LAPS, radius=3.0)
    world = jrender.make_box_world(traj.p, margin=5.0, seed=0)
    rays = jrender.camera_rays(cam)
    R_all = np.asarray(jlie.quat_to_rot(jnp.asarray(traj.q)))
    lms = grounded_landmarks(world, cam, rays, traj, R_all, n_views=16,
                             lap_frac=0.85)
    rng = np.random.default_rng(0)
    snaps, imgs = [], []
    for f in range(0, int(DURATION * 10), KF_EVERY):
        k = f * 20
        Pc = (lms - traj.p[k]) @ R_all[k]
        z = Pc[:, 2]
        uv = Pc[:, :2] / np.maximum(z, 1e-6)[:, None]
        # inside the image with the node's BRIEF margin, so that every
        # snapshot hands the node exactly N_WIN points (one shape for JAX)
        pix = uv * fx + [W / 2.0, H / 2.0]
        m = tpg.PATCH_HALF + 3
        vis = np.nonzero((z > 0.5) & (pix >= m).all(1)
                         & (pix < [W - m, H - m]).all(1))[0]
        vis = vis[rng.permutation(len(vis))[:N_WIN]]
        assert len(vis) == N_WIN
        dyaw, dt = _drift(traj.t[k])
        Rd = np.asarray(jlie.ypr_to_rot(jnp.asarray([dyaw, 0.0, 0.0])))
        q_d = np.asarray(jlie.rot_to_quat(jnp.asarray(Rd @ R_all[k])))
        snaps.append({
            "t": float(traj.t[k]), "p": Rd @ traj.p[k] + dt, "q": q_d,
            "ids": vis.astype(np.int64), "X": lms[vis] @ Rd.T + dt,
            "uv": uv[vis] + rng.normal(scale=0.3 / fx, size=(len(vis), 2))})
        imgs.append(np.asarray(jrender.render_frame(world, cam, rays,
                                                    traj.p[k], R_all[k])))
    return types.SimpleNamespace(cam=cam, snaps=snaps, imgs=imgs, lms=lms)


def _replay(node, inputs):
    rec = ReloRecorder()
    returned = [node.on_keyframe(img, snap, rec)
                for img, snap in zip(inputs.imgs, inputs.snaps)]
    return types.SimpleNamespace(node=node, returned=returned, relo=rec.calls)


@pytest.fixture(scope="module")
def replayed(replay_inputs):
    jnode = JNode(cam=replay_inputs.cam, graph=jpg.PoseGraph(), **NODE_KW)
    c = replay_inputs.cam
    tcam_ = tcam.PinholeCamera.create(
        float(c.fx), float(c.fy), float(c.cx), float(c.cy), width=c.width,
        height=c.height, device="cpu")
    tnode = TNode(cam=tcam_, device="cpu", **NODE_KW)
    return _replay(jnode, replay_inputs), _replay(tnode, replay_inputs)


def test_replayed_node_equals_jax(replayed):
    """The same snapshots and images: each query's answer, the funnel, the
    accepted loops, every keyframe's descriptors and window selection, the
    retrieval database, and at least one accepted loop."""
    rj, rt = replayed
    nj, nt = rj.node, rt.node
    assert rt.returned == rj.returned
    assert nt.stats == nj.stats
    assert nt.gate_rejects == nj.gate_rejects
    assert nt.loops == nj.loops and len(nt.loops) >= 1
    for ej, et in zip(nj.entries, nt.entries, strict=True):
        np.testing.assert_array_equal(et.corner_desc, ej.corner_desc)
        np.testing.assert_array_equal(et.win_desc, ej.win_desc)
        np.testing.assert_array_equal(et.win_ids, ej.win_ids)
        np.testing.assert_array_equal(et.hist, ej.hist)
        np.testing.assert_allclose(et.corner_norm, ej.corner_norm, rtol=0,
                                   atol=1e-7)
    np.testing.assert_array_equal(nt._desc_cat[: nt._desc_off[-1]].numpy(),
                                  nj._desc_cat)
    assert nt._desc_off == nj._desc_off


def test_replayed_graph_and_relo_equal_jax(replayed):
    """The loop edges (indices exact, translation / yaw / weight 1e-9), the
    optimized graph and drift 1e-9, the relocalization feedback (poses 1e-9,
    ids exact, points 1e-12), and `correct_pose` along the snapshots."""
    rj, rt = replayed
    gj, gt = rj.node.graph, rt.node.graph
    assert (gt.n, gt.n_loops) == (gj.n, gj.n_loops)
    for name in ("loop_i", "loop_j", "seq_i", "seq_j", "seq_id"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))
    for name in ("loop_t", "loop_yaw", "loop_w", "pos", "yaw", "vio_pos",
                 "vio_yaw", "seq_t", "seq_yaw", "t_drift"):
        np.testing.assert_allclose(getattr(gt, name), getattr(gj, name),
                                   rtol=0, atol=1e-9, err_msg=name)
    assert len(rt.relo) == len(rj.relo) >= 1
    for (pj, qj, mj), (pt, qt, mt) in zip(rj.relo, rt.relo):
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)
        np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-9)
        assert list(mt) == list(mj)
        for fid in mj:
            np.testing.assert_allclose(mt[fid], mj[fid], rtol=0, atol=1e-12)
    for snap in rj.node.entries:
        p_j, q_j = rj.node.correct_pose(snap.p_vio, snap.q_vio)
        p_t, q_t = rt.node.correct_pose(snap.p_vio, snap.q_vio)
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-9)
        np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-9)


def test_landmark_fields_equal_jax(replay_inputs):
    """The replay's landmark field through the port (`loop_benchmark.
    grounded_landmarks`: the same renders, corners and backprojection on the
    CPU) equals the JAX package's exactly; `synthetic.wall_landmarks` draws
    the JAX package's points."""
    fx = 0.6 * W
    cam = tcam.PinholeCamera.create(fx, fx, W / 2.0, H / 2.0, width=W,
                                    height=H, device="cpu")
    traj = tsyn.loop_trajectory(DURATION, laps=LAPS, radius=3.0)
    world = trender.make_box_world(traj.p, margin=5.0, seed=0, device="cpu")
    R_all = tlie.quat_to_rot(torch.tensor(traj.q)).numpy()
    lms = tlb.grounded_landmarks(world, cam, trender.camera_rays(cam), traj,
                                 R_all, n_views=16, lap_frac=0.85)
    np.testing.assert_array_equal(lms, replay_inputs.lms)
    lo, hi = traj.p.min(0) - 5.0, traj.p.max(0) + 5.0
    np.testing.assert_array_equal(
        tsyn.wall_landmarks(lo, hi, 500, np.random.default_rng(3)),
        jwall(lo, hi, 500, np.random.default_rng(3)))
