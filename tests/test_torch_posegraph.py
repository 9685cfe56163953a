"""Port vs JAX: the pose graph (models/posegraph.py), CPU.

The scenarios of the JAX package's `tests/test_posegraph.py`, each run
through both packages on the same numpy inputs: BRIEF / Hamming, the
similarities, PGO on a drifting circle, `find_connection` on a rendered
revisit and on unrelated descriptors, capacity growth past the static cap,
sequence discontinuity and alignment, and the drift reset.

Tolerances. `brief_descriptors` bit-exact on float64 images; on float32
images a bit may differ only where JAX's own |I(a) − I(b)| is at rounding
level (≤ 1e-6 of the image's range); `hamming_match`, `bow_histogram`,
`direct_similarities` exact; `global_descriptor` 1e-12 (float64);
`find_connection` the same pairs and inlier count, R and p ≤ 1e-9 (float64,
the same numpy RANSAC draws; the port's `pnp_gn` takes `exp_so3` from its
own `ops/lie`); `pgo_solve` positions and yaw ≤ 1e-8 (float64; the port's
closed-form Jacobian and block assembly against JAX's `jacfwd` and one-hot
einsum), the graph's bookkeeping arrays exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import frontend as jfe
from anticipated_vins_mono_tpu.models import posegraph as jpg
from anticipated_vins_mono_tpu.ops import cameras as jcam
from anticipated_vins_mono_tpu.ops import lie as jlie
from anticipated_vins_mono_torch.models import posegraph as tpg

torch.set_num_threads(1)

PGO_ATOL = 1e-8
BOOK = ("vio_pos", "vio_yaw", "pitch_roll", "seq_id", "seq_i", "seq_j",
        "seq_t", "seq_yaw", "seq_valid", "loop_i", "loop_j", "loop_t",
        "loop_yaw", "loop_valid", "loop_w")


def _graph(mod, cfg, **kw):
    if mod is tpg:
        kw["device"] = "cpu"
    return mod.PoseGraph(mod.PGOConfig(**cfg), **kw)


def _assert_graphs_equal(gj, gt, atol=PGO_ATOL):
    assert (gt.n, gt.n_seq, gt.n_loops, gt.cur_sequence) == \
        (gj.n, gj.n_seq, gj.n_loops, gj.cur_sequence)
    assert tuple(gt.cfg) == tuple(gj.cfg)
    for name in BOOK:
        np.testing.assert_allclose(getattr(gt, name), getattr(gj, name),
                                   rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(gt.pos, gj.pos, rtol=0, atol=atol)
    np.testing.assert_allclose(gt.yaw, gj.yaw, rtol=0, atol=atol)
    np.testing.assert_allclose(gt.t_drift, gj.t_drift, rtol=0, atol=atol)
    assert gt.yaw_drift == pytest.approx(gj.yaw_drift, abs=atol)
    np.testing.assert_array_equal(gt._gauge_mask(), gj._gauge_mask())


def _blocky(rng):
    return np.kron(rng.random((30, 40)), np.ones((4, 4)))


def test_brief_bit_exact_on_float64_images():
    """The JAX test's blocky image and points, plus 200 random points,
    float64: every bit equal; the Hamming matrices equal, the diagonal 0."""
    rng = np.random.default_rng(0)
    img = _blocky(rng)
    pts = np.concatenate([[[40.0, 40.0], [80.0, 60.0], [100.0, 30.0]],
                          rng.uniform(0.0, 119.0, size=(200, 2))])
    dj = np.asarray(jpg.brief_descriptors(jnp.asarray(img), jnp.asarray(pts)))
    dt = tpg.brief_descriptors(torch.tensor(img), torch.tensor(pts))
    np.testing.assert_array_equal(dt.numpy(), dj)
    ham_j = np.asarray(jpg.hamming_match(jnp.asarray(dj), jnp.asarray(dj)))
    ham_t = tpg.hamming_match(dt, dt).numpy()
    np.testing.assert_array_equal(ham_t, ham_j)
    assert np.all(np.diag(ham_t) == 0) and ham_t[0, 1] > 40
    # the descriptor survives a monotone illumination change
    d3 = tpg.brief_descriptors(torch.tensor(img * 0.5 + 0.1),
                               torch.tensor(pts))
    assert np.all(np.diag(tpg.hamming_match(dt, d3).numpy()) == 0)


def test_brief_float32_flips_only_at_rounding_level():
    """The blocky image in float32 (its flat blocks make exact ties
    common): a bit may differ only where JAX's own two samples are equal to
    rounding."""
    from anticipated_vins_mono_tpu.models.frontend import _bilinear, _blur3
    rng = np.random.default_rng(1)
    img = np.asarray(_blocky(rng), np.float32)
    pts = rng.uniform(0.0, 119.0, size=(300, 2)).astype(np.float32)
    dj = np.asarray(jpg.brief_descriptors(jnp.asarray(img), jnp.asarray(pts)))
    dt = tpg.brief_descriptors(torch.tensor(img), torch.tensor(pts)).numpy()
    sm = _blur3(_blur3(jnp.asarray(img)))
    pa, pb = jpg._brief_pattern()
    va = np.asarray(_bilinear(sm, jnp.asarray(pts)[:, None] + pa[None]))
    vb = np.asarray(_bilinear(sm, jnp.asarray(pts)[:, None] + pb[None]))
    flips = dt != dj
    assert flips.mean() < 1e-3
    assert np.all(np.abs(va - vb)[flips] <= 1e-6)


def test_hamming_bow_and_global_descriptor_equal_jax():
    rng = np.random.default_rng(1)
    d_a = rng.random((50, tpg.BRIEF_BITS)) > 0.5
    d_b = rng.random((40, tpg.BRIEF_BITS)) > 0.5
    np.testing.assert_array_equal(
        tpg.hamming_match(torch.tensor(d_a), torch.tensor(d_b)).numpy(),
        np.asarray(jpg.hamming_match(jnp.asarray(d_a), jnp.asarray(d_b))))
    valid = (rng.random(50) > 0.2).astype(np.float64)
    np.testing.assert_array_equal(
        tpg.bow_histogram(torch.tensor(d_a), torch.tensor(valid)).numpy(),
        np.asarray(jpg.bow_histogram(jnp.asarray(d_a), jnp.asarray(valid))))
    np.testing.assert_allclose(
        tpg.bow_descriptor(torch.tensor(d_a), torch.tensor(valid)).numpy(),
        np.asarray(jpg.bow_descriptor(jnp.asarray(d_a), jnp.asarray(valid))),
        rtol=0, atol=1e-7)
    g_t = tpg.global_descriptor(torch.tensor(d_a), torch.tensor(valid))
    g_j = jpg.global_descriptor(jnp.asarray(d_a), jnp.asarray(valid))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-12)
    g3 = tpg.global_descriptor(torch.tensor(d_b),
                               torch.ones(40, dtype=torch.float64))
    assert float(g_t @ g_t) > 0.999 and float(g_t @ g3) < 0.995


def test_similarities_equal_jax():
    """`direct_similarities` with empty keyframes (also the last one), and
    `idf_similarities`: exact."""
    rng = np.random.default_rng(3)
    sizes = (5, 0, 7, 3, 0)
    descs = [rng.integers(0, 2, (m, tpg.BRIEF_BITS)).astype(np.uint8)
             for m in sizes]
    off = np.concatenate([[0], np.cumsum(sizes)])
    cat = np.concatenate(descs)
    q = rng.integers(0, 2, (6, tpg.BRIEF_BITS)).astype(np.uint8)
    for thresh in (48, 120, 128):
        want = jpg.direct_similarities(cat, off[:-1], q, ham_thresh=thresh)
        got = tpg.direct_similarities(torch.tensor(cat), off[:-1],
                                      torch.tensor(q), ham_thresh=thresh)
        np.testing.assert_array_equal(got, want)
        # an empty last keyframe (np.minimum.reduceat cannot take it)
        got_all = tpg.direct_similarities(cat, off, q, ham_thresh=thresh,
                                          device="cpu")
        np.testing.assert_array_equal(got_all, np.append(want, 0.0))
    hists = rng.random((9, tpg.BOW_WORDS)) * (rng.random((9, 1)) > 0.3)
    np.testing.assert_array_equal(tpg.idf_similarities(hists, hists[2]),
                                  jpg.idf_similarities(hists, hists[2]))


def _circle_with_drift(n=40, drift=0.002):
    true_p, true_yaw = [], []
    for k in range(n):
        th = 2 * np.pi * k / (n - 1)
        true_p.append([np.cos(th), np.sin(th), 0.0])
        true_yaw.append(np.degrees(th))
    true_p = np.asarray(true_p)
    drift_p = true_p + np.arange(n)[:, None] * [drift, drift * 0.5,
                                                drift * 0.2]
    return true_p, np.asarray(true_yaw), drift_p


def _wrap(y):
    return (y + 180.0) % 360.0 - 180.0


def _yaw_quat(yaw):
    return np.asarray(jlie.rot_to_quat(jlie.ypr_to_rot(
        jnp.asarray([_wrap(yaw), 0.0, 0.0]))))


def _loop_drift_graph(mod):
    graph = _graph(mod, dict(max_kf=64, max_loops=8, iters=30))
    true_p, true_yaw, drift_p = _circle_with_drift()
    n = len(true_p)
    for k in range(n):
        hint = None
        if k == n - 1:
            R0 = np.asarray(jlie.ypr_to_rot(
                jnp.asarray([_wrap(true_yaw[0]), 0.0, 0.0])))
            hint = (0, R0.T @ (true_p[k] - true_p[0]),
                    _wrap(true_yaw[k] - true_yaw[0]))
        graph.add_keyframe(drift_p[k], _yaw_quat(true_yaw[k]), loop_hint=hint)
    graph.optimize()
    return graph, true_p, true_yaw, drift_p


def test_pgo_loop_drift_equals_jax():
    """The drifting circle with one verified loop edge: the optimized
    positions and yaw 1e-8, the drift 1e-8; the port's correction pulls the
    endpoint back as the JAX test asks."""
    gj, true_p, true_yaw, drift_p = _loop_drift_graph(jpg)
    gt, *_ = _loop_drift_graph(tpg)
    _assert_graphs_equal(gj, gt)
    n = len(true_p)
    err_after = np.linalg.norm(gt.pos[n - 1] - true_p[n - 1])
    assert err_after < 0.6 * np.linalg.norm(drift_p[n - 1] - true_p[n - 1])
    p_t, y_t = gt.correct(drift_p[n - 1], true_yaw[n - 1])
    p_j, y_j = gj.correct(drift_p[n - 1], true_yaw[n - 1])
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=PGO_ATOL)
    assert y_t == pytest.approx(y_j, abs=PGO_ATOL)


def test_pgo_solve_weights_gauge_and_huber_equal_jax():
    """`pgo_solve` alone: loop edges beyond the Huber radius, per-edge
    weights, an explicit gauge, pitch/roll ≠ 0, 10 iterations."""
    rng = np.random.default_rng(7)
    K, L, n = 32, 8, 20
    cfg_j, cfg_t = jpg.PGOConfig(max_kf=K, max_loops=L, iters=10), \
        tpg.PGOConfig(max_kf=K, max_loops=L, iters=10)
    pos = np.zeros((K, 3))
    pos[:n] = np.cumsum(rng.normal(scale=0.3, size=(n, 3)), 0)
    yaw = np.zeros(K)
    yaw[:n] = rng.uniform(-170, 170, n)
    pr = np.zeros((K, 2))
    pr[:n] = rng.normal(scale=5.0, size=(n, 2))
    kf_valid = (np.arange(K) < n).astype(float)
    E = 4 * K
    seq_i = np.zeros(E, np.int32)
    seq_j = np.zeros(E, np.int32)
    seq_valid = np.zeros(E)
    seq_i[:n - 1], seq_j[:n - 1], seq_valid[:n - 1] = \
        np.arange(n - 1), np.arange(1, n), 1.0
    seq_t = rng.normal(scale=0.3, size=(E, 3))
    seq_yaw = rng.normal(scale=10.0, size=E)
    loop_i = np.array([0, 2, 5, 0, 0, 0, 0, 0], np.int32)
    loop_j = np.array([15, 18, 19, 0, 0, 0, 0, 0], np.int32)
    loop_valid = np.array([1.0, 1.0, 1.0, 0, 0, 0, 0, 0])
    loop_t = rng.normal(scale=1.0, size=(L, 3))
    loop_yaw = rng.normal(scale=20.0, size=L)
    loop_w = rng.uniform(0.25, 2.5, L)
    gauge = np.zeros(K)
    gauge[[0, 10]] = 1.0
    args = (pos, yaw, pr, kf_valid, seq_i, seq_j, seq_t, seq_yaw, seq_valid,
            loop_i, loop_j, loop_t, loop_yaw, loop_valid)
    for g in (gauge, None):
        pj, yj = jpg.pgo_solve(*(jnp.asarray(a) for a in args), cfg_j,
                               gauge=None if g is None else jnp.asarray(g),
                               loop_w=jnp.asarray(loop_w))
        pt, yt = tpg.pgo_solve(*(torch.tensor(a) for a in args), cfg_t,
                               gauge=None if g is None else torch.tensor(g),
                               loop_w=torch.tensor(loop_w))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                                   atol=PGO_ATOL)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=PGO_ATOL)


def test_similarity_loop_detection_equals_jax():
    """Loop detection from global descriptors (`gdesc`): the same loop, the
    VIO-derived loop edge and the graph arrays."""
    graphs = []
    for mod in (jpg, tpg):
        graph = _graph(mod, dict(max_kf=128, max_loops=8), sim_thresh=0.95,
                       exclude_recent=10)
        rng = np.random.default_rng(2)
        descs = [rng.random(tpg.BRIEF_BITS) for _ in range(15)]
        descs = [d / np.linalg.norm(d) for d in descs]
        q = np.array([1.0, 0, 0, 0])
        for k in range(15):
            graph.add_keyframe(np.array([k, 0, 0.0]), q, gdesc=descs[k])
        assert graph.add_keyframe(np.array([2.1, 0, 0.0]), q,
                                  gdesc=descs[2]) == 2
        graphs.append(graph)
    _assert_graphs_equal(*graphs)


def _render_plane(cam, tex, p_cam, R_cw, z_plane=6.0):
    """The JAX test's textured plane at z = 6, rendered with the JAX
    package's camera and bilinear sampler."""
    H, W = 120, 160
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.asarray(jcam.lift_projective(
        cam, jnp.asarray(np.stack([xx, yy], -1).reshape(-1, 2),
                         jnp.float32)))
    d_w = rays @ R_cw
    lam = (z_plane - p_cam[2]) / np.maximum(d_w[:, 2], 1e-6)
    X = p_cam[None] + lam[:, None] * d_w
    ui = (X[:, 0] * 14.0) % tex.shape[1]
    vi = (X[:, 1] * 14.0) % tex.shape[0]
    vals = np.asarray(jfe._bilinear(
        jnp.asarray(tex, jnp.float32),
        jnp.asarray(np.stack([ui, vi], -1), jnp.float32)))
    return vals.reshape(H, W)


@pytest.fixture(scope="module")
def revisit():
    """The JAX test's rendered revisit: corners + BRIEF of the old and the
    new view, the old corners' 3-D points and the new ones' normalized
    coordinates (float64), all from the JAX package."""
    rng = np.random.default_rng(0)
    cam = jcam.PinholeCamera.create(120.0, 120.0, 80.0, 60.0, width=160,
                                    height=120)
    tex = np.kron(rng.random((80, 80)), np.ones((3, 3)))
    dyaw = np.radians(6.0)
    R_new = np.array([[np.cos(dyaw), -np.sin(dyaw), 0],
                      [np.sin(dyaw), np.cos(dyaw), 0], [0, 0, 1.0]])
    p_new = np.array([0.25, -0.1, 0.0])
    views = []
    for p, R in ((np.zeros(3), np.eye(3)), (p_new, R_new)):
        img = jnp.asarray(_render_plane(cam, tex, p, R), jnp.float32)
        uv, _s, valid = jfe.detect_features(
            img, jnp.zeros((120, 160), jnp.float32), 60, min_dist=8)
        uv = np.asarray(uv)[np.asarray(valid)]
        desc = np.asarray(jpg.brief_descriptors(img, jnp.asarray(uv)))
        rays = np.asarray(jcam.lift_projective(cam, jnp.asarray(uv)),
                          np.float64)
        views.append((img, uv, desc, rays))
    (img_o, uv_o, d_old, rays_o), (img_n, uv_n, d_new, rays_n) = views
    X_old = rays_o * (6.0 / rays_o[:, 2])[:, None]
    return dict(img_old=np.asarray(img_o), uv_old=uv_o, d_old=d_old,
                X_old=X_old, d_new=d_new, kps_new=rays_n[:, :2],
                R_new=R_new, p_new=p_new)


def test_find_connection_on_a_rendered_revisit_equals_jax(revisit):
    """The same descriptors and points into both: the same pairs and inlier
    count, R and p 1e-9, rms 1e-12; the recovered pose is the revisit's
    (the JAX test's oracle). The port's BRIEF on the same image and corners
    differs from JAX's only at rounding-level comparisons."""
    r = revisit
    kw = dict(min_inliers=15, reproj_thresh=4.0 / 120.0)
    got_j = jpg.find_connection(jnp.asarray(r["d_old"]), r["X_old"],
                                jnp.asarray(r["d_new"]), r["kps_new"], **kw)
    got_t = tpg.find_connection(torch.tensor(r["d_old"]), r["X_old"],
                                torch.tensor(r["d_new"]), r["kps_new"], **kw)
    assert got_j is not None and got_t is not None
    R_j, p_j, n_j, pairs_j, rms_j = got_j
    R_t, p_t, n_t, pairs_t, rms_t = got_t
    assert (n_t, pairs_t) == (n_j, pairs_j) and n_t >= 15
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-9)
    assert rms_t == pytest.approx(rms_j, abs=1e-12)
    np.testing.assert_allclose(p_t, r["p_new"], atol=0.15)
    d_t = tpg.brief_descriptors(torch.tensor(r["img_old"]),
                                torch.tensor(r["uv_old"])).numpy()
    assert (d_t != r["d_old"]).mean() < 1e-3


def test_find_connection_rejects_unrelated_as_jax():
    """Random descriptors: both reject, with the same funnel counter."""
    rng = np.random.default_rng(5)
    d1 = rng.random((40, tpg.BRIEF_BITS)) > 0.5
    d2 = rng.random((40, tpg.BRIEF_BITS)) > 0.5
    X = rng.normal(size=(40, 3)) + [0, 0, 6]
    uv = rng.normal(size=(40, 2)) * 0.2
    st_j, st_t = {}, {}
    assert jpg.find_connection(jnp.asarray(d1), X, jnp.asarray(d2), uv,
                               fail_stats=st_j) is None
    assert tpg.find_connection(torch.tensor(d1), X, torch.tensor(d2), uv,
                               fail_stats=st_t) is None
    assert st_t == st_j and st_t


def _capacity_graph(mod):
    graph = _graph(mod, dict(max_kf=8, max_loops=2, iters=10))
    q = np.array([1.0, 0, 0, 0])
    for k in range(25):
        graph.add_keyframe(np.array([k * 0.1, 0.02 * np.sin(k), 0.0]), q,
                           t=float(k))
    for k in range(5):
        graph.add_keyframe(np.array([0.1, 0, 0.0]), q,
                           loop_hint=(1, np.zeros(3), 0.0), t=25.0 + k)
    graph.optimize()
    return graph


def test_capacity_growth_equals_jax():
    """Growth past the static caps (8 keyframes → 32, 2 loops → 8), then
    PGO at the grown capacity: 1e-8."""
    gj, gt = _capacity_graph(jpg), _capacity_graph(tpg)
    assert gt.cfg.max_kf == 32 and gt.cfg.max_loops == 8 and gt.n == 30
    _assert_graphs_equal(gj, gt)


def _sequences_graph(mod):
    graph = _graph(mod, dict(max_kf=64, max_loops=8, iters=15))
    q = np.array([1.0, 0, 0, 0])
    for k in range(10):
        graph.add_keyframe(np.array([k * 1.0, 0, 0.0]), q, t=0.1 * k)
    # a 5 s gap opens sequence 1 in its own local frame
    for k in range(5):
        graph.add_keyframe(np.array([k * 1.0, 0, 0.0]), q, t=6.0 + 0.1 * k)
    assert graph.add_keyframe(np.array([2.0, 0, 0.0]), q,
                              loop_hint=(5, np.zeros(3), 0.0), t=6.6) == 5
    aligned = graph.pos[: graph.n].copy()
    # a third sequence, unanchored: its head is pinned by the gauge
    for k in range(4):
        graph.add_keyframe(np.array([k * 0.5, 1.0, 0.0]), q, t=20.0 + 0.1 * k)
    graph.optimize()
    return graph, aligned


def test_sequence_discontinuity_alignment_and_gauge_equal_jax():
    """A second sequence rigidly aligned by a cross-sequence loop, a third
    left unanchored (its head in the gauge): the alignment exact, PGO with
    the multi-sequence gauge 1e-8."""
    (gj, al_j), (gt, al_t) = _sequences_graph(jpg), _sequences_graph(tpg)
    np.testing.assert_allclose(al_t, al_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(al_t[-1], [5.0, 0, 0], atol=1e-9)
    assert gt.cur_sequence == 2 and gt._gauge_mask().sum() == 2
    _assert_graphs_equal(gj, gt)


def _persist_graph(mod):
    graph = _graph(mod, dict(max_kf=64, max_loops=8, iters=15))
    q = _yaw_quat(20.0)
    for k in range(10):
        graph.add_keyframe(np.array([k * 1.0, 0, 0.0]), q, t=0.1 * k)
    for k in range(3):
        graph.add_keyframe(np.array([k * 1.0, 0, 0.0]), q, t=6.0 + 0.1 * k)
    graph.add_keyframe(np.array([2.0, 0, 0.0]), q,
                       loop_hint=(5, np.array([0.1, 0.0, 0.0]), 4.0), t=6.3)
    assert graph.add_keyframe(np.array([3.0, 0, 0.0]), q, t=6.4) is None
    graph.add_keyframe(np.array([4.0, 0, 0.0]), q,
                       loop_hint=(7, np.zeros(3), 0.0), t=6.5)
    return graph


def test_alignment_persists_for_later_keyframes_as_jax():
    """After a cross-sequence loop (with a yaw offset) aligns sequence 1,
    later keyframes are re-expressed through the same transform, and a
    second cross-sequence loop does not re-align: every array equal."""
    gj, gt = _persist_graph(jpg), _persist_graph(tpg)
    assert gt._seq_anchored == gj._seq_anchored == {1}
    a_j, a_t = gj._seq_align[1], gt._seq_align[1]
    assert a_t[0] == pytest.approx(a_j[0], abs=1e-12)
    np.testing.assert_allclose(a_t[1], a_j[1], rtol=0, atol=1e-12)
    _assert_graphs_equal(gj, gt, atol=1e-12)


def test_new_sequence_resets_drift_as_jax():
    graphs = []
    for mod in (jpg, tpg):
        graph = _graph(mod, dict(max_kf=32, max_loops=4, iters=10))
        graph.yaw_drift = 12.0
        graph.t_drift = np.array([1.0, 2.0, 3.0])
        graph.new_sequence()
        graphs.append(graph)
    gj, gt = graphs
    assert gt.yaw_drift == gj.yaw_drift == 0.0
    np.testing.assert_array_equal(gt.t_drift, gj.t_drift)
    assert gt.cur_sequence == gj.cur_sequence == 1
