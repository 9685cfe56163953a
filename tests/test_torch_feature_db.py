"""Port vs JAX: models/feature_db.py — the same insert / slide / outlier
sequence on both packages' `FeatureDB`, every array exact (both are the same
numpy code)."""

import numpy as np
import pytest

from anticipated_vins_mono_tpu.models.feature_db import FeatureDB as JDB
from anticipated_vins_mono_torch.models.feature_db import FeatureDB as TDB

FIELDS = ("ids", "pts", "vel", "prob", "mask", "inv_depth", "solved")


def _assert_same(jdb, tdb):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tdb, name), getattr(jdb, name),
                                      err_msg=name)
    assert tdb.last_obs_count == jdb.last_obs_count
    np.testing.assert_array_equal(tdb.anchor, jdb.anchor)
    np.testing.assert_array_equal(tdb.feat_valid, jdb.feat_valid)


def _rot(rng, scale=0.1):
    w = rng.normal(size=3) * scale
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _frame_feats(rng, live, next_id, n_new, zero_vel_new=True):
    """Keep a random subset of the live ids, add `n_new` new ones."""
    keep = [i for i in live if rng.uniform() < 0.8]
    feats = {}
    for i in keep + list(range(next_id, next_id + n_new)):
        pt = np.array([*rng.uniform(-0.5, 0.5, 2), 1.0])
        vel = np.zeros(2) if (zero_vel_new and i >= next_id) \
            else rng.normal(size=2) * 0.01
        feats[i] = (pt, vel, float(rng.uniform(0.3, 1.0)))
    return feats, next_id + n_new


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_slide_and_outliers_equal_jax(seed):
    """A stream of frames with track churn through a small DB that fills up
    (junk eviction), keyframe and non-keyframe slides with re-anchoring of
    solved depths, and outlier removal: both DBs stay identical."""
    rng = np.random.default_rng(seed)
    F, NF = 24, 6
    jdb, tdb = JDB(F, NF), TDB(F, NF)
    live, next_id, k = [], 0, 0
    for step in range(30):
        feats, next_id = _frame_feats(rng, live, next_id,
                                      int(rng.integers(2, 9)))
        kj = jdb.add_frame(k, feats)
        kt = tdb.add_frame(k, feats)
        assert kj == kt
        _assert_same(jdb, tdb)
        live = [int(i) for i in jdb.ids if i >= 0]
        # solve some depths, as the estimator's triangulation would
        fresh = (jdb.solved < 0.5) & (jdb.feat_valid > 0)
        depth = rng.uniform(0.1, 1.0, F)
        for db in (jdb, tdb):
            db.inv_depth[fresh] = depth[fresh]
            db.solved[fresh] = 1.0
        if k < NF - 1:
            k += 1
            continue
        if step % 5 == 3:
            bad = rng.choice(F, 3, replace=False)
            jdb.remove_outliers(bad)
            tdb.remove_outliers(bad)
        if kj:
            R0, R1, Ric = _rot(rng), _rot(rng), _rot(rng, 0.02)
            p0, p1, tic = rng.normal(size=3), rng.normal(size=3), \
                rng.normal(size=3) * 0.05
            jdb.slide_oldest(R0, p0, R1, p1, tic, Ric)
            tdb.slide_oldest(R0, p0, R1, p1, tic, Ric)
        else:
            jdb.slide_second_newest()
            tdb.slide_second_newest()
        _assert_same(jdb, tdb)
        k = NF - 1


def test_full_db_evicts_junk_but_not_this_frames_slots():
    """With no free slot, a new feature takes a junk slot (unseen in the
    previous frame, < 2 observations) but never one filled earlier in the
    same frame (`_alloc`'s current-frame exclusion): same slots as JAX."""
    F, NF = 4, 5
    jdb, tdb = JDB(F, NF), TDB(F, NF)
    pt = lambda u: (np.array([u, 0.0, 1.0]), np.zeros(2), 1.0)
    frames = [{0: pt(0.1), 1: pt(0.2), 2: pt(0.3), 3: pt(0.4)},
              {0: pt(0.1), 1: pt(0.2)},           # 2, 3 become junk
              {0: pt(0.1), 4: pt(0.5), 5: pt(0.6), 6: pt(0.7)}]
    for k, feats in enumerate(frames):
        assert jdb.add_frame(k, feats) == tdb.add_frame(k, feats)
        _assert_same(jdb, tdb)
    # 4 and 5 took the junk slots of 2 and 3; 6 found none (1 is live)
    np.testing.assert_array_equal(tdb.ids, [0, 1, 4, 5])


def test_keyframe_decision_by_parallax_equals_jax():
    """Few tracked features → keyframe; many tracked with small / large
    parallax → the threshold decides, as in the JAX package."""
    rng = np.random.default_rng(5)
    for shift in (0.0, 0.001, 0.05):
        jdb, tdb = JDB(64, 6), TDB(64, 6)
        base = {i: (np.array([*rng.uniform(-0.4, 0.4, 2), 1.0]),
                    np.zeros(2), 1.0) for i in range(30)}
        for k in range(4):
            feats = {i: (f[0] + np.array([shift * k, 0.0, 0.0]), f[1], f[2])
                     for i, f in base.items()}
            assert jdb.add_frame(k, feats) == tdb.add_frame(k, feats)
        _assert_same(jdb, tdb)
