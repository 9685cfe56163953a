"""Port vs JAX: the `AttentionSelector` host class of
models/feature_selector.py (f64, CPU) — the three policies, the id
watermark, `validity_aware`, the first-image and pre-initialization
pass-through, and the anticipation pipeline through a `FeatureDB` with
solved depths. The kept id sets are equal, for "chol" and "lowrank"."""

import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.models.feature_db import FeatureDB
from anticipated_vins_mono_tpu.models.feature_selector import \
    AttentionSelector as JSel
from anticipated_vins_mono_torch.models import anticipation as tant
from anticipated_vins_mono_torch.models.feature_selector import \
    AttentionSelector as TSel

torch.set_num_threads(1)


def _state_k1(v=(1.0, 0, 0), t=None, gyr=(0.0, 0.0, 0.0)):
    s = {"p": np.zeros(3), "q": np.array([1.0, 0, 0, 0]),
         "v": np.asarray(v, float), "ba": np.zeros(3), "bg": np.zeros(3),
         "acc": np.array([0.0, 0.0, 9.81007]), "gyr": np.asarray(gyr, float)}
    if t is not None:
        s["t"] = t
    return s


def _feat(u, v, prob=1.0):
    return (np.array([u, v, 1.0]), np.zeros(2), prob)


def _pair(impl=None, **kw):
    cfg = kw.pop("cfg")
    jcfg = jant.SelectorConfig(**cfg)
    tcfg = tant.SelectorConfig(**cfg)
    return JSel(jcfg, **kw), TSel(tcfg, impl=impl, device="cpu", **kw)


def _both(sels, *args, **kw):
    j, t = sels
    out_j = j.select(*args, **kw)
    out_t = t.select(*args, **kw)
    assert list(out_t) == list(out_j)
    assert t.tracked_ids == j.tracked_ids
    assert t.last_feature_id == j.last_feature_id
    return out_t


def test_first_image_and_pre_init_pass_everything():
    sels = _pair(cfg=dict(horizon=6, max_features=2))
    feats = {i: _feat(0.01 * i, 0.0) for i in range(10)}
    assert _both(sels, feats, _state_k1()) == feats
    more = {**feats, **{i: _feat(0.01 * i, 0.1) for i in range(10, 14)}}
    # before the backend initializes every feature passes and registers
    assert _both(sels, more, _state_k1(), initialized=False) == more
    assert sels[1].n_anticipate == 0


@pytest.mark.parametrize("impl", ["chol", "lowrank"])
def test_budget_respected_and_tracked_kept(impl):
    sels = _pair(impl, cfg=dict(horizon=6, max_features=5),
                 max_candidates=32)
    first = {i: _feat(0.02 * i - 0.1, 0.0) for i in range(3)}
    _both(sels, first, _state_k1())
    second = dict(first)
    for i in range(3, 15):
        second[i] = _feat(0.02 * (i - 9), 0.05)
    out = _both(sels, second, _state_k1())
    assert set(first).issubset(out) and len(out) == 5
    assert sels[1].n_anticipate == 1


@pytest.mark.parametrize("impl", ["chol", "lowrank"])
def test_prefers_features_visible_over_horizon(impl):
    sels = _pair(impl, cfg=dict(horizon=10, max_features=3),
                 max_candidates=16)
    first = {0: _feat(0.0, 0.0)}
    _both(sels, first, _state_k1())
    feats = dict(first)
    feats[1] = _feat(-0.56, 0.0)
    feats[2] = _feat(0.1, 0.0)
    feats[3] = _feat(0.15, 0.05)
    out = _both(sels, feats, _state_k1(v=(2.0, 0, 0)))
    assert 2 in out and 3 in out and 1 not in out


def test_watermark_keeps_rejected_ids_out():
    """An id at or below the watermark that was not passed before stays
    dropped; tracked ids pass without a selection; no new id → tracked."""
    sels = _pair(cfg=dict(horizon=6, max_features=4), max_candidates=16)
    rng = np.random.default_rng(0)
    feats = {i: _feat(*rng.uniform(-0.3, 0.3, 2)) for i in range(2)}
    _both(sels, feats, _state_k1())
    feats = {**feats, **{i: _feat(*rng.uniform(-0.3, 0.3, 2))
                         for i in range(2, 12)}}
    out = _both(sels, feats, _state_k1())
    rejected = set(feats) - set(out)
    assert rejected
    again = _both(sels, feats, _state_k1())
    assert not (rejected & set(again))
    assert set(again) == set(out)


@pytest.mark.parametrize("policy", ["quality", "random"])
def test_quality_and_random_policies_equal_jax(policy):
    sels = _pair(cfg=dict(horizon=6, max_features=6), max_candidates=32,
                 policy=policy, seed=3)
    rng = np.random.default_rng(1)
    next_id, live = 0, {}
    for frame in range(6):
        new = {next_id + i: _feat(*rng.uniform(-0.4, 0.4, 2),
                                  prob=float(rng.uniform(0.2, 1.0)))
               for i in range(8)}
        next_id += 8
        feats = {i: f for i, f in live.items() if rng.uniform() < 0.7}
        feats.update(new)
        live = _both(sels, feats, _state_k1())
    assert sels[1].n_anticipate == 0


@pytest.mark.parametrize("impl", ["chol", "lowrank"])
def test_anticipation_through_a_feature_db_equals_jax(impl):
    """Candidates' depths from the DB's solved landmarks, Δ_used from the
    tracked subset's depths: the same pipeline inputs, the same picks."""
    rng = np.random.default_rng(2)
    sels = _pair(impl, cfg=dict(horizon=6, max_features=8),
                 max_candidates=32)
    db = FeatureDB(32, 5)
    first = {i: _feat(*rng.uniform(-0.4, 0.4, 2)) for i in range(6)}
    _both(sels, first, _state_k1(), db=db)
    for k in range(2):
        db.add_frame(k, first)
    db.solved[:6] = 1.0
    db.inv_depth[:6] = rng.uniform(0.1, 0.5, 6)
    feats = {**first, **{i: _feat(*rng.uniform(-0.5, 0.5, 2),
                                    prob=float(rng.uniform(0.3, 1.0)))
                         for i in range(6, 30)}}
    state = _state_k1(v=(0.5, 0.2, 0.1), gyr=(0.05, -0.1, 0.2))
    out = _both(sels, feats, state, db=db)
    assert len(out) == 8


def test_validity_aware_falls_back_like_jax():
    """A horizon that keeps missing the realized motion trips the fallback
    to the quality policy after the same frame in both packages, with the
    same mismatch trace."""
    sels = _pair(cfg=dict(horizon=6, max_features=5), max_candidates=32,
                 validity_aware=True, validity_thresh=0.15)
    rng = np.random.default_rng(7)
    first = {i: _feat(*rng.uniform(-0.3, 0.3, 2)) for i in range(3)}
    _both(sels, first, _state_k1(t=0.0))
    next_id = 3
    for k in range(1, 7):
        feats = dict(first)
        feats.update({next_id + i: _feat(*rng.uniform(-0.4, 0.4, 2),
                                         prob=float(rng.uniform(0.2, 1.0)))
                      for i in range(6)})
        next_id += 6
        # the realized position jumps away from the constant-velocity
        # prediction every other frame
        state = _state_k1(v=(1.0, 0, 0), t=0.1 * k)
        state["p"] = np.array([0.1 * k + 0.3 * (k % 2), 0.0, 0.0])
        _both(sels, feats, state)
    j, t = sels
    np.testing.assert_allclose(t.diag_mis, j.diag_mis, rtol=1e-12)
    assert t.diag_fallback == j.diag_fallback > 0
    assert t.n_anticipate == 6 - t.diag_fallback


def test_select_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    sel = TSel(tant.SelectorConfig(horizon=4, max_features=2),
               max_candidates=8)
    sel.select({0: _feat(0.0, 0.0)}, _state_k1())
    with pytest.raises((RuntimeError, AssertionError)):
        sel.select({0: _feat(0.0, 0.0), 1: _feat(0.1, 0.0),
                    2: _feat(0.2, 0.0)}, _state_k1())
