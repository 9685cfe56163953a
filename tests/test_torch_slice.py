"""The slice as a whole, port vs JAX, at a small size on the CPU (f64):
window problem → anticipation selector → `feat_w` → batched LM solve, with
the constants of the JAX package's streaming composition
(`utils/streaming_bench.py`). Also `make_window_problem(seed)` field by
field, and the numpy hand-over of the containers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.models.feature_selector import \
    _device_select as j_device_select
from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_tpu.utils import synthetic as jsyn
from anticipated_vins_mono_torch.models import anticipation as tant
from anticipated_vins_mono_torch.models.feature_selector import device_select
from anticipated_vins_mono_torch.ops import window as tw
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils import synthetic as tsyn
from anticipated_vins_mono_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

CFG = dict(window=4, max_feats=24, iters=8)
HORIZON, KAPPA, B = 4, 6, 2


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _assert_tree_close(t_tree, j_tree, rtol, atol):
    t_leaves = tree_leaves(convert.to_numpy_tree(t_tree))
    j_leaves = jax.tree_util.tree_leaves(_np_tree(j_tree))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(perturb=0.3, pixel_noise=0.5)),
    (0, dict()),
    (3, dict(perturb=0.1, bias_scale=1.0, imu_noise=True)),
])
def test_make_window_problem_equals_jax(seed, kw):
    """Same numpy RNG call order → the same problem. atol=1e-12; rtol=1e-12
    covers the whitening matrices S, whose entries are ~1e6."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("imu_noise"):
        from anticipated_vins_mono_tpu.ops.preintegration import ImuNoise as JN
        from anticipated_vins_mono_torch.ops.preintegration import ImuNoise as TN
        jkw["imu_noise"], tkw["imu_noise"] = JN(), TN()
    jp = jsyn.make_window_problem(jw.WindowConfig(**CFG), seed=seed, **jkw)
    tp = tsyn.make_window_problem(tw.WindowConfig(**CFG), seed=seed,
                                  device="cpu", **tkw)
    for name in ("gt", "init", "meas"):
        _assert_tree_close(getattr(tp, name), getattr(jp, name), 1e-12, 1e-12)
    np.testing.assert_array_equal(tp.frame_times, jp.frame_times)
    assert tp.meas.anchor.dtype == torch.int32


def test_full_size_problem_shapes_f32():
    cfg = tw.WindowConfig(window=10, max_feats=128, iters=8)
    prob = tsyn.make_window_problem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                                    dtype=torch.float32, device="cpu")
    assert cfg.dim == 178 and prob.init.p.shape == (11, 3)
    assert prob.meas.pts.shape == (128, 11, 3)
    assert prob.meas.pre.S.shape == (10, 15, 15)
    assert all(x.dtype == torch.float32 for x in tree_leaves(prob.init))


def _selector_inputs(init, meas, nf1, F, as_array):
    """The arguments of `_device_select` as the streaming composition builds
    them: newest frame's state, one IMU sample, identity extrinsics, empty
    used / landmark sets, candidates = the newest frame's observations."""
    z = lambda *s: as_array(np.zeros(s))
    probs = np.random.default_rng(1).uniform(0.5, 1.0, F)
    return probs, (
        init.p[nf1], init.q[nf1], init.v[nf1],
        as_array(np.array([0.2, 0.1, 9.9])),
        as_array(np.array([0.02, -0.01, 0.05])),
        init.ba[nf1], init.bg[nf1], z(3), as_array(np.array([1.0, 0, 0, 0])),
        meas.pts[:, nf1], as_array(probs), meas.mask[:, nf1] * meas.feat_valid,
        z(F, 3), as_array(np.full(F, 5.0)), z(F),
        z(F, 2), as_array(np.full(F, 5.0)), z(F))


def test_slice_matches_jax(monkeypatch):
    """problem → select → feat_w → solve, B=2: identical mask, final state
    atol=1e-6 (eight accept/reject iterations amplify rounding)."""
    monkeypatch.setenv("ANT_SELECT_IMPL", "chol")
    monkeypatch.setenv("ANT_SELECT_GROUP", "1")
    jcfg, tcfg = jw.WindowConfig(**CFG), tw.WindowConfig(**CFG)
    F, nf1 = jcfg.max_feats, jcfg.nf - 1
    jscfg = jant.SelectorConfig(horizon=HORIZON, max_features=KAPPA)
    tscfg = tant.SelectorConfig(horizon=HORIZON, max_features=KAPPA)

    jouts, touts = [], []
    for seed in range(B):
        jp = jsyn.make_window_problem(jcfg, seed=seed, perturb=0.3,
                                      pixel_noise=0.5)
        tp = tsyn.make_window_problem(tcfg, seed=seed, perturb=0.3,
                                      pixel_noise=0.5, device="cpu")
        probs, jargs = _selector_inputs(jp.init, jp.meas, nf1, F, jnp.asarray)
        _, targs = _selector_inputs(tp.init, tp.meas, nf1, F, torch.from_numpy)
        jsel, *_ = j_device_select(jscfg, KAPPA, 20, 0.005, *jargs)
        tsel, *_ = device_select(tscfg, KAPPA, 20, 0.005, *targs,
                                 impl="chol", device="cpu")
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        assert int(tsel.sum()) == KAPPA
        jw_ = 0.5 + 0.5 * jnp.asarray(probs) + 0.5 * jsel
        tw_ = 0.5 + 0.5 * torch.from_numpy(probs) + 0.5 * tsel
        jouts.append((jp.init, jp.meas._replace(feat_w=jw_)))
        touts.append((tp.init, tp.meas._replace(feat_w=tw_)))

    jst, jms = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jouts)
    tst, tms = tree_map(lambda *x: torch.stack(x), *touts)
    jout, jd = jax.vmap(lambda s, m: jw.lm_solve(s, m, jcfg))(jst, jms)
    tout, td = tw.lm_solve(tst, tms, tcfg, device="cpu")
    _assert_tree_close(tout, jout, 0, 1e-6)
    np.testing.assert_allclose(td["cost"].numpy(), np.asarray(jd["cost"]),
                               rtol=1e-6)
    assert (td["cost"] < td["cost0"]).all()


def test_convert_copies_keeps_dtype_and_none():
    """`from_numpy` containers never alias their source (torch.from_numpy
    alone would), keep dtype, and keep absent optional fields as None."""
    jcfg = jw.WindowConfig(window=3, max_feats=8)
    jp = jsyn.make_window_problem(jcfg, seed=0, dtype=jnp.float32)
    n_state, n_meas = _np_tree(jp.init), _np_tree(jp.meas)
    n_meas = n_meas._replace(zupt_w=np.ones(4, np.float32))
    st = convert.window_state_from_numpy(n_state, "cpu")
    ms = convert.window_measurements_from_numpy(n_meas, "cpu")
    assert isinstance(st, tw.WindowState) and isinstance(ms.prior.lin,
                                                         tw.WindowState)
    assert st.p.dtype == torch.float32 and ms.anchor.dtype == torch.int32
    assert st.relo_p is None and ms.feat_w is None and ms.td_obs is None
    assert ms.relo_pts is None and ms.anchor_pin_rp is None
    assert ms.zupt_w is not None and ms.pre.S.shape == (3, 15, 15)
    before = n_state.p.copy()
    st.p.add_(1.0)
    ms.pts.zero_()
    np.testing.assert_array_equal(n_state.p, before)
    assert np.any(n_meas.pts != 0)
    back = convert.to_numpy_tree(st)
    assert isinstance(back, tw.WindowState) and back.relo_q is None
    back.q[...] = 7.0
    assert not np.any(st.q.numpy() == 7.0)
    flat = convert.from_numpy_tree((n_state.p, None, {"a": n_state.td}), "cpu")
    assert flat[1] is None and flat[2]["a"].shape == ()
