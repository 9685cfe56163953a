"""Port vs JAX: ops/triangulation.py (f64, CPU).

Tolerance: `inv_depth` rtol=1e-8. Both sides take the eigenvector of the
smallest eigenvalue of the same 4×4 AᵀA; its direction is conditioned by the
gap to the next eigenvalue, so LAPACK-vs-XLA rounding (~1e-16) is amplified
by a few decades, not more. The depth is a ratio of two components of that
vector, so its sign convention cancels. `good` is exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import triangulation as jtri
from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_tpu.utils import synthetic as jsyn
from anticipated_vins_mono_torch.ops import triangulation as ttri
from anticipated_vins_mono_torch.ops import window as tw
from anticipated_vins_mono_torch.utils import convert

torch.set_num_threads(1)

CFG = dict(window=6, max_feats=32)


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _both(jstate, pts, mask, anchor):
    jcfg, tcfg = jw.WindowConfig(**CFG), tw.WindowConfig(**CFG)
    jd, jg = jtri.triangulate(jstate, jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(anchor), jcfg)
    st = convert.window_state_from_numpy(_np_tree(jstate), "cpu")
    td, tg = ttri.triangulate(st, torch.tensor(pts), torch.tensor(mask),
                              torch.tensor(anchor), tcfg)
    return (np.asarray(jd), np.asarray(jg)), (td.numpy(), tg.numpy())


@pytest.mark.parametrize("seed,which", [(0, "gt"), (1, "gt"), (1, "init")])
def test_triangulate_equals_jax(seed, which):
    jp = jsyn.make_window_problem(jw.WindowConfig(**CFG), seed=seed,
                                  perturb=0.3, pixel_noise=0.5)
    state = getattr(jp, which)
    m = jp.meas
    (jd, jg), (td, tg) = _both(state, np.array(m.pts), np.array(m.mask),
                               np.array(m.anchor))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(td, jd, rtol=1e-8, atol=0)
    assert tg.sum() >= 10 and td.dtype == np.float64
    if which == "gt":
        # noise of 0.5 px on a few-metre baseline: depths near the truth
        ok = tg > 0
        np.testing.assert_allclose(td[ok], np.array(jp.gt.inv_depth)[ok],
                                   rtol=0.2)


def test_one_observation_and_zero_baseline_are_not_good():
    """A slot seen once, and a slot seen from poses that all coincide (no
    parallax), both come out good = 0 at the 5 m default depth."""
    jp = jsyn.make_window_problem(jw.WindowConfig(**CFG), seed=0)
    m = jp.meas
    pts, mask = np.array(m.pts), np.array(m.mask)
    anchor = np.array(m.anchor)
    mask[0] = 0.0
    mask[0, 2] = 1.0
    anchor[0] = 2
    still = jp.gt._replace(p=jnp.broadcast_to(jp.gt.p[0], jp.gt.p.shape),
                           q=jnp.broadcast_to(jp.gt.q[0], jp.gt.q.shape))
    (jd, jg), (td, tg) = _both(jp.gt, pts, mask, anchor)
    assert tg[0] == 0 and jg[0] == 0 and td[0] == 0.2 == jd[0]
    pts_still = np.broadcast_to(pts[:, :1], pts.shape).copy()
    (jd, jg), (td, tg) = _both(still, pts_still, mask, anchor)
    np.testing.assert_array_equal(tg, np.zeros_like(tg))
    np.testing.assert_array_equal(jg, np.zeros_like(jg))
    np.testing.assert_array_equal(td, np.full_like(td, 0.2))
