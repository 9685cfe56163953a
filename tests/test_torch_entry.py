"""The port's entry points (`entry.py`) against the repository root's
`__graft_entry__.py`, CPU.

`entry()` builds the same flagship problem (10-keyframe window, 128 slots,
seed 0, perturb 0.3, 0.5 px, float32) as the JAX `entry()`, leaf by leaf
within float32 rounding (rtol 1e-5, atol 1e-6 of the leaf's largest
entry: the whitening factors reach 1.4e4); `chip_smoke.py`'s `parallel`
phase runs its solve on the card. `dryrun_multichip(2)` runs both stages on two ranks
(spawned processes, gloo) in float64, its solve at `tests/test_parallel.py`'s
window (4 keyframes, 32 slots, 6 iterations; `chip_smoke.py` runs the
flagship's): the sharded solve equals the port's single-rank `lm_solve`
(positions 1e-6, cost rtol 1e-5, the bounds of `tests/test_parallel.py`)
and the sharded selection, at the flagship selector's size, picks the set
of `select_informative(impl="chol")`, Ω within rtol 1e-8.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from anticipated_vins_mono_torch import entry
from anticipated_vins_mono_torch.models.anticipation import select_informative
from anticipated_vins_mono_torch.ops.window import WindowConfig, lm_solve
from anticipated_vins_mono_torch.parallel.selector import gather_selection
from anticipated_vins_mono_torch.utils.synthetic import make_window_problem

torch.set_num_threads(1)

CFG = WindowConfig(window=4, max_feats=32, iters=6)


def test_entry_problem_equals_jax():
    fn, args = entry.entry(device="cpu")
    _, jargs = jentry.entry()
    for t, j in zip(jax.tree_util.tree_leaves(args),
                    jax.tree_util.tree_leaves(jargs), strict=True):
        t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype
        # float32 rounding of the generator, relative to the leaf's scale
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(j).max(), 1.0))
    assert callable(fn)


@pytest.fixture(scope="module")
def dryrun():
    return entry.dryrun_multichip(2, dtypes=(torch.float64,), device="cpu",
                                  cfg=CFG)


def test_dryrun_solve_equals_one_rank(dryrun):
    res = dryrun[torch.float64]
    prob = make_window_problem(CFG, dtype=torch.float64, device="cpu",
                               **entry.FLAGSHIP_PROBLEM)
    st, diag = lm_solve(prob.init, prob.meas, CFG, device="cpu")
    assert [(r["solve"]["dp"], r["solve"]["fp"]) for r in res] == \
        [(0, 0), (0, 1)]
    for r in res:
        np.testing.assert_allclose(r["solve"]["p"][0], st.p.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(r["solve"]["cost"][0], float(diag["cost"]),
                                   rtol=1e-5)


def test_dryrun_selection_equals_select_informative(dryrun):
    sel, Om = gather_selection([r["select"] for r in dryrun[torch.float64]],
                               n_fp=2)
    Omega, Deltas, probs, valid = (torch.from_numpy(x) for x in
                                   entry.selection_inputs(1, 2, np.float64))
    ref_sel, ref_Om = select_informative(Omega[0], Deltas[0], probs[0],
                                         valid[0], entry.KAPPA, impl="chol",
                                         device="cpu")
    np.testing.assert_array_equal(sel[0], ref_sel.numpy())
    np.testing.assert_allclose(Om[0], ref_Om.numpy(), rtol=1e-8)
    assert int(sel[0].sum()) == entry.KAPPA
