"""Port vs JAX: ops/marginalization.py, float64 path (CPU).

A prior is compared in INFORMATION form (J0ᵀJ0, J0ᵀr0), never by J0 or r0:
J0 = s·Vᵀ, and the rows of Vᵀ change sign, and rotate inside repeated
eigenvalues, between XLA's and LAPACK's `eigh`.

Tolerances, relative to each matrix's largest entry: the Schur complement
and the augmented system 1e-9 (same algebra, other summation order); the
priors 1e-7 — the eigenvalue pseudo-inverse divides by eigenvalues down to
EIG_EPS = 1e-8 while the information reaches ~1e11, so rounding in H is
amplified by the conditioning of the drop block; a cascade of three stays
within the same bound."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anticipated_vins_mono_tpu.ops import marginalization as jmg
from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_tpu.utils import synthetic as jsyn
from anticipated_vins_mono_torch.ops import marginalization as tmg
from anticipated_vins_mono_torch.ops import window as tw
from anticipated_vins_mono_torch.utils import convert
from anticipated_vins_mono_torch.utils.synthetic import window_batch
from anticipated_vins_mono_torch.utils.tree import tree_map

torch.set_num_threads(1)

CFG = dict(window=4, max_feats=24, iters=6)
JCFG, TCFG = jw.WindowConfig(**CFG), tw.WindowConfig(**CFG)


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _assert_scaled(a, b, rtol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    scale = max(np.max(np.abs(b)), 1e-300)
    err = np.max(np.abs(a - b))
    assert err <= rtol * scale, (name, err, scale)


def _info(prior):
    """(J0ᵀJ0, J0ᵀr0) of a prior of either package, as numpy."""
    J0, r0 = np.asarray(prior.J0), np.asarray(prior.r0)
    return J0.T @ J0, J0.T @ r0


def _assert_prior_close(tp, jp, rtol=1e-7):
    tp = convert.to_numpy_tree(tp)
    (tH, tb), (jH, jb) = _info(tp), _info(jp)
    assert np.all(np.isfinite(tp.J0)) and np.abs(jH).max() > 1.0
    _assert_scaled(tH, jH, rtol, "J0'J0")
    _assert_scaled(tb, jb, rtol, "J0'r0")
    assert tp.J0.dtype == np.asarray(jp.J0).dtype
    np.testing.assert_array_equal(tp.weight, np.asarray(jp.weight))
    for name in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        np.testing.assert_allclose(getattr(tp.lin, name),
                                   np.asarray(getattr(jp.lin, name)),
                                   rtol=0, atol=1e-12, err_msg=name)


@pytest.fixture(scope="module")
def solved():
    """A solved window in both packages (the JAX solve, carried across)."""
    jp = jsyn.make_window_problem(JCFG, seed=3, perturb=0.3, pixel_noise=0.5)
    jst, _ = jw.lm_solve(jp.init, jp.meas, JCFG)
    st = convert.window_state_from_numpy(_np_tree(jst), "cpu")
    ms = convert.window_measurements_from_numpy(_np_tree(jp.meas), "cpu")
    return jst, jp.meas, st, ms


def test_masked_schur_equals_jax_and_zeroes_the_drop_set():
    rng = np.random.default_rng(0)
    n = 30
    A = rng.normal(size=(n + 10, n))
    H, b = A.T @ A, rng.normal(size=n)
    mask = np.zeros(n)
    drop = np.array([0, 1, 2, 7, 8, 15])
    mask[drop] = 1.0
    jH, jb = jmg._masked_schur(jnp.asarray(H), jnp.asarray(b),
                               jnp.asarray(mask))
    tH, tb = tmg._masked_schur(torch.tensor(H), torch.tensor(b),
                               torch.tensor(mask))
    _assert_scaled(tH.numpy(), jH, 1e-9, "H")
    _assert_scaled(tb.numpy(), jb, 1e-9, "b")
    assert tH.numpy()[drop].max() < 1e-12 and tH.dtype == torch.float64
    # float32 in, float64 out: the cast is the function's own
    tH32, _ = tmg._masked_schur(torch.tensor(H, dtype=torch.float32),
                                torch.tensor(b, dtype=torch.float32),
                                torch.tensor(mask, dtype=torch.float32))
    assert tH32.dtype == torch.float64


def test_augmented_system_equals_jax(solved):
    jst, jms, st, ms = solved
    ref = (jst.p[0], jst.q[0])
    jH, jb = jmg._augmented_system(jst, jms, JCFG, ref)
    tH, tb = tmg._augmented_system(st, ms, TCFG, (st.p[0], st.q[0]))
    assert tH.shape == (TCFG.dim + TCFG.max_feats,) * 2
    _assert_scaled(tH.numpy(), jH, 1e-9, "H")
    # b = Jᵀr cancels at the solved state (it is the gradient), so its
    # rounding error scales with |J|ᵀ|r|, not with b itself
    r_all, J_all, *_ = tw.linearize(st, ms, TCFG, (st.p[0], st.q[0]))
    scale = float((J_all.abs().T @ r_all.abs()).max())
    assert np.max(np.abs(tb.numpy()[:TCFG.dim] - np.asarray(jb)[:TCFG.dim])) \
        <= 1e-9 * scale
    _assert_scaled(tb.numpy()[TCFG.dim:], np.asarray(jb)[TCFG.dim:], 1e-9,
                   "b, landmark part")


def test_sqrt_factor_reconstructs_and_equals_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(50, 20))
    H = A.T @ A
    H[:, 5] = 0          # rank deficient
    H[5, :] = 0
    b = H @ rng.normal(size=20)
    J0, r0 = tmg._sqrt_factor(torch.tensor(H), torch.tensor(b))
    np.testing.assert_allclose((J0.T @ J0).numpy(), H, atol=1e-8)
    np.testing.assert_allclose((J0.T @ r0).numpy(), b, atol=1e-8)
    jJ0, jr0 = jmg._sqrt_factor(jnp.asarray(H), jnp.asarray(b))
    np.testing.assert_allclose((J0.T @ J0).numpy(), np.asarray(jJ0.T @ jJ0),
                               atol=1e-8)
    np.testing.assert_allclose((J0.T @ r0).numpy(), np.asarray(jJ0.T @ jr0),
                               atol=1e-8)


@pytest.mark.parametrize("drop_frame", [0, TCFG.nf - 2])
def test_shift_matrix_is_exact(drop_frame):
    np.testing.assert_array_equal(
        tmg._shift_matrix(TCFG, drop_frame),
        np.asarray(jmg._shift_matrix(JCFG, drop_frame)))


def test_marginalize_oldest_equals_jax(solved):
    jst, jms, st, ms = solved
    _assert_prior_close(tmg.marginalize_oldest(st, ms, TCFG),
                        jmg.marginalize_oldest(jst, jms, JCFG))


def test_marginalize_second_newest_equals_jax(solved):
    """The same (JAX) prior into both: J0's row convention is then the same
    on both sides and only the function under test differs."""
    jst, jms, st, ms = solved
    jprior = jmg.marginalize_oldest(jst, jms, JCFG)
    tprior = convert._rebuild(tw.PriorFactor, _np_tree(jprior),
                              torch.device("cpu"))
    # a state away from the prior's linearization point: r0 + J0·dx matters
    jmoved = jst._replace(p=jst.p + 0.01, v=jst.v - 0.02)
    moved = st._replace(p=st.p + 0.01, v=st.v - 0.02)
    tp2 = tmg.marginalize_second_newest(moved, tprior, TCFG)
    _assert_prior_close(tp2, jmg.marginalize_second_newest(jmoved, jprior,
                                                           JCFG))
    nf = TCFG.nf
    H = _info(convert.to_numpy_tree(tp2))[0]
    assert np.abs(H[6 * (nf - 1): 6 * nf]).max() < 1e-9 * np.abs(H).max()


def test_cascade_of_three_stays_within_the_bound(solved):
    """oldest → second-newest → oldest, each package on its OWN priors."""
    jst, jms, st, ms = solved
    jp = jmg.marginalize_oldest(jst, jms, JCFG)
    jp = jmg.marginalize_second_newest(jst, jp, JCFG)
    jp = jmg.marginalize_oldest(jst, jms._replace(prior=jp), JCFG)
    tp = tmg.marginalize_oldest(st, ms, TCFG)
    tp = tmg.marginalize_second_newest(st, tp, TCFG)
    tp = tmg.marginalize_oldest(st, ms._replace(prior=tp), TCFG)
    _assert_prior_close(tp, jp)


def test_df32_takes_the_f64_path(solved):
    _, _, st, ms = solved
    a = tmg.marginalize_oldest(st, ms, TCFG)
    b = tmg.marginalize_oldest(st, ms, TCFG._replace(accum="df32"))
    assert torch.equal(a.J0, b.J0) and torch.equal(a.r0, b.r0)
    assert not hasattr(tmg, "_schur_drop_df")


def test_marginalize_leaves_its_inputs_unchanged(solved):
    _, _, st, ms = solved
    before = convert.to_numpy_tree((st, ms))
    prior = tmg.marginalize_oldest(st, ms, TCFG)
    tmg.marginalize_second_newest(st, prior, TCFG)
    after = convert.to_numpy_tree((st, ms))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------------
# The augmented system from the normal equations' blocks (the card's route)
# ----------------------------------------------------------------------------

# the deployment's window: D = 178, F = 128
FLAGSHIP = tw.WindowConfig(window=10, max_feats=128)
# as `tests/test_torch_normal_eq_kernel.py`: a float32 result's distance to
# the float64 dense rows at most this many times the float32 dense rows',
# plus 8 ulps of the output's size
F32_FACTOR = 4


def _flagship_drop_set(dtype, estimate_td):
    """The deployment's window (`window_batch`'s scenario 0: a dense prior,
    ZUPT, a roll/pitch pin, feature weights; with td the image velocities
    and td away from the frames' capture), restricted to MARGIN_OLD's drop
    set as `marginalize_oldest` restricts it."""
    cfg = FLAGSHIP._replace(estimate_td=estimate_td,
                            tr_over_row=0.033 / 480 if estimate_td else 0.0)
    st, ms = window_batch(cfg, 1, seed=5, td=estimate_td, dtype=dtype,
                          device="cpu")
    st, ms = tree_map(lambda x: x[0], (st, ms))
    if estimate_td:
        st = st._replace(td=st.td + 0.004)
    return cfg, st, tmg._drop_touching(ms, cfg, dtype)


@pytest.mark.parametrize("estimate_td", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_blocks_assemble_the_linearized_augmented_system(dtype, estimate_td):
    """`_assemble_augmented` of the plain normal equations (the kernel's
    plain version) equals `linearize`'s J_augᵀJ_aug, J_augᵀr on the drop
    set at D = 178, F = 128: float64 within 1e-9 of each output's largest
    entry, float32 as `F32_FACTOR` says; the landmark block exactly
    diagonal in both."""
    cfg, st, ms = _flagship_drop_set(dtype, estimate_td)
    ref = (st.p[0], st.q[0])
    got = tmg._assemble_augmented(
        *tw.normal_equations_fast_plain(st, ms, cfg, ref))
    want = tmg._linearized_augmented_system(st, ms, cfg, ref)
    D, F = cfg.dim, cfg.max_feats
    assert got[0].shape == (D + F, D + F) and got[1].shape == (D + F,)
    assert got[0].dtype == want[0].dtype == dtype
    dropped = ms.feat_valid > 0
    assert 0 < int(dropped.sum()) < F
    for H in (got[0], want[0]):
        H_ll = H[D:, D:]
        assert torch.equal(H_ll, torch.diag_embed(torch.diagonal(H_ll)))
        assert (torch.diagonal(H_ll)[dropped] > 0).all()
        assert not torch.diagonal(H_ll)[~dropped].any()
    if dtype == torch.float64:
        for name, a, b in zip(("H", "b"), got, want):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-9 * scale, name
        return
    cfg64, st64, ms64 = _flagship_drop_set(torch.float64, estimate_td)
    want64 = tmg._linearized_augmented_system(st64, ms64, cfg64,
                                              (st64.p[0], st64.q[0]))
    err = lambda a, b: float((a.double() - b).abs().max())
    eps = torch.finfo(torch.float32).eps
    for name, a, b, w in zip(("H", "b"), got, want, want64):
        scale = float(w.abs().max())
        assert err(a, w) <= F32_FACTOR * err(b, w) + 8 * eps * scale, \
            (name, err(a, w), err(b, w))


@pytest.mark.parametrize("relo", [False, True])
def test_cpu_tensors_and_relo_windows_keep_the_linearized_system(
        monkeypatch, solved, relo):
    """On CPU tensors `_augmented_system` never asks for the normal
    equations' blocks: without a relocalization frame it is `linearize`'s
    assembly bit for bit, and `marginalize_oldest` runs through it; a window
    with a relocalization frame (which the kernel has no rows for) is
    handed to that assembly whole."""
    _, _, st, ms = solved

    def blocks(*a, **kw):
        raise AssertionError("the normal equations' blocks asked for")

    monkeypatch.setattr(tmg, "normal_equations_fast", blocks)
    ref = (st.p[0], st.q[0])
    if not relo:
        want = tmg._linearized_augmented_system(st, ms, TCFG, ref)
        got = tmg._augmented_system(st, ms, TCFG, ref)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        prior = tmg.marginalize_oldest(st, ms, TCFG)
        assert torch.isfinite(prior.J0).all() and prior.J0.abs().max() > 0
        return
    rng = np.random.default_rng(7)
    pts = ms.pts[:, 0].clone()
    pts[:, :2] += torch.from_numpy(rng.normal(size=(TCFG.max_feats, 2))) * 1e-3
    ms = ms._replace(relo_pts=pts, relo_valid=ms.mask[:, 0] * ms.feat_valid)
    st = st._replace(relo_p=st.p[0] + 0.02, relo_q=st.q[0].clone())
    handed = []
    monkeypatch.setattr(tmg, "_linearized_augmented_system",
                        lambda *a: handed.append(a) or "dense")
    assert tmg._augmented_system(st, ms, TCFG, ref) == "dense"
    assert len(handed) == 1 and handed[0][1] is ms
