"""The normal equations' kernel (`csrc/normal_eq_fused.cu`, launcher
`hopper_kernels.normal_eq_fused`, route and packing
`window._lm_route`) and its plain version,
`window.normal_equations_fast_plain`.

On the CPU: `normal_equations_fast` and the route are the plain version and
launch nothing; the prior, gauge anchor and ZUPT rows whose JᵀJ the route
gives the kernel once per solve are the plain version's small rows without
the IMU group, and do not depend on the state; `lm_solve` asks the route
once a solve, which sends CPU tensors to the plain version, td estimation
included (its td column equals the dense rows of `linearize`). (The JAX
parity of the plain version is `tests/test_torch_window.py`; the
launcher's refusal of CPU tensors is `tests/test_torch_kernels.py`'s.)

On a card (`gpu` marker, `pytest -m gpu`): the kernel against the plain
version on the same card, its determinism, its launch count, and an
8-iteration `lm_solve` that takes the same steps either way; the same for
the instance that estimates the time offset (`normal_eq_fused_td`, with and
without the rolling shutter's row shift). No JAX here: the card's machine
has none (run with `--noconftest`)."""

import pytest
import torch

from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.utils.synthetic import window_batch
from anticipated_vins_mono_torch.utils.tree import tree_map

torch.set_num_threads(1)

SMALL = win.WindowConfig(window=3, max_feats=12)
FLAGSHIP = win.WindowConfig(window=10, max_feats=128)
NAMES = ("H", "g", "H_lp", "h_ll", "g_l")


def _problem(cfg, B, device="cpu", dtype=torch.float64, **kw):
    return window_batch(cfg, B, seed=3, dtype=dtype, device=device, **kw)


def _anchor_ref(st):
    return st.p[..., 0, :], st.q[..., 0, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_takes_the_plain_version_and_counts_no_launch(
        monkeypatch, dtype):
    """On CPU tensors `normal_equations_fast` and the route's function are
    the plain version, bit for bit; the kernel's inputs are never made."""
    def kernel_inputs(*a, **kw):
        raise AssertionError("the kernel's inputs made on CPU tensors")

    monkeypatch.setattr(win, "_kernel_fixed_inputs", kernel_inputs)
    st, ms = _problem(SMALL, 2, dtype=dtype)
    hk.reset_launch_counts()
    ref = win.normal_equations_fast_plain(st, ms, SMALL)
    route = win._lm_route(st, ms, SMALL, _anchor_ref(st)).normal_equations
    for got in (route(st), win.normal_equations_fast(st, ms, SMALL)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert hk.launch_counts["normal_eq_fused"] == 0


@pytest.mark.parametrize("zupt", [True, False])
def test_fixed_rows_are_the_small_rows_without_the_imu_group(zupt):
    """The rows whose JᵀJ the kernel's caller forms once per solve: the
    plain version's prior, anchor and ZUPT rows exactly, and the same at
    another state (none of them depends on it)."""
    st, ms = _problem(SMALL, 2, zupt=zupt, pin_rp=0.25)
    ref = (st.p[..., 0, :], st.q[..., 0, :])
    _, rows = win._small_dense_rows(st, ms, SMALL, ref)
    fixed = win._fixed_rows(st, ms, SMALL, ref)
    assert torch.equal(fixed, rows[..., 15 * SMALL.window:, :])
    moved = tree_map(lambda x: x + 0.1, st)
    assert torch.equal(win._fixed_rows(moved, ms, SMALL, ref), fixed)


@pytest.mark.parametrize("estimate_td", [False, True])
def test_lm_solve_routes_td_estimation_to_the_dense_rows(monkeypatch,
                                                         estimate_td):
    """Since the kernels carry the time offset's column, td estimation no
    longer takes the dense rows: on CPU tensors the route's function is the
    plain version's with and without td estimation, bit for bit, and
    `linearize` is never called (on CUDA tensors the kernels' td instances,
    `test_td_kernel_matches_the_plain_version_on_the_card`); `lm_solve`
    asks the route once a solve and calls what it gives once an iteration;
    on CPU tensors the kernel's inputs are never made."""
    cfg = SMALL._replace(iters=2, estimate_td=estimate_td,
                         tr_over_row=0.033 / 480 if estimate_td else 0.0)
    st, ms = _problem(cfg, 1, td=estimate_td)
    ref = _anchor_ref(st)
    want = win.normal_equations_fast_plain(st, ms, cfg, ref)
    got = win._lm_route(st, ms, cfg, ref).normal_equations(st)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    calls = {"route": 0, "normal_equations_fast_plain": 0, "linearize": 0,
             "_kernel_fixed_inputs": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(win, "_lm_route", count("route", win._lm_route))
    for name in list(calls)[1:]:
        monkeypatch.setattr(win, name, count(name, getattr(win, name)))
    out, diag = win.lm_solve(st, ms, cfg, device="cpu")
    assert torch.isfinite(diag["cost"]).all()
    assert calls == {"route": 1, "normal_equations_fast_plain": 2,
                     "linearize": 0, "_kernel_fixed_inputs": 0}


@pytest.mark.parametrize("tr_over_row", [0.0, 0.033 / 480])
@pytest.mark.parametrize("variant", ["prior", "no_prior_no_feat_w"])
def test_plain_version_with_td_equals_the_dense_rows(tr_over_row, variant):
    """The plain version's td column and the rolling shutter's row shift,
    float64: every output of `normal_equations_fast_plain` with
    `estimate_td` within 1e-12 of its largest entry of `linearize` +
    `build_normal_equations` (the same factors, summed blockwise instead of
    through dense rows), td's column not zero."""
    cfg = SMALL._replace(estimate_td=True, tr_over_row=tr_over_row)
    kw = dict(prior_weight=0.0, feat_w=False) if variant != "prior" else {}
    st, ms = _problem(cfg, 2, td=True, **kw)
    st = st._replace(td=st.td + 0.004)
    ref = _anchor_ref(st)
    got = win.normal_equations_fast_plain(st, ms, cfg, ref)
    want = win.build_normal_equations(*win.linearize(st, ms, cfg, ref)[:5],
                                      cfg)
    for name, a, b in zip(NAMES, got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale, name
    T = 15 * cfg.nf + 6
    assert got[0][..., T, :6 * cfg.nf].abs().max() > 0
    assert got[2][..., T].abs().max() > 0


# ----------------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------------

# float32: the kernel's largest distance to the float64 plain version, per
# output, at most this many times the float32 plain version's, plus 8 ulps
# of the output's size: both are float32 roundings of the same sums, taken
# in another order (the kernel sums factor by factor, the plain version in
# PyTorch's einsum order)
F32_FACTOR = 4

VARIANTS = {
    "prior": dict(prior_weight=1.0),
    "no_prior": dict(prior_weight=0.0),
    "no_zupt_no_pin": dict(zupt=False, pin_rp=None),
    "pin_rp_0": dict(pin_rp=0.0),
    "no_feat_w": dict(feat_w=False),
    "no_extrinsic": dict(estimate_extrinsic=False),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_matches_the_plain_version_on_the_card(variant, B):
    """float64: every output within 1e-10 of its largest entry (the same
    algebra, the sums in another order: ~1e-15 expected). float32: as
    `F32_FACTOR` says. Slot 0 is anchored in the last frame and seen in
    all; the last two slots are empty; odd scenarios have an invalid IMU
    pair."""
    _needs_card()
    kw = dict(VARIANTS[variant])
    cfg = FLAGSHIP._replace(
        estimate_extrinsic=kw.pop("estimate_extrinsic", True))
    st, ms = _problem(cfg, B, device="cuda", **kw)
    ref64 = win.normal_equations_fast_plain(st, ms, cfg)
    hk.reset_launch_counts()
    got64 = win.normal_equations_fast(st, ms, cfg)
    assert hk.launch_counts["normal_eq_fused"] == 1
    f32 = lambda x: x.float() if x.is_floating_point() else x
    st32, ms32 = tree_map(f32, st), tree_map(f32, ms)
    got32 = win.normal_equations_fast(st32, ms32, cfg)
    ref32 = win.normal_equations_fast_plain(st32, ms32, cfg)
    assert hk.launch_counts["normal_eq_fused"] == 2
    eps = torch.finfo(torch.float32).eps
    for name, r64, k64, r32, k32 in zip(NAMES, ref64, got64, ref32, got32):
        scale = float(r64.abs().max())
        assert k64.shape == r64.shape and k32.dtype == torch.float32
        assert torch.isfinite(k64).all() and torch.isfinite(k32).all()
        assert _max_err(k64, r64) <= 1e-10 * scale, (name, _max_err(k64, r64))
        assert _max_err(k32, r64) <= F32_FACTOR * _max_err(r32, r64) \
            + 8 * eps * scale, (name, _max_err(k32, r64), _max_err(r32, r64))
    if not cfg.estimate_extrinsic:
        X = 15 * cfg.nf
        assert not got32[2][..., X:X + 6].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_deterministic_and_takes_fixed_inputs(dtype):
    """The same inputs give the same bits on every launch, with the fixed
    inputs made once (the route's function, called twice) or per call
    (`normal_equations_fast`)."""
    _needs_card()
    st, ms = _problem(FLAGSHIP, 64, device="cuda", dtype=dtype)
    route = win._lm_route(st, ms, FLAGSHIP, _anchor_ref(st)).normal_equations
    first = win.normal_equations_fast(st, ms, FLAGSHIP)
    for again in (route(st), route(st),
                  win.normal_equations_fast(st, ms, FLAGSHIP)):
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# the time offset's instance at a global (TR = 0) and a rolling shutter
# (33 ms over 480 rows)
TD_SHUTTERS = {"global": 0.0, "rolling": 0.033 / 480}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("shutter", sorted(TD_SHUTTERS))
def test_td_kernel_matches_the_plain_version_on_the_card(shutter, B):
    """`normal_eq_fused_td` against the plain version's td column, at the
    tolerances of `test_kernel_matches_the_plain_version_on_the_card`, with
    td estimated (td ≠ td at the frames' capture), image velocities and the
    shutter's row shift; the td column of H and of H_lp not zero."""
    _needs_card()
    cfg = FLAGSHIP._replace(estimate_td=True, tr_over_row=TD_SHUTTERS[shutter])
    st, ms = _problem(cfg, B, device="cuda", td=True)
    st = st._replace(td=st.td + 0.004)
    ref64 = win.normal_equations_fast_plain(st, ms, cfg)
    hk.reset_launch_counts()
    got64 = win.normal_equations_fast(st, ms, cfg)
    f32 = lambda x: x.float() if x.is_floating_point() else x
    st32, ms32 = tree_map(f32, st), tree_map(f32, ms)
    got32 = win.normal_equations_fast(st32, ms32, cfg)
    ref32 = win.normal_equations_fast_plain(st32, ms32, cfg)
    assert hk.launch_counts["normal_eq_fused_td"] == 2
    assert hk.launch_counts["normal_eq_fused"] == 0
    eps = torch.finfo(torch.float32).eps
    for name, r64, k64, r32, k32 in zip(NAMES, ref64, got64, ref32, got32):
        scale = float(r64.abs().max())
        assert torch.isfinite(k64).all() and torch.isfinite(k32).all()
        assert _max_err(k64, r64) <= 1e-10 * scale, (name, _max_err(k64, r64))
        assert _max_err(k32, r64) <= F32_FACTOR * _max_err(r32, r64) \
            + 8 * eps * scale, (name, _max_err(k32, r64), _max_err(r32, r64))
    T = 15 * cfg.nf + 6
    assert got64[0][..., T, :6 * cfg.nf].abs().max() > 0
    assert got64[2][..., T].abs().max() > 0


@pytest.mark.gpu
def test_lm_solve_takes_the_same_steps_as_the_plain_version(monkeypatch):
    """float32 with the fused Schur kernel, B = 64, 8 iterations: the
    damping each Schur launch receives (which records every earlier
    accept or reject) is the same with the kernel as with the plain version
    in every scenario and iteration. Where the solves land, the kernel's is
    as near the float64 plain solve's as the float32 plain one's, within
    `F32_FACTOR` (largest and median gap over the scenarios): the window's
    unobserved directions carry each float32 rounding a few tenths of a
    millimetre, whichever sums take it."""
    _needs_card()
    cfg = FLAGSHIP._replace(fused_schur=True)
    f32 = lambda x: x.float() if x.is_floating_point() else x
    st64, ms64 = _problem(cfg, 64, device="cuda", prior_weight=0.0)
    st, ms = tree_map(f32, st64), tree_map(f32, ms64)
    lams, schur = [], hk.schur_solve_fused

    def recording(*a, **kw):
        lams[-1].append(a[5].clone())
        return schur(*a, **kw)

    monkeypatch.setattr(hk, "schur_solve_fused", recording)
    lams.append([])
    hk.reset_launch_counts()
    out_k, diag_k = win.lm_solve(st, ms, cfg)
    assert hk.launch_counts["normal_eq_fused"] == cfg.iters
    real = win._lm_route
    plain = lambda state, meas, c, anchor_ref: real(
        state, meas, c, anchor_ref)._replace(
        normal_equations=lambda s: win.normal_equations_fast_plain(
            s, meas, c, anchor_ref))
    monkeypatch.setattr(win, "_lm_route", plain)
    lams.append([])
    out_p, diag_p = win.lm_solve(st, ms, cfg)
    out_64, _ = win.lm_solve(st64, ms64, FLAGSHIP)
    assert len(lams[0]) == len(lams[1]) == cfg.iters
    for it, (a, b) in enumerate(zip(*lams)):
        assert torch.equal(a, b), (it, (a != b).nonzero().flatten().tolist())
    assert torch.equal(diag_k["lambda"], diag_p["lambda"])
    assert (diag_k["cost"] < diag_k["cost0"]).all()
    gap = lambda x: (x.p.double() - out_64.p).abs().amax(dim=(-1, -2))
    gk, gp = gap(out_k), gap(out_p)
    assert gk.max() <= F32_FACTOR * gp.max(), (gk.max(), gp.max())
    assert gk.median() <= F32_FACTOR * gp.median(), (gk.median(), gp.median())
