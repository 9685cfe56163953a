"""The keyframe marginalization on the card: its augmented system from one
launch of the normal equations' kernel (`marginalization._augmented_system`
on CUDA tensors without a relocalization frame), held against the CPU
route, which assembles `linearize`'s dense rows.

Every test here needs a card (`gpu` marker, `pytest -m gpu`) and skips
elsewhere; the CPU side of the route is `tests/test_torch_marginalization.py`'s.
Priors are compared in information form (J0ᵀJ0, J0ᵀr0), never J0: its rows
change sign, and rotate inside repeated eigenvalues, from one `eigh` to the
next. No JAX here: the card's machine has none (run with `--noconftest`)."""

import pytest
import torch

from anticipated_vins_mono_torch.ops import factors
from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import marginalization as mg
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.utils.synthetic import window_batch
from anticipated_vins_mono_torch.utils.tree import tree_map, tree_to

torch.set_num_threads(1)

# the deployment's window: D = 178, F = 128
FLAGSHIP = win.WindowConfig(window=10, max_feats=128)
# as `tests/test_torch_normal_eq_kernel.py`: a float32 result's distance to
# the float64 CPU route at most this many times the float32 CPU route's,
# plus 8 ulps of the output's size
F32_FACTOR = 4
ROLLING = 0.033 / 480     # the rolling shutter's TR / ROW


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _drop_set(dtype, estimate_td, device):
    """`window_batch`'s scenario 0 at the deployment's window (a dense prior,
    ZUPT, a roll/pitch pin, feature weights; with td the image velocities
    and td away from the frames' capture), restricted to MARGIN_OLD's drop
    set as `marginalize_oldest` restricts it, on `device`."""
    cfg = FLAGSHIP._replace(estimate_td=estimate_td,
                            tr_over_row=ROLLING if estimate_td else 0.0)
    st, ms = window_batch(cfg, 1, seed=5, td=estimate_td, dtype=dtype,
                          device="cpu")
    st, ms = tree_map(lambda x: x[0], (st, ms))
    if estimate_td:
        st = st._replace(td=st.td + 0.004)
    st, ms = tree_to((st, mg._drop_touching(ms, cfg, dtype)), device)
    return cfg, st, ms


def _kernel(estimate_td):
    return "normal_eq_fused_td" if estimate_td else "normal_eq_fused"


def _err(a, b):
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def _info(prior):
    J0, r0 = prior.J0.cpu().double(), prior.r0.cpu().double()
    return J0.T @ J0, J0.T @ r0


@pytest.mark.gpu
@pytest.mark.parametrize("estimate_td", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_augmented_system_on_the_card_equals_the_cpu_route(dtype,
                                                           estimate_td):
    """One launch of the kernel's instance (none of the other) gives the
    system `linearize`'s dense rows give on the CPU: float64 within 1e-9 of
    each output's largest entry, float32 as `F32_FACTOR` says against the
    float64 CPU route; the landmark block exactly diagonal."""
    _needs_card()
    cfg, st, ms = _drop_set(dtype, estimate_td, "cuda")
    hk.reset_launch_counts()
    got = mg._augmented_system(st, ms, cfg, (st.p[0], st.q[0]))
    assert hk.launch_counts[_kernel(estimate_td)] == 1
    assert hk.launch_counts[_kernel(not estimate_td)] == 0
    assert got[0].is_cuda and got[0].dtype == dtype
    D = cfg.dim
    H_ll = got[0][D:, D:]
    assert torch.equal(H_ll, torch.diag_embed(torch.diagonal(H_ll)))
    _, st64, ms64 = _drop_set(torch.float64, estimate_td, "cpu")
    want64 = mg._augmented_system(st64, ms64, cfg, (st64.p[0], st64.q[0]))
    if dtype == torch.float64:
        for name, a, w in zip(("H", "b"), got, want64):
            assert _err(a, w) <= 1e-9 * float(w.abs().max()), \
                (name, _err(a, w))
        return
    _, st32, ms32 = _drop_set(dtype, estimate_td, "cpu")
    want32 = mg._augmented_system(st32, ms32, cfg, (st32.p[0], st32.q[0]))
    eps = torch.finfo(torch.float32).eps
    for name, a, b, w in zip(("H", "b"), got, want32, want64):
        scale = float(w.abs().max())
        assert _err(a, w) <= F32_FACTOR * _err(b, w) + 8 * eps * scale, \
            (name, _err(a, w), _err(b, w))


@pytest.mark.gpu
@pytest.mark.parametrize("estimate_td", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_marginalize_oldest_on_the_card_equals_the_cpu_route(dtype,
                                                             estimate_td):
    """The prior `marginalize_oldest` makes on the card (one launch) against
    the CPU route's, in information form: float64 within 1e-7 of the
    largest entry (the bound of the JAX parity tests: the pseudo-inverse
    amplifies rounding by the drop block's conditioning), float32 as
    `F32_FACTOR` says against the float64 CPU route; the same weight and
    linearization point."""
    _needs_card()
    cfg, st, ms = _drop_set(dtype, estimate_td, "cuda")
    hk.reset_launch_counts()
    prior = mg.marginalize_oldest(st, ms, cfg)
    assert hk.launch_counts[_kernel(estimate_td)] == 1
    assert prior.J0.is_cuda and prior.J0.dtype == dtype
    assert torch.isfinite(prior.J0).all() and torch.isfinite(prior.r0).all()
    _, st64, ms64 = _drop_set(torch.float64, estimate_td, "cpu")
    want64 = mg.marginalize_oldest(st64, ms64, cfg)
    assert torch.equal(prior.weight.cpu().double(), want64.weight)
    for name in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        assert _err(getattr(prior.lin, name),
                    getattr(want64.lin, name)) <= 1e-6, name
    got, w64 = _info(prior), _info(want64)
    assert float(w64[0].abs().max()) > 1.0
    if dtype == torch.float64:
        for name, a, w in zip(("J0'J0", "J0'r0"), got, w64):
            assert _err(a, w) <= 1e-7 * float(w.abs().max()), \
                (name, _err(a, w))
        return
    _, st32, ms32 = _drop_set(dtype, estimate_td, "cpu")
    w32 = _info(mg.marginalize_oldest(st32, ms32, cfg))
    eps = torch.finfo(torch.float32).eps
    for name, a, b, w in zip(("J0'J0", "J0'r0"), got, w32, w64):
        scale = float(w.abs().max())
        assert _err(a, w) <= F32_FACTOR * _err(b, w) + 8 * eps * scale, \
            (name, _err(a, w), _err(b, w))


@pytest.mark.gpu
def test_relo_window_on_the_card_keeps_the_linearized_system(monkeypatch):
    """A window with a relocalization frame, which the kernel has no rows
    for, is handed to `linearize`'s assembly on the card too: no launch."""
    _needs_card()
    cfg, st, ms = _drop_set(torch.float32, False, "cuda")
    ms = ms._replace(relo_pts=ms.pts[:, 0].clone(),
                     relo_valid=ms.mask[:, 0] * ms.feat_valid)
    st = st._replace(relo_p=st.p[0] + 0.02, relo_q=st.q[0].clone())
    handed = []
    monkeypatch.setattr(mg, "_linearized_augmented_system",
                        lambda *a: handed.append(a) or "dense")
    hk.reset_launch_counts()
    assert mg._augmented_system(st, ms, cfg, (st.p[0], st.q[0])) == "dense"
    assert len(handed) == 1 and handed[0][1] is ms
    assert hk.launch_counts["normal_eq_fused"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,estimate_td", [
    (torch.float32, False), (torch.float32, True), (torch.float64, False)])
def test_keyframe_vio_step_on_the_card_makes_no_jvp(monkeypatch, dtype,
                                                    estimate_td):
    """Three `vio_step`s of the deployment (the anticipation gate on) from
    the oracle start, `factors.tangent_jacobian` made to raise: at least one
    is a keyframe, none fails, and the normal equations' kernel launches 8
    times a solve and once a keyframe's marginalization."""
    _needs_card()
    from anticipated_vins_mono_torch.models import estimator_device as ed
    from anticipated_vins_mono_torch.utils import deployment as dep
    from anticipated_vins_mono_torch.utils.synthetic import \
        analytic_trajectory

    pr = dep.vio_params(fused_schur=dtype == torch.float32)
    pr = pr._replace(wcfg=pr.wcfg._replace(
        estimate_td=estimate_td, tr_over_row=ROLLING if estimate_td else 0.0))
    traj = analytic_trajectory(2.0)
    _, packed = dep.vio_sequence(traj, dtype, seed=0)
    first = pr.wcfg.nf - 1
    st = dep.vio_start(pr, traj, packed)

    def no_jvp(*a, **kw):
        raise AssertionError("a jvp on the card's frame")

    monkeypatch.setattr(factors, "tangent_jacobian", no_jvp)
    hk.reset_launch_counts()
    keyframes = 0
    for pk in packed[first:first + 3]:
        st, out = ed.vio_step(pr, st, *pk)
        assert not bool(out["fail"])
        keyframes += int(out["keyframe"])
    assert keyframes >= 1
    assert hk.launch_counts[_kernel(estimate_td)] == \
        3 * pr.wcfg.iters + keyframes
    assert hk.launch_counts[_kernel(not estimate_td)] == 0
    assert torch.isfinite(st.prior.J0).all() and st.prior.J0.abs().max() > 0
