"""The cost phase's kernel (`csrc/lm_cost_fused.cu`, launcher
`hopper_kernels.lm_cost_fused`, route `window._lm_route`) and its plain
version, `window._lm_cost_plain`.

On the CPU: the route is the plain version and launches nothing, and
`lm_solve` takes its cost phases, its cost at the start and its diagnostics
from the plain functions; the kernel's pointer table is in the order the
launcher writes it; the benchmark's readers of the kernel's launches count
them per LM iteration. (The JAX parity of the plain version is
`tests/test_torch_window.py`'s; the launcher's refusal of CPU tensors is
`tests/test_torch_kernels.py`'s.)

On a card (`gpu` marker, `pytest -m gpu`): the kernel's candidate against
`window.retract`, its cost against `window.robust_cost`, its decision
against the plain version's, its determinism, an 8-iteration `lm_solve`
that takes the same decisions either way, and the solve's launches and host
synchronisations; the same for the instance that estimates the time offset
(`lm_cost_fused_td`). No JAX here: the card's machine has none (run with
`--noconftest`)."""

import re
from types import SimpleNamespace

import pytest
import torch

from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import window as win
from anticipated_vins_mono_torch.utils.synthetic import window_batch
from anticipated_vins_mono_torch.utils.tree import tree_map

torch.set_num_threads(1)

SMALL = win.WindowConfig(window=3, max_feats=12)
FLAGSHIP = win.WindowConfig(window=10, max_feats=128)
LEAVES = win.WindowState._fields[:9]


def _problem(cfg, B, device="cpu", dtype=torch.float64, **kw):
    return window_batch(cfg, B, seed=3, dtype=dtype, device=device, **kw)


def _anchor_ref(st):
    return st.p[..., 0, :], st.q[..., 0, :]


def _step(cfg, st, ms, lam=1e-4):
    """One LM step of the plain version at `st`: (dx, d_rho, pred, λ, cost),
    with scenario 1's step (where there is one) poisoned by a NaN."""
    ref = _anchor_ref(st)
    H, g, H_lp, h_ll, g_l = win.normal_equations_fast_plain(st, ms, cfg, ref)
    lam = torch.full(st.p.shape[:-2], lam, dtype=st.p.dtype,
                     device=st.p.device)
    dx, d_rho, pred = win.schur_solve(H, g, H_lp, h_ll, g_l, lam, cfg)
    if dx.shape[0] > 1:
        dx[1, 0] = float("nan")
    return dx, d_rho, pred, lam, win.robust_cost(st, ms, cfg, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_route_on_cpu_takes_the_plain_cost_phase(monkeypatch, dtype):
    """On CPU tensors the route's cost, cost step and diagnostics are the
    plain functions', bit for bit, and neither kernel's inputs are made nor
    the kernel launched."""
    def kernel_inputs(*a, **kw):
        raise AssertionError("the kernels' inputs made on CPU tensors")

    monkeypatch.setattr(win, "_kernel_fixed_inputs", kernel_inputs)
    cfg = SMALL._replace(lm_strategy="nielsen")
    st, ms = _problem(cfg, 2, dtype=dtype)
    ref = _anchor_ref(st)
    hk.reset_launch_counts()
    route = win._lm_route(st, ms, cfg, ref)
    step = _step(cfg, st, ms)
    assert torch.equal(route.cost(st), win.robust_cost(st, ms, cfg, ref))
    got, want = route.cost_step(st, *step), win._lm_cost_plain(
        st, *step, ms, cfg, ref)
    assert all(torch.equal(getattr(got[0], k), getattr(want[0], k))
               for k in LEAVES)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    assert got[3].tolist() == [True, False]     # the NaN step is rejected
    for a, b in zip(route.diagnostics(st), (win.imu_chi2_mean(st, ms, cfg),
                                           win.prior_chi2(st, ms, cfg))):
        assert torch.equal(a, b)
    assert hk.launch_counts["lm_cost_fused"] == 0


def test_lm_solve_on_cpu_takes_each_phase_from_the_plain_functions(
        monkeypatch):
    """`lm_solve` on CPU tensors: the cost at the start is `robust_cost`'s,
    each iteration's cost phase one call of `_lm_cost_plain`, whose λ and
    cost it returns, and the diagnostics those of the returned state."""
    cfg = SMALL._replace(iters=3)
    st, ms = _problem(cfg, 2)
    calls = []
    plain = win._lm_cost_plain

    def recording(*a, **kw):
        out = plain(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(win, "_lm_cost_plain", recording)
    out, diag = win.lm_solve(st, ms, cfg, device="cpu")
    assert len(calls) == cfg.iters
    assert torch.equal(diag["cost0"], win.robust_cost(st, ms, cfg))
    assert torch.equal(diag["lambda"], calls[-1][1])
    assert torch.equal(diag["cost"], calls[-1][2])
    assert all(torch.equal(getattr(out, k), getattr(calls[-1][0], k))
               for k in LEAVES)
    assert torch.equal(diag["imu_chi2"], win.imu_chi2_mean(out, ms, cfg))
    assert torch.equal(diag["prior_chi2"], win.prior_chi2(out, ms, cfg))


def _source(name):
    return (hk.CSRC_DIR / hk.KERNEL_SOURCES[name]).read_text()


def _launch_body(text):
    return text[text.index("int launch("):]


@pytest.mark.parametrize("kernel", ["normal_eq_fused", "lm_cost_fused"])
def test_input_table_is_in_the_order_of_the_source(kernel):
    """The launchers write their pointer tables in the order the `.cu`'s
    `launch` reads them: `in[]`, then the anchor frames (and for the cost
    kernel the step's tensors, then its outputs)."""
    body = _launch_body(_source(kernel))
    table = re.search(r"\*\*\s*in\[\]\s*=\s*\{(.*?)\};", body, re.S).group(1)
    names = re.findall(r"&a\.(\w+)", table)
    shapes = (hk.normal_eq_inputs if kernel == "normal_eq_fused"
              else hk.lm_cost_inputs)
    # the time offset's instance reads two inputs more, last in `in[]`
    assert names[-2:] == ["vel", "td_obs"]
    assert names[:-2] + ["anchor"] == list(shapes(11, 128))
    assert names + ["anchor"] == list(shapes(11, 128, td=True))
    if kernel == "lm_cost_fused":
        after = body[body.index("a.anchor ="):]
        read = re.findall(r"a\.(\w+) = (?:static_cast|ptr)", after)
        assert [n for n in read if not n.startswith("o_")] == \
            ["anchor", *hk.LM_COST_MODES["step"][1]]
        outs = re.findall(r"&a\.o_(\w+)", after) + [
            n[2:] for n in read if n.startswith("o_")]
        assert outs == list(hk.LM_COST_OUTPUTS)


def _trace_ctx(kernel_names, spans, iters=8, vio=False):
    trace = SimpleNamespace(spans=spans, kernels=[(n, 0, 1)
                                                  for n in kernel_names])
    return SimpleNamespace(
        trace=trace, counters={} if vio else {"iters": iters},
        config={"max_num_iterations": iters} if vio else {})


@pytest.mark.parametrize("metric", ["solver.cost_kernel_per_iter",
                                    "solver.cost_kernel_per_iter.vio"])
def test_benchmark_reader_counts_the_kernel_per_iteration(metric):
    """(8 + 2) launches a solve read 1.25 an iteration; none read 0, and a
    context without a trace reads nothing."""
    from benchmark.harness import reader
    read = reader(metric)
    vio = metric.endswith(".vio")
    name = "void (anonymous namespace)::lm_cost_fused_kernel<float>(Args)"
    other = "void (anonymous namespace)::normal_eq_fused_kernel<float>(Args)"
    ctx = _trace_ctx([name] * 20 + [other] * 16, spans=2, vio=vio)
    assert read(ctx) == 1.25
    assert read(_trace_ctx([other] * 16, spans=2, vio=vio)) == 0
    assert read(SimpleNamespace(trace=None)) is None


# ----------------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------------

# float32: the kernel's cost's distance to the float64 plain cost at most
# this many times the float32 plain cost's. The projection factors' terms are
# the same bits (both round as PyTorch's CUDA kernels do); the IMU, prior and
# anchor terms carry matrix products, which PyTorch hands to the CUDA matrix
# library, which sums them in an order of its own, and the kernel sums left
# to right: the same float32 roundings of the same sums in another order
F32_FACTOR = 4
# float64: every term is within an ulp or two of the plain version's, and
# only the order of the float64 sum differs
F64_RTOL = 1e-12

VARIANTS = {
    "prior": dict(prior_weight=1.0),
    "no_prior": dict(prior_weight=0.0),
    "no_zupt_no_pin": dict(zupt=False, pin_rp=None),
    "pin_rp_0": dict(pin_rp=0.0),
    "no_feat_w": dict(feat_w=False),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _launch(cfg, st, ms, mode, step=(), diagnostics=False):
    shapes = hk.normal_eq_inputs(cfg.nf, cfg.max_feats, cfg.estimate_td)
    fixed = win._kernel_fixed_inputs(st, ms, cfg, _anchor_ref(st), shapes)
    leaves = {k: getattr(st, k).contiguous() for k in LEAVES}
    td_consts = (cfg.tr_over_row, cfg.row_fy, cfg.row_c0) \
        if cfg.estimate_td else None
    return hk.lm_cost_fused(
        {**fixed, **leaves}, mode, cfg.cauchy_scale ** 2,
        cfg.anchor_weight ** 0.5, cfg.min_inv_depth,
        cfg.lm_strategy == "nielsen", cfg.lm_lambda_up, cfg.lm_lambda_down,
        tuple(x.contiguous() for x in step), diagnostics, td_consts)


def _f64(x):
    return x.double() if x is not None and x.is_floating_point() else x


def _cost_close(cfg, x, ms, ref, got, where=None):
    """The kernel's costs at states `x` (anchor reference `ref`; scenarios
    `where`, default all) against the plain version's: float64 within
    F64_RTOL each; float32 the largest relative distance to the float64
    plain cost at most F32_FACTOR times the float32 plain cost's (as the
    normal equations' test holds its outputs)."""
    want = win.robust_cost(x, ms, cfg, ref)
    where = torch.ones_like(want, dtype=torch.bool) if where is None \
        else where
    if x.p.dtype == torch.float64:
        rel = (got - want).abs() / want.abs()
        return float(rel[where].max()) <= F64_RTOL, float(rel[where].max())
    c64 = win.robust_cost(tree_map(_f64, x), tree_map(_f64, ms), cfg,
                          tuple(map(_f64, ref)))
    ek = float(((got - c64).abs() / c64.abs())[where].max())
    ep = float(((want - c64).abs() / c64.abs())[where].max())
    return ek <= F32_FACTOR * ep + F64_RTOL, (ek, ep)


def _candidate_and_cost(cfg, B, dtype, **kw):
    """Retract and evaluate launches of the instance `cfg` takes against the
    plain version (`test_candidate_and_cost_match_the_plain_version`)."""
    st, ms = _problem(cfg, B, device="cuda", dtype=dtype, **kw)
    ref = _anchor_ref(st)
    dx, d_rho, pred, _, _ = _step(cfg, st, ms)
    hk.reset_launch_counts()
    out = _launch(cfg, st, ms, "retract", (dx, d_rho, pred))
    clean = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    cand = win.retract(st, clean, d_rho, cfg)
    for k in LEAVES:
        assert torch.equal(out[k], getattr(cand, k)), k
    ok, err = _cost_close(cfg, cand, ms, ref, out["cost"])
    assert ok, err
    assert out["ok"].tolist() == [b != 1 for b in range(B)]
    ev = _launch(cfg, st, ms, "evaluate", diagnostics=True)
    name = "lm_cost_fused_td" if cfg.estimate_td else "lm_cost_fused"
    assert hk.launch_counts[name] == 2 and sum(hk.launch_counts.values()) == 2
    return st, ms, ref, ev


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_candidate_and_cost_match_the_plain_version(variant, B, dtype):
    """Retract mode: the candidate equals `window.retract`'s of the
    sanitized step bit for bit, its cost `robust_cost`'s at it, and `ok`
    says whether the step was finite (scenario 1's is not). Evaluate mode:
    the cost and the diagnostics at the state as given."""
    _needs_card()
    cfg = FLAGSHIP
    st, ms, ref, ev = _candidate_and_cost(cfg, B, dtype, **VARIANTS[variant])
    ok, err = _cost_close(cfg, st, ms, ref, ev["cost"])
    assert ok, err
    rtol = F64_RTOL if dtype == torch.float64 else 1e-5
    for name, plain in (("imu_chi2", win.imu_chi2_mean(st, ms, cfg)),
                        ("prior_chi2", win.prior_chi2(st, ms, cfg))):
        assert torch.allclose(ev[name], plain, rtol=rtol, atol=0), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("tr_over_row", [0.0, 0.033 / 480])
def test_td_candidate_and_cost_match_the_plain_version(tr_over_row, B,
                                                        dtype):
    """The time offset's instance (`lm_cost_fused_td`): as
    `test_candidate_and_cost_match_the_plain_version`, with td estimated,
    image velocities, td at the frames' capture, and a global (TR = 0) or a
    rolling shutter (33 ms over 480 rows): the candidate's td bit for bit,
    its cost against `robust_cost`'s shifted observations."""
    _needs_card()
    cfg = FLAGSHIP._replace(estimate_td=True, tr_over_row=tr_over_row)
    st, ms, ref, ev = _candidate_and_cost(cfg, B, dtype, td=True)
    ok, err = _cost_close(cfg, st, ms, ref, ev["cost"])
    assert ok, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("strategy", ["halving", "nielsen"])
def test_step_matches_the_plain_version(strategy, dtype):
    """Step mode (the route's cost step) against `_lm_cost_plain`, B = 64:
    the same decisions (the NaN step of scenario 1 rejected), the next
    iterate bit for bit, λ bit for bit under "halving" and where a step is
    rejected (under "nielsen" an accepted step's λ follows the gain ratio,
    whose cost difference the two round apart: 1e-5 there), the next cost
    the iterate's where a step is rejected and as the cost test holds it
    where one is accepted. Two launches give the same bits."""
    _needs_card()
    cfg = FLAGSHIP._replace(lm_strategy=strategy)
    st, ms = _problem(cfg, 64, device="cuda", dtype=dtype)
    ref = _anchor_ref(st)
    step = _step(cfg, st, ms)
    route = win._lm_route(st, ms, cfg, ref)
    got = route.cost_step(st, *step)
    again = route.cost_step(st, *step)
    want = win._lm_cost_plain(st, *step, ms, cfg, ref)
    for k in LEAVES:
        assert torch.equal(getattr(got[0], k), getattr(again[0], k))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
    ok = want[3]
    assert torch.equal(got[3], ok) and not bool(ok[1]) and bool(ok.any())
    for k in LEAVES:
        assert torch.equal(getattr(got[0], k), getattr(want[0], k)), k
    if strategy == "halving":
        assert torch.equal(got[1], want[1])
    else:
        assert torch.equal(got[1][~ok], want[1][~ok])
        assert torch.allclose(got[1], want[1], rtol=1e-5, atol=0)
    assert torch.equal(got[2][~ok], want[2][~ok])
    clean = torch.where(torch.isfinite(step[0]), step[0],
                        torch.zeros_like(step[0]))
    cand = win.retract(st, clean, step[1], cfg)
    close, err = _cost_close(cfg, cand, ms, ref, got[2], ok)
    assert close, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_solve_takes_the_same_decisions_as_the_plain_version(
        monkeypatch, dtype):
    """B = 64, 8 iterations (float32 with the fused Schur kernel), both
    kernels against the normal equations' kernel with the plain cost phase:
    every scenario accepts and rejects at the same iterations; with the
    same decisions "halving" takes the same steps, so the solves end at the
    same bits. The solve launches the cost kernel 8 + 2 times and makes no
    host synchronisation (torch's sync check set to raise)."""
    _needs_card()
    _same_decisions(monkeypatch, FLAGSHIP, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_solve_with_td_takes_the_plain_routes_decisions(monkeypatch,
                                                           dtype):
    """As `test_lm_solve_takes_the_same_decisions_as_the_plain_version`,
    with td estimated under a rolling shutter (33 ms over 480 rows): both td
    instances, 8 + 2 launches of the cost's and 8 of the normal
    equations', against the td normal equations with the plain cost phase:
    the same decisions and the same bits at the end."""
    _needs_card()
    _same_decisions(monkeypatch, FLAGSHIP._replace(
        estimate_td=True, tr_over_row=0.033 / 480), dtype, td=True)


def _same_decisions(monkeypatch, cfg, dtype, **kw):
    cfg = cfg._replace(fused_schur=dtype == torch.float32)
    st, ms = _problem(cfg, 64, device="cuda", dtype=dtype, prior_weight=0.0,
                      **kw)
    real = win._lm_route
    oks = []

    def recording(route):
        def cost_step(*a):
            out = route.cost_step(*a)
            oks[-1].append(out[3].clone())
            return out
        return route._replace(cost_step=cost_step)

    monkeypatch.setattr(win, "_lm_route", lambda *a: recording(real(*a)))
    oks.append([])
    hk.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out_k, diag_k = win.lm_solve(st, ms, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sfx = "_td" if cfg.estimate_td else ""
    assert hk.launch_counts["lm_cost_fused" + sfx] == cfg.iters + 2
    assert hk.launch_counts["normal_eq_fused" + sfx] == cfg.iters
    assert sum(hk.launch_counts[k] for k in (
        "lm_cost_fused", "lm_cost_fused_td", "normal_eq_fused",
        "normal_eq_fused_td")) == 2 * cfg.iters + 2

    def plain_cost(state, meas, c, anchor_ref):
        route = real(state, meas, c, anchor_ref)
        return route._replace(
            cost=lambda s: win.robust_cost(s, meas, c, anchor_ref),
            cost_step=lambda *a: win._lm_cost_plain(*a, meas, c, anchor_ref))

    monkeypatch.setattr(win, "_lm_route",
                        lambda *a: recording(plain_cost(*a)))
    oks.append([])
    out_p, diag_p = win.lm_solve(st, ms, cfg)
    assert len(oks[0]) == len(oks[1]) == cfg.iters
    for it, (a, b) in enumerate(zip(*oks)):
        assert torch.equal(a, b), (it, (a != b).nonzero().flatten().tolist())
    assert torch.equal(diag_k["lambda"], diag_p["lambda"])
    for k in LEAVES:
        assert torch.equal(getattr(out_k, k), getattr(out_p, k)), k
    assert (diag_k["cost"] < diag_k["cost0"]).all()
