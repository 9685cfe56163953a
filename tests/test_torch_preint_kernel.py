"""The IMU preintegration kernel (`csrc/preint_scan.cu`, launcher
`hopper_kernels.preint_scan`, route and packing `preintegration.preintegrate`)
and its plain version, the port's loop (`preintegration.preintegrate_plain`).

On the CPU: `preintegrate` is the loop and launches nothing, under one
`preint` span a call (the launcher's refusal of CPU tensors is
`tests/test_torch_kernels.py`'s); and the kernel's
stopping rule — scan up to each pair's last row whose dt is not 0, then
renormalise δq until it stops changing — gives the 64-step loop's result
bit for bit, with trailing padding and interior dt = 0 rows. (The JAX
parity of `preintegrate` is `tests/test_torch_preintegration.py`.)

On a card (`gpu` marker, `pytest -m gpu`): the kernel against the loop on
the same card. No JAX here: the card's machine has none."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.ops import preintegration as pre
from anticipated_vins_mono_torch.utils import timing
from anticipated_vins_mono_torch.utils.synthetic import imu_pairs

torch.set_num_threads(1)

FIELDS = ("dp", "dq", "dv", "J", "P", "dt_sum", "S")


def _pairs(seed, dtype=torch.float64, device="cpu", **kw):
    return imu_pairs(seed, dtype=dtype, device=device, **kw)


def _stopped_scan(args, noise, with_cov):
    """The kernel's rule in plain PyTorch, pair by pair: the loop over the
    rows up to the last whose dt is not 0, then δq renormalised once per
    later row until it stops changing."""
    dts = args[0]
    flat = [a.reshape((-1,) + tuple(a.shape[dts.dim() - 1:])) for a in args]
    outs = []
    for b in range(flat[0].shape[0]):
        nz = torch.nonzero(flat[0][b] != 0)
        rows = int(nz[-1]) + 1 if len(nz) else 0
        one = [a[b:b + 1] for a in flat]
        one[0], one[1], one[2] = (one[0][:, :rows], one[1][:, :rows],
                                  one[2][:, :rows])
        p = pre.preintegrate_plain(*one, noise, with_cov=with_cov)
        dq = p.dq
        for _ in range(dts.shape[-1] - rows):
            dq2 = lie.quat_normalize(dq)
            if torch.equal(dq2, dq):
                break
            dq = dq2
        outs.append(p._replace(dq=dq))
    lead = tuple(dts.shape[:-1])
    return {f: None if getattr(outs[0], f) is None else torch.cat(
        [getattr(o, f) for o in outs]).reshape(
            lead + tuple(getattr(outs[0], f).shape[1:])) for f in FIELDS}


@pytest.mark.parametrize("with_cov", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_takes_the_loop_and_counts_no_launch(monkeypatch, dtype,
                                                           with_cov):
    """`preintegrate` on CPU tensors is `preintegrate_plain`, bit for bit,
    and never reaches the launcher."""
    def launcher(*a, **kw):
        raise AssertionError("the launcher on CPU tensors")

    monkeypatch.setattr(hk, "preint_scan", launcher)
    args = _pairs(0, dtype=dtype)
    hk.reset_launch_counts()
    ref = pre.preintegrate_plain(*args, pre.ImuNoise(), with_cov=with_cov)
    via = pre.preintegrate(*args, pre.ImuNoise(), with_cov=with_cov)
    for f in pre.Preintegrated._fields:
        a, b = getattr(via, f), getattr(ref, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert hk.launch_counts["preint_scan"] == 0


def test_preintegrate_calls_the_wrapper_once_under_one_span(monkeypatch):
    """Every `preintegrate` call on CPU tensors goes through
    `preintegrate_plain` once, with its arguments as given (on CUDA tensors
    it packs them for the launcher instead), and records one `preint`
    span."""
    calls = []
    wrapped = pre.preintegrate_plain

    def recording(*a, **kw):
        calls.append((a, kw))
        return wrapped(*a, **kw)

    monkeypatch.setattr(pre, "preintegrate_plain", recording)
    args = _pairs(1, batch=(3,))
    noise = pre.ImuNoise()
    with profile(activities=[ProfilerActivity.CPU]):
        pre.preintegrate(*args, noise)
    timing.reset_recorded()
    with profile(activities=[ProfilerActivity.CPU]):
        pre.preintegrate(*args, noise, with_cov=False)
    spans = timing.recorded()
    timing.reset_recorded()
    assert len(calls) == 2
    assert all(x is y for x, y in zip(calls[0][0], list(args) + [noise]))
    assert [s.name for s in spans] == ["preint"]


@pytest.mark.parametrize("with_cov", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["moving", "interior", "ragged"])
def test_stopping_after_the_last_nonzero_dt_is_the_64_step_loop(
        case, dtype, with_cov):
    """Bit for bit: rows after the last nonzero dt change nothing but δq's
    renormalisation (dt = 0: the deltas gain dv·0, the Jacobian and the
    covariance an identity F and a zero V), which the rule repeats until it
    is a fixed point. Interior dt = 0 rows are stepped: they carry their
    samples into the next row's midpoint."""
    noise = pre.ImuNoise()
    for seed in range(12):
        if case == "ragged":   # pairs of one batch end at other rows
            parts = [_pairs(seed * 7 + r, batch=(1,), real=r, dtype=dtype)
                     for r in (20, 1, 0, 64, 33)]
            args = [torch.cat(p) for p in zip(*parts)]
        else:
            args = _pairs(seed, batch=(2, 5), dtype=dtype,
                          interior=(3, 4, 11) if case == "interior" else ())
        full = pre.preintegrate_plain(*args, noise, with_cov=with_cov)
        cut = _stopped_scan(args, noise, with_cov)
        for f in FIELDS:
            a = getattr(full, f)
            assert (a is None and cut[f] is None) or torch.equal(a, cut[f]), \
                (case, seed, f)


# ----------------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------------


class _NegativeNoise(pre.ImuNoise):
    """A negative noise covariance: P comes out negative definite, so the
    whitening's factor fails (the deltas stay finite)."""

    def noise_cov18(self, dtype=torch.float64, device=None):
        return -super().noise_cov18(dtype, device)


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.gpu
def test_preint_kernel_matches_the_loop_on_the_card():
    """Runs on a machine with a CUDA card and nvcc (`pytest -m gpu`).

    float64: rtol 1e-9 (S, whose entries reach 1e6, rtol 1e-8; P, ~1e-9,
    atol 1e-20), as the port against JAX: the same algebra, other sums.
    float32: per field, the kernel's largest distance to the float64 loop at
    most 4 times the float32 loop's, plus 8 ulps of the field's size: both
    are float32 roundings of the same scan (the kernel contracts products
    into fused multiply-adds, which round once where the loop rounds
    twice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    noise = pre.ImuNoise()
    cases = [dict(batch=(10,)), dict(batch=(10,), interior=(3, 4, 11)),
             dict(batch=(3, 10)), dict(batch=(10,), n=20, real=20),
             dict(batch=(2,), n=80, real=70)]
    for kw in cases:
        for with_cov in (True, False):
            a64 = _pairs(5, dtype=torch.float64, device="cuda", **kw)
            ref64 = pre.preintegrate_plain(*a64, noise, with_cov=with_cov)
            hk.reset_launch_counts()
            got64 = pre.preintegrate(*a64, noise, with_cov=with_cov)
            assert hk.launch_counts["preint_scan"] == 1
            a32 = [x.float() for x in a64]
            ref32 = pre.preintegrate_plain(*a32, noise, with_cov=with_cov)
            got32 = pre.preintegrate(*a32, noise, with_cov=with_cov)
            assert hk.launch_counts["preint_scan"] == 2
            for f in pre.Preintegrated._fields:
                r64, k64, r32, k32 = (getattr(x, f) for x in
                                      (ref64, got64, ref32, got32))
                if r64 is None:
                    assert k64 is None and k32 is None, f
                    continue
                assert k64.shape == r64.shape and k32.dtype == torch.float32
                torch.testing.assert_close(
                    k64, r64, rtol=1e-8 if f == "S" else 1e-9,
                    atol=1e-20 if f == "P" else 1e-11,
                    msg=lambda m: f"{kw} {with_cov} {f}: {m}")
                scale = float(r64.abs().max())
                eps = torch.finfo(torch.float32).eps
                assert _max_err(k32, r64) <= 4 * _max_err(r32, r64) \
                    + 8 * eps * scale, (kw, with_cov, f, _max_err(k32, r64),
                                        _max_err(r32, r64))
    # not positive definite: the whole of S is NaN, as the loop's
    for dtype in (torch.float32, torch.float64):
        args = _pairs(6, dtype=dtype, device="cuda")
        got = pre.preintegrate(*args, _NegativeNoise())
        ref = pre.preintegrate_plain(*args, _NegativeNoise())
        assert torch.isnan(got.S).all() and torch.isnan(ref.S).all()
        assert torch.isfinite(got.dp).all()
