"""The port's batch-scaling curve (`utils/bench_curve.py`) against the JAX
package's, CPU, at a test size (window 3, 32 slots, 4 LM iterations,
B = 1, 2).

Its solves are the batched `lm_solve` of the JAX curve (`jax.vmap` of
`lm_solve` over the same broadcast problem): in float64 through the f64
Schur path, every scenario's state within 1e-6 and its cost within rtol
1e-6 of JAX's (`test_torch_window.py`'s tolerance for `lm_solve`). Rows
carry the JAX row's keys but the two renamed ones
(`test_torch_jax_runner_keys.py`). The operation count is positive and
exactly linear in B (the aten products are per scenario); the kernel route
on the CPU runs the kernel's plain version, so it launches nothing and the
count is the products the counter sees. Nothing is written unless a path
is given.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.ops import window as jw
from anticipated_vins_mono_tpu.utils.synthetic import \
    make_window_problem as jproblem
from anticipated_vins_mono_torch.ops import hopper_kernels as hk
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.utils import bench_curve as bc

torch.set_num_threads(1)

CFG = dict(window=3, max_feats=32, iters=4)
BATCHES = (1, 2)


@pytest.fixture(scope="module")
def curve_f64():
    return bc.run_curve(BATCHES, reps=1, device="cpu", cfg=WindowConfig(**CFG),
                        fused_schur=False, dtype=torch.float64,
                        return_outputs=True)


@pytest.fixture(scope="module")
def curve_kernel_route():
    return bc.run_curve(BATCHES, reps=1, device="cpu", cfg=WindowConfig(**CFG),
                        fused_schur=True)


@pytest.fixture(scope="module")
def jax_batched():
    """The JAX curve's solve: `jax.vmap(lm_solve)` over the problem
    broadcast to the largest B, float64 (one compile; every scenario is the
    same problem, so the smaller batches are its leading rows)."""
    cfg = jw.WindowConfig(**CFG)
    prob = jproblem(cfg, seed=0, perturb=0.3, pixel_noise=0.5,
                    dtype=jnp.float64)
    B = max(BATCHES)
    batch = lambda x: jnp.broadcast_to(x[None], (B,) + x.shape).copy()
    st, diag = jax.jit(jax.vmap(lambda s, m: jw.lm_solve(s, m, cfg)))(
        jax.tree_util.tree_map(batch, prob.init),
        jax.tree_util.tree_map(batch, prob.meas))
    return (jax.tree_util.tree_map(np.asarray, st),
            {k: np.asarray(v) for k, v in diag.items()})


def test_rows_have_the_port_keys(curve_f64, curve_kernel_route):
    rows, _ = curve_f64
    for row, B in zip(rows + curve_kernel_route, BATCHES * 2):
        assert row["B"] == B
        assert set(row) == bc_row_keys()
        assert row["device"] == "cpu" and row["nvidia_smi"] is None
        assert row["solves"] == 3 and row["schur_launches"] == 0
        assert row["iters_per_s"] > 0 and row["ms_per_batched_solve"] > 0
        assert row["first_solve_s"] > 0 and row["mfu_f32"] > 0
    assert [r["fused_schur"] for r in curve_kernel_route] == [True, True]


def bc_row_keys():
    return {"B", "iters_per_s", "vs_ceres", "ms_per_batched_solve",
            "flops_per_solve", "mfu_f32", "first_solve_s", "fused_schur",
            "solves", "schur_launches", "device", "nvidia_smi"}


@pytest.mark.parametrize("B", BATCHES)
def test_solves_equal_the_jax_batched_lm_solve(curve_f64, jax_batched, B):
    st, diag = curve_f64[1][B]
    jst, jdiag = jax_batched
    for name in ("p", "q", "v", "ba", "bg", "inv_depth"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   getattr(jst, name)[:B], rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(diag["cost"].numpy(), jdiag["cost"][:B],
                               rtol=1e-6)
    np.testing.assert_allclose(diag["cost0"].numpy(), jdiag["cost0"][:B],
                               rtol=1e-9)
    assert np.all(jdiag["cost"] < jdiag["cost0"])


@pytest.mark.parametrize("curve", ["curve_f64", "curve_kernel_route"])
def test_flop_count_is_positive_and_linear_in_B(curve, request):
    rows = request.getfixturevalue(curve)
    rows = rows[0] if isinstance(rows, tuple) else rows
    f1, f2 = rows[0]["flops_per_solve"], rows[1]["flops_per_solve"]
    assert f1 > 0 and f2 == pytest.approx(2 * f1, rel=1e-12)


def test_schur_work_is_the_chip_smoke_bound():
    """One formula: `hopper_kernels.schur_work` per scenario, the one
    `chip_smoke.schur_bound` and the curve's count use."""
    floats, flops = hk.schur_work(178, 128)
    assert floats == 178 * 178 + 178 + 128 * 178 + 2 * 128 + 1 + 178 + 128 + 1
    assert flops == 128 * 178 * 179 + 178 ** 3 / 3 + 2 * 178 ** 2 \
        + 4 * 128 * 178


def test_writes_only_where_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = WindowConfig(window=2, max_feats=8, iters=1)
    bc.run_curve((1,), reps=1, device="cpu", cfg=cfg, fused_schur=False,
                 dtype=torch.float64)
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "sub" / "curve.json"
    rows = bc.run_curve((1,), reps=1, out_path=str(out), device="cpu",
                        cfg=cfg, fused_schur=False, dtype=torch.float64)
    assert json.loads(out.read_text())[0]["B"] == rows[0]["B"] == 1


def test_flagship_is_the_bench_shape():
    assert bc.FLAGSHIP.window == 10 and bc.FLAGSHIP.max_feats == 128
    assert bc.FLAGSHIP.iters == 8 and bc.FLAGSHIP.dim == 178
    assert bc.PEAK_F32_FLOPS == 67e12
