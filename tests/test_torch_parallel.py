"""The port's multi-rank solver and selection (`parallel/`) against the
JAX package, CPU, float64, ranks as processes over gloo.

One module fixture spawns 4 ranks (`spawn_ranks`, a free port, one torch
thread each) that run, in one process group:

- the feature-sharded solve on a 2 (dp) × 2 (fp) mesh at
  `tests/test_parallel.py`'s size (window 4, 32 slots, 6 iterations), one
  problem broadcast over dp;
- the dp-only solve on a 4 × 1 mesh over two different problems;
- the candidate-sharded greedy selection of `tests/test_parallel.py` on a
  2 × 2 mesh.

The oracle is the one `tests/test_parallel.py` uses: the JAX package's
single-device `lm_solve` (positions 1e-6, cost rtol 1e-5: the all-reduce
reassociates the sums) and `select_informative` (the same set, Ω rtol
1e-8). The JAX `sharded_lm_solve` itself is not compiled here; its own
tests hold it to the same oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anticipated_vins_mono_tpu.models import anticipation as jant
from anticipated_vins_mono_tpu.ops.window import WindowConfig as JCfg
from anticipated_vins_mono_tpu.ops.window import lm_solve as jlm_solve
from anticipated_vins_mono_tpu.utils.synthetic import \
    make_window_problem as jproblem
from anticipated_vins_mono_torch.ops.window import WindowConfig
from anticipated_vins_mono_torch.parallel import distributed, selector, sharded

torch.set_num_threads(1)

CFG = dict(window=4, max_feats=32, iters=6)
PROBLEM = dict(seed=0, perturb=0.3, pixel_noise=0.5)
DP_ONLY = [dict(seed=s, perturb=0.3) for s in (0, 1, 0, 1)]
KAPPA = 4


def _selection_problem():
    """`tests/test_parallel.py::test_sharded_selection_matches_single_device`'s
    inputs: B = 2 scenarios, horizon 6, F = 16 candidates."""
    rng = np.random.default_rng(0)
    D = jant.SelectorConfig(horizon=6).dim
    B, F = 2, 16
    A = rng.normal(size=(B, D + 4, D)) * 0.3
    Omega = np.einsum("bij,bik->bjk", A, A) + np.eye(D)
    Deltas = []
    for _ in range(B * F):
        Bm = rng.normal(size=(4, D))
        Deltas.append(Bm.T @ Bm)
    Deltas = np.stack(Deltas).reshape(B, F, D, D)
    probs = rng.uniform(0.5, 1.0, (B, F))
    return Omega, Deltas, probs, np.ones((B, F))


@pytest.fixture(scope="module")
def ranks():
    cfg = WindowConfig(**CFG)
    calls = [(sharded.solve_rank, (cfg, 2, [PROBLEM] * 2, torch.float64,
                                   "cpu")),
             (sharded.solve_rank, (cfg, 1, DP_ONLY, torch.float64, "cpu")),
             (selector.select_rank, (2, KAPPA, _selection_problem(), "cpu"))]
    out = distributed.spawn_ranks(distributed.run_each, 4, calls,
                                  backend="gloo", threads=1)
    return [[r[k] for r in out] for k in range(len(calls))]


@pytest.fixture(scope="module")
def jax_solves():
    cfg = JCfg(**CFG)
    out = {}
    for key, kw in (("noisy", PROBLEM), (0, DP_ONLY[0]), (1, DP_ONLY[1])):
        prob = jproblem(cfg, **kw)
        st, diag = jlm_solve(prob.init, prob.meas, cfg)
        out[key] = (np.asarray(st.p), float(diag["cost0"]),
                    float(diag["cost"]))
    return out


def test_mesh_layout_is_dp_major(ranks):
    """rank = dp_index · fp + fp_index: fp ranks contiguous."""
    for rank, r in enumerate(ranks[0]):
        assert (r["dp"], r["fp"]) == divmod(rank, 2)
    assert [(r["dp"], r["fp"]) for r in ranks[1]] == [(k, 0) for k in range(4)]


def test_sharded_2x2_matches_the_single_device_solve(ranks, jax_solves):
    p_ref, c0_ref, c_ref = jax_solves["noisy"]
    for r in ranks[0]:
        assert r["p"].shape == (1, CFG["window"] + 1, 3)
        assert r["inv_depth"].shape == (1, CFG["max_feats"] // 2)
        np.testing.assert_allclose(r["p"][0], p_ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["cost"][0], c_ref, rtol=1e-5)
        np.testing.assert_allclose(r["cost0"][0], c0_ref, rtol=1e-9)
    # the fp ranks of one dp group take the same (all-reduced) steps; their
    # costs add the shared factors to their own landmarks' in another order
    for d in range(2):
        a, b = ranks[0][2 * d], ranks[0][2 * d + 1]
        np.testing.assert_array_equal(a["p"], b["p"])
        np.testing.assert_allclose(a["cost"], b["cost"], rtol=1e-12)


def test_sharded_dp_only_over_two_problems(ranks, jax_solves):
    rs = ranks[1]
    for k, r in enumerate(rs):
        assert np.all(r["cost"] < r["cost0"])
        p_ref, _, c_ref = jax_solves[k % 2]
        np.testing.assert_allclose(r["p"][0], p_ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["cost"][0], c_ref, rtol=1e-5)
    # scenarios 0 and 2 are the same problem
    np.testing.assert_allclose(rs[0]["p"], rs[2]["p"], atol=1e-12)
    assert not np.allclose(rs[0]["p"], rs[1]["p"])


def test_sharded_selection_matches_jax_select_informative(ranks):
    Omega, Deltas, probs, valid = _selection_problem()
    sel, OmF = selector.gather_selection(ranks[2], n_fp=2)
    assert sel.shape == (2, 16) and OmF.shape == Omega.shape
    for b in range(2):
        ref_sel, ref_Om = jant.select_informative(
            jnp.asarray(Omega[b]), jnp.asarray(Deltas[b]),
            jnp.asarray(probs[b]), jnp.asarray(valid[b]), KAPPA)
        np.testing.assert_array_equal(sel[b], np.asarray(ref_sel))
        np.testing.assert_allclose(OmF[b], np.asarray(ref_Om), rtol=1e-8)
        assert int(sel[b].sum()) == KAPPA


def test_make_global_array_takes_the_ranks_block():
    """The block of one rank of a 2 × 2 mesh, without a process group: a
    stand-in mesh answers the rank's coordinates."""
    class Mesh:
        mesh_dim_names = ("dp", "fp")

        def size(self, dim):
            return 2

        def get_local_rank(self, name):
            return {"dp": 1, "fp": 0}[name]

    x = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    blk = distributed.make_global_array(Mesh(), distributed.P("dp", "fp"), x)
    np.testing.assert_array_equal(blk.numpy(), x[2:4, 0:3].numpy())
    blk = distributed.make_global_array(Mesh(), distributed.P("dp"), x)
    np.testing.assert_array_equal(blk.numpy(), x[2:4].numpy())


def test_solver_specs_shard_the_landmark_leaves():
    ss, ms = sharded.solver_specs()
    dpfp = distributed.P("dp", "fp")
    assert [f for f in ss._fields if getattr(ss, f) == dpfp] == ["inv_depth"]
    assert [f for f in ms._fields if getattr(ms, f) == dpfp] == \
        ["pts", "vel", "mask", "anchor", "feat_valid"]
    assert ms.prior.lin.inv_depth == dpfp
    assert all(getattr(ms.pre, f) == distributed.P("dp")
               for f in ms.pre._fields)


def test_initialize_multihost_is_single_process_without_a_coordinator(
        monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
                "WORLD_SIZE", "NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_multihost() is False
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert distributed.initialize_multihost(num_processes=1) is False


def test_a_failing_rank_fails_the_spawn():
    """No problems to stack: every rank raises, and so does the spawn."""
    with pytest.raises(Exception, match="terminated with the following error"):
        distributed.spawn_ranks(distributed.run_each, 2,
                                [(sharded.solve_rank, (WindowConfig(
                                    window=2, max_feats=3, iters=1), 2, [],
                                    torch.float64, "cpu"))],
                                backend="gloo", threads=1)
