"""Entry points: one flagship solve, and the multi-rank dry run.

Counterpart of the repository root's `__graft_entry__.py` for the port.
`entry()` gives the flagship sliding-window LM solve (linearize → normal
equations → Schur → Cholesky → retract, 8 LM iterations, 10-keyframe
window, 128 landmark slots) in float32 on the card; `dryrun_multichip`
runs the multi-rank step on `n_ranks` processes: the dp × fp sharded solve
at the flagship shape, then the candidate-sharded greedy selection at the
flagship selector shape (horizon 13 → Ω 126×126, 128 candidates, κ̄ = 30).

    python3 -m anticipated_vins_mono_torch.entry 2
"""

from __future__ import annotations

import numpy as np
import torch

from anticipated_vins_mono_torch.ops.window import WindowConfig, lm_solve

FLAGSHIP = WindowConfig(window=10, max_feats=128, iters=8)
FLAGSHIP_PROBLEM = dict(seed=0, perturb=0.3, pixel_noise=0.5)
KAPPA = 30
N_CANDIDATES = 128


def entry(device="cuda"):
    """(fn, example_args): one full sliding-window LM solve on the flagship
    problem, float32, on `device`."""
    from anticipated_vins_mono_torch.utils.synthetic import make_window_problem
    prob = make_window_problem(FLAGSHIP, dtype=torch.float32, device=device,
                               **FLAGSHIP_PROBLEM)

    def fn(state, meas):
        return lm_solve(state, meas, FLAGSHIP, device=device)

    return fn, (prob.init, prob.meas)


def selection_inputs(B: int, n_fp: int, dtype=np.float32):
    """The dry run's selection problem (numpy, seed 0): Omega [B,126,126]
    PSD, 128 rank-4 PSD Δ per scenario (rounded up to a multiple of n_fp),
    unit probabilities, all valid."""
    from anticipated_vins_mono_torch.models import anticipation as ant
    D = ant.SelectorConfig().dim
    F = N_CANDIDATES + (-N_CANDIDATES) % n_fp
    rng = np.random.default_rng(0)
    A = rng.normal(size=(B, D + 4, D)).astype(np.float32) * 0.3
    Omega = np.einsum("bij,bik->bjk", A, A) + np.eye(D, dtype=np.float32)
    Bm = rng.normal(size=(B, F, 4, D)).astype(np.float32)
    Deltas = np.einsum("bfij,bfik->bfjk", Bm, Bm)
    return tuple(x.astype(dtype) for x in (
        Omega, Deltas, np.ones((B, F), np.float32),
        np.ones((B, F), np.float32)))


def dryrun_rank(rank, n_ranks, dtypes, device, cfg=FLAGSHIP):
    """Worker of `dryrun_multichip`: both stages on this rank, once per
    dtype. Returns {dtype name: {"solve": ..., "select": ...}}."""
    from anticipated_vins_mono_torch.parallel import selector, sharded
    n_fp = 2 if n_ranks % 2 == 0 else 1
    n_dp = n_ranks // n_fp
    mesh = sharded.make_mesh(n_dp, n_fp)
    device = torch.device(device)
    out = {}
    for dtype in dtypes:
        # one scenario per dp rank
        solve = sharded.solve_problems(mesh, cfg,
                                       [FLAGSHIP_PROBLEM] * n_dp, dtype, device)
        c0, c1 = solve["cost0"], solve["cost"]
        assert np.all(np.isfinite(c1)), c1
        assert np.all(c1 <= c0 + 1e-6), (c0, c1)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        sel = selector.select_arrays(mesh, KAPPA, *selection_inputs(
            n_dp, n_fp, np_dtype), device)
        out[str(dtype)] = {"solve": solve, "select": sel}
    return out


def dryrun_multichip(n_ranks: int, dtypes=(torch.float32,), device="cuda",
                     cfg: WindowConfig = FLAGSHIP):
    """The multi-rank step on `n_ranks` new processes: dp (scenario batch)
    × fp (landmark shards, all-reduced normal equations), fp = 2 when
    n_ranks is even, on the window `cfg` (the flagship unless a test asks
    for a smaller one); then the sharded selection; once per dtype of
    `dtypes`, in one process group. Every scenario must pick κ̄
    candidates. Returns {dtype: each rank's results (numpy) in rank
    order}."""
    from anticipated_vins_mono_torch.parallel.distributed import spawn_ranks
    from anticipated_vins_mono_torch.parallel.selector import gather_selection
    n_fp = 2 if n_ranks % 2 == 0 else 1
    ranks = spawn_ranks(dryrun_rank, n_ranks, tuple(dtypes), str(device), cfg)
    out = {}
    for dtype in dtypes:
        results = [r[str(dtype)] for r in ranks]
        sel, Om = gather_selection([r["select"] for r in results], n_fp)
        n_sel = sel.sum(axis=1)
        assert np.all(n_sel == KAPPA), n_sel
        c0 = np.concatenate([r["solve"]["cost0"] for r in results])
        c1 = np.concatenate([r["solve"]["cost"] for r in results])
        print(f"dryrun_multichip ok: {dtype}, mesh=({n_ranks // n_fp}x{n_fp}) "
              f"cost {c0.mean():.3e} -> {c1.mean():.3e}; sharded selection "
              f"D={Om.shape[-1]} F={sel.shape[1]} picked {int(n_sel[0])}"
              f"/scenario", flush=True)
        out[dtype] = results
    return out


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
