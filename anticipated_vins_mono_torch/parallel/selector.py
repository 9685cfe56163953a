"""Feature-candidate sharding for the greedy logdet selection.

Counterpart of `anticipated_vins_mono_tpu/parallel/selector.py`. Candidate
features are split over the ranks of the fp axis; each greedy round scores
the LOCAL candidates' logdets with `lie.logdet_psd` (a batched Cholesky, as
the JAX module scores with its `lie.logdet_psd`, not the Pallas kernel),
takes the global winner by an all-reduce MAX of the gain and then MIN of
the global index among the maxima (the deterministic tie-break: smallest
global index), and all-reduces SUM the winner's p·Δ so every rank applies
the same Ω update. The result is the single-rank exact greedy's, with the
per-round work divided by the shard count.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from anticipated_vins_mono_torch.ops import lie
from anticipated_vins_mono_torch.parallel.distributed import (
    P, axis_size, make_global_array)
from anticipated_vins_mono_torch.parallel.sharded import make_mesh

_NO_INDEX = torch.iinfo(torch.int64).max


def sharded_select(mesh, kappa: int, axis: str = "fp"):
    """The sharded greedy selector on `mesh`.

    Returns `select(Omega, Deltas, probs, valid)` for this rank's block:
    Omega [B,D,D] (whole on every `axis` rank), Deltas [B,F,D,D] and probs
    / valid [B,F] this rank's slice of the candidates (F per rank). Returns
    (selected mask [B,F] of this rank's candidates, Omega_final [B,D,D])."""
    n_sh = axis_size(mesh, axis)
    group = mesh.get_group(axis) if n_sh > 1 else None
    shard = mesh.get_local_rank(axis)

    def reduce(x, op):
        if group is not None:
            dist.all_reduce(x, op=op, group=group)
        return x

    def select(Omega, Deltas, probs, valid):
        with torch.no_grad():
            return _select(Omega, Deltas, probs, valid)

    def _select(Omega, Deltas, probs, valid):
        B, F_local = probs.shape
        gidx0 = shard * F_local
        rows = torch.arange(B, device=probs.device)
        Om = Omega.clone()
        sel = torch.zeros_like(probs)
        for _ in range(kappa):
            cand = Om[:, None] + probs[..., None, None] * Deltas
            ld = lie.logdet_psd(cand)
            ld = torch.where((valid > 0) & (sel < 0.5), ld,
                             torch.full_like(ld, -float("inf")))
            ld = torch.where(torch.isnan(ld),
                             torch.full_like(ld, -float("inf")), ld)
            lbest, larg = torch.max(ld, dim=-1)
            gbest = reduce(lbest.clone(), dist.ReduceOp.MAX)
            garg = torch.where(lbest >= gbest, gidx0 + larg,
                               torch.full_like(larg, _NO_INDEX))
            garg = reduce(garg, dist.ReduceOp.MIN)
            ok = torch.isfinite(gbest)
            is_winner = (garg >= gidx0) & (garg < gidx0 + F_local) & ok
            lwin = torch.clamp(garg - gidx0, 0, F_local - 1)
            okf = ok.to(Om.dtype)
            winf = is_winner.to(Om.dtype)
            sel[rows, lwin] += winf * okf
            d_win = (winf * probs[rows, lwin])[:, None, None] * \
                Deltas[rows, lwin]
            Om = Om + okf[:, None, None] * reduce(d_win, dist.ReduceOp.SUM)
            sel = torch.clamp(sel, max=1.0)
        return sel, Om

    return select


def select_arrays(mesh, kappa: int, Omega, Deltas, probs, valid, device):
    """This rank's block of the full numpy inputs (Omega [B,D,D], Deltas
    [B,F,D,D], probs / valid [B,F]; B over dp, F over fp) through
    `sharded_select`. Returns numpy (this rank's dp and fp index, its
    selected mask [B/dp, F/fp], its final Ω)."""
    dp, dpfp = P("dp"), P("dp", "fp")
    put = lambda x, s: make_global_array(mesh, s, x, device)
    sel, Om = sharded_select(mesh, kappa)(
        put(Omega, dp), put(Deltas, dpfp), put(probs, dpfp),
        put(valid, dpfp))
    return {"dp": mesh.get_local_rank("dp"), "fp": mesh.get_local_rank("fp"),
            "sel": sel.cpu().numpy(), "Omega": Om.cpu().numpy()}


def select_rank(rank, n_ranks, n_fp: int, kappa: int, arrays: tuple,
                device="cuda"):
    """Worker for `spawn_ranks`: `select_arrays` on a (n_ranks / n_fp,
    n_fp) mesh."""
    mesh = make_mesh(n_ranks // n_fp, n_fp)
    return select_arrays(mesh, kappa, *arrays, torch.device(device))


def gather_selection(results: list, n_fp: int):
    """The global (selected mask [B,F], Ω [B,D,D]) from every rank's
    `select_arrays` result: masks joined over fp in rank order, Ω of each
    dp group's first fp rank."""
    n_dp = len(results) // n_fp
    by = {(r["dp"], r["fp"]): r for r in results}
    row = lambda d: np.concatenate([by[d, f]["sel"] for f in range(n_fp)],
                                   axis=1)
    sel = np.concatenate([row(d) for d in range(n_dp)])
    Om = np.concatenate([by[d, 0]["Omega"] for d in range(n_dp)])
    return sel, Om
