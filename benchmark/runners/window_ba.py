"""Runner of the batched window-solve cells: `ops/window.lm_solve` over a
scenario batch, back to back.

Set-up makes the configuration's few distinct window problems from the seed
(`traffic.window_problems`), tiles them to the cell's batch B with a
perturbation of every element's initial state drawn on the card, casts the
batch to the configuration's dtype and solves it once (the warm-up: the
kernels load, cuBLAS and cuSOLVER make their handles). The window then runs
whole solves of the same batch back to back, each ended by a synchronise,
until `--seconds` have passed: `solve_iters_per_s` = B × iterations ×
solves / window seconds.

The check: after the window, the reference (`reference/window.lm_solve`,
float64, in blocks of scenarios) solves the same inputs, the float32 values
the program was given, and every scenario of the window's last solve is
compared with it: per scenario the largest position gap over the window's
frames; per distinct problem the median over its scenarios; compared, the
largest of those medians over the problems (`pos_gap_problem_m`), so that a
problem answered wrongly in half its scenarios or more fails the run. The
largest gap of a single scenario is not compared: a few scenarios, where
float32 and float64 take different accept / reject decisions, read as far
from the reference as the control does (see PERF.md).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import convert, trace
from benchmark.harness import Check, HostWatch, RunResult, note, stage
from benchmark.reference import lie as ref_lie
from benchmark.reference import preintegration as ref_pre
from benchmark.reference import window as ref_window
from benchmark.reference.tree import tree_map
from benchmark.traffic import window_problems

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _batched_empty_prior(window_mod, wcfg, B, dtype, device):
    prior = window_mod.PriorFactor.empty(wcfg, dtype, device)
    return tree_map(lambda x: x[None].expand((B,) + x.shape).contiguous(),
                    prior)


def _containers(window_mod, pre_mod, batch, wcfg, dtype, device):
    """(initial WindowState, WindowMeasurements) of the batch in the
    containers of `window_mod`."""
    B = batch["init"]["p"].shape[0]
    cast = convert.floats_to(dtype, device)
    state = window_mod.WindowState(
        **{k: cast(batch["init"][k]) for k in window_problems.STATE_KEYS})
    m = batch["meas"]
    meas = window_mod.WindowMeasurements(
        pre=pre_mod.Preintegrated(**{k: cast(v) for k, v in m["pre"].items()}),
        pre_valid=cast(m["pre_valid"]), pts=cast(m["pts"]),
        vel=cast(m["vel"]), mask=cast(m["mask"]), anchor=cast(m["anchor"]),
        feat_valid=cast(m["feat_valid"]),
        prior=_batched_empty_prior(window_mod, wcfg, B, dtype, device))
    return state, meas


def _program(cell, wcfg_kw, dtype, device):
    """(solve function, its WindowConfig, the function that makes the state
    and measurements): the port's `lm_solve`, or with `--control tf32` the
    reference in float32 with TF32 matrix products."""
    if cell.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        wcfg = ref_window.WindowConfig(**wcfg_kw)

        def solve(state, meas):
            return ref_window.lm_solve(state, meas, wcfg, device=device)
        return solve, wcfg, lambda b: _containers(
            ref_window, ref_pre, b, wcfg, dtype, device)
    if cell.control is not None:
        raise ValueError(f"unknown control {cell.control!r}")
    from anticipated_vins_mono_torch.ops import preintegration, window
    wcfg = window.WindowConfig(**wcfg_kw)

    def solve(state, meas):
        return window.lm_solve(state, meas, wcfg, device=device)
    return solve, wcfg, lambda b: _containers(
        window, preintegration, b, wcfg, dtype, device)


def _faulty(solve, fault):
    """The solve with a planted fault, for the benchmark's own tests."""
    if fault is None:
        return solve

    def broken(state, meas):
        out, diag = solve(state, meas)
        if fault == "unchanged":
            return state, dict(diag, cost=diag["cost0"])
        if fault == "half_batch":
            h = out.p.shape[0] // 2
            # the second half answered with the first half's answers
            keep = lambda x: torch.cat([x[:h], x[:h]])[:x.shape[0]]
            return tree_map(keep, out), {k: keep(v) for k, v in diag.items()}
        if fault == "altered":
            # every answer of the batch, 1 cm off in x at the newest frame
            p = out.p.clone()
            p[:, -1, 0] += 0.01
            return out._replace(p=p), diag
        raise ValueError(f"unknown fault {fault!r}")
    return broken


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell) -> RunResult:
    cfg, tr = cell.config, cell.traffic
    device = torch.device(cell.device)
    dtype = DTYPES[cfg["dtype"]]
    B, iters = tr["batch"], cfg["lm_iters"]
    wcfg_kw = dict(window=cfg["window"], max_feats=cfg["max_feats"],
                   iters=iters, fused_schur=cfg["fused_schur"])

    # -- set-up: problems from the seed, the batch on the card, one solve
    seeds = window_problems.problem_seeds(cell.seed, cfg["distinct_problems"])
    problems = [window_problems.window_problem(
        cfg["window"], cfg["max_feats"], s, cfg["pixel_noise_px"],
        cfg["perturb"]) for s in seeds]
    stage(cell.t0, "problems made")
    batch = window_problems.scenario_batch(problems, B, cell.seed,
                                           cfg["perturb"], device)
    _sync(device)
    stage(cell.t0, "batch on the device")
    solve, wcfg, build = _program(cell, wcfg_kw, dtype, device)
    solve = _faulty(solve, cell.fault)
    state, meas = build(batch)
    _sync(device)
    stage(cell.t0, "program imported, containers built")
    out, diag = solve(state, meas)
    _sync(device)
    setup_s = time.monotonic() - cell.t0
    note(f"set-up {setup_s:.3f} s: {len(problems)} problems tiled to B = {B}")

    # -- the window
    n_trace = tr["trace_solves"] if cell.trace else 0
    prof = trace.profiler(n_trace) if n_trace else None
    if prof is not None:
        prof.start()
    n = 0
    watch = HostWatch()
    t_start = time.monotonic()
    while True:
        if prof is not None and n <= n_trace:
            with torch.profiler.record_function("bench.solve"):
                out, diag = solve(state, meas)
                _sync(device)
            prof.step()
            if n == n_trace:
                prof.stop()
        else:
            out, diag = solve(state, meas)
            _sync(device)
        n += 1
        watch.unit_done()
        if time.monotonic() - t_start >= cell.seconds:
            break
    window_s = time.monotonic() - t_start
    watch.note("solves")
    note(f"window {window_s:.3f} s: {n} solves of B = {B}")
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    tr_red = trace.Trace.from_profile(prof) if prof is not None else None
    if tr_red is not None:
        note(f"trace: {tr_red.spans} solves, {tr_red.launches} launch calls, "
             f"{len(tr_red.kernels)} kernels, window {tr_red.window_s:.6f} s,"
             f" busy {tr_red.busy_s:.6f} s")

    # -- the check, once the program's state is read
    torch.backends.cuda.matmul.allow_tf32 = False
    prog_p = out.p.detach().to(torch.float64)
    prog_cost = diag["cost"].detach().to(torch.float64)
    del out, diag
    ref_wcfg = ref_window.WindowConfig(**wcfg_kw)
    # the reference gets what the program got: the inputs in `dtype`
    rounded = convert.retype(batch, {}, lambda x: x.to(dtype).to(x.dtype)
                             if x.is_floating_point() else x)
    rstate, rmeas = _containers(ref_window, ref_pre, rounded, ref_wcfg,
                                torch.float64, device)
    block = tr.get("check_block", 128)
    ref_p, ref_cost = [], []
    for s in range(0, B, block):
        sl = lambda x: x[s:s + block]
        o, d = ref_window.lm_solve(tree_map(sl, rstate), tree_map(sl, rmeas),
                                   ref_wcfg, device=device)
        ref_p.append(o.p)
        ref_cost.append(d["cost"])
    ref_p, ref_cost = torch.cat(ref_p), torch.cat(ref_cost)
    pos_gap = torch.linalg.norm(prog_p - ref_p, dim=-1).amax(dim=-1)
    cost_rgap = (prog_cost - ref_cost).abs() / ref_cost.abs()
    finite = torch.isfinite(prog_p).all(dim=(-1, -2)) & torch.isfinite(prog_cost)
    gaps = torch.nan_to_num(pos_gap, 1e9)
    costs = torch.nan_to_num(cost_rgap, 1e9)
    group = window_problems.problem_of(B, len(problems)).to(gaps.device)
    per = [(gaps[group == i], costs[group == i])
           for i in range(len(problems))]
    med = [float(torch.quantile(g, 0.5)) for g, _ in per]
    note("per-problem position gaps, median / largest: " + " ".join(
        f"{m:.3e}/{float(g.max()):.3e}" for m, (g, _) in zip(med, per))
        + "; cost gaps, median / largest: " + " ".join(
        f"{float(torch.quantile(c, 0.5)):.3e}/{float(c.max()):.3e}"
        for _, c in per))
    note(f"reference cost {float(ref_cost.min()):.6g}-"
         f"{float(ref_cost.max()):.6g}")
    readings = {"pos_gap_problem_m": max(med),
                "pos_gap_p75_m": float(torch.quantile(gaps, 0.75)),
                "pos_gap_median_m": float(torch.quantile(gaps, 0.5)),
                "pos_gap_max_m": float(gaps.max()),
                "cost_rgap_median": float(torch.quantile(
                    torch.nan_to_num(cost_rgap, 1e9), 0.5)),
                "cost_rgap_max": float(torch.nan_to_num(cost_rgap, 1e9).max())}
    note(f"readings {readings}")
    checks = [Check(k, v, tr["limits"][k]) for k, v in readings.items()
              if k in tr["limits"]]
    return RunResult(
        attempted=B * n, failed=int((~finite).sum()) * n,
        e2e={"solve_iters_per_s": B * iters * n / window_s,
             "setup_s": setup_s},
        checks=checks, memory_peak_bytes=mem, trace=tr_red,
        counters={"solves": tr_red.spans if tr_red else 0, "batch": B,
                  "iters": iters})
