"""Process-group initialization + rank meshes over one or more hosts.

Counterpart of `anticipated_vins_mono_tpu/parallel/distributed.py`. The JAX
version starts `jax.distributed` and builds a global device mesh; here one
process is one rank of a `torch.distributed` process group, and the
(dp, fp) mesh is a `DeviceMesh` over the ranks. Scenario batches shard over
`dp` (no collectives inside a solve), landmark shards over `fp` (the
normal equations are all-reduced within each fp group). fp ranks are
contiguous, as the JAX mesh keeps fp devices within a host.

Each rank holds its own slice of every array (`make_global_array`,
`shard_problem`): every process builds the same full problem from a shared
seed and keeps its dp rows and fp feature slice.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from anticipated_vins_mono_torch.utils.tree import tree_map


class P:
    """Partition of an array's leading axes over mesh axes, the counterpart
    of `jax.sharding.PartitionSpec`: P("dp") splits axis 0 over dp, P("dp",
    "fp") also axis 1 over fp; axes not named are whole on every rank."""

    def __init__(self, *axes: Optional[str]):
        self.axes = axes

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes


def pick_backend(world_size: int) -> str:
    """"nccl" when every rank has a card of its own, else "gloo": NCCL
    refuses two ranks on one device, and one card may carry every rank."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Start the default process group from the arguments or the
    environment: `coordinator` "host:port" or MASTER_ADDR + MASTER_PORT or
    COORDINATOR_ADDRESS; `num_processes` or WORLD_SIZE or NUM_PROCESSES;
    `process_id` or RANK or PROCESS_ID. `backend` defaults to
    `pick_backend`. Returns True when a multi-process group was started,
    False for single-process runs."""
    env = os.environ.get
    if coordinator is None:
        if env("MASTER_ADDR") and env("MASTER_PORT"):
            coordinator = f"{env('MASTER_ADDR')}:{env('MASTER_PORT')}"
        else:
            coordinator = env("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(env("WORLD_SIZE", env("NUM_PROCESSES", "1")))
    if num_processes <= 1 or not coordinator:
        return False
    if process_id is None:
        process_id = int(env("RANK", env("PROCESS_ID", "0")))
    dist.init_process_group(backend or pick_backend(num_processes),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def global_mesh(fp: int = 1, dp: Optional[int] = None):
    """The (dp, fp) `DeviceMesh` over all ranks of the process group, fp
    ranks contiguous (rank = dp_index · fp + fp_index)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    assert n % fp == 0, (n, fp)
    dp = dp or n // fp
    assert dp * fp == n, (dp, fp, n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, fp), mesh_dim_names=("dp", "fp"))


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def make_global_array(mesh, spec: P, x, device=None):
    """This rank's block of `x` under `spec`: the rows of its dp index on
    the axis `spec` maps to dp, its slice of the axis mapped to fp. Every
    rank calls it with the same full array (built from a shared seed); the
    block goes to `device` (where `x` is by default)."""
    x = torch.as_tensor(x)
    for dim, name in enumerate(spec.axes):
        if name is None:
            continue
        n, i = axis_size(mesh, name), mesh.get_local_rank(name)
        size = x.shape[dim]
        assert size % n == 0, (name, size, n)
        x = x.narrow(dim, i * (size // n), size // n)
    return x.contiguous().to(device if device is not None else x.device)


def shard_problem(mesh, state, meas, device=None):
    """This rank's block of a batched (state, meas) window problem under
    the solver's layout (parallel.sharded.solver_specs)."""
    from anticipated_vins_mono_torch.parallel.sharded import solver_specs
    ss, ms = solver_specs()
    put = lambda x, s: make_global_array(mesh, s, x, device)
    return tree_map(put, state, ss), tree_map(put, meas, ms)


def scaling_report(solver, state, meas, reps: int = 5) -> dict:
    """Aggregate window-solves/s of `solver` (from `sharded_lm_solve`) on
    its mesh: every rank solves its block `reps` times, synchronising its
    device before each clock reading; the slowest rank's time counts."""
    dev = state.p.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    solver(state, meas)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        solver(state, meas)
    sync()
    dt = torch.tensor((time.perf_counter() - t0) / reps, dtype=torch.float64,
                      device=dev)
    n_dp = axis_size(solver.mesh, "dp")
    if dist.is_initialized():
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)
    B = state.p.shape[0] * n_dp
    world = dist.get_world_size() if dist.is_initialized() else 1
    # devices in use: the cards the ranks share, or one CPU process a rank
    devices = min(world, torch.cuda.device_count()) if dev.type == "cuda" \
        else world
    return {"batch": B, "seconds_per_step": float(dt),
            "solves_per_s": B / float(dt), "devices": devices,
            "hosts": world}


# ----------------------------------------------------------------------------
# Ranks as processes on one host
# ----------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that no one listens on right now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n_ranks, port, backend, threads, queue, args):
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_ranks, rank=rank)
    try:
        queue.put((rank, fn(rank, n_ranks, *args)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, *args, backend: Optional[str] = None,
                threads: Optional[int] = None) -> list:
    """Run `fn(rank, n_ranks, *args)` in `n_ranks` new processes that form
    one process group on localhost (a free port, `backend` by default
    `pick_backend`), and return their results in rank order. `fn` must be
    a module-level function and its results picklable (numpy, not CUDA
    tensors). A rank that raises makes this raise, after every process has
    been stopped. `threads`: torch threads per rank (default: the calling
    process's torch threads shared out)."""
    import torch.multiprocessing as mp
    backend = backend or pick_backend(n_ranks)
    threads = threads or max(1, torch.get_num_threads() // n_ranks)
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.spawn(_rank_main, nprocs=n_ranks, join=False,
                   args=(fn, n_ranks, free_port(), backend, threads, queue,
                         args))
    results = {}

    def drain():
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out

    while not ctx.join(timeout=0.2):
        drain()
    drain()
    return [results[r] for r in range(n_ranks)]


def run_each(rank, n_ranks, calls: list) -> list:
    """Worker for `spawn_ranks` that runs several workers in turn in the
    same process group: `calls` is a list of (fn, args), each called as
    `fn(rank, n_ranks, *args)`. Returns their results in order."""
    return [fn(rank, n_ranks, *args) for fn, args in calls]
