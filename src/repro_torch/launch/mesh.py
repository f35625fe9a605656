"""Device meshes of the port: ranks on a torch.distributed group.

The reference is single-controller SPMD: one process holds every device
and ``jax.make_mesh`` names them.  The port's counterpart is one process
per device on a ``torch.distributed`` group, named by a ``DeviceMesh``
(dims ``("dev",)`` for the parent-worker multiply, ``("pr", "pc")`` for
SpSUMMA).  Every rank runs the same host program; the collectives of
:mod:`repro_torch.core.distributed` move the blocks.  An NCCL group ships
CUDA tensors (one rank per GPU); a gloo group ships host tensors, whatever
device a rank computes on.

:func:`launch_ranks` starts the p ranks of a program in processes — the
counterpart of the reference's forced host-device count.  Processes are
spawned, never forked (children touch CUDA), and the group meets through
a file store in a fresh temporary directory, so runs side by side never
share a port.

Mesh factories are functions, and importing this module starts no process
group, no process and no CUDA context.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import rank_and_size

def production_layout(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the reference's production meshes."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks) mesh
    over the initialised world, which must hold exactly that many ranks
    (one per device)."""
    shape, names = production_layout(multi_pod)
    need, world = math.prod(shape), rank_and_size()[1]
    if world != need:
        layout = "x".join(map(str, shape))
        raise ValueError(f"make_production_mesh: the {layout} mesh needs a "
                         f"world of {need} ranks, this one has {world} "
                         f"(start one rank per device, launch_ranks)")
    return _mesh(shape, names)


def _mesh(shape: tuple, names: tuple):
    """A DeviceMesh of ``shape`` over the initialised world (CUDA on NCCL,
    the host on gloo and on the dry run's ``fake`` backend, whose ranks
    hold meta or any other tensors); None for a world of one without a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                            shape, mesh_dim_names=names)


def make_spmm_mesh(n_dev: Optional[int] = None, *, axis: str = "dev"):
    """1-D mesh of the ranks for the distributed block-sparse multiply.

    ``n_dev`` must equal the world size (default: the world).  A world of
    one without an initialised process group is ``None``: the per-rank
    functions then run alone and make no collective call.
    """
    world = rank_and_size()[1]
    n = world if n_dev is None else n_dev
    if n != world:
        raise ValueError(f"make_spmm_mesh: n_dev={n} but the world has "
                         f"{world} ranks (start one rank per device, "
                         f"launch_ranks)")
    return _mesh((n,), (axis,))


def make_summa_mesh(pgrid: Optional[int] = None):
    """2-D process grid for the SpSUMMA baseline.

    ``pgrid=None`` derives the grid from the world size, which must then
    be a perfect square — p=6 used to shard silently onto a 2x2 sub-grid
    with two ranks idle.  An explicit ``pgrid`` is validated against the
    world size for the same reason.  A world of one without an
    initialised process group is ``None`` (a 1 x 1 grid).
    """
    from repro_torch.core.spsumma import summa_pgrid

    n_dev = rank_and_size()[1]
    if pgrid is None:
        pgrid = summa_pgrid(n_dev)
    else:
        summa_pgrid(pgrid * pgrid)  # positive-int sanity
        if pgrid * pgrid > n_dev:
            raise ValueError(
                f"make_summa_mesh: pgrid={pgrid} needs {pgrid * pgrid} "
                f"ranks but the world has only {n_dev}.")
        if pgrid * pgrid < n_dev:
            raise ValueError(
                f"make_summa_mesh: pgrid={pgrid} uses only "
                f"{pgrid * pgrid} of {n_dev} ranks — SpSUMMA "
                f"would silently mis-shard. Pass pgrid=None to derive "
                f"the grid (the world size must be a perfect square), or "
                f"start fewer ranks.")
    return _mesh((pgrid, pgrid), ("pr", "pc"))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch (pod+data when multi-pod)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world_size: int, init_file: str, backend: str,
               timeout_s: float, args: tuple, results) -> None:
    """Body of one rank's process: join the group, run ``fn``, report.

    The ranks meet at a barrier before teardown: a rank whose ``fn`` makes
    no collective call would otherwise destroy its group while a slower
    rank is still connecting to it.  A rank whose ``fn`` raises skips the
    barrier and exits non-zero."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, *args)
        dist.barrier()
        results.put((rank, result))
    finally:
        dist.destroy_process_group()


def launch_ranks(fn: Callable, world_size: int, args: tuple = (), *,
                 backend: str = "gloo", timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes on one process group; returns the results by rank.

    ``fn`` and ``args`` are pickled (``fn`` by import path), and so is each
    result.  On ``"nccl"`` rank r runs on ``cuda:r``; on ``"gloo"`` each
    rank picks its device itself.  A rank that raises or exits non-zero,
    or a run past ``timeout`` seconds, raises here; every process this
    call started is stopped before it returns.
    """
    if world_size < 1:
        raise ValueError(f"launch_ranks needs at least one rank, got "
                         f"{world_size}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_file = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, init_file, backend,
                               timeout, args, results),
                         name=f"rank{r}")
             for r in range(world_size)]
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, res = results.get(timeout=0.2)
                out[rank] = res
                continue
            except queue.Empty:
                pass
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"launch_ranks: rank {bad[0][0]} exited "
                                   f"with code {bad[0][1]}")
            if all(p.exitcode == 0 for p in procs) and results.empty():
                missing = sorted(set(range(world_size)) - set(out))
                raise RuntimeError(f"launch_ranks: ranks {missing} exited "
                                   f"without a result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch_ranks: {world_size} ranks did "
                                   f"not finish within {timeout} s")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"launch_ranks: {p.name} ended with "
                                   f"code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
