"""One process a mesh coordinate: start the ranks, join them by a deadline.

``spawn(fn, world, backend=..., workdir=..., timeout=...)`` starts
``world`` processes by ``torch.multiprocessing``'s spawn method. Rank r
initialises the default process group (the caller's ``backend``, a
``file://`` rendezvous in ``workdir``, rank r of ``world``), runs ``fn(r,
*args)``, destroys the group and leaves what ``fn`` returned in
``workdir`` (``torch.save``), which ``spawn`` returns in rank order. The
parent joins every rank by ``timeout`` seconds, and a collective that
waits longer raises in its rank: a rank that raises, exits non-zero or
outlives the deadline fails the whole spawn, the others are killed and
``spawn`` raises. A rank makes its mesh with ``launch.mesh.
make_process_mesh``. Build the CUDA kernels (``kernels._build.
build_all``) before spawning ranks that launch them, so that each rank
only loads the libraries.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable, List, Sequence

import torch


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               workdir: str, args: Sequence[Any], timeout: float) -> None:
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        # no rank tears its group down while another still joins it
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str, workdir: str,
          args: Sequence[Any] = (), timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined by a
    ``backend`` process group (``"gloo"`` or ``"nccl"``); return each
    rank's result. ``fn`` must be importable by name (a module's top
    level) and its result picklable. ``workdir`` (created if missing)
    holds the rendezvous file and the results; it must hold neither
    before."""
    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    for name in ["rendezvous"] + [f"rank{r}.pt" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            raise ValueError(f"{workdir} already holds {name}")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, workdir, tuple(args), timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past "
                                   f"{timeout} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join()
        raise
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


__all__ = ["spawn"]
