"""Start N local ranks, one process each, and return each rank's result.

    results = launch(fn, nprocs, backend, args)

``backend`` is "nccl" (one card per rank: rank r on ``cuda:r``; more ranks than
cards raises) or "gloo" (CPU ranks, each on one torch thread); there is no
default and no switch on what the machine has. The ranks are started with
``torch.multiprocessing`` spawn; each sets MASTER_ADDR, a free MASTER_PORT,
RANK, WORLD_SIZE and LOCAL_RANK, joins the process group (``timeout`` bounds
its collectives; the rendezvous waits up to ``mesh.TIMEOUT`` for every rank to
start), calls
``fn(*args)`` (``args`` handed over in a file of a temporary directory) and
hands its return value back to the parent (a file there too, read after every
rank has ended). A rank that raises
ends the launch: the others are stopped and the parent raises.

``fn`` must be importable from the port's package (a spawned rank imports the
module that defines it, and only the port's modules).
"""
from __future__ import annotations

import os
import shutil
import socket
import tempfile
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from .mesh import TIMEOUT, rank_device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, backend: str, port: int,
               out_dir: str, timeout: timedelta) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    device = rank_device(backend, rank)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    else:
        torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0, timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout, **kw)
    try:
        result = fn(*torch.load(os.path.join(out_dir, "args.pt"), weights_only=False))
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, backend: str, args: Sequence[Any] = (),
           timeout: timedelta = TIMEOUT) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` ranks over ``backend``; the ranks'
    return values, in rank order. ``timeout`` bounds each collective of the
    default group."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: use 'nccl' or 'gloo'")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nprocs > cards:
            raise RuntimeError(f"{nprocs} NCCL ranks need {nprocs} cards, this machine has "
                               f"{cards}: one rank per card, never two on one")
        from ..ops import _build

        _build.library()  # build once here, not in every rank at the same time
    out_dir = tempfile.mkdtemp(prefix="iret_ranks_")
    try:
        # through a file: spawn's own arguments go down a pipe that each start
        # waits on until its rank has imported its modules, one rank at a time
        torch.save(tuple(args), os.path.join(out_dir, "args.pt"))
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, nprocs, backend, free_port(), out_dir, timeout),
            nprocs=nprocs, join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
