"""Run a function on P ranks: P processes joined in one gloo default
group, on one card or on the CPU.

The JAX package runs one program over a mesh of devices; here each rank of
a sequence group is a process. On a machine with one card all the ranks
share ``cuda:0``: NCCL refuses two ranks on one GPU, so the default group is
gloo, and :mod:`~petastorm_tpu_torch.parallel.comm` stages CUDA tensors
through pinned host memory. The rendezvous is a file in a fresh temporary
directory (no port to collide with another run's).

The ranks fork from multiprocessing's fork server, which imports torch and
the main module once, on the first call, so a rank starts without an
interpreter's imports of its own (about 10 s a rank on the card's host,
against a fresh interpreter's). As for spawned processes, the main module
must be safe to import (no work outside ``if __name__ == "__main__":``);
the ranks see the environment variables the server started with, not
later changes. :func:`start_fork_server` starts the server ahead of the
first call, so that its imports overlap the caller's other work.
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.forkserver
import os
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


_PRELOAD = ["__main__", "torch"]


def start_fork_server() -> None:
    """Start the fork server now, in the background (it imports torch and
    the main module while the caller goes on), instead of on the first
    :func:`run_ranks` call."""
    multiprocessing.set_forkserver_preload(_PRELOAD)
    multiprocessing.forkserver.ensure_running()


def _rank_main(rank: int, fn: Callable, world_size: int, args: Sequence, workdir: str,
               device: str, timeout_s: float) -> None:
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), device: str = "cuda",
              timeout_s: float = 600.0) -> List:
    """``[fn(rank, world_size, *args) for rank in range(world_size)]``, each
    call in its own process forked from the fork server, all joined in one gloo default group
    before ``fn`` runs (``device="cuda"``: each on ``cuda:0``). ``fn`` must
    be importable by module (it is pickled by name) and return something
    ``torch.save`` takes. Raises if a rank raises; the other ranks are then
    stopped. A collective that waits longer than ``timeout_s`` fails."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA device")
    # Taken when the server starts (here on the first call, unless
    # start_fork_server came first): the ranks fork with torch and the main
    # module imported.
    multiprocessing.set_forkserver_preload(_PRELOAD)
    with tempfile.TemporaryDirectory() as workdir:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, tuple(args), workdir, device, timeout_s),
            nprocs=world_size, join=True, start_method="forkserver")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
