"""Run a function on P ranks: P spawned processes joined in one gloo
default group, on one card or on the CPU.

The JAX package runs one program over a mesh of devices; here each rank of
a sequence group is a process. On a machine with one card all the ranks
share ``cuda:0``: NCCL refuses two ranks on one GPU, so the default group is
gloo, and :mod:`~petastorm_tpu_torch.parallel.comm` stages CUDA tensors
through pinned host memory. The rendezvous is a file in a fresh temporary
directory (no port to collide with another run's).
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


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
    call in its own spawned process, all joined in one gloo default group
    before ``fn`` runs (``device="cuda"``: each on ``cuda:0``). ``fn`` must
    be importable by module (spawn pickles it by name) and return something
    ``torch.save`` takes. Raises if a rank raises; the other ranks are then
    stopped. A collective that waits longer than ``timeout_s`` fails."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA device")
    with tempfile.TemporaryDirectory() as workdir:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, tuple(args), workdir, device, timeout_s),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
