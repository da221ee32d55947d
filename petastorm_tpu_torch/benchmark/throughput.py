"""Input-stall measurement against a real device step, synchronised every
step (the counterpart of the JAX package's ``benchmark/throughput.py``
``training_input_stall``)."""
from __future__ import annotations

import time

import torch
from torch.utils._pytree import tree_leaves


def _wait_for(out) -> None:
    """Wait until the device work behind ``out`` (any tree of tensors) is
    done: ``torch.cuda.synchronize`` of each CUDA device among its tensors.
    CPU tensors are done when they are returned."""
    devices = {t.device for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def training_input_stall(loader, device_step_fn, steps: int = 50, it=None) -> dict:
    """Measure input stall against a real device step: for each iteration,
    time waiting on ``next(loader)`` against running ``device_step_fn(batch)``
    and waiting for its output. The first batch and its step run before the
    window (loader spin-up). Syncing every step serialises the input
    pipeline against the compute, so this stall is not the pipelined
    ``input_stall_pct`` of :func:`.imagenet_bench.run_imagenet_bench`."""
    it = iter(loader) if it is None else it
    wait, compute, done = 0.0, 0.0, 0
    first = next(it)
    _wait_for(device_step_fn(first))
    for _ in range(steps):
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        _wait_for(device_step_fn(batch))
        t2 = time.perf_counter()
        wait += t1 - t0
        compute += t2 - t1
        done += 1
    total = wait + compute
    return {"input_stall_percent": 100.0 * wait / total if total else 0.0,
            "wait_s": wait, "compute_s": compute, "steps": done}
