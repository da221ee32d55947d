"""Reader throughput: warm-up and measured cycles, RSS and CPU %, and input
stall against a device step (the JAX package's ``benchmark/throughput.py``).

:func:`reader_throughput` reads rows straight from ``make_reader``
(``read_method="python"``), through a ``tf.data`` Dataset (``"tf"``) or batches staged by the port's
:class:`~petastorm_tpu_torch.loader.DataLoader` onto ``device``
(``"torch"``); with ``device_step_ms`` it overlaps the batches with a
calibrated device step (:func:`make_synthetic_device_step`) and reports the
input stall against the step it measured. RSS comes from
``/proc/self/status`` and CPU % from ``os.times``: the port does not use
psutil. The module imports torch only where a device is used.

:func:`training_input_stall` measures the stall against a real device step,
synchronised every step.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class BenchmarkResult:
    samples_per_second: float
    memory_rss_mb: float
    cpu_percent: float
    input_stall_percent: Optional[float] = None
    #: The measured mean duration of the synthetic device step (it may
    #: differ from the requested ``device_step_ms``): the stall is relative
    #: to this number.
    device_step_ms_actual: Optional[float] = None

    def __str__(self):
        s = (f"{self.samples_per_second:.2f} samples/sec; "
             f"{self.memory_rss_mb:.2f} MB RSS; {self.cpu_percent:.1f}% CPU")
        if self.input_stall_percent is not None:
            s += f"; {self.input_stall_percent:.1f}% input stall"
        if self.device_step_ms_actual is not None:
            s += f" (vs {self.device_step_ms_actual:.1f}ms actual step)"
        return s

    def as_dict(self) -> dict:
        """The JAX CLI's ``--json`` keys."""
        return {"samples_per_second": self.samples_per_second,
                "memory_rss_mb": self.memory_rss_mb, "cpu_percent": self.cpu_percent,
                "input_stall_percent": self.input_stall_percent,
                "device_step_ms_actual": self.device_step_ms_actual}


def process_rss_mb() -> float:
    """This process's resident set (``VmRSS`` of ``/proc/self/status``), MiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("/proc/self/status has no VmRSS line")


class CpuMeter:
    """CPU time of this process (every thread, user and system, from
    ``os.times``) over wall time since the meter was made, in percent, as
    psutil's ``Process.cpu_percent`` gives it after a priming call."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._cpu0 = self._cpu_s()

    @staticmethod
    def _cpu_s() -> float:
        t = os.times()
        return t.user + t.system

    def percent(self) -> float:
        wall = time.perf_counter() - self._t0
        return 100.0 * (self._cpu_s() - self._cpu0) / wall if wall > 0 else 0.0


def reader_throughput(dataset_url: str,
                      field_regex=None,
                      warmup_cycles: int = 200,
                      measure_cycles: int = 1000,
                      pool_type: str = "thread",
                      loaders_count: int = 3,
                      shuffling_queue_size: int = 500,
                      min_after_dequeue: int = 400,
                      read_method: str = "python",
                      device_step_ms: Optional[float] = None,
                      profile_threads: bool = False,
                      reader_extra_kwargs: Optional[dict] = None,
                      device="cuda") -> BenchmarkResult:
    """Samples per second of ``make_reader`` on ``dataset_url`` (every
    epoch, ``shuffle_row_groups=True``).

    ``read_method="python"`` iterates the reader's rows;
    ``read_method="tf"`` iterates them through
    :func:`petastorm_tpu_torch.tf_utils.make_petastorm_dataset` (one
    ``tf.data`` element a row; needs tensorflow); ``read_method="torch"`` takes batches of 16 staged onto ``device`` by
    the port's ``DataLoader`` (with a ``shuffling_queue_size`` row buffer),
    each waited for. The input stall is reported only with
    ``device_step_ms``: each batch then meets a calibrated device step, and
    the stall is the share of the wall spent waiting for batches.
    ``profile_threads`` runs the measurement under ``cProfile`` and prints
    the cumulative stats at the end; on Python 3.12 the profile covers every
    thread of the process (the reader's threads and this one), and it slows
    the loop: quote no rate from a profiled run.
    """
    from petastorm_tpu_torch.reader import make_reader

    if read_method not in ("python", "tf", "torch"):
        raise ValueError(f"Unknown read_method {read_method!r} (expected 'python', 'tf' or "
                         f"'torch')")
    cpu = CpuMeter()
    profiler = None
    if profile_threads:
        import cProfile
        profiler = cProfile.Profile()
        profiler.enable()
    stall = step_ms_actual = None
    try:
        with make_reader(dataset_url, schema_fields=field_regex, reader_pool_type=pool_type,
                         workers_count=loaders_count, num_epochs=None, shuffle_row_groups=True,
                         **(reader_extra_kwargs or {})) as reader:
            if read_method in ("python", "tf"):
                if read_method == "tf":
                    from petastorm_tpu_torch.tf_utils import make_petastorm_dataset
                    it = iter(make_petastorm_dataset(reader))
                else:
                    it = iter(reader)
                for _ in range(warmup_cycles):
                    next(it)
                t0 = time.perf_counter()
                for _ in range(measure_cycles):
                    next(it)
                dt = time.perf_counter() - t0
                samples = measure_cycles
            else:
                from petastorm_tpu_torch.loader import DataLoader
                batch_size = 16
                loader = DataLoader(reader, batch_size=batch_size,
                                    shuffling_queue_capacity=shuffling_queue_size,
                                    min_after_retrieve=min_after_dequeue, device=device)
                it = iter(loader)
                for _ in range(max(1, warmup_cycles // batch_size)):
                    _wait_for(next(it))
                steps = max(1, measure_cycles // batch_size)
                if device_step_ms is not None:
                    device_step = make_synthetic_device_step(device_step_ms, device=device)
                    measured = training_input_stall(loader, lambda b: device_step(),
                                                    steps=steps, it=it)
                    # The measured steps' wall only: the warm-up is left out.
                    dt = measured["wait_s"] + measured["compute_s"]
                    steps = measured["steps"]
                    stall = measured["input_stall_percent"]
                    if steps:
                        step_ms_actual = 1000.0 * measured["compute_s"] / steps
                else:
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        _wait_for(next(it))
                    dt = time.perf_counter() - t0
                samples = steps * batch_size
                it.close()
    finally:
        if profiler is not None:
            import pstats
            profiler.disable()
            pstats.Stats(profiler).sort_stats("cumulative").print_stats(40)
    return BenchmarkResult(samples_per_second=samples / dt, memory_rss_mb=process_rss_mb(),
                           cpu_percent=cpu.percent(), input_stall_percent=stall,
                           device_step_ms_actual=step_ms_actual)


def make_synthetic_device_step(target_ms: float, device="cuda"):
    """A step calibrated to take about ``target_ms``, standing in for a
    model step when measuring how well the input pipeline overlaps the
    device's work. On a CUDA device it is a chain of ``torch.matmul`` on
    ``(size, size)`` float32 matrices (``x @ x / size`` repeated): the
    largest size whose chunk still fits four times into the step, then the
    chunk count scaled once against a timing of the assembled step. On the
    CPU it is ``time.sleep``, as the JAX package's step is there: a
    sleeping consumer frees the host's cores for the reader, as a device
    computing off the host does. The step returns its output (a tensor on
    the card), which the caller waits for."""
    import torch
    target_s = target_ms / 1000.0
    dev = torch.device(device)
    if dev.type == "cpu":
        def sleep_step():
            time.sleep(target_s)
        return sleep_step
    from petastorm_tpu_torch.loader.loader import resolve_device
    dev = resolve_device(dev)

    def chunk_fn(size, iters):
        x = torch.ones((size, size), dtype=torch.float32, device=dev)
        scale = 1.0 / size

        def chunk(y):
            for _ in range(iters):
                y = torch.matmul(y, y) * scale
            return y

        chunk(x)   # warm-up: cuBLAS picks its kernel
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        chunk(x)
        torch.cuda.synchronize(dev)
        return chunk, x, time.perf_counter() - t0

    chosen = None
    for size, iters in ((64, 2), (128, 4), (256, 8), (512, 8), (1024, 16), (2048, 16)):
        chunk, x, per_chunk = chunk_fn(size, iters)
        if chosen is None or per_chunk <= target_s / 4:
            chosen = (chunk, x, per_chunk)
        if per_chunk > target_s / 4:
            break
    chunk, x, per_chunk = chosen
    n = max(1, round(target_s / per_chunk))

    def run(count):
        y = x
        for _ in range(count):
            y = chunk(y)
        return y

    # One timing of the assembled step rescales n: a lone chunk measures short.
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize(dev)
    actual_s = time.perf_counter() - t0
    if actual_s > 0:
        n = max(1, round(n * target_s / actual_s))

    def step():
        return run(n)

    return step


def _wait_for(out) -> None:
    """Wait until the device work behind ``out`` (any tree of tensors) is
    done: ``torch.cuda.synchronize`` of each CUDA device among its tensors.
    CPU tensors are done when they are returned."""
    import torch
    from torch.utils._pytree import tree_leaves
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
