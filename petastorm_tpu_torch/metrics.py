"""Pipeline metrics and profiler annotations (the JAX package's
``metrics.py`` without its telemetry registry).

Every loader keeps a :class:`PipelineMetrics` (``loader.metrics``) that its
staging thread feeds once per staged batch, and wraps the host batch and
the staging of each batch in :func:`trace` spans named
``petastorm_tpu.host_batch`` and ``petastorm_tpu.stage``, so input-pipeline
time shows up by name in a ``torch.profiler`` trace next to the device's
kernels (and, once CUDA is initialised, as NVTX ranges).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch


class PipelineMetrics:
    """Thread-safe counters of one loader: ``batches``, ``samples`` and
    ``bytes_staged`` (the tensor columns' bytes) of the batches staged, and
    ``host_wait_s`` (building the host batch: reading, collating) and
    ``stage_s`` (sanitizing and the copy onto the device) spent on them.
    After a pass the staged batches are the delivered ones; during a pass
    the counts run up to ``prefetch`` batches ahead of the consumer."""

    _FIELDS = ("batches", "samples", "bytes_staged", "host_wait_s", "stage_s")

    def __init__(self):
        self._lock = threading.Lock()
        self._values = dict.fromkeys(self._FIELDS, 0)

    def record_batch(self, samples: int, nbytes: int, host_wait_s: float,
                     stage_s: float) -> None:
        with self._lock:
            v = self._values
            v["batches"] += 1
            v["samples"] += samples
            v["bytes_staged"] += nbytes
            v["host_wait_s"] += host_wait_s
            v["stage_s"] += stage_s

    def _get(self, name):
        with self._lock:
            return self._values[name]

    batches = property(lambda self: self._get("batches"))
    samples = property(lambda self: self._get("samples"))
    bytes_staged = property(lambda self: self._get("bytes_staged"))
    host_wait_s = property(lambda self: self._get("host_wait_s"))
    stage_s = property(lambda self: self._get("stage_s"))

    @staticmethod
    def _rounded(v: dict) -> dict:
        return {"batches": int(v["batches"]), "samples": int(v["samples"]),
                "bytes_staged": int(v["bytes_staged"]),
                "host_wait_s": round(v["host_wait_s"], 4), "stage_s": round(v["stage_s"], 4)}

    def as_dict(self) -> dict:
        with self._lock:
            return self._rounded(self._values)

    def reset(self) -> dict:
        """Zero the counters and return what they held, in one step (no
        batch recorded between a read and a reset is lost)."""
        with self._lock:
            snapshot = self._rounded(self._values)
            self._values = dict.fromkeys(self._FIELDS, 0)
        return snapshot


@contextmanager
def trace(name: str):
    """A ``torch.profiler.record_function`` range named ``name``, plus an
    NVTX range when CUDA is initialised in this process (never initialising
    it: a CPU-only process or a reader worker stays off the card)."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def traced_span(name: str):
    """The span the JAX package's loaders open around their stages: here a
    :func:`trace` (its ``telemetry=`` recorder waits for the telemetry
    port)."""
    return trace(name)
