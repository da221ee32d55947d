"""Pipeline metrics and profiler annotations (the JAX package's
``metrics.py``).

Every loader keeps a :class:`PipelineMetrics` (``loader.metrics``), a view
over the pipeline's :class:`~petastorm_tpu_torch.telemetry.TelemetryRegistry`
that its staging thread feeds once per staged batch, and wraps the host
batch and the staging of each batch in :func:`traced_span` spans named
``petastorm_tpu.host_batch`` and ``petastorm_tpu.stage``: a
``torch.profiler`` range (and, once CUDA is initialised, an NVTX range)
paired with a telemetry recorder span of the same name, so input-pipeline
time shows up by one name in a profiler trace next to the device's kernels
and in the registry's snapshot and Chrome trace.
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
    the counts run up to ``prefetch`` batches ahead of the consumer.

    Backed by ``telemetry`` (the loader's registry, so one registry covers
    the whole pipeline): :meth:`record_batch` feeds its ``loader.*``
    counters and its ``loader.host_wait_seconds``, ``loader.stage_seconds``
    and ``loader.batch_bytes`` histograms. The registry is
    pipeline-cumulative (a second loader over the same reader continues its
    totals), so this view subtracts a baseline taken at construction: the
    attributes count this instance's batches only, as the JAX package's do.
    """

    _FIELDS = ("batches", "samples", "bytes_staged", "host_wait_s", "stage_s")

    def __init__(self, telemetry=None):
        from petastorm_tpu_torch.telemetry import SIZE_BOUNDS, make_registry
        if telemetry is None:
            telemetry = make_registry()
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._counters = {
            "batches": telemetry.counter("loader.batches"),
            "samples": telemetry.counter("loader.samples"),
            "bytes_staged": telemetry.counter("loader.bytes_staged"),
            "host_wait_s": telemetry.counter("loader.host_wait_s"),
            "stage_s": telemetry.counter("loader.stage_s"),
        }
        self._host_wait_hist = telemetry.histogram("loader.host_wait_seconds")
        self._stage_hist = telemetry.histogram("loader.stage_seconds")
        self._bytes_hist = telemetry.histogram("loader.batch_bytes", bounds=SIZE_BOUNDS)
        self._base = dict.fromkeys(self._FIELDS, 0.0)
        self._base = self._read_raw()

    def _read_raw(self) -> dict:
        raw = {f: self._counters[f].value for f in self._FIELDS}
        # A registry-wide ``telemetry.reset()`` zeroes the shared counters
        # under every view: a value below the baseline can only mean that,
        # so the baseline restarts at zero.
        for f, v in raw.items():
            if v < self._base[f]:
                self._base[f] = 0.0
        return raw

    def _delta(self, name: str):
        v = self._counters[name].value
        if v < self._base[name]:
            self._base[name] = 0.0
        return v - self._base[name]

    batches = property(lambda self: int(self._delta("batches")))
    samples = property(lambda self: int(self._delta("samples")))
    bytes_staged = property(lambda self: int(self._delta("bytes_staged")))
    host_wait_s = property(lambda self: self._delta("host_wait_s"))
    stage_s = property(lambda self: self._delta("stage_s"))

    def record_batch(self, samples: int, nbytes: int, host_wait_s: float,
                     stage_s: float) -> None:
        with self._lock:
            self._counters["batches"].add(1)
            self._counters["samples"].add(samples)
            self._counters["bytes_staged"].add(nbytes)
            self._counters["host_wait_s"].add(host_wait_s)
            self._counters["stage_s"].add(stage_s)
        self._host_wait_hist.observe(host_wait_s)
        self._stage_hist.observe(stage_s)
        self._bytes_hist.observe(nbytes)

    @staticmethod
    def _rounded(raw: dict, base: dict) -> dict:
        return {"batches": int(raw["batches"] - base["batches"]),
                "samples": int(raw["samples"] - base["samples"]),
                "bytes_staged": int(raw["bytes_staged"] - base["bytes_staged"]),
                "host_wait_s": round(raw["host_wait_s"] - base["host_wait_s"], 4),
                "stage_s": round(raw["stage_s"] - base["stage_s"], 4)}

    def as_dict(self) -> dict:
        with self._lock:
            return self._rounded(self._read_raw(), self._base)

    def reset(self) -> dict:
        """Zero this view and return what it held, in one step (no batch
        recorded between a read and a reset is lost). Only the baseline
        moves: the registry's counters and histograms are shared with any
        other loader over the same reader and may be exported, so they
        never go down. ``telemetry.reset()`` drains the whole registry."""
        with self._lock:
            raw = self._read_raw()
            snapshot = self._rounded(raw, self._base)
            self._base = raw
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


def traced_span(name: str, telemetry=None, **span_kw):
    """A :func:`trace` range paired with a telemetry recorder span of the
    same name (the JAX package pairs its ``jax.profiler.TraceAnnotation``
    the same way), so the profiler timeline and the telemetry snapshot give
    time to identical labels. ``span_kw`` (``trace=``, ``stage=``,
    ``track=``) passes through to the recorder span: lineage in trace mode.
    Without ``telemetry`` it is the :func:`trace` range alone."""
    if telemetry is None:
        return trace(name)
    return _TracedSpan(name, telemetry, span_kw)


class _TracedSpan:
    __slots__ = ("_name", "_telemetry", "_span_kw", "_trace_cm", "_span_cm")

    def __init__(self, name: str, telemetry, span_kw=None):
        self._name = name
        self._telemetry = telemetry
        self._span_kw = span_kw or {}

    def __enter__(self):
        self._trace_cm = trace(self._name)
        self._span_cm = self._telemetry.span(self._name, **self._span_kw)
        self._trace_cm.__enter__()
        self._span_cm.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._span_cm.__exit__(*exc)
        finally:
            self._trace_cm.__exit__(*exc)
        return False


__all__ = ["PipelineMetrics", "trace", "traced_span"]
