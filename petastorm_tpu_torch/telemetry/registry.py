"""Named-metric registry: counters, gauges, histograms + a span recorder.

One :class:`TelemetryRegistry` instance covers one pipeline end-to-end — the
Reader creates it, hands it to its worker pool and ventilator, and a loader
consuming that reader adopts the same instance, so a single ``snapshot()``
shows decode, queueing, shuffling, and staging side by side. The snapshot
schema is the JAX package's (``SNAPSHOT_SCHEMA_VERSION`` 1), without its
``events``, ``timeline``, ``explain`` and ``quality`` attachments, which
this package does not produce.

Metric names are dotted (``reader.pool_wait_s``); exporters sanitize them
for their format (Prometheus rewrites ``.`` to ``_``).
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Sequence

from petastorm_tpu_torch.telemetry.histogram import StreamingHistogram
from petastorm_tpu_torch.telemetry.recorder import SpanRecorder

__all__ = ["Counter", "Gauge", "TelemetryRegistry", "SNAPSHOT_SCHEMA_VERSION"]

SNAPSHOT_SCHEMA_VERSION = 1


class Counter:
    """Monotonic (never decremented) thread-safe counter; float-valued so
    it can accumulate seconds as well as item counts."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> float:
        """Zero the counter, returning the pre-reset value (atomic)."""
        with self._lock:
            v, self._value = self._value, 0.0
            return v


class Gauge:
    """Point-in-time value: either ``set()`` explicitly or backed by a
    zero-argument callable sampled at snapshot time."""

    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        with self._lock:
            self._fn = fn

    def clear_function(self, expected: Callable[[], float]) -> None:
        """Drop the backing callable only while it is still ``expected`` —
        so a stale iteration's teardown can't null the closure a newer
        iteration (or a sibling loader sharing the registry) re-registered
        under the same name."""
        with self._lock:
            if self._fn is expected:
                self._fn = None

    @property
    def value(self) -> Optional[float]:
        """Current value; ``None`` when a callable-backed gauge fails (its
        subject was torn down) — exporters skip None rather than lying."""
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 - dead gauge target, not an error
            return None


class TelemetryRegistry:
    """Get-or-create keyed metric store. All accessors are thread-safe and
    idempotent: the first caller fixes a histogram's bucket bounds."""

    def __init__(self, span_capacity: int = 4096,
                 spans_enabled: bool = False):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, StreamingHistogram] = {}
        self.recorder = SpanRecorder(capacity=span_capacity,
                                     enabled=spans_enabled)
        # Every recorded span carrying a stage also accrues the stage's
        # span-time counter (trace.span.{stage}_s) — the span-derived view
        # next to the always-on counters the critical-path attributor reads.
        self._stage_counters: Dict[str, Counter] = {}
        self.recorder.on_stage = self._observe_stage
        #: Stable identity for this registry's pipeline: multi-reader
        #: processes and federated merges need more than file-path stems
        #: to tell registries apart. Unique per construction (pid +
        #: random), constant for the registry's lifetime, stamped into
        #: every snapshot together with the wall-clock creation time.
        self.pipeline_id = f"p{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.created_at = time.time()  # wall-clock-ok: one-shot provenance stamp at construction, not a hot-path read

    def _observe_stage(self, stage: str, duration_s: float) -> None:
        c = self._stage_counters.get(stage)
        if c is None:
            c = self._stage_counters[stage] = self.counter(
                f"trace.span.{stage}_s")
        if duration_s > 0:
            c.add(duration_s)

    # ------------------------------------------------------------ create
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(fn)
            elif fn is not None:
                g.set_function(fn)
            return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> StreamingHistogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = StreamingHistogram(bounds)
            return h

    def span(self, name: str, extra: Optional[dict] = None, **kw):
        """Shortcut for ``registry.recorder.span(...)`` (``trace=`` /
        ``stage=`` / ``track=`` attach lineage provenance in trace mode)."""
        return self.recorder.span(name, extra, **kw)

    # ------------------------------------------------------------- peeking
    def peek_counter(self, name: str) -> float:
        """A counter's value WITHOUT creating it (0.0 when absent) — for
        readers like the critical-path attributor that must not add empty
        series to pipelines that never exercise a stage."""
        with self._lock:
            c = self._counters.get(name)
        return 0.0 if c is None else c.value

    def find_counter(self, name: str):
        """The live :class:`Counter` object WITHOUT creating it (``None``
        when absent) — lets per-batch readers like the critical-path
        attributor cache the object and read ``.value`` lock-free instead
        of paying a registry-lock ``peek`` per name per batch."""
        with self._lock:
            return self._counters.get(name)

    def find_histogram(self, name: str):
        """The live histogram object without creating it (``None`` when
        absent); see :meth:`find_counter`."""
        with self._lock:
            return self._histograms.get(name)

    def snapshot(self, include_trace: bool = True) -> dict:
        """JSON-safe point-in-time view of every registered metric.
        ``include_trace=False`` omits the raw ``trace_events`` payload in
        trace mode — for periodic writers that would otherwise serialize
        the whole span ring every tick (the final flush includes it)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        snap = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "pipeline_id": self.pipeline_id,
            "created_at": self.created_at,
            "counters": {k: round(c.value, 6)
                         for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(histograms.items())},
            "spans": self.recorder.aggregate(),
        }
        if include_trace and self.recorder.trace_enabled:
            # Trace mode: raw lineage spans ride the snapshot so exported
            # files carry what `to_chrome_trace` renders.
            trace_spans = [sp.as_dict() for sp in self.recorder.spans()]
            if trace_spans:
                snap["trace_events"] = trace_spans
        return snap

    def reset(self) -> dict:
        """Zero counters/histograms and drain spans, returning the pre-reset
        snapshot. Atomic per metric: each counter/histogram is read AND
        zeroed under one lock hold (:meth:`Counter.reset`,
        :meth:`StreamingHistogram.drain`), so a concurrent ``add()`` /
        ``observe()`` lands either in the returned snapshot or in the new
        epoch — never lost between a read and a reset. Gauges are live
        views and are left alone."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        drained_spans = self.recorder.drain()
        out = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "pipeline_id": self.pipeline_id,
            "created_at": self.created_at,
            "counters": {k: round(c.reset(), 6)
                         for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.drain()
                           for k, h in sorted(histograms.items())},
            "spans": SpanRecorder.aggregate_spans(drained_spans),
        }
        if self.recorder.trace_enabled and drained_spans:
            out["trace_events"] = [sp.as_dict() for sp in drained_spans]
        return out
