"""Low-overhead span/event recorder.

A :class:`SpanRecorder` collects named, monotonic-clock spans with thread and
process provenance into a bounded ring buffer (old spans are evicted, the
pipeline never grows without bound). The disabled hot path is a single
attribute check returning a shared no-op context manager — cheap enough to
leave ``recorder.span(...)`` permanently inlined on per-batch paths.

Trace mode layers batch lineage on
top: spans may carry a ``trace`` id (``e{epoch}:g{ordinal}`` — the work
item's epoch/row-group-ordinal lineage), a ``stage`` name (``ventilate``,
``fetch``, ``decode``, ``transport``, ``shuffle``, ``stage``, ``pull``,
``assemble``), and a ``track`` (the display lane — ``worker:2``,
``fetch:0``, ``h3:pull``). :meth:`enable_trace` turns retention up so a
whole epoch's raw spans survive for Chrome-trace export
(:mod:`petastorm_tpu_torch.telemetry.trace`); spans recorded in other processes
cross the boundary as compact tuples via :meth:`record_remote`.

Clock discipline: spans use ``time.perf_counter()`` exclusively.
``time.time()`` is wall-clock and can step backwards under NTP slew.

The module imports no torch: spawned reader workers import it.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = ["Span", "SpanRecorder", "TRACE_SPAN_CAPACITY"]

#: Ring capacity :meth:`SpanRecorder.enable_trace` grows to: large enough
#: that an epoch of hundreds of row groups x ~6 stages retains every
#: lineage span, small enough to stay a bounded buffer.
TRACE_SPAN_CAPACITY = 65536

#: Process-wide span-id allocator (``itertools.count.__next__`` is atomic
#: on CPython); 0 means "no id assigned".
_SPAN_IDS = itertools.count(1)

#: Cached pid for span provenance: ``os.getpid()`` is a real syscall and
#: under seccomp-filtered sandboxes costs tens of microseconds — per-record
#: that dwarfed the whole recording path. The pid only changes across
#: fork(), so refresh it in fork children; spawned workers (this repo's
#: process pools) re-import the module and cache their own.
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_refresh_pid)


@dataclass(frozen=True)
class Span:
    """One completed span. ``start_s`` is a ``perf_counter`` timestamp —
    meaningful only relative to other spans from the same process (remote
    spans are re-anchored to the consumer's clock on ingest)."""
    name: str
    start_s: float
    duration_s: float
    thread: str
    thread_id: int
    pid: int
    extra: Optional[dict] = field(default=None)
    #: Lineage id (``e{epoch}:g{ordinal}`` for row-group work items,
    #: ``b{n}`` for assembled batches); None outside trace mode.
    trace: Optional[str] = field(default=None)
    #: Pipeline stage this span's time belongs to (critical-path edge).
    stage: Optional[str] = field(default=None)
    #: Display lane for trace export (one track per host/worker/stage).
    track: Optional[str] = field(default=None)
    span_id: int = 0
    parent_id: int = 0

    def as_dict(self) -> dict:
        d = {"name": self.name, "start_s": round(self.start_s, 6),
             "duration_s": round(self.duration_s, 6), "thread": self.thread,
             "thread_id": self.thread_id, "pid": self.pid}
        if self.extra:
            d["extra"] = dict(self.extra)
        if self.trace is not None:
            d["trace"] = self.trace
        if self.stage is not None:
            d["stage"] = self.stage
        if self.track is not None:
            d["track"] = self.track
        if self.span_id:
            d["span_id"] = self.span_id
        if self.parent_id:
            d["parent_id"] = self.parent_id
        return d


class _NoopSpan:
    """Shared disabled-path context manager: no allocation per call."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    __slots__ = ("_recorder", "_name", "_extra", "_t0", "_trace", "_stage",
                 "_track", "_parent_id", "span_id")

    def __init__(self, recorder, name, extra, trace=None, stage=None,
                 track=None, parent_id=0):
        self._recorder = recorder
        self._name = name
        self._extra = extra
        self._trace = trace
        self._stage = stage
        self._track = track
        self._parent_id = parent_id
        self.span_id = 0

    def __enter__(self):
        if self._trace is not None or self._stage is not None:
            self.span_id = next(_SPAN_IDS)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._recorder.record(self._name, self._t0, t1 - self._t0,
                              extra=self._extra, trace=self._trace,
                              stage=self._stage, track=self._track,
                              span_id=self.span_id,
                              parent_id=self._parent_id)
        return False


class SpanRecorder:
    """Ring-buffer bounded span sink.

    :param capacity: max retained spans (oldest evicted first)
    :param enabled: record spans when True; when False ``span()`` returns a
        shared no-op context manager (sub-microsecond)
    """

    def __init__(self, capacity: int = 4096, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dropped = 0
        self.enabled = bool(enabled)
        #: Trace mode: raw spans (with lineage fields) are retained for
        #: Chrome-trace export and included in registry snapshots.
        self.trace_enabled = False
        self.capacity = capacity
        #: Optional callback ``(stage, duration_s)`` invoked for every
        #: recorded span carrying a stage — the registry wires it to the
        #: ``trace.span.{stage}_s`` self-time counters.
        self.on_stage = None

    def enable(self) -> None:
        self.enabled = True

    def enable_trace(self, capacity: Optional[int] = None) -> None:
        """Turn on trace retention: spans on, lineage fields recorded, and
        the ring grown to ``capacity`` (default
        :data:`TRACE_SPAN_CAPACITY`) so a whole epoch's spans survive for
        export. Growing preserves already-recorded spans."""
        cap = int(capacity) if capacity else TRACE_SPAN_CAPACITY
        with self._lock:
            if cap > (self._spans.maxlen or 0):
                self._spans = deque(self._spans, maxlen=cap)
                self.capacity = cap
        self.enabled = True
        self.trace_enabled = True

    def span(self, name: str, extra: Optional[dict] = None, *,
             trace: Optional[str] = None, stage: Optional[str] = None,
             track: Optional[str] = None, parent_id: int = 0):
        """Context manager timing one span; no-op while disabled. ``trace``
        / ``stage`` / ``track`` attach lineage provenance (trace mode)."""
        if not self.enabled:
            return _NOOP_SPAN
        return _LiveSpan(self, name, extra, trace, stage, track, parent_id)

    def record(self, name: str, start_s: float, duration_s: float,
               extra: Optional[dict] = None, trace: Optional[str] = None,
               stage: Optional[str] = None, track: Optional[str] = None,
               span_id: int = 0, parent_id: int = 0) -> None:
        if not self.enabled:
            return
        t = threading.current_thread()
        sp = Span(name, start_s, duration_s, t.name, t.ident or 0,
                  _PID, extra, trace, stage, track, span_id,
                  parent_id)
        self._append((sp,))
        if stage is not None and self.on_stage is not None:
            self.on_stage(stage, duration_s)

    def record_event(self, name: str, extra: Optional[dict] = None, *,
                     trace: Optional[str] = None,
                     stage: Optional[str] = None,
                     track: Optional[str] = None) -> None:
        """Zero-duration marker (e.g. 'epoch_end', 'worker_failure')."""
        self.record(name, time.perf_counter(), 0.0, extra=extra,
                    trace=trace, stage=stage, track=track)

    def record_remote(self, compact_spans: Sequence, pid: int = 0,
                      anchor_s: Optional[float] = None) -> None:
        """Ingest spans recorded in ANOTHER process, shipped as compact
        ``(name, stage, duration_s, trace, track)`` tuples (piggybacked on
        the process pool's item-processed control record).
        Remote ``perf_counter`` clocks are not comparable to ours, so each
        span is re-anchored: it *ends* at ``anchor_s`` (default: now, i.e.
        the moment its processed marker arrived)."""
        if not self.enabled or not compact_spans:
            return
        end = time.perf_counter() if anchor_s is None else anchor_s
        spans = [Span(name, end - duration_s, duration_s, "remote", 0,
                      pid, None, trace, stage, track, 0, 0)
                 for name, stage, duration_s, trace, track in compact_spans]
        self._append(spans)
        if self.on_stage is not None:
            for sp in spans:
                if sp.stage is not None:
                    self.on_stage(sp.stage, sp.duration_s)

    def _append(self, spans) -> None:
        """The single ring-append path (one lock hold for the whole
        sequence): capacity eviction and the dropped count live here and
        nowhere else."""
        with self._lock:
            for sp in spans:
                if len(self._spans) == self._spans.maxlen:
                    self._dropped += 1
                self._spans.append(sp)

    # ------------------------------------------------------------ readout
    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def drain(self) -> list:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def aggregate(self) -> dict:
        """Per-name aggregate of currently retained spans:
        ``{name: {"count", "total_s", "max_s"}}``."""
        return self.aggregate_spans(self.spans())

    @staticmethod
    def aggregate_spans(spans) -> dict:
        """:meth:`aggregate` over an explicit span list — lets a caller
        aggregate exactly what :meth:`drain` returned, with no window for
        concurrent records to slip between the two."""
        out: dict = {}
        for sp in spans:
            agg = out.setdefault(sp.name, {"count": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += sp.duration_s
            agg["max_s"] = max(agg["max_s"], sp.duration_s)
        for agg in out.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["max_s"] = round(agg["max_s"], 6)
        return out
