"""Trace plane: cross-process batch lineage + Chrome-trace export +
critical-path attribution.

Lineage model
-------------
One ventilated work item (one row group, in the common 1:1 configuration)
is one **trace**: its id is ``e{epoch}:g{ordinal}`` — the ventilator epoch
and the row-group ordinal (the dataset-global ordinal when the plan came
from ``rowgroup_subset``; the plan position otherwise). The id is minted at
ventilation time and propagated:

* in-process — injected into the work item's kwargs
  (``trace_context=``), popped by the pool loops, attached to the decode
  span;
* cross-process — spawned workers time their decode locally and piggyback
  compact span tuples on the item-processed control record
  (:meth:`SpanRecorder.record_remote` re-anchors them to the consumer's
  clock).

Batch-scoped spans (``host_batch``, ``stage``) carry ``b{n}`` trace ids.
A span whose track starts ``h{N}:`` names a host (the JAX package's mesh
rollup writes such tracks; this package's loaders do not).

Chrome-trace export
-------------------
:func:`to_chrome_trace` renders span dicts (from
``registry.snapshot()["trace_events"]``) as Chrome/Perfetto trace JSON:
one *process* per host (the ``h{N}:`` track prefix, else the recording
pid), one *thread* (track) per worker/stage lane, ``X`` duration events
with the trace id in ``args``; the file loads in ``ui.perfetto.dev``.

Critical-path attribution
-------------------------
:class:`CriticalPathAttributor` runs per delivered batch (cheap counter
reads — no spans needed): it reads each stage's cumulative self-time from
the registry, takes the delta since the previous batch, and names the
longest blocking edge (``fetch`` vs ``decode`` vs ``transport`` vs
``shuffle`` vs ``stage`` vs ``assemble``). Winners land on
``trace.critical_path.{stage}`` counters, per-batch self-times on
``trace.self.{stage}_s`` histograms. The stages and their counters are the
JAX package's: ``fetch`` is the readahead stage's, ``assemble`` and the
host plane's share of ``decode`` the mesh loader's.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["TraceContext", "CriticalPathAttributor", "CRITICAL_STAGES",
           "to_chrome_trace", "chrome_trace_events", "write_chrome_trace",
           "lineage_index", "complete_lineages"]


@dataclass(frozen=True)
class TraceContext:
    """One work item's lineage identity: the ventilator epoch and the
    row-group ordinal. ``str(ctx)`` / :attr:`id` is the wire form that
    rides kwargs, ctrl frames, and span records."""
    epoch: int
    ordinal: int

    @property
    def id(self) -> str:
        return f"e{self.epoch}:g{self.ordinal}"

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.id

    @staticmethod
    def parse(trace_id: str) -> Optional["TraceContext"]:
        """Inverse of :attr:`id`; None for non-lineage ids (``b{n}``)."""
        try:
            epoch_part, group_part = trace_id.split(":", 1)
            if not (epoch_part.startswith("e")
                    and group_part.startswith("g")):
                return None
            return TraceContext(int(epoch_part[1:]), int(group_part[1:]))
        except (ValueError, AttributeError):
            return None


# --------------------------------------------------------------- exporter
def _track_identity(span: dict) -> Tuple[str, str]:
    """-> (process key, thread/track key) for one span dict. The ``h{N}:``
    track prefix (mesh rollup) names the process; otherwise the recording
    pid does."""
    track = span.get("track")
    pid = span.get("pid", 0)
    if track:
        head, sep, rest = track.partition(":")
        if sep and len(head) > 1 and head[0] == "h" and head[1:].isdigit():
            return f"host{head[1:]}", rest or "main"
        return f"pid{pid}", track
    stage = span.get("stage")
    if stage:
        return f"pid{pid}", stage
    return f"pid{pid}", span.get("thread", "main")


def chrome_trace_events(span_dicts: Iterable[dict]) -> List[dict]:
    """Span dicts -> Chrome trace event list: ``M`` metadata events naming
    one process per host/pid and one thread per track, then one ``X``
    (complete) event per span — zero-duration spans become ``i`` instant
    events so ventilation markers stay visible."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[dict] = []
    for span in span_dicts:
        pkey, tkey = _track_identity(span)
        if pkey not in pids:
            pids[pkey] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[pkey], "tid": 0,
                           "args": {"name": pkey}})
        pid = pids[pkey]
        if (pkey, tkey) not in tids:
            tids[(pkey, tkey)] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[(pkey, tkey)],
                           "args": {"name": tkey}})
        tid = tids[(pkey, tkey)]
        args = {}
        for key in ("trace", "stage", "span_id", "parent_id"):
            if span.get(key):
                args[key] = span[key]
        if span.get("extra"):
            args.update(span["extra"])
        ts = span.get("start_s", 0.0) * 1e6
        dur = span.get("duration_s", 0.0) * 1e6
        if dur <= 0.0:
            events.append({"ph": "i", "name": span["name"], "ts": ts,
                           "pid": pid, "tid": tid, "s": "t", "args": args})
        else:
            events.append({"ph": "X", "name": span["name"], "ts": ts,
                           "dur": dur, "pid": pid, "tid": tid,
                           "args": args})
    return events


def to_chrome_trace(span_dicts: Iterable[dict],
                    metadata: Optional[dict] = None) -> dict:
    """Full Chrome-trace JSON object (the ``ui.perfetto.dev`` /
    ``chrome://tracing`` format)."""
    out = {"traceEvents": chrome_trace_events(span_dicts),
           "displayTimeUnit": "ms"}
    if metadata:
        out["otherData"] = dict(metadata)
    return out


def write_chrome_trace(path: str, span_dicts: Iterable[dict],
                       metadata: Optional[dict] = None) -> None:
    import json
    with open(path, "w") as f:
        json.dump(to_chrome_trace(span_dicts, metadata), f)


# ---------------------------------------------------------------- lineage
def lineage_index(span_dicts: Iterable[dict]) -> Dict[str, set]:
    """``{trace_id: {stages observed}}`` over row-group lineage ids
    (``e*:g*``; batch-scoped ``b*`` ids are excluded)."""
    out: Dict[str, set] = {}
    for span in span_dicts:
        trace = span.get("trace")
        if not trace or TraceContext.parse(trace) is None:
            continue
        out.setdefault(trace, set()).add(span.get("stage") or span["name"])
    return out


def complete_lineages(span_dicts: Iterable[dict],
                      required: Tuple[str, ...] = ("ventilate", "decode"),
                      ) -> List[str]:
    """Trace ids whose span set covers every ``required`` stage — the
    "complete lineage per row group" acceptance check."""
    need = set(required)
    return sorted(t for t, stages in lineage_index(span_dicts).items()
                  if need <= stages)


# ------------------------------------------------------ critical path
#: The blocking edges the attributor arbitrates between, and where each
#: stage's cumulative self-time lives in the registry (counter name, or a
#: histogram read via its ``sum``).
CRITICAL_STAGES: Tuple[str, ...] = ("fetch", "decode", "transport",
                                    "shuffle", "stage", "assemble")

_STAGE_COUNTERS = {
    "fetch": "io.readahead.fetch_s",
    # decode: histogram worker.decode_s (sum), or the process workers'
    # decode spans (trace.span.decode_s), + mesh.host_decode_s (the mesh
    # loader's host readers).
    "decode": None,
    "transport": "transport.deserialize_s",
    "shuffle": "loader.shuffle_s",
    "stage": "loader.stage_s",
    "assemble": "mesh.assemble_s",
}


class CriticalPathAttributor:
    """Per-delivered-batch critical-path classifier over the registry's
    per-stage self-time counters (always-on: a handful of counter reads
    per batch, no span recording required).

    :param registry: the pipeline :class:`TelemetryRegistry`
    :param history: bounded per-batch record retention (for reports and
        the trace export's attribution summary)
    """

    def __init__(self, registry, history: int = 512):
        self._registry = registry
        self._lock = threading.Lock()
        # Winner counters / self-time histograms are created lazily on
        # first use: an idle stage must not add empty series to every
        # pipeline snapshot.
        self._winners: Dict[str, object] = {}
        self._self_hists: Dict[str, object] = {}
        # Per-source live metric objects, cached once resolved: the
        # attributor runs per DELIVERED batch on the consumer path, and a
        # registry-lock peek per source name per batch is measurable at
        # batch-native rates (counters/histograms are append-only in the
        # registry, so a resolved object stays valid forever).
        self._src_cache: Dict[str, object] = {}
        self._last = self._cumulative()
        self._batches = 0
        self._history: deque = deque(maxlen=max(1, history))
        # The registry's trace.critical_path.* counters are pipeline-
        # cumulative (shared with any earlier loader over the same
        # reader); this instance's report subtracts its construction-time
        # baseline so counts always describe ITS batches — the same
        # baseline contract PipelineMetrics uses.
        self._winner_base = {
            s: registry.peek_counter(f"trace.critical_path.{s}")
            for s in CRITICAL_STAGES}

    def _counter_value(self, name: str) -> float:
        c = self._src_cache.get(name)
        if c is None:
            c = self._registry.find_counter(name)
            if c is None:
                return 0.0
            self._src_cache[name] = c
        return c.value

    def _histogram_sum(self, name: str) -> float:
        h = self._src_cache.get(name)
        if h is None:
            h = self._registry.find_histogram(name)
            if h is None:
                return 0.0
            self._src_cache[name] = h
        return h.sum

    def _cumulative(self) -> Dict[str, float]:
        out = {}
        for stage in CRITICAL_STAGES:
            cname = _STAGE_COUNTERS[stage]
            if cname is None:
                # Decode self-time has two sources that cover the SAME
                # work: the in-process pools' worker.decode_s histogram,
                # and (process pools in trace mode) the spawned workers'
                # piggybacked spans accruing trace.span.decode_s. Take the
                # max — never the sum, which would double-count thread
                # pools with spans on — plus the JAX mesh loader's per-host
                # sync (never fed here, so it reads 0). Max of
                # monotonic counters stays monotonic, so deltas are sound.
                out[stage] = (max(self._histogram_sum("worker.decode_s"),
                                  self._counter_value("trace.span.decode_s"))
                              + self._counter_value("mesh.host_decode_s"))
            else:
                out[stage] = self._counter_value(cname)
        return out

    def observe_batch(self) -> Optional[str]:
        """Record one delivered batch: per-stage self-time deltas since the
        previous delivery, the longest edge named as this batch's critical
        path. Returns the winning stage (None when no stage accrued time —
        a fully warm pipeline between the two reads)."""
        now = self._cumulative()
        with self._lock:
            deltas = {s: max(0.0, now[s] - self._last[s])
                      for s in CRITICAL_STAGES}
            self._last = now
            self._batches += 1
            batch_idx = self._batches
        winner = max(deltas, key=lambda s: deltas[s])
        if deltas[winner] <= 0.0:
            winner = None
        for stage, delta in deltas.items():
            if delta > 0.0:
                hist = self._self_hists.get(stage)
                if hist is None:
                    hist = self._self_hists[stage] = \
                        self._registry.histogram(f"trace.self.{stage}_s")
                hist.observe(delta)
        if winner is not None:
            counter = self._winners.get(winner)
            if counter is None:
                counter = self._winners[winner] = self._registry.counter(
                    f"trace.critical_path.{winner}")
            counter.add(1)
        with self._lock:
            self._history.append({
                "batch": batch_idx, "critical": winner,
                "self_s": {s: round(d, 6) for s, d in deltas.items() if d}})
        return winner

    def report(self) -> dict:
        """Aggregate + recent per-batch attribution: winner counts, the
        dominant edge, and the bounded per-batch history."""
        with self._lock:
            batches = self._batches
            history = list(self._history)
        counts = {s: int(self._registry.peek_counter(
            f"trace.critical_path.{s}") - self._winner_base[s])
            for s in CRITICAL_STAGES}
        attributed = sum(counts.values())
        dominant = (max(counts, key=lambda s: counts[s])
                    if attributed else None)
        return {"batches": batches, "attributed": attributed,
                "counts": counts, "dominant": dominant,
                "recent": history[-32:]}
