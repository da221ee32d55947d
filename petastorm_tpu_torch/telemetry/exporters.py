"""Snapshot exporters: Prometheus text exposition and JSON.

Both render the dict produced by
:meth:`petastorm_tpu_torch.telemetry.TelemetryRegistry.snapshot`:

* :func:`to_prometheus_text` — the ``text/plain; version=0.0.4`` exposition
  format (``# TYPE`` headers, cumulative ``_bucket{le=...}`` histogram
  series). Scrape it from a file with Prometheus' node-exporter textfile
  collector, or serve the string from any HTTP handler.
* :func:`to_json` / :func:`from_json` — a lossless round-trip of the
  snapshot for programmatic consumers.
* :class:`PeriodicExporter` — background thread writing fresh snapshots to a
  file (atomic rename) every ``interval_s``; setting
  ``PETASTORM_TPU_TELEMETRY_EXPORT=/path.json`` on any reader-owning process
  turns this on automatically (see :mod:`petastorm_tpu_torch.reader`).

Names and formats are the JAX package's, byte for byte, so one scraper or
dashboard reads either package's exports.
"""
from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
import weakref
from typing import Optional

__all__ = ["to_prometheus_text", "parse_prometheus_text", "to_json",
           "from_json", "write_snapshot", "PeriodicExporter"]

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)$")


def _prom_name(name: str, prefix: str) -> str:
    return _NAME_SANITIZE.sub("_", f"{prefix}_{name}")


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping per the text-exposition spec:
    backslash, double-quote, AND newline (a raw newline inside a label —
    e.g. a pathological dataset path in a span name — would split the
    sample across lines and corrupt the whole exposition)."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    return repr(round(float(value), 9))


def to_prometheus_text(snapshot: dict,
                       prefix: str = "petastorm_tpu") -> str:
    """Render a registry snapshot in Prometheus text exposition format.
    Dead gauges (value ``None``) are skipped; span aggregates export as
    ``<prefix>_span_seconds_total``/``_count`` with a ``name`` label."""
    lines = []
    for name, value in snapshot.get("counters", {}).items():
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {_fmt(value)}")
    for name, value in snapshot.get("gauges", {}).items():
        if value is None:
            continue
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {_fmt(value)}")
    for name, h in snapshot.get("histograms", {}).items():
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} histogram")
        for bound, cum in h.get("buckets", []):
            le = "+Inf" if bound is None else _fmt(bound)
            lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{pname}_sum {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{pname}_count {h.get('count', 0)}")
    spans = snapshot.get("spans", {})
    if spans:
        total = _prom_name("span_seconds_total", prefix)
        count = _prom_name("span_count", prefix)
        lines.append(f"# TYPE {total} counter")
        lines.append(f"# TYPE {count} counter")
        for name, agg in spans.items():
            label = _escape_label(name)
            lines.append(f'{total}{{name="{label}"}} '
                         f'{_fmt(agg["total_s"])}')
            lines.append(f'{count}{{name="{label}"}} {agg["count"]}')
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser (used by tests and tools to
    verify/inspect exports): returns ``{metric_name: {labels_str_or_"":
    float}}`` and raises ``ValueError`` on any malformed sample line."""
    out: dict = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            raise ValueError(f"malformed Prometheus sample on line "
                             f"{lineno}: {raw!r}")
        value = m.group("value")
        if value == "+Inf":
            fval = float("inf")
        elif value == "-Inf":
            fval = float("-inf")
        else:
            fval = float(value)  # raises ValueError on garbage
        out.setdefault(m.group("name"), {})[m.group("labels") or ""] = fval
    return out


def to_json(snapshot: dict, indent: Optional[int] = None) -> str:
    return json.dumps(snapshot, indent=indent, sort_keys=True)


def from_json(text: str) -> dict:
    return json.loads(text)


def write_snapshot(path: str, snapshot: dict, fmt: str = "json") -> None:
    """Write a snapshot atomically (same-directory temp file + rename), so a
    concurrent reader never sees a half-written file. The temp
    name is pid- AND thread-unique: two exporters in one process (e.g. two
    Readers auto-started by the same export env var) must not truncate each
    other's in-progress write."""
    if fmt == "json":
        payload = to_json(snapshot, indent=2)
    elif fmt == "prometheus":
        payload = to_prometheus_text(snapshot)
    else:
        raise ValueError(f"fmt must be 'json' or 'prometheus', got {fmt!r}")
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


#: Exporters started but not yet stopped. A reader abandoned without
#: ``close()`` would otherwise lose its terminal snapshot — the daemon
#: export thread dies with the interpreter before its next tick. The
#: atexit hook below final-flushes every still-live exporter (weak
#: references: an exporter whose owner was garbage-collected is gone,
#: not resurrected).
_LIVE_EXPORTERS: "weakref.WeakSet" = weakref.WeakSet()
_ATEXIT_REGISTERED = False
_ATEXIT_LOCK = threading.Lock()


def _flush_live_exporters() -> None:
    for exporter in list(_LIVE_EXPORTERS):
        try:
            exporter._write_once(final=True)
        except Exception:  # noqa: BLE001 - interpreter exit: best-effort only
            pass


def _register_atexit_flush() -> None:
    global _ATEXIT_REGISTERED
    with _ATEXIT_LOCK:
        if not _ATEXIT_REGISTERED:
            atexit.register(_flush_live_exporters)
            _ATEXIT_REGISTERED = True


class PeriodicExporter:
    """Daemon thread exporting ``registry.snapshot()`` to ``path`` every
    ``interval_s`` (and once more on ``stop()``, so the final state always
    lands on disk). Abandonment-safe: a started exporter whose owner never
    calls ``stop()`` still writes its terminal snapshot from an atexit
    finalizer at interpreter exit."""

    def __init__(self, registry, path: str, interval_s: float = 2.0,
                 fmt: str = "json"):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._registry = registry
        self._path = path
        self._interval = interval_s
        self._fmt = fmt
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PeriodicExporter":
        if self._thread is not None:
            raise RuntimeError("PeriodicExporter already started")
        _register_atexit_flush()
        _LIVE_EXPORTERS.add(self)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-tpu-telemetry-export")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self._interval):
            self._write_once(final=False)

    def _write_once(self, final: bool = True):
        # Periodic ticks skip the raw trace_events payload: in trace mode
        # that is up to a 65536-span ring re-serialized every interval —
        # CPU stolen from the data plane for a file nobody reads
        # mid-flight. The final flush (reader stop) carries the full
        # payload a trace export reads.
        try:
            snap = (self._registry.snapshot() if final
                    else self._registry.snapshot(include_trace=False))
            write_snapshot(self._path, snap, self._fmt)
        except OSError:
            pass  # a transiently unwritable path must not kill the pipeline

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5.0)
            self._thread = None
        _LIVE_EXPORTERS.discard(self)
        self._write_once()
