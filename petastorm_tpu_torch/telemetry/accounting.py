"""Per-tenant resource accounting: the fabric's usage ledger.

A data-service fleet's quotas and fair-share scheduling both start
from one primitive: an attributable, mergeable
answer to "who consumed what". This module derives a fixed-schema totals
record from any pipeline registry (:func:`accounting_totals` — rows,
bytes read/decoded, decode/fetch seconds, cache hits; the same source
counters the explain-plane cost profiles read), and accumulates those
records per ``(pipeline_id, tenant)`` in an :class:`AccountingLedger`
whose per-window deltas are restart-safe (a ``registry.reset()`` between
epochs never produces negative usage) and whose reports merge
(:func:`merge_accounting_reports`) — so N aggregators, or an aggregator
restarted mid-run, still roll up to one exact fleet bill
(docs/observability.md "Telemetry fabric").

Tenant identity is a *label*, not an auth boundary: ``tenant=`` on
``make_reader``/``make_batch_reader`` (or a publisher) stamps every
window the pipeline streams; unlabeled pipelines land under
:data:`DEFAULT_TENANT`.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["ACCOUNTING_SCHEMA_VERSION", "ACCOUNTING_FIELDS",
           "DEFAULT_TENANT", "accounting_totals", "AccountingLedger",
           "merge_accounting_reports"]

ACCOUNTING_SCHEMA_VERSION = 1

#: The fixed accounting schema, in report order. Every field is a
#: non-negative cumulative total; deltas of each are summable across
#: windows, pipelines, and tenants.
ACCOUNTING_FIELDS = ("rows", "bytes_read", "bytes_decoded", "decode_s",
                     "fetch_s", "cache_hits")

#: Tenant key for pipelines that never declared one.
DEFAULT_TENANT = "default"


def accounting_totals(metrics_view: dict) -> Dict[str, float]:
    """Cumulative accounting totals from a ``registry.metrics_view()``
    dict. Source metrics mirror the explain-plane cost profiles: decode
    seconds are ``max(worker.decode_s histogram sum, trace.span.decode_s)``
    — the histogram and the span counter observe the same work, never
    both — plus the mesh-host decode counter."""
    c = metrics_view.get("counters", {})
    h = metrics_view.get("histograms", {})

    def cv(name: str) -> float:
        return float(c.get(name, 0.0) or 0.0)

    decode_s = max(float(h.get("worker.decode_s", {}).get("sum", 0.0)),
                   cv("trace.span.decode_s")) + cv("mesh.host_decode_s")
    return {
        "rows": cv("reader.rows") or cv("loader.samples"),
        "bytes_read": cv("io.bytes_read"),
        "bytes_decoded": cv("loader.bytes_staged")
        or cv("transport.zero_copy_bytes"),
        "decode_s": round(decode_s, 6),
        "fetch_s": round(cv("io.readahead.fetch_s"), 6),
        "cache_hits": cv("cache.mem.hits") + cv("io.readahead.hits"),
    }


def _delta(cur: float, prev: Optional[float]) -> float:
    """Restart-safe windowed delta (same contract as the timeline's
    counter deltas): a total that went backwards means the source registry
    was reset, so the observable new usage is the new total."""
    if prev is None:
        return max(cur, 0.0)
    d = cur - prev
    return d if d >= 0 else max(cur, 0.0)


class AccountingLedger:
    """Mergeable usage ledger keyed ``(pipeline_id, tenant)``.

    Feed it cumulative :func:`accounting_totals` records via
    :meth:`apply`; the ledger differences consecutive records per key
    (restart-safe) and accumulates the deltas, so totals stay exact even
    when the source pipeline resets its registry between epochs or a
    stream skips windows (cumulative records self-resync). Thread-safe.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._last: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._totals: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._windows: Dict[Tuple[str, str], int] = {}
        self._members: Dict[Tuple[str, str], str] = {}

    def apply(self, pipeline_id: str, tenant: Optional[str],
              totals: dict, member: Optional[str] = None) -> Dict[str, float]:
        """Fold one cumulative totals record into the ledger; returns the
        per-field delta this record contributed."""
        key = (str(pipeline_id), str(tenant or DEFAULT_TENANT))
        with self._lock:
            last = self._last.get(key)
            acc = self._totals.setdefault(
                key, {f: 0.0 for f in ACCOUNTING_FIELDS})
            deltas = {}
            for field in ACCOUNTING_FIELDS:
                cur = float(totals.get(field, 0.0) or 0.0)
                d = _delta(cur, None if last is None else last.get(field))
                deltas[field] = d
                acc[field] += d
            self._last[key] = {f: float(totals.get(f, 0.0) or 0.0)
                               for f in ACCOUNTING_FIELDS}
            self._windows[key] = self._windows.get(key, 0) + 1
            if member is not None:
                self._members[key] = member
        return deltas

    def dump(self) -> dict:
        """JSON-safe full ledger state (totals AND per-key delta
        baselines) for the service journal's compacted snapshot; inverse
        of :meth:`restore`. Keeping the baselines is what makes a
        restored ledger bit-exact: the next cumulative record a client
        replays differences against the same ``_last`` it would have on
        the original incarnation."""
        with self._lock:
            return {
                "last": [[list(k), dict(v)] for k, v in self._last.items()],
                "totals": [[list(k), dict(v)]
                           for k, v in self._totals.items()],
                "windows": [[list(k), n] for k, n in self._windows.items()],
                "members": [[list(k), m] for k, m in self._members.items()],
            }

    def restore(self, dumped: dict) -> None:
        with self._lock:
            self._last = {tuple(k): {f: float(v.get(f, 0.0) or 0.0)
                                     for f in ACCOUNTING_FIELDS}
                          for k, v in dumped.get("last") or []}
            self._totals = {tuple(k): {f: float(v.get(f, 0.0) or 0.0)
                                       for f in ACCOUNTING_FIELDS}
                            for k, v in dumped.get("totals") or []}
            self._windows = {tuple(k): int(n)
                             for k, n in dumped.get("windows") or []}
            self._members = {tuple(k): str(m)
                             for k, m in dumped.get("members") or []}

    def forget(self, pipeline_id: str, tenant: Optional[str]) -> None:
        """Drop the per-key delta baseline (a member left); accumulated
        totals are kept — a departed tenant still owes its bill."""
        key = (str(pipeline_id), str(tenant or DEFAULT_TENANT))
        with self._lock:
            self._last.pop(key, None)

    def report(self) -> dict:
        """JSON-safe ledger: per-pipeline rows plus per-tenant rollups."""
        with self._lock:
            totals = {k: dict(v) for k, v in self._totals.items()}
            windows = dict(self._windows)
            members = dict(self._members)
        pipelines = []
        tenants: Dict[str, Dict[str, float]] = {}
        for (pid, tenant) in sorted(totals):
            fields = {f: round(totals[(pid, tenant)][f], 6)
                      for f in ACCOUNTING_FIELDS}
            row = {"pipeline_id": pid, "tenant": tenant,
                   "windows": windows.get((pid, tenant), 0)}
            if (pid, tenant) in members:
                row["member"] = members[(pid, tenant)]
            row.update(fields)
            pipelines.append(row)
            t = tenants.setdefault(tenant,
                                   {f: 0.0 for f in ACCOUNTING_FIELDS})
            for f in ACCOUNTING_FIELDS:
                t[f] = round(t.get(f, 0.0) + fields[f], 6)
            t["pipelines"] = int(t.get("pipelines", 0)) + 1
        return {"schema_version": ACCOUNTING_SCHEMA_VERSION,
                "pipelines": pipelines,
                "tenants": {k: tenants[k] for k in sorted(tenants)}}


def merge_accounting_reports(reports: Iterable[dict]) -> dict:
    """Merge ledger reports from several aggregators (or aggregator
    incarnations) into one: per-``(pipeline_id, tenant)`` rows sum
    field-wise, tenant rollups are recomputed."""
    rows: Dict[Tuple[str, str], dict] = {}
    for rep in reports:
        for row in (rep or {}).get("pipelines", []):
            key = (row.get("pipeline_id", "?"),
                   row.get("tenant", DEFAULT_TENANT))
            acc = rows.setdefault(key, {"pipeline_id": key[0],
                                        "tenant": key[1], "windows": 0,
                                        **{f: 0.0 for f in
                                           ACCOUNTING_FIELDS}})
            acc["windows"] += int(row.get("windows", 0))
            if "member" in row:
                acc["member"] = row["member"]
            for f in ACCOUNTING_FIELDS:
                acc[f] = round(acc[f] + float(row.get(f, 0.0) or 0.0), 6)
    tenants: Dict[str, Dict[str, float]] = {}
    for (_pid, tenant) in sorted(rows):
        t = tenants.setdefault(tenant, {f: 0.0 for f in ACCOUNTING_FIELDS})
        for f in ACCOUNTING_FIELDS:
            t[f] = round(t[f] + rows[(_pid, tenant)][f], 6)
        t["pipelines"] = int(t.get("pipelines", 0)) + 1
    return {"schema_version": ACCOUNTING_SCHEMA_VERSION,
            "pipelines": [rows[k] for k in sorted(rows)],
            "tenants": {k: tenants[k] for k in sorted(tenants)}}
