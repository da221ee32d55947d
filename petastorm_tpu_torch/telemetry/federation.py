"""Cross-host / cross-process telemetry federation.

One pipeline = one registry; a fleet is many — per-host mesh readers, a
process pool's spawned workers, eventually the data-service dispatcher's
tenants. This module merges their snapshots and
timelines into ONE rollup:

* :func:`federate_snapshots` — counters sum, histograms bucket-merge,
  gauges stay per-member (a queue depth does not sum meaningfully across
  hosts); every member's metrics are also retained under its key prefix
  (``h3:reader.rows``) so nothing is lost in the rollup.
* :func:`federate_timelines` — aligns members' newest windows by position
  and emits fleet-sum series (``fleet:rows_per_s``) plus a divergence
  series (``skew:rows_per_s`` — (max−min)/max across members per window),
  the signal the ``host_skew_divergence`` anomaly detector watches.

Keying is a *parameter*, not a schema: mesh hosts federate under
``h{idx}``, process-pool workers under ``w{id}``, and the data-service
dispatcher will pass per-tenant keys (``tenant7``) through the same API —
the per-tenant fleet rollup is a key-naming convention, not a rewrite
(docs/observability.md "Federation").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

__all__ = ["merge_histogram_dicts", "federate_snapshots",
           "federate_timelines", "FEDERATION_SCHEMA_VERSION"]

FEDERATION_SCHEMA_VERSION = 1

#: Rate-like series federated as fleet sums (a throughput splits across
#: members; a latency quantile does not).
_SUMMABLE_SUFFIXES = ("_per_s", "rows_per_s", "samples_per_s")

#: Series whose cross-member divergence is emitted as ``skew:{name}``.
_SKEW_SERIES = ("rows_per_s", "samples_per_s", "batches_per_s")


def merge_histogram_dicts(a: Optional[dict], b: dict) -> dict:
    """Merge two snapshot-form histogram dicts (cumulative ``buckets``).
    Identical bucket grids merge exactly (bucket-wise sums, quantiles
    re-interpolated); mismatched grids degrade to count/sum-only with
    ``"approximate": True`` — an honest partial merge beats a crash when
    two build generations federate."""
    if a is None:
        return dict(b, buckets=[list(x) for x in b.get("buckets", [])])
    bounds_a = [x[0] for x in a.get("buckets", [])]
    bounds_b = [x[0] for x in b.get("buckets", [])]
    count = a.get("count", 0) + b.get("count", 0)
    total = a.get("sum", 0.0) + b.get("sum", 0.0)
    mn = min(a.get("min", 0.0), b.get("min", 0.0))
    mx = max(a.get("max", 0.0), b.get("max", 0.0))
    if bounds_a != bounds_b:
        return {"count": count, "sum": round(total, 6), "min": mn, "max": mx,
                "approximate": True}
    buckets = [[bound, cum_a + cum_b] for (bound, cum_a), (_b, cum_b)
               in zip(a["buckets"], b["buckets"])]
    merged = {"count": count, "sum": round(total, 6), "min": mn, "max": mx,
              "buckets": buckets}
    merged.update(_quantiles_from_cumulative(buckets, count))
    return merged


def _quantiles_from_cumulative(buckets: List[List[float]],
                               count: int) -> dict:
    from petastorm_tpu_torch.telemetry.timeseries import _quantile_from_buckets
    bounds = [b for b, _cum in buckets]
    counts, prev = [], 0
    for _bound, cum in buckets:
        counts.append(int(cum) - prev)
        prev = int(cum)
    return {"p50": _quantile_from_buckets(bounds, counts, 0.50),
            "p95": _quantile_from_buckets(bounds, counts, 0.95),
            "p99": _quantile_from_buckets(bounds, counts, 0.99)} \
        if count else {"p50": 0.0, "p95": 0.0, "p99": 0.0}


def federate_snapshots(members: Dict[str, dict],
                       key_label: str = "host") -> dict:
    """Merge member snapshots (``{key: registry.snapshot()-dict}``) into
    one fleet view: summed counters + bucket-merged histograms under the
    bare metric names, every member's metrics retained under
    ``{key}:{metric}``, and per-member row totals with a spread summary
    under ``"skew"``."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, Optional[float]] = {}
    histograms: Dict[str, dict] = {}
    events: Dict[str, list] = {}
    member_rows: Dict[str, float] = {}
    for key in sorted(members):
        snap = members[key] or {}
        for name, value in snap.get("counters", {}).items():
            counters[f"{key}:{name}"] = value
            counters[name] = counters.get(name, 0.0) + value
        for name, value in snap.get("gauges", {}).items():
            gauges[f"{key}:{name}"] = value
        for name, h in snap.get("histograms", {}).items():
            histograms[f"{key}:{name}"] = h
            histograms[name] = merge_histogram_dicts(histograms.get(name), h)
        for name, ring in (snap.get("events") or {}).items():
            events.setdefault(f"{key}:{name}", []).extend(ring)
        member_rows[key] = float(
            snap.get("counters", {}).get("reader.rows", 0.0)
            or snap.get("counters", {}).get("loader.samples", 0.0))
    rows = [v for v in member_rows.values()]
    skew = {}
    if rows and max(rows) > 0:
        skew = {"rows_min": min(rows), "rows_max": max(rows),
                "rows_spread_frac": round(
                    (max(rows) - min(rows)) / max(rows), 6)}
    out = {
        "schema_version": FEDERATION_SCHEMA_VERSION,
        "key_label": key_label,
        "members": sorted(members),
        "counters": {k: round(v, 6) for k, v in sorted(counters.items())},
        "gauges": dict(sorted(gauges.items())),
        "histograms": dict(sorted(histograms.items())),
        "skew": skew,
    }
    if events:
        out["events"] = dict(sorted(events.items()))
    return out


def _is_summable(name: str) -> bool:
    return name.endswith(_SUMMABLE_SUFFIXES)


def federate_timelines(members: Dict[str, dict],
                       key_label: str = "host") -> dict:
    """Merge member timeline dicts (``MetricsTimeline.as_dict()`` form)
    into one fleet timeline view, aligned by window position from the
    newest end (members start staggered; their *recent* windows are the
    comparable ones):

    * ``series["{key}:{name}"]`` — every member series, prefixed;
    * ``series["fleet:{name}"]`` — per-window sum of rate-like series
      present in ≥1 member;
    * ``series["skew:{name}"]`` — per-window (max−min)/max across members
      for the throughput series (:data:`_SKEW_SERIES`), the host-skew
      divergence signal.
    """
    live = {k: v for k, v in members.items() if v and v.get("windows")}
    depth = min((len(v["windows"]) for v in live.values()), default=0)
    member_windows = {k: v["windows"][-depth:] for k, v in live.items()}
    series: Dict[str, List[Optional[float]]] = {}
    fleet_names = set()
    for key in sorted(member_windows):
        for w in member_windows[key]:
            fleet_names.update(w["series"])
    for key in sorted(member_windows):
        windows = member_windows[key]
        names = set()
        for w in windows:
            names.update(w["series"])
        for name in sorted(names):
            series[f"{key}:{name}"] = [w["series"].get(name)
                                       for w in windows]
    for name in sorted(fleet_names):
        if not _is_summable(name):
            continue
        sums: List[Optional[float]] = []
        for i in range(depth):
            vals = [member_windows[k][i]["series"].get(name)
                    for k in member_windows]
            vals = [v for v in vals if v is not None]
            sums.append(round(sum(vals), 6) if vals else None)
        series[f"fleet:{name}"] = sums
    for name in _SKEW_SERIES:
        if name not in fleet_names or len(member_windows) < 2:
            continue
        skews: List[Optional[float]] = []
        for i in range(depth):
            vals = [member_windows[k][i]["series"].get(name)
                    for k in member_windows]
            vals = [v for v in vals if v is not None]
            if len(vals) < 2 or max(vals) <= 0:
                skews.append(None)
            else:
                skews.append(round((max(vals) - min(vals)) / max(vals), 6))
        series[f"skew:{name}"] = skews
    return {
        "schema_version": FEDERATION_SCHEMA_VERSION,
        "key_label": key_label,
        "members": sorted(members),
        "interval_s": max((v.get("interval_s", 0.0) for v in live.values()),
                          default=0.0),
        "depth": depth,
        "series": series,
    }
