"""SLO watch: rolling detectors over the pipeline registry, plus the
one-shot ``telemetry check`` evaluation CI and benches gate on.

A small rule language over the snapshot schema
(docs/observability.md "SLO watch"):

* ``gauge`` — the gauge's current value must stay ≤ the threshold
  (e.g. ``loader.input_stall_pct``);
* ``p99`` — a histogram's p99 must stay ≤ the threshold
  (e.g. ``loader.host_wait_seconds`` — per-batch production latency);
* ``counter`` — a counter's cumulative total must stay ≤ the threshold
  (e.g. ``resilience.quarantined_rowgroups`` ≤ 0: any quarantine breaks
  the SLO);
* ``rate`` — a counter's per-second rate over the watcher's sampling
  window must stay ≤ the threshold (e.g. hedge launches/s). Rate rules
  need two samples: the background :class:`SloWatcher` evaluates them per
  tick; the one-shot ``telemetry check`` mode skips them unless given two
  snapshots.

Violations are recorded as bounded ``slo.violation`` registry events (rule
name, metric, value, threshold) and counted on ``slo.violations_total`` —
so a dashboard, the ``telemetry watch`` CLI, and ``Reader.diagnostics``
all surface SLO breaks without new plumbing.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["SloRule", "SloWatcher", "DEFAULT_RULES", "default_rules",
           "evaluate_rules", "parse_rules", "rule_value"]

_KINDS = ("gauge", "p99", "counter", "rate")


@dataclass(frozen=True)
class SloRule:
    """``metric`` (``kind``) must stay <= ``max_value``."""
    name: str
    kind: str
    metric: str
    max_value: float

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"rule {self.name!r}: kind must be one of "
                             f"{_KINDS}, got {self.kind!r}")


def default_rules(input_stall_pct: float = 5.0,
                  batch_p99_s: float = 1.0,
                  quarantined: float = 0.0,
                  reshards: float = 0.0,
                  hedges_per_s: float = 2.0,
                  stragglers_per_s: float = 2.0,
                  ingest_lag_s: float = 300.0,
                  max_drift: float = 0.2,
                  coverage_violations: float = 0.0,
                  index_lookup_p99_s: float = 0.010,
                  torn_journal: float = 0.0) -> List[SloRule]:
    """The documented default rule set (thresholds per the tuning table in
    docs/observability.md). ``ingest_lag_s`` is the live-data freshness
    contract (docs/live_data.md): now minus the newest admitted file's
    mtime — the gauge only exists on readers with
    ``refresh_interval_s=``, so static pipelines skip the rule. NOTE the
    gauge measures end-to-end data staleness, which includes the
    PRODUCER's append cadence — the default threshold is deliberately
    loose (5 min); tune it to your producer (``ingest_lag_s<=30``) and
    read ``dataset_growth_report()``'s ``max_admission_lag_s`` for the
    cadence-independent ingestion-health number."""
    return [
        SloRule("input_stall_pct", "gauge", "loader.input_stall_pct",
                input_stall_pct),
        SloRule("batch_p99_s", "p99", "loader.host_wait_seconds",
                batch_p99_s),
        SloRule("quarantined", "counter",
                "resilience.quarantined_rowgroups", quarantined),
        SloRule("reshards", "counter", "mesh.reshard_events", reshards),
        SloRule("hedge_rate", "rate", "resilience.hedges_launched",
                hedges_per_s),
        SloRule("straggler_rate", "rate", "resilience.stragglers_total",
                stragglers_per_s),
        SloRule("ingest_lag_s", "gauge", "discovery.ingest_lag_s",
                ingest_lag_s),
        # Data-quality contract (docs/observability.md "Data quality
        # plane"): PSI >= 0.2 is the industry-conventional actionable
        # band; the gauge only exists on quality-enabled readers WITH a
        # reference profile, so other pipelines skip the rule.
        SloRule("max_drift", "gauge", "quality.max_drift", max_drift),
        # Data-service exactly-once contract (docs/service.md): a plan
        # position accounted twice across the fleet is a determinism
        # break, never operational noise — threshold is a hard 0. The
        # counter only exists on dispatcher registries, so single-reader
        # pipelines skip the rule.
        SloRule("coverage_violations", "counter",
                "service.coverage_violations_total", coverage_violations),
        # Random-access contract (docs/random_access.md): warm point
        # lookups must stay interactive — p99 of end-to-end lookup()
        # latency <= 10ms. The histogram only exists once a lookup plane
        # has served a call, so epoch-only pipelines skip the rule.
        SloRule("index_lookup_p99_s", "p99", "index.lookup_s",
                index_lookup_p99_s),
        # Journal-integrity contract (docs/service.md "Failure modes &
        # recovery"): a torn line mid-WAL means disk corruption, not a
        # crash artifact (only the FINAL line can legitimately be torn,
        # and that one is counted separately as journal.torn_tail_total).
        # The counter only exists on journaled dispatchers, so other
        # pipelines skip the rule.
        SloRule("torn_journal", "counter", "journal.torn_records_total",
                torn_journal),
    ]


DEFAULT_RULES: List[SloRule] = default_rules()


def parse_rules(spec: str) -> List[SloRule]:
    """Parse a compact rule spec: comma-separated ``name<=value`` entries
    overriding a default rule's threshold by name, or fully explicit
    ``kind:metric<=value`` entries (e.g.
    ``input_stall_pct<=1,counter:resilience.worker_crashes<=0``)."""
    by_name = {r.name: r for r in DEFAULT_RULES}
    # A default rule is addressable by its full metric name too
    # (`quality.max_drift<=0.2` reads better in a CI config than the
    # short rule name); explicit names win on collision.
    by_metric = {r.metric: r for r in DEFAULT_RULES}
    out: List[SloRule] = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        if "<=" not in entry:
            raise ValueError(f"SLO rule {entry!r}: expected name<=value or "
                             f"kind:metric<=value")
        lhs, value = entry.split("<=", 1)
        lhs = lhs.strip()
        threshold = float(value)
        if ":" in lhs:
            kind, metric = lhs.split(":", 1)
            out.append(SloRule(metric, kind.strip(), metric.strip(),
                               threshold))
        elif lhs in by_name or lhs in by_metric:
            base = by_name.get(lhs) or by_metric[lhs]
            out.append(SloRule(base.name, base.kind, base.metric, threshold))
        else:
            raise ValueError(
                f"SLO rule {lhs!r}: not a default rule "
                f"({sorted(by_name)}); use kind:metric<=value for custom "
                f"metrics")
    return out


def rule_value(rule: SloRule, snapshot: dict,
               prev: Optional[dict] = None,
               dt_s: Optional[float] = None) -> Optional[float]:
    """The rule's observed value from snapshot(s); None = not evaluable
    (absent metric, dead gauge, or a rate rule without a window)."""
    if rule.kind == "gauge":
        return snapshot.get("gauges", {}).get(rule.metric)
    if rule.kind == "counter":
        return snapshot.get("counters", {}).get(rule.metric)
    if rule.kind == "p99":
        h = snapshot.get("histograms", {}).get(rule.metric)
        if not h or not h.get("count"):
            return None
        return h.get("p99")
    # rate: needs a previous sample and a window
    if prev is None or not dt_s or dt_s <= 0:
        return None
    cur = snapshot.get("counters", {}).get(rule.metric)
    old = prev.get("counters", {}).get(rule.metric, 0.0)
    if cur is None:
        return None
    return max(0.0, cur - old) / dt_s


def evaluate_rules(snapshot: dict, rules: Sequence[SloRule],
                   prev: Optional[dict] = None,
                   dt_s: Optional[float] = None) -> List[dict]:
    """-> one violation record per broken rule:
    ``{"rule", "kind", "metric", "value", "threshold"}``."""
    violations = []
    for rule in rules:
        value = rule_value(rule, snapshot, prev=prev, dt_s=dt_s)
        if value is not None and value > rule.max_value:
            violations.append({"rule": rule.name, "kind": rule.kind,
                               "metric": rule.metric,
                               "value": round(float(value), 6),
                               "threshold": rule.max_value})
    return violations


class SloWatcher:
    """Background rolling-window SLO detector over one pipeline registry.

    Each tick takes a snapshot, evaluates every rule (rate rules against
    the previous tick's snapshot), records an ``slo.violation`` event +
    ``slo.violations_total`` count per broken rule, and logs the FIRST
    tick of each violation streak (entering a bad state is news; staying
    in it is the event ring's job).
    """

    def __init__(self, registry, rules: Optional[Sequence[SloRule]] = None,
                 interval_s: float = 5.0, on_violation=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._registry = registry
        self.rules = list(rules) if rules is not None else default_rules()
        #: Optional ``fn(violation_dict)`` fired on the FIRST tick of each
        #: violation streak (entry edge, like the log line) — the
        #: postmortem black box's SLO-trip trigger.
        self._on_violation = on_violation
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._prev: Optional[dict] = None
        self._prev_t: Optional[float] = None
        self._violating: set = set()
        self._tally: dict = {}
        self._ticks = 0
        self._counter = registry.counter("slo.violations_total")

    def start(self) -> "SloWatcher":
        if self._thread is not None:
            raise RuntimeError("SloWatcher already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-tpu-slo-watch")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 - watcher must not die mid-run
                logger.exception("SLO watcher tick failed")

    def check_once(self) -> List[dict]:
        """One evaluation tick (also directly callable from tests/benches);
        returns this tick's violations. Uses the registry's metrics-only
        view: a full ``snapshot()`` in trace mode would serialize (and
        retain, as the rate window's previous sample) the entire raw span
        ring every tick — the rules only read counters/gauges/histograms."""
        import time
        now = time.perf_counter()
        snap = self._registry.metrics_view()
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = snap, now
            self._ticks += 1
        dt = None if prev_t is None else now - prev_t
        violations = evaluate_rules(snap, self.rules, prev=prev, dt_s=dt)
        broken = {v["rule"] for v in violations}
        for v in violations:
            self._registry.record_event("slo.violation", v)
            self._counter.add(1)
            with self._lock:
                self._tally[v["rule"]] = self._tally.get(v["rule"], 0) + 1
            if v["rule"] not in self._violating:
                logger.warning("SLO violated: %(rule)s %(metric)s "
                               "%(value)s > %(threshold)s", v)
                if self._on_violation is not None:
                    try:
                        self._on_violation(v)
                    except Exception:  # noqa: BLE001 - callback must not kill ticks
                        logger.exception("SLO on_violation callback failed")
        with self._lock:
            self._violating = broken
        return violations

    def report(self) -> dict:
        with self._lock:
            return {"ticks": self._ticks,
                    "rules": [{"name": r.name, "kind": r.kind,
                               "metric": r.metric,
                               "max_value": r.max_value}
                              for r in self.rules],
                    "violations_total": int(self._counter.value),
                    "violations_by_rule": dict(self._tally),
                    "currently_violating": sorted(self._violating)}

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5.0)
            self._thread = None
