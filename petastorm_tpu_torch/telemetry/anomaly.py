"""Anomaly detection over timeline series.

The SLO watcher (:mod:`petastorm_tpu_torch.telemetry.slo`) gates on *absolute*
thresholds; an anomaly detector gates on *change* — a pipeline that ran at
500k rows/s for two minutes and now runs at 100k is sick even if no fixed
threshold names the number. Detectors run over
:class:`~petastorm_tpu_torch.telemetry.timeseries.MetricsTimeline` windows:

* ``collapse`` — EWMA baseline; fires when the value drops below
  ``threshold`` × baseline (throughput collapse);
* ``spike`` — EWMA mean/variance z-score; fires when the value exceeds
  ``threshold`` standard deviations above the mean (stall spike);
* ``slope`` — fires when the last ``min_windows`` values are monotonically
  non-decreasing with total growth > ``threshold`` (ingest lag creeping up
  on a live dataset — docs/live_data.md);
* ``skew`` — fires when a series *family*'s per-window spread
  ((max−min)/max across members) exceeds ``threshold`` for
  ``min_windows`` consecutive windows (one mesh host falling behind).

Detections are recorded as bounded ``anomaly.{rule}`` registry events and
counted on ``anomaly.detections_total`` / ``anomaly.{rule}_total`` — so
they compose with the SLO machinery for free: the rule
``counter:anomaly.detections_total<=0`` makes ``telemetry check`` (or a
live :class:`~petastorm_tpu_torch.telemetry.slo.SloWatcher`) gate on "no
anomalies", and ``telemetry check --anomaly`` replays the detectors over
an exported snapshot's timeline offline (the CI gate).
"""
from __future__ import annotations

import logging
import math
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["AnomalyRule", "AnomalyMonitor", "default_anomaly_rules",
           "detect_over_timeline"]

_KINDS = ("collapse", "spike", "slope", "skew")


@dataclass(frozen=True)
class AnomalyRule:
    """One detector over one series (or a ``*`` series family for
    ``skew``). ``threshold`` semantics depend on ``kind`` (module doc);
    ``min_windows`` is the warm-up / persistence requirement;
    ``min_value`` suppresses detections when the baseline signal is too
    small to be meaningful (an idle pipeline collapsing from 3 rows/s to
    1 is noise, not an incident)."""
    name: str
    series: str
    kind: str
    threshold: float
    min_windows: int = 5
    min_value: float = 0.0
    #: Consecutive qualifying windows required before a ``collapse`` /
    #: ``spike`` fires. Bursty pipelines legitimately produce single
    #: zero-rate windows (a row-group boundary, a backpressure park) —
    #: one bad window is a gap, ``persist`` of them is an incident.
    persist: int = 2

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"rule {self.name!r}: kind must be one of "
                             f"{_KINDS}, got {self.kind!r}")
        if self.min_windows < 2:
            raise ValueError(f"rule {self.name!r}: min_windows must be >= 2")
        if self.persist < 1:
            raise ValueError(f"rule {self.name!r}: persist must be >= 1")


def default_anomaly_rules() -> List[AnomalyRule]:
    """The documented default detector set (docs/observability.md
    "Anomaly detection")."""
    return [
        # Throughput collapse: the rate fell to <= 5% of its EWMA
        # baseline — a cliff, not variance. Windowed pipeline rates
        # legitimately swing several-fold window to window (bursty
        # row-group deliveries, GIL/host contention); the robust default
        # signal is "essentially stopped while the baseline shows it was
        # moving". Tune threshold up per pipeline for partial-degradation
        # alerting on smoother (longer-window) timelines.
        AnomalyRule("throughput_collapse", "rows_per_s", "collapse",
                    threshold=0.05, min_windows=4, min_value=50.0),
        AnomalyRule("loader_throughput_collapse", "samples_per_s",
                    "collapse", threshold=0.05, min_windows=4,
                    min_value=50.0),
        # Stall spike: delivery-wait fraction jumps > 3 sigma above its
        # rolling mean (and is at least 10% of the window in absolute
        # terms — a 0.1% → 0.5% move is statistically loud but harmless).
        AnomalyRule("stall_spike", "stall_frac", "spike",
                    threshold=3.0, min_windows=6, min_value=0.10,
                    persist=2),
        # Monotonic ingest-lag growth: the live-data freshness contract
        # degrading for 5 straight windows by > 2 s total.
        AnomalyRule("ingest_lag_growth", "ingest_lag_s", "slope",
                    threshold=2.0, min_windows=5),
        # Host skew divergence: one mesh host's rows/s persistently > 50%
        # below the fastest host's.
        AnomalyRule("host_skew_divergence", "mesh.host*.rows_per_s",
                    "skew", threshold=0.5, min_windows=4, min_value=50.0),
    ]


class _Ewma:
    """Exponentially weighted mean + variance (West's incremental form)."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, value: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = value
            self.var = 0.0
            return
        diff = value - self.mean
        incr = self.alpha * diff
        self.mean += incr
        self.var = (1.0 - self.alpha) * (self.var + diff * incr)

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


def _family_values(window_series: dict, pattern: str) -> List[float]:
    prefix, _, suffix = pattern.partition("*")
    out = []
    for name, value in window_series.items():
        if value is None:
            continue
        if (name.startswith(prefix) and name.endswith(suffix)
                and len(name) >= len(prefix) + len(suffix)):
            out.append(float(value))
    return out


class _RuleState:
    """Per-rule detector state; :meth:`observe` returns a detection dict
    on the *entry edge* of a bad state (staying bad does not re-fire —
    the event ring and counters carry the entry; re-arming needs a
    recovery first, so a sustained incident is one detection)."""

    def __init__(self, rule: AnomalyRule):
        self.rule = rule
        self.ewma = _Ewma()
        self.recent: List[float] = []
        self.active = False
        self.streak = 0

    def observe(self, window: dict) -> Optional[dict]:
        rule = self.rule
        series = window.get("series", {})
        if rule.kind == "skew":
            return self._observe_skew(window, series)
        value = series.get(rule.series)
        if value is None:
            return None
        value = float(value)
        if rule.kind == "collapse":
            return self._observe_collapse(window, value)
        if rule.kind == "spike":
            return self._observe_spike(window, value)
        return self._observe_slope(window, value)

    def _fire(self, window: dict, value: float, baseline: float,
              detail: str) -> Optional[dict]:
        if self.active:
            return None
        self.active = True
        return {"rule": self.rule.name, "kind": self.rule.kind,
                "series": self.rule.series, "window": window.get("index"),
                "t_s": window.get("t_s"), "value": round(value, 6),
                "baseline": round(baseline, 6), "detail": detail}

    def _observe_collapse(self, window, value) -> Optional[dict]:
        baseline = self.ewma.mean
        warm = self.ewma.n >= self.rule.min_windows
        if warm and baseline >= self.rule.min_value \
                and value < self.rule.threshold * baseline:
            # Qualifying window. Freeze the baseline while suspected
            # (feeding it the collapsed values would normalize the
            # incident), and require `persist` consecutive qualifiers — a
            # single zero-rate window is a burst gap, not a collapse.
            self.streak += 1
            if self.streak < self.rule.persist:
                return None
            return self._fire(
                window, value, baseline,
                f"value {value:.6g} < {self.rule.threshold:g} x EWMA "
                f"baseline {baseline:.6g} for {self.streak} consecutive "
                f"windows")
        self.streak = 0
        self.active = False
        self.ewma.update(value)
        return None

    def _observe_spike(self, window, value) -> Optional[dict]:
        warm = self.ewma.n >= self.rule.min_windows
        mean, std = self.ewma.mean, self.ewma.std
        # Floor the deviation at 5% of the mean plus 5% of the rule's
        # absolute floor: a perfectly flat (or all-zero) baseline has
        # zero variance, and a genuine jump off it must read as a large
        # finite z, not a divide-by-zero artifact.
        std = max(std, 0.05 * abs(mean), 0.05 * self.rule.min_value, 1e-9)
        z = (value - mean) / std
        if warm and value >= self.rule.min_value \
                and z > self.rule.threshold:
            self.streak += 1
            if self.streak < self.rule.persist:
                return None
            return self._fire(window, value, mean,
                             f"z-score {z:.2f} > {self.rule.threshold:g} "
                             f"(mean {mean:.6g}, std {std:.6g}, "
                             f"{self.streak} consecutive windows)")
        self.streak = 0
        self.active = False
        self.ewma.update(value)
        return None

    def _observe_slope(self, window, value) -> Optional[dict]:
        self.recent.append(value)
        if len(self.recent) > self.rule.min_windows:
            self.recent.pop(0)
        if len(self.recent) == self.rule.min_windows:
            monotonic = all(b >= a for a, b in zip(self.recent,
                                                   self.recent[1:]))
            growth = self.recent[-1] - self.recent[0]
            if monotonic and growth > self.rule.threshold:
                return self._fire(
                    window, value, self.recent[0],
                    f"grew {growth:.6g} over {self.rule.min_windows} "
                    f"consecutive windows")
        self.active = False
        return None

    def _observe_skew(self, window, series) -> Optional[dict]:
        vals = _family_values(series, self.rule.series)
        # A zero-rate member is either FINISHED (per-host plans drain at
        # different times) or LOST (the mesh host-loss machinery's job) —
        # neither is the "slowly falling behind" signal this rule hunts.
        if len(vals) < 2 or max(vals) < self.rule.min_value \
                or min(vals) <= 0:
            self.streak = 0
            self.active = False
            return None
        spread = (max(vals) - min(vals)) / max(vals)
        if spread > self.rule.threshold:
            self.streak += 1
            if self.streak >= self.rule.min_windows:
                return self._fire(
                    window, spread, self.rule.threshold,
                    f"member spread {spread:.2%} > "
                    f"{self.rule.threshold:.0%} for {self.streak} windows "
                    f"(min {min(vals):.6g}, max {max(vals):.6g})")
            return None
        self.streak = 0
        self.active = False
        return None


class AnomalyMonitor:
    """Live detector bank over one pipeline's timeline.

    Register :meth:`observe_window` as a
    :meth:`MetricsTimeline.add_listener` callback; every appended window
    runs every rule, and each detection records an ``anomaly.{rule}``
    event plus ``anomaly.detections_total`` / ``anomaly.{rule}_total``
    counters on the registry (``on_detection`` additionally fires for the
    black-box trigger)."""

    #: Retained detection records (newest kept; the counters carry the
    #: lifetime totals) — a flapping detector on a weeks-long job must
    #: not grow report()/bundle payloads without bound.
    MAX_DETECTIONS = 256

    def __init__(self, registry, rules: Optional[Sequence[AnomalyRule]] = None,
                 on_detection: Optional[Callable[[dict], None]] = None):
        self._registry = registry
        self.rules = list(rules) if rules is not None \
            else default_anomaly_rules()
        self._states = [_RuleState(r) for r in self.rules]
        self._on_detection = on_detection
        self._lock = threading.Lock()
        self._detections: "deque" = deque(maxlen=self.MAX_DETECTIONS)
        self._total = registry.counter("anomaly.detections_total")

    def observe_window(self, window: dict) -> List[dict]:
        fired = []
        with self._lock:
            for state in self._states:
                det = state.observe(window)
                if det is not None:
                    fired.append(det)
                    self._detections.append(det)
        for det in fired:
            self._total.add(1)
            self._registry.counter(f"anomaly.{det['rule']}_total").add(1)
            self._registry.record_event(f"anomaly.{det['rule']}", det)
            logger.warning("Anomaly detected: %(rule)s on %(series)s — "
                           "%(detail)s", det)
            if self._on_detection is not None:
                try:
                    self._on_detection(det)
                except Exception:  # noqa: BLE001 - callback must not kill sampling
                    logger.exception("anomaly on_detection callback failed")
        return fired

    def report(self) -> dict:
        with self._lock:
            return {"rules": [{"name": r.name, "kind": r.kind,
                               "series": r.series,
                               "threshold": r.threshold,
                               "min_windows": r.min_windows}
                              for r in self.rules],
                    "detections_total": int(self._total.value),
                    "detections": list(self._detections),
                    "currently_active": sorted(
                        s.rule.name for s in self._states if s.active)}


def detect_over_timeline(timeline_dict: dict,
                         rules: Optional[Sequence[AnomalyRule]] = None
                         ) -> List[dict]:
    """Replay the detectors over an exported timeline dict (a snapshot's
    ``"timeline"`` payload) — the offline/CI mode behind ``telemetry
    check --anomaly``. Returns every detection in window order."""
    states = [_RuleState(r) for r in (rules if rules is not None
                                      else default_anomaly_rules())]
    out: List[dict] = []
    for window in timeline_dict.get("windows", []):
        for state in states:
            det = state.observe(window)
            if det is not None:
                out.append(det)
    return out
