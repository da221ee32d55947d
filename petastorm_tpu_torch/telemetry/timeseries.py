"""Rolling time-series telemetry: the ops plane's memory.

Every other surface in this subsystem is a point-in-time snapshot; a
:class:`MetricsTimeline` is the *history* — a fixed-interval ring of
windowed registry readings that derives **rates** from counter deltas
(rows/s, bytes/s, stall fraction, hedge rate) and **rolling quantiles**
from histogram-bucket deltas, so a dashboard, the anomaly detectors
(:mod:`petastorm_tpu_torch.telemetry.anomaly`) and the ``telemetry top`` /
``timeline`` CLI can see a pipeline *degrade* instead of only its
cumulative totals (docs/observability.md "Ops plane").

A :class:`TimelineSampler` thread attaches one timeline per pipeline
registry (``registry.timeline``) and feeds it from ``metrics_view()`` on a
fixed cadence — monotonic clock only (``time.perf_counter``), per the
repo-wide clock discipline. Counter resets (``registry.reset()`` between
epochs) are handled at the delta layer: a cumulative value that went
*backwards* is treated as a restart and the delta is the new value —
windowed rates never go negative.

Series are declared, not hard-coded: a :class:`SeriesSpec` names a metric
(``*`` matches a family — per-mesh-host counters, per-mixer-member
gauges) and a derivation kind (``rate`` / ``frac`` / ``gauge`` / ``p50``
/ ``p99``). :data:`DEFAULT_SERIES` is the documented default set.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["SeriesSpec", "DEFAULT_SERIES", "MetricsTimeline",
           "TimelineSampler", "TIMELINE_ENV", "timeline_interval_from_env",
           "concat_timeline_dicts", "render_sparkline"]

#: Environment variable: a float number of seconds enables a background
#: :class:`TimelineSampler` (and the default anomaly monitor) on every
#: Reader / MeshDataLoader registry — e.g. ``PETASTORM_TPU_TIMELINE=1``
#: samples one window per second. Unset/empty/0 = off.
TIMELINE_ENV = "PETASTORM_TPU_TIMELINE"

#: Default retained windows (ring bound): 120 windows at the default 1 s
#: interval = two minutes of history, enough for the anomaly detectors'
#: EWMA warm-up and a `top` screen, small enough to ride every snapshot.
DEFAULT_WINDOW_COUNT = 120


def timeline_interval_from_env(environ=None) -> Optional[float]:
    """The sampler interval :data:`TIMELINE_ENV` requests, or None."""
    import os
    value = (environ if environ is not None else os.environ).get(
        TIMELINE_ENV, "").strip()
    if not value:
        return None
    try:
        interval = float(value)
    except ValueError:
        # Known truthy spellings = on at the default interval; anything
        # else (incl. "off"/"false"/"no") must NOT silently enable a
        # background sampler the operator asked to turn off.
        if value.lower() in ("1", "true", "yes", "on", "default"):
            return 1.0
        import logging
        logging.getLogger(__name__).warning(
            "%s=%r is neither a number of seconds nor a recognized "
            "on-switch; timeline stays OFF", TIMELINE_ENV, value)
        return None
    return interval if interval > 0 else None


@dataclass(frozen=True)
class SeriesSpec:
    """One derived series: ``name`` <- ``kind`` applied to ``metric``.

    ``kind``:

    * ``rate`` — counter delta / window seconds;
    * ``frac`` — counter delta / window seconds clamped to [0, 1] (for
      seconds-type counters: the fraction of the window spent there);
    * ``gauge`` — the gauge's sampled value, passed through;
    * ``p50`` / ``p99`` — the quantile of the histogram's *windowed*
      observations (bucket-count deltas, not the cumulative distribution);
    * ``util`` — ONE aggregate series over a seconds-counter *family*:
      sum of member deltas / (window seconds x member count), clamped to
      [0, 1] — the fleet-level utilization of a per-member busy family
      (``pool.w*.busy_s`` -> ``pool.utilization``). Members are the
      family counters present in the sample; a worker that never
      processed an item has no counter yet and is not in the denominator
      until it does.

    A single ``*`` in ``metric`` matches a metric family (``mesh.host*.
    rows``); for per-member kinds the matched wildcard text is
    substituted into ``name``'s ``{}`` placeholder, yielding one series
    per family member (``util`` aggregates instead — no placeholder).
    """
    name: str
    kind: str
    metric: str

    def __post_init__(self):
        if self.kind not in ("rate", "frac", "gauge", "p50", "p99", "util"):
            raise ValueError(f"series {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.metric.count("*") > 1:
            raise ValueError(f"series {self.name!r}: at most one '*' "
                             f"wildcard is supported")
        if self.kind == "util":
            if "*" not in self.metric:
                raise ValueError(f"series {self.name!r}: kind 'util' "
                                 f"aggregates a metric FAMILY and needs a "
                                 f"'*' wildcard in the metric")
        elif "*" in self.metric and "{}" not in self.name:
            raise ValueError(f"series {self.name!r}: family metrics need a "
                             f"'{{}}' placeholder in the series name")


#: The documented default series set (docs/observability.md "Ops plane").
#: Live-data freshness (``ingest_lag_s`` / ``max_admission_lag_s``) and the
#: mixer starvation gauges ride along so a growing-dataset or curriculum
#: pipeline degrades visibly in the same view.
DEFAULT_SERIES: Sequence[SeriesSpec] = (
    SeriesSpec("rows_per_s", "rate", "reader.rows"),
    SeriesSpec("samples_per_s", "rate", "loader.samples"),
    SeriesSpec("batches_per_s", "rate", "loader.batches"),
    SeriesSpec("bytes_read_per_s", "rate", "io.bytes_read"),
    SeriesSpec("bytes_staged_per_s", "rate", "loader.bytes_staged"),
    SeriesSpec("stall_frac", "frac", "loader.delivery_wait_s"),
    SeriesSpec("pool_wait_frac", "frac", "reader.pool_wait_s_total"),
    SeriesSpec("hedges_per_s", "rate", "resilience.hedges_launched"),
    SeriesSpec("stragglers_per_s", "rate", "resilience.stragglers_total"),
    SeriesSpec("input_stall_pct", "gauge", "loader.input_stall_pct"),
    SeriesSpec("ventilator_backlog", "gauge", "ventilator.backlog"),
    SeriesSpec("shuffle_fill", "gauge", "shuffle_buffer.fill"),
    SeriesSpec("ingest_lag_s", "gauge", "discovery.ingest_lag_s"),
    SeriesSpec("max_admission_lag_s", "gauge",
               "discovery.max_admission_lag_s"),
    SeriesSpec("snapshot_age_s", "gauge", "discovery.snapshot_age_s"),
    SeriesSpec("host_skew_s", "gauge", "mesh.host_skew_s"),
    SeriesSpec("decode_p99_s", "p99", "worker.decode_s"),
    SeriesSpec("host_wait_p99_s", "p99", "loader.host_wait_seconds"),
    # Random-access plane (docs/random_access.md): warm-lookup latency
    # tail and point-read throughput of the field-index lookup path.
    SeriesSpec("index.lookup_p99_s", "p99", "index.lookup_s"),
    SeriesSpec("index.lookups_per_s", "rate", "index.lookups_total"),
    SeriesSpec("index.rows_served_per_s", "rate", "index.rows_served_total"),
    # Families: one series per mesh host / process-pool worker / mixer
    # member — the federation plane's per-member views.
    SeriesSpec("mesh.host{}.rows_per_s", "rate", "mesh.host*.rows"),
    SeriesSpec("pool.w{}.items_per_s", "rate", "pool.w*.items"),
    SeriesSpec("pool.w{}.busy_frac", "frac", "pool.w*.busy_s"),
    # Fleet-level pool utilization: sum of per-worker busy fractions /
    # worker count, one number per window (both in-process and spawned
    # pool backends publish the pool.w*.busy_s family).
    SeriesSpec("pool.utilization", "util", "pool.w*.busy_s"),
    SeriesSpec("mixer.m{}.lag_s", "gauge", "mixer.m*.lag_s"),
    SeriesSpec("mixer.m{}.starved_per_s", "rate", "mixer.m*.starved_total"),
    # Data-quality plane (docs/observability.md "Data quality plane"):
    # the lazy drift gauges are COMPUTED by these reads, so the sampler
    # cadence is the drift-detection cadence; one sparkline per drifting
    # column plus the headline maximum.
    SeriesSpec("quality.max_drift", "gauge", "quality.max_drift"),
    SeriesSpec("quality.drift.{}", "gauge", "quality.drift.*"),
    SeriesSpec("quality.admission.max_drift", "gauge",
               "quality.admission.max_drift"),
)


def _match_family(metric_pattern: str, names) -> List[tuple]:
    """``(matched_name, wildcard_text)`` for every name matching the
    single-``*`` pattern."""
    prefix, _, suffix = metric_pattern.partition("*")
    out = []
    for name in names:
        if (name.startswith(prefix) and name.endswith(suffix)
                and len(name) >= len(prefix) + len(suffix)):
            out.append((name, name[len(prefix):len(name) - len(suffix)]))
    return out


def _bucket_counts(hist_dict: dict) -> List[int]:
    """Raw per-bucket counts from a snapshot histogram's cumulative
    ``buckets`` list."""
    counts, prev = [], 0
    for _bound, cum in hist_dict.get("buckets", []):
        counts.append(int(cum) - prev)
        prev = int(cum)
    return counts


def _quantile_from_buckets(bounds: List[Optional[float]],
                           counts: List[int], q: float) -> float:
    """Interpolated quantile over raw bucket counts (windowed delta
    distribution — min/max of the window are unknown, so interpolation is
    bounded by the bucket grid)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    seen = 0
    last_finite = 0.0
    for i, c in enumerate(counts):
        hi = bounds[i]
        if hi is not None:
            last_finite = hi
        if c <= 0:
            seen += c
            continue
        if seen + c >= target:
            lo = 0.0 if i == 0 else (bounds[i - 1] or 0.0)
            if hi is None:
                return last_finite if i > 0 else 0.0
            return lo + (hi - lo) * ((target - seen) / c)
        seen += c
    return last_finite


class MetricsTimeline:
    """Fixed-interval ring of windowed registry readings.

    Feed it with :meth:`sample` (a ``registry.metrics_view()`` dict); each
    call closes one window: per-:class:`SeriesSpec` derived values over
    the delta since the previous sample. The ring keeps the newest
    ``window_count`` windows; :meth:`as_dict` is the JSON-safe form that
    rides ``registry.snapshot()["timeline"]``.

    Thread-safe: one lock guards the baselines and the ring; listeners
    (the anomaly monitor) run *outside* the lock, after the window is
    appended.
    """

    def __init__(self, interval_s: float = 1.0,
                 window_count: int = DEFAULT_WINDOW_COUNT,
                 series: Optional[Sequence[SeriesSpec]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if window_count < 2:
            raise ValueError(f"window_count must be >= 2, got {window_count}")
        self.interval_s = float(interval_s)
        self.series_specs = tuple(series if series is not None
                                  else DEFAULT_SERIES)
        self._lock = threading.Lock()
        self._windows: deque = deque(maxlen=window_count)
        self._windows_total = 0
        self._t0: Optional[float] = None
        self._last_t: Optional[float] = None
        self._prev_counters: Dict[str, float] = {}
        self._prev_hists: Dict[str, List[int]] = {}
        self._util_members: Dict[str, set] = {}
        self._listeners: List[Callable[[dict], None]] = []

    # ------------------------------------------------------------ feeding
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """``fn(window)`` after every appended window (sampler thread;
        exceptions are swallowed — a listener must not kill sampling)."""
        with self._lock:
            self._listeners.append(fn)

    @staticmethod
    def _counter_delta(cur: float, prev: Optional[float]) -> float:
        """Windowed counter delta, restart-safe: a cumulative value that
        went backwards means the counter was reset mid-window (registry
        ``reset()``), so the observable progress is the new value — never
        a negative delta."""
        if prev is None:
            return max(cur, 0.0)
        delta = cur - prev
        return delta if delta >= 0 else max(cur, 0.0)

    def sample(self, metrics_view: dict,
               now_s: Optional[float] = None) -> Optional[dict]:
        """Close one window from a ``metrics_view()`` dict. The first call
        only records baselines (a window needs a delta) and returns None;
        later calls return the appended window."""
        now = time.perf_counter() if now_s is None else now_s
        counters = metrics_view.get("counters", {})
        gauges = metrics_view.get("gauges", {})
        hists = metrics_view.get("histograms", {})
        # Histogram totals double as counters for `frac` series over
        # histogram-fed stages (reader.pool_wait_s has no counter twin).
        counters = dict(counters)
        for hname, h in hists.items():
            counters.setdefault(f"{hname}_total", float(h.get("sum", 0.0)))
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            first = self._last_t is None
            dt = None if first else now - self._last_t
            if dt is not None and dt <= 0:
                return None  # duplicate/stale tick: keep the baselines
            window: Optional[dict] = None
            if not first:
                values: Dict[str, Optional[float]] = {}
                for spec in self.series_specs:
                    self._derive(spec, counters, gauges, hists, dt, values)
                self._windows_total += 1
                window = {
                    "index": self._windows_total - 1,
                    "t_s": round(now - self._t0, 6),
                    "dt_s": round(dt, 6),
                    "series": values,
                }
                self._windows.append(window)
            self._last_t = now
            self._prev_counters = {k: float(v) for k, v in counters.items()}
            self._prev_hists = {k: _bucket_counts(h)
                                for k, h in hists.items()}
            listeners = list(self._listeners)
        if window is not None:
            for fn in listeners:
                try:
                    fn(window)
                except Exception:  # noqa: BLE001 - listener must not kill sampling
                    pass
        return window

    def _derive(self, spec: SeriesSpec, counters, gauges, hists,
                dt: float, out: Dict[str, Optional[float]]) -> None:
        if spec.kind == "util":
            members = _match_family(spec.metric, counters)
            # Sticky membership: remember every family member ever seen.
            # In a federated/fabric view a member's counters can be
            # absent from one sample (its window arrived late) — the
            # denominator must not shrink, and the series must stay
            # defined (a missing member contributes zero delta, not a
            # gap that NaNs the fleet rollup).
            seen = self._util_members.setdefault(spec.metric, set())
            seen.update(m for m, _wild in members)
            if not seen:
                return
            total = sum(
                self._counter_delta(float(counters[m]),
                                    self._prev_counters.get(m))
                for m, _wild in members)
            out[spec.name] = round(
                min(1.0, max(0.0, total / (dt * len(seen)))), 6)
            return
        if "*" in spec.metric:
            source = gauges if spec.kind == "gauge" else counters
            for metric, wild in _match_family(spec.metric, source):
                out[spec.name.format(wild)] = self._one_value(
                    spec.kind, metric, counters, gauges, hists, dt)
        else:
            value = self._one_value(spec.kind, spec.metric, counters,
                                    gauges, hists, dt)
            if value is not None or spec.metric in gauges \
                    or spec.metric in counters or spec.metric in hists:
                out[spec.name] = value

    def _one_value(self, kind: str, metric: str, counters, gauges, hists,
                   dt: float) -> Optional[float]:
        if kind == "gauge":
            value = gauges.get(metric)
            return None if value is None else round(float(value), 6)
        if kind in ("rate", "frac"):
            cur = counters.get(metric)
            if cur is None:
                return None
            delta = self._counter_delta(float(cur),
                                        self._prev_counters.get(metric))
            value = delta / dt
            if kind == "frac":
                value = min(1.0, max(0.0, value))
            return round(value, 6)
        # p50 / p99 over the windowed bucket delta
        h = hists.get(metric)
        if h is None:
            return None
        cur_counts = _bucket_counts(h)
        prev_counts = self._prev_hists.get(metric)
        if prev_counts is None or len(prev_counts) != len(cur_counts):
            delta_counts = cur_counts
        else:
            delta_counts = [c - p for c, p in zip(cur_counts, prev_counts)]
            if any(d < 0 for d in delta_counts):
                delta_counts = cur_counts  # histogram reset mid-window
        bounds = [b for b, _cum in h.get("buckets", [])]
        q = 0.5 if kind == "p50" else 0.99
        return round(_quantile_from_buckets(bounds, delta_counts, q), 9)

    # ------------------------------------------------------------ readout
    def windows(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._windows)
        return out if last is None else out[-last:]

    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._windows[-1] if self._windows else None

    def series(self, name: str,
               last: Optional[int] = None) -> List[Optional[float]]:
        """One named series across retained windows (None where a window
        lacked the metric)."""
        return [w["series"].get(name) for w in self.windows(last)]

    def series_names(self) -> List[str]:
        names = set()
        with self._lock:
            for w in self._windows:
                names.update(w["series"])
        return sorted(names)

    def as_dict(self, last: Optional[int] = None) -> dict:
        """JSON-safe form: this is what rides ``snapshot()["timeline"]``
        and what :func:`petastorm_tpu_torch.telemetry.federation.
        federate_timelines` merges."""
        with self._lock:
            windows = list(self._windows)
            total = self._windows_total
        if last is not None:
            windows = windows[-last:]
        return {
            "interval_s": self.interval_s,
            "window_count": self._windows.maxlen,
            "windows_total": total,
            "windows": [dict(w, series=dict(w["series"])) for w in windows],
        }

    @staticmethod
    def replay_dict(timeline_dict: dict):
        """Yield the windows of an exported timeline dict in order —
        the offline feed for :func:`petastorm_tpu_torch.telemetry.anomaly.
        detect_over_timeline`."""
        for w in timeline_dict.get("windows", []):
            yield w


def render_sparkline(values: Sequence[Optional[float]],
                     width: int = 40) -> str:
    """Unicode block sparkline over a series (None gaps render ``·``) —
    the one renderer behind ``telemetry top``/``timeline`` and the
    postmortem report."""
    blocks = "▁▂▃▄▅▆▇█"
    vals = [v for v in values if v is not None]
    if not vals:
        return ""
    step = max(1, len(values) // width)
    sampled = list(values)[::step][-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        "·" if v is None
        else blocks[int((v - lo) / span * (len(blocks) - 1))]
        for v in sampled)


def concat_timeline_dicts(parts: Sequence[dict]) -> dict:
    """Concatenate exported timeline dicts from SEQUENTIAL runs of the same
    pipeline (a mesh host that ran a recovery source after its primary):
    windows are appended in order and re-indexed."""
    parts = [p for p in parts if p and p.get("windows")]
    if not parts:
        return {"interval_s": 0.0, "window_count": 0, "windows_total": 0,
                "windows": []}
    windows: List[dict] = []
    t_base = 0.0
    for p in parts:
        for w in p["windows"]:
            windows.append(dict(w, index=len(windows),
                                t_s=round(t_base + w["t_s"], 6),
                                series=dict(w["series"])))
        if p["windows"]:
            t_base += p["windows"][-1]["t_s"]
    return {"interval_s": parts[0].get("interval_s", 0.0),
            "window_count": max(p.get("window_count") or 0 for p in parts),
            "windows_total": len(windows), "windows": windows}


class TimelineSampler:
    """Daemon thread feeding one timeline from one registry on a fixed
    cadence, with a final sample on :meth:`stop` so the terminal window
    (the interesting one, in a postmortem) is never lost."""

    def __init__(self, registry, timeline: MetricsTimeline,
                 interval_s: Optional[float] = None):
        self._registry = registry
        self.timeline = timeline
        self._interval = (float(interval_s) if interval_s is not None
                          else timeline.interval_s)
        if self._interval <= 0:
            raise ValueError(f"interval_s must be > 0, got {self._interval}")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = registry.counter("timeline.samples_total")

    def start(self) -> "TimelineSampler":
        if self._thread is not None:
            raise RuntimeError("TimelineSampler already started")
        self.sample_once()  # baseline: the first interval closes a window
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-tpu-timeline")
        self._thread.start()
        return self

    def sample_once(self) -> Optional[dict]:
        window = self.timeline.sample(self._registry.metrics_view())
        if window is not None:
            self._samples.add(1)
        return window

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampler must not die mid-run
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5.0)
            self._thread = None
        try:
            self.sample_once()  # terminal window
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
