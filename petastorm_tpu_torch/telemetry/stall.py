"""Stall attribution: is each training step host-bound or device-bound?

The loader's consumer loop reports, for every delivered batch, how long the
consumer *waited* for the staged batch (``wait_s`` — the input pipeline was
the bottleneck for that interval) versus how long it spent *away* from the
loader (``busy_s`` — the device step / user code). Each ``__next__`` is
classified:

* **device-bound** — wait is a negligible fraction of the step: the input
  pipeline kept up; making it faster buys nothing.
* **host-bound** — the consumer mostly waited on the host pipeline; the
  existing ``host_wait_s``/``stage_s`` split from
  :class:`petastorm_tpu_torch.metrics.PipelineMetrics` then sub-attributes the
  host side to batch production (reader pull + collate) vs. staging
  (sanitize + the host-to-device copy).
* **balanced** — in between; host and device finish near-simultaneously
  (the double-buffered ideal runs slightly device-bound).
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["StallAttributor"]

_CLASSES = ("host_bound", "device_bound", "balanced")


class StallAttributor:
    """:param registry: optional :class:`TelemetryRegistry`; per-class
        counts and wait/busy totals are mirrored into it under
        ``loader.next_*`` names.
    :param device_bound_below: wait fraction below which a step counts as
        device-bound (default 5% — under typical jitter, "no stall")
    :param host_bound_above: wait fraction above which a step counts as
        host-bound (default 25% — a quarter of the step burned waiting)
    """

    def __init__(self, registry=None, device_bound_below: float = 0.05,
                 host_bound_above: float = 0.25):
        if not 0.0 <= device_bound_below < host_bound_above <= 1.0:
            raise ValueError(
                f"need 0 <= device_bound_below < host_bound_above <= 1, got "
                f"{device_bound_below}, {host_bound_above}")
        self._low = device_bound_below
        self._high = host_bound_above
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(_CLASSES, 0)
        self._wait_s = 0.0
        self._busy_s = 0.0
        self._last: Optional[str] = None
        self._registry = registry
        if registry is not None:
            for cls in _CLASSES:
                registry.counter(f"loader.next_{cls}")
            registry.counter("loader.delivery_wait_s")
            registry.counter("loader.consumer_busy_s")
            # Derived gauge: stall time as a percentage of step wall time
            # (delivery wait / (wait + busy)), read straight off a snapshot
            # without re-deriving it from two counters.
            registry.gauge("loader.input_stall_pct", self._stall_pct)

    def observe(self, wait_s: float, busy_s: float) -> str:
        """Record one delivered batch; returns its classification."""
        wait_s = max(0.0, wait_s)
        busy_s = max(0.0, busy_s)
        total = wait_s + busy_s
        frac = wait_s / total if total > 0 else 0.0
        if frac <= self._low:
            cls = "device_bound"
        elif frac >= self._high:
            cls = "host_bound"
        else:
            cls = "balanced"
        with self._lock:
            self._counts[cls] += 1
            self._wait_s += wait_s
            self._busy_s += busy_s
            self._last = cls
        if self._registry is not None:
            self._registry.counter(f"loader.next_{cls}").add(1)
            self._registry.counter("loader.delivery_wait_s").add(wait_s)
            self._registry.counter("loader.consumer_busy_s").add(busy_s)
        return cls

    def _stall_pct(self) -> float:
        with self._lock:
            total = self._wait_s + self._busy_s
            return (round(100.0 * self._wait_s / total, 4) if total
                    else 0.0)

    # ------------------------------------------------------------ readout
    @property
    def steps(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def report(self, pipeline_metrics=None) -> dict:
        """Aggregate verdict. With ``pipeline_metrics`` (a
        :class:`~petastorm_tpu_torch.metrics.PipelineMetrics`), host-bound time is
        sub-attributed using its ``host_wait_s`` (batch production) vs
        ``stage_s`` (sanitize + host-to-device copy) split."""
        with self._lock:
            counts = dict(self._counts)
            wait_s, busy_s = self._wait_s, self._busy_s
            last = self._last
        steps = sum(counts.values())
        total = wait_s + busy_s
        verdict = "idle"
        if steps:
            verdict = max(counts, key=lambda c: counts[c])
        out = {
            "steps": steps,
            "counts": counts,
            "fractions": {c: round(counts[c] / steps, 4) if steps else 0.0
                          for c in _CLASSES},
            "delivery_wait_s": round(wait_s, 6),
            "consumer_busy_s": round(busy_s, 6),
            "wait_fraction": round(wait_s / total, 4) if total else 0.0,
            "input_stall_pct": (round(100.0 * wait_s / total, 4) if total
                                else 0.0),
            "verdict": verdict,
            "last": last,
            "thresholds": {"device_bound_below": self._low,
                           "host_bound_above": self._high},
        }
        if pipeline_metrics is not None:
            m = pipeline_metrics.as_dict()
            host = m.get("host_wait_s", 0.0) + m.get("stage_s", 0.0)
            out["host_side"] = {
                "host_wait_s": m.get("host_wait_s", 0.0),
                "stage_s": m.get("stage_s", 0.0),
                "production_fraction": round(
                    m.get("host_wait_s", 0.0) / host, 4) if host else 0.0,
                "dominant": ("production" if m.get("host_wait_s", 0.0)
                             >= m.get("stage_s", 0.0) else "staging"),
            }
        return out
