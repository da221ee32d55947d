"""Runtime pipeline knobs with clamped ranges.

An :class:`Actuator` wraps one throughput knob that a pipeline component
owns but never turns itself (``tools/check_knobs.py`` checks that the
setters are called from this package alone):

* ``worker_concurrency``: the thread pool's
  :class:`~petastorm_tpu_torch.workers_pool.thread_pool.ConcurrencyGate`;
* ``ventilate_ahead``: the ventilator's in-flight cap
  (:meth:`~petastorm_tpu_torch.workers_pool.ventilator.ConcurrentVentilator.set_max_inflight`);
* ``shuffle_target``: a shuffling buffer's target rows
  (``set_target_capacity``);
* ``readahead_depth``: the fetch stage's depth
  (:meth:`~petastorm_tpu_torch.reader_impl.readahead.ReadaheadFetcher.set_readahead_depth`);
* ``prefetch_depth``: a loader's staged-batch depth
  (:meth:`~petastorm_tpu_torch.loader.loader.LoaderBase.set_prefetch_depth`).

Every ``set()`` clamps to ``[lo, hi]``, mirrors the value into an
``autotune.<name>`` gauge and adds one to ``autotune.adjustments_total``.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["Actuator", "WorkerConcurrencyActuator", "VentilatorDepthActuator",
           "ShuffleTargetActuator", "PrefetchDepthActuator", "ReadaheadDepthActuator"]


class Actuator:
    """A named integer knob of a clamped range. A subclass's ``_apply`` is
    the one place its component's setter is called; ``set()`` is
    thread-safe, and setting the current value records nothing."""

    def __init__(self, name: str, lo: int, hi: int, initial: int, telemetry=None):
        if lo > hi:
            raise ValueError(f"{name}: lo {lo} > hi {hi}")
        self.name = name
        self.lo = int(lo)
        self.hi = int(hi)
        self._value = self._clamp(initial)
        self._lock = threading.Lock()
        self._gauge = None
        self._adjustments = None
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    def attach_telemetry(self, telemetry) -> None:
        self._gauge = telemetry.gauge(f"autotune.{self.name}")
        self._gauge.set(self._value)
        self._adjustments = telemetry.counter("autotune.adjustments_total")

    def _clamp(self, value: int) -> int:
        return max(self.lo, min(self.hi, int(value)))

    def _apply(self, value: int) -> None:
        raise NotImplementedError

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    @property
    def at_max(self) -> bool:
        with self._lock:
            return self._value >= self.hi

    @property
    def at_min(self) -> bool:
        with self._lock:
            return self._value <= self.lo

    def set(self, value: int) -> int:
        """Clamp, apply and record; returns the value applied."""
        value = self._clamp(value)
        with self._lock:
            if value == self._value:
                return value
            self._apply(value)
            self._value = value
        if self._gauge is not None:
            self._gauge.set(value)
        if self._adjustments is not None:
            self._adjustments.add(1)
        return value

    def nudge(self, delta: int) -> int:
        with self._lock:
            target = self._value + int(delta)
        return self.set(target)


class WorkerConcurrencyActuator(Actuator):
    """Live decode concurrency through a thread pool's admission gate:
    workers above the limit park before their next item. Range ``[1,
    workers_count]``."""

    def __init__(self, gate, workers_count: int, telemetry=None):
        self._gate = gate
        super().__init__("worker_concurrency", 1, workers_count, gate.limit,
                         telemetry=telemetry)

    def _apply(self, value: int) -> None:
        self._gate.set_limit(value)


class VentilatorDepthActuator(Actuator):
    """The in-flight row-group cap. Defaults: floor a quarter of the
    starting cap (at least 1), ceiling four times it."""

    def __init__(self, ventilator, lo: Optional[int] = None, hi: Optional[int] = None,
                 telemetry=None):
        self._ventilator = ventilator
        initial = ventilator.max_inflight
        super().__init__("ventilate_ahead",
                         lo if lo is not None else max(1, initial // 4),
                         hi if hi is not None else max(1, initial * 4),
                         initial, telemetry=telemetry)

    def _apply(self, value: int) -> None:
        self._ventilator.set_max_inflight(value)


class ShuffleTargetActuator(Actuator):
    """A shuffling buffer's target, in rows. Floor the buffer's
    ``min_target`` (else a quarter of its capacity), never above the
    ceiling, its configured capacity (a tight buffer becomes a fixed
    knob)."""

    def __init__(self, buf, telemetry=None):
        self._buf = buf
        hi = buf.capacity
        lo = max(1, getattr(buf, "min_target", None) or max(1, hi // 4))
        super().__init__("shuffle_target", min(lo, hi), hi, buf.capacity, telemetry=telemetry)

    def _apply(self, value: int) -> None:
        self._buf.set_target_capacity(value)


class ReadaheadDepthActuator(Actuator):
    """The fetch stage's depth. Floor 1, ceiling four times the starting
    depth (at least 2): each unit holds one fetched Arrow table, and the
    stage's byte budget is the memory bound."""

    def __init__(self, fetcher, hi: Optional[int] = None, telemetry=None):
        self._fetcher = fetcher
        initial = fetcher.depth
        super().__init__("readahead_depth", 1,
                         hi if hi is not None else max(2, initial * 4), initial,
                         telemetry=telemetry)

    def _apply(self, value: int) -> None:
        self._fetcher.set_readahead_depth(value)


class PrefetchDepthActuator(Actuator):
    """A loader's staged-batch depth. Floor 1, ceiling four times the
    starting depth (at least 2): each unit holds one batch on the card."""

    def __init__(self, loader, hi: Optional[int] = None, telemetry=None):
        self._loader = loader
        initial = loader.prefetch_depth
        super().__init__("prefetch_depth", 1,
                         hi if hi is not None else max(2, initial * 4), initial,
                         telemetry=telemetry)

    def _apply(self, value: int) -> None:
        self._loader.set_prefetch_depth(value)
