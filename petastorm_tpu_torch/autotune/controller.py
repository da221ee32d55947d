"""The feedback controller: telemetry in, actuator nudges out.

The registry already measures what a tuner needs: the stall attributor's
per-batch classes, the queue gauges, the resilience counters. The
controller samples it every ``interval_s``, diagnoses which side of the
pipeline holds it back and moves one step of one knob, with hysteresis
and a cooldown so noise does not turn into knob thrash.

Verdicts a tick:

* ``producer_bound``: the consumer waited on the host pipeline (a
  majority of host-bound batches, or an empty results queue with work in
  flight): raise decode concurrency, then the ventilation depth, then the
  readahead depth, then the prefetch depth; with all of them at their
  ceilings, a placement trial (when a placement actuator is registered);
* ``consumer_bound``: the pipeline kept ahead: lower the prefetch depth,
  then decode concurrency;
* ``balanced``: hold (convergence);
* ``fault_hold``: retries, quarantines or crash recoveries in this window:
  the stall is the faults', so every knob holds;
* ``memory_pressure``: the shared budget passed its watermark: halve the
  shuffle target and lower prefetch, readahead and ventilation depths;
* ``idle``: nothing moved.

Each tick adds to ``autotune.ticks_total`` and its verdict's counter;
each move to ``autotune.adjustments_total``, the actuator's gauge and
:attr:`AutotuneController.history`.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from collections import deque
from typing import Dict, List, Optional

from petastorm_tpu_torch.autotune.actuators import Actuator

__all__ = ["AutotuneConfig", "AutotuneController"]

logger = logging.getLogger(__name__)

_VERDICTS = ("producer_bound", "consumer_bound", "balanced", "fault_hold",
             "memory_pressure", "idle")

#: Counters whose growth in a window marks it as disturbed by faults.
_FAULT_COUNTERS = ("resilience.retries_total", "resilience.quarantined_rowgroups",
                   "resilience.worker_crashes", "resilience.reventilated_items")


@dataclasses.dataclass
class AutotuneConfig:
    """:param interval_s: the background thread's sampling period
    :param hysteresis: equal verdicts in a row before acting
    :param cooldown_ticks: ticks held after a move
    :param memory_high_watermark: budget pressure above which the memory
        knobs back off
    :param memory_budget_bytes: the host bytes the pipeline's holders may
        charge together: the reader makes one shared :class:`MemoryBudget`
        of it, points the memory cache and the readahead stage at it and
        watches it for ``memory_pressure`` (size it above
        ``memory_cache_size_bytes``). None: no budget is watched
    :param queue_empty_frac/queue_full_frac: results-queue fill fractions
        read as producer- and consumer-bound where no loader reports stalls
    :param placement: tune the decode stage's placement (thread against
        process pool): the reader registers a placement actuator, and a
        resolved trial persists in the plan cache
        (:mod:`petastorm_tpu_torch.plan`)
    :param placement_settle_ticks: ticks after a completed migration
        before it is judged
    :param placement_tolerance: the rows-a-tick loss that reverts a trial
    """

    interval_s: float = 0.5
    hysteresis: int = 2
    cooldown_ticks: int = 2
    memory_high_watermark: float = 0.85
    memory_budget_bytes: Optional[int] = None
    queue_empty_frac: float = 0.1
    queue_full_frac: float = 0.9
    placement: bool = False
    placement_settle_ticks: int = 12
    placement_tolerance: float = 0.15

    def __post_init__(self):
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.cooldown_ticks < 0:
            raise ValueError(f"cooldown_ticks must be >= 0, got {self.cooldown_ticks}")
        if not 0.0 < self.memory_high_watermark <= 1.5:
            raise ValueError(f"memory_high_watermark out of range: {self.memory_high_watermark}")
        if self.memory_budget_bytes is not None and self.memory_budget_bytes <= 0:
            raise ValueError(f"memory_budget_bytes must be > 0, got {self.memory_budget_bytes}")
        if self.placement_settle_ticks < 1:
            raise ValueError(f"placement_settle_ticks must be >= 1, "
                             f"got {self.placement_settle_ticks}")
        if not 0.0 < self.placement_tolerance < 1.0:
            raise ValueError(f"placement_tolerance must be in (0, 1), "
                             f"got {self.placement_tolerance}")


class AutotuneController:
    """:param registry: the pipeline's telemetry registry
    :param config: an :class:`AutotuneConfig`
    :param budget: a shared :class:`~petastorm_tpu_torch.autotune.MemoryBudget`
        watched for memory pressure, or None

    Actuators come and go: the reader registers the pool's, the
    ventilator's and the readahead stage's at construction, a loader adds
    its own while it stages and removes them after. A tick tunes whatever
    is registered then."""

    def __init__(self, registry, config: Optional[AutotuneConfig] = None, budget=None):
        self._registry = registry
        self.config = config or AutotuneConfig()
        self.budget = budget
        self._lock = threading.Lock()        # the actuator map
        self._tick_lock = threading.Lock()   # whole control steps
        self._actuators: Dict[str, Actuator] = {}
        self._prev_counters: Dict[str, float] = {}
        self._streak_verdict: Optional[str] = None
        self._streak = 0
        self._cooldown = 0
        self._tick_count = 0
        # The placement trial: rows a tick over a rolling window, one trial
        # a controller, then the knob pins.
        self._rate_window: deque = deque(maxlen=8)
        self._placement_trial: Optional[dict] = None
        self._placement_pinned = False
        self._placement_apply_failures = 0
        #: ``{"verdict": "kept" | "reverted" | "apply_failed" | ..., "backend", ...}``
        #: once placement is pinned.
        self.placement_outcome: Optional[dict] = None
        #: Called with the outcome when a measured trial resolves.
        self.on_placement_resolved = None
        #: ``(tick, actuator, old, new, verdict)`` rows, append-only.
        self.history: List[tuple] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._ticks_total = registry.counter("autotune.ticks_total")
        self._verdict_counters = {v: registry.counter(f"autotune.verdict_{v}")
                                  for v in _VERDICTS}
        registry.counter("autotune.adjustments_total")

    def register(self, actuator: Actuator) -> Actuator:
        actuator.attach_telemetry(self._registry)
        with self._lock:
            self._actuators[actuator.name] = actuator
        return actuator

    def unregister(self, name: str) -> None:
        with self._lock:
            self._actuators.pop(name, None)

    def actuator(self, name: str) -> Optional[Actuator]:
        with self._lock:
            return self._actuators.get(name)

    def actuator_values(self) -> Dict[str, int]:
        with self._lock:
            return {name: a.value for name, a in self._actuators.items()}

    def tick(self) -> str:
        """One control step; returns its verdict."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> str:
        snap = self._registry.snapshot()
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        deltas = {k: counters.get(k, 0.0) - self._prev_counters.get(k, 0.0)
                  for k in set(counters) | set(self._prev_counters)}
        self._prev_counters = dict(counters)
        self._tick_count += 1
        self._ticks_total.add(1)
        self._rate_window.append(deltas.get("reader.rows", 0.0))
        self._placement_trial_tick()

        verdict = self._diagnose(deltas, gauges)
        self._verdict_counters[verdict].add(1)
        if verdict in ("fault_hold", "idle", "balanced"):
            # No shape signal (or converged): a stale trend must not act the
            # moment the faults clear.
            self._streak_verdict, self._streak = None, 0
            return verdict
        if self._cooldown > 0:
            self._cooldown -= 1
            return verdict
        if verdict == self._streak_verdict:
            self._streak += 1
        else:
            self._streak_verdict, self._streak = verdict, 1
        if self._streak < self.config.hysteresis:
            return verdict
        if self._act(verdict):
            self._cooldown = self.config.cooldown_ticks
            self._streak = 0
        return verdict

    def _diagnose(self, deltas: Dict[str, float], gauges: Dict[str, float]) -> str:
        if any(deltas.get(k, 0.0) > 0 for k in _FAULT_COUNTERS):
            return "fault_hold"
        if self.budget is not None and self.budget.pressure > self.config.memory_high_watermark:
            return "memory_pressure"
        host = deltas.get("loader.next_host_bound", 0.0)
        device = deltas.get("loader.next_device_bound", 0.0)
        balanced = deltas.get("loader.next_balanced", 0.0)
        if host + device + balanced > 0:
            return max(("producer_bound", host), ("consumer_bound", device),
                       ("balanced", balanced), key=lambda kv: kv[1])[0]
        # No loader reports stalls: read the results queue's shape.
        if deltas.get("reader.rows", 0.0) <= 0:
            return "idle"
        depth = gauges.get("pool.results_queue_depth")
        backlog = gauges.get("ventilator.backlog")
        capacity = gauges.get("pool.results_queue_capacity")
        if depth is not None and capacity:
            fill = depth / capacity
            if fill <= self.config.queue_empty_frac and (backlog or 0) > 0:
                return "producer_bound"
            if fill >= self.config.queue_full_frac:
                return "consumer_bound"
        return "balanced"

    def _placement_trial_tick(self) -> None:
        """Advance the placement trial: wait for the migration to apply and
        ``placement_settle_ticks`` to pass, then keep or revert by rows a
        tick and pin the knob."""
        trial = self._placement_trial
        if trial is None:
            return
        act = self.actuator("placement")
        if act is None:
            self._placement_trial = None
            return
        if not act.applied:
            return
        if getattr(act, "last_apply_failed", False):
            # The migration never happened: cancel rather than measure; a
            # second failure pins the knob.
            self._placement_trial = None
            self._placement_apply_failures += 1
            if self._placement_apply_failures >= 2:
                self._finish_trial({"verdict": "apply_failed", "backend": act.backend})
            return
        if trial.get("reverting"):
            outcome = trial.get("outcome") or {"verdict": "reverted", "backend": act.backend}
            self._placement_trial = None
            self._finish_trial(outcome)
            return
        if "settle_left" not in trial:
            trial["settle_left"] = self.config.placement_settle_ticks
            self._rate_window.clear()
            return
        trial["settle_left"] -= 1
        if trial["settle_left"] > 0:
            return
        baseline = trial["baseline"]
        current = (sum(self._rate_window) / len(self._rate_window)
                   if self._rate_window else 0.0)
        if baseline > 0 and current < baseline * (1.0 - self.config.placement_tolerance):
            old = act.value
            act.set(1 - old)
            self.history.append((self._tick_count, "placement", old, act.value,
                                 "placement_revert"))
            trial.clear()
            trial["reverting"] = True
            trial["outcome"] = {"verdict": "reverted", "backend": act.backend,
                                "baseline_rows_per_tick": round(baseline, 3),
                                "measured_rows_per_tick": round(current, 3)}
        else:
            self._placement_trial = None
            self._finish_trial({"verdict": "kept", "backend": act.backend,
                                "baseline_rows_per_tick": round(baseline, 3),
                                "measured_rows_per_tick": round(current, 3)})

    def _finish_trial(self, outcome: dict) -> None:
        self._placement_pinned = True
        self.placement_outcome = dict(outcome)
        callback = self.on_placement_resolved
        if callback is not None and outcome.get("verdict") in ("kept", "reverted"):
            try:
                callback(dict(outcome))
            except Exception:  # noqa: BLE001 - a failed callback never stops the tuning
                logger.exception("on_placement_resolved callback failed")

    def pin_placement(self, outcome: Optional[dict] = None) -> None:
        """Pin the placement knob without a trial (an owner that already
        knows the winner)."""
        self._placement_pinned = True
        self.placement_outcome = dict(outcome) if outcome else {"verdict": "pinned"}

    def _try_placement(self, acts, verdict: str) -> bool:
        act = acts.get("placement")
        if act is None or self._placement_pinned or self._placement_trial is not None \
                or not act.applied:
            return False
        baseline = (sum(self._rate_window) / len(self._rate_window)
                    if self._rate_window else 0.0)
        old = act.value
        act.set(1 - old)
        self.history.append((self._tick_count, "placement", old, act.value, verdict))
        self._placement_trial = {"baseline": baseline}
        return True

    def _act(self, verdict: str) -> bool:
        """One step for the verdict; True if an actuator moved."""
        with self._lock:
            acts = dict(self._actuators)
        moved = False
        if verdict == "producer_bound":
            for name, delta in (("worker_concurrency", 1), ("ventilate_ahead", 2),
                                ("readahead_depth", 1), ("prefetch_depth", 1)):
                moved = self._nudge(acts.get(name), delta, verdict)
                if moved:
                    break
            if not moved:
                moved = self._try_placement(acts, verdict)
        elif verdict == "consumer_bound":
            for name, delta in (("prefetch_depth", -1), ("worker_concurrency", -1)):
                moved = self._nudge(acts.get(name), delta, verdict)
                if moved:
                    break
        elif verdict == "memory_pressure":
            # Every memory knob backs off, not just the first.
            for name, delta in (("shuffle_target", None), ("prefetch_depth", -1),
                                ("readahead_depth", -1), ("ventilate_ahead", -2)):
                if delta is None:
                    act = acts.get(name)
                    delta = -(act.value // 2 or 1) if act is not None else 0
                if self._nudge(acts.get(name), delta, verdict):
                    moved = True
        return moved

    def _nudge(self, actuator: Optional[Actuator], delta: int, verdict: str) -> bool:
        if actuator is None or delta == 0:
            return False
        old = actuator.value
        new = actuator.nudge(delta)
        if new == old:
            return False
        self.history.append((self._tick_count, actuator.name, old, new, verdict))
        return True

    def start(self) -> "AutotuneController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-torch-autotune")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the tuning never stops the reading
                logger.exception("autotune tick failed; controller continues")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def report(self) -> dict:
        """Ticks, each actuator's value and range, and every move (the JAX
        package's schema)."""
        with self._lock:
            acts = {name: {"value": a.value, "lo": a.lo, "hi": a.hi}
                    for name, a in self._actuators.items()}
        out = {"ticks": self._tick_count, "actuators": acts,
               "adjustments": [{"tick": t, "actuator": n, "old": o, "new": v, "verdict": verdict}
                               for t, n, o, v, verdict in list(self.history)]}
        if self.placement_outcome is not None:
            out["placement"] = dict(self.placement_outcome)
        return out
