"""Per-stage deadlines: "slow" as a first-class, bounded failure mode (the
JAX package's ``resilience/deadline.py``).

The retry/quarantine machinery only fires when an attempt *raises*. A
straggling remote read or a decode wedged on a lock raises nothing — it
just silently starves the accelerator. A
:class:`StageDeadline` turns that latency into the same failure currency
the rest of the resilience layer already speaks:

* **soft budget** — an attempt that finishes but ran past ``soft_s`` is a
  *straggler*: it still delivers its data, and a ``resilience.straggler``
  telemetry event + counters record it (:class:`StragglerMonitor`).
* **hard budget** — an attempt past ``hard_s`` is *cancelled*:
  :meth:`DeadlineTimer.finish` (and every cooperative
  :meth:`DeadlineTimer.check` checkpoint inside the attempt) raises
  :class:`StageDeadlineExceeded`, which the worker's
  :class:`~petastorm_tpu_torch.resilience.quarantine.RowGroupGuard` treats like
  any transient failure — retry per the policy, then quarantine in
  degraded mode. The overrun attempt's result is discarded even when it
  eventually completes, so the stream's latency is bounded by
  ``hard_s * max_attempts``, never by one pathological read.

Cancellation is **cooperative**: Python cannot interrupt a blocking C
read, so enforcement happens at checkpoints (attempt completion plus the
read/decode stage boundaries inside both reader workers). A
:class:`CancellationToken` lets the pipeline watchdog request
cancellation from outside the worker — the next checkpoint in any
in-flight attempt raises, handing the item to the retry machinery
(see :mod:`petastorm_tpu_torch.resilience.watchdog`).

Deadlines are plain picklable values, so they cross the spawn boundary
into process-pool workers unchanged (the token does not — cross-process
cancellation has no shared memory to flip; the watchdog escalates to the
crash-recovery kill path there instead).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

__all__ = ["CancellationToken", "DeadlineTimer", "StageDeadline",
           "StageDeadlineExceeded", "StragglerMonitor"]


class StageDeadlineExceeded(IOError):
    """A per-attempt hard deadline (or a watchdog cancellation) fired.

    Subclasses :class:`IOError` so the default classifier retries it: a
    fresh attempt may land on a healthy replica or a warm page cache,
    and in degraded mode an item that is *always* slow quarantines with
    full provenance instead of stalling the epoch forever.
    """


class CancellationToken:
    """Thread-safe cancel request checked at deadline checkpoints.

    Shared between the consumer-side watchdog and in-process workers
    (thread/dummy pools). Cancellation is **edge-triggered per attempt**:
    each :meth:`request` bumps a generation, and a timer cancels only
    attempts that were already in flight when the request happened —
    attempts armed *after* the request (the guard's retries) run
    normally, so a transient wedge cancels once and then recovers via
    the retry machinery instead of insta-failing every retry across the
    pipeline. Deliberately NOT picklable into spawned workers — there is
    no shared flag to flip across a process boundary.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._generation = 0
        self._requested = False
        self._reason = ""

    def request(self, reason: str = "") -> None:
        with self._lock:
            self._generation += 1
            self._requested = True
            self._reason = reason

    def clear(self) -> None:
        """Reset the *reporting* flag (the watchdog's ladder reset); the
        generation is never rewound — in-flight attempts armed before the
        request still cancel at their next checkpoint."""
        with self._lock:
            self._requested = False
            self._reason = ""

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def requested(self) -> bool:
        with self._lock:
            return self._requested

    @property
    def reason(self) -> str:
        with self._lock:
            return self._reason


@dataclasses.dataclass(frozen=True)
class StageDeadline:
    """Per-attempt latency budget (seconds). Picklable value.

    :param soft_s: overruns are *recorded* (straggler telemetry) but the
        attempt's data is kept
    :param hard_s: overruns are *cancelled* — checkpoints raise
        :class:`StageDeadlineExceeded` and the retry/quarantine machinery
        takes the item
    """

    soft_s: Optional[float] = None
    hard_s: Optional[float] = None

    def __post_init__(self):
        for name in ("soft_s", "hard_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if (self.soft_s is not None and self.hard_s is not None
                and self.soft_s > self.hard_s):
            raise ValueError(f"soft_s ({self.soft_s}) must not exceed "
                             f"hard_s ({self.hard_s})")
        if self.soft_s is None and self.hard_s is None:
            raise ValueError("a StageDeadline needs soft_s and/or hard_s")

    @classmethod
    def from_arg(cls, arg) -> Optional["StageDeadline"]:
        """Normalize the reader kwarg: ``None`` passes through, a number
        becomes ``hard_s`` with a soft budget at half of it (the overrun
        is visible in telemetry well before it is cancelled), an instance
        is used as-is."""
        if arg is None or isinstance(arg, cls):
            return arg
        hard = float(arg)
        return cls(soft_s=hard / 2.0, hard_s=hard)

    def start(self, cancel_token: Optional[CancellationToken] = None
              ) -> "DeadlineTimer":
        """Begin one attempt's budget."""
        return DeadlineTimer(self, cancel_token)


class DeadlineTimer:
    """One attempt's running budget; created by :meth:`StageDeadline.start`
    (or directly with ``deadline=None`` for a cancellation-only timer —
    the ``hang_timeout_s``-without-``stage_deadline_s`` configuration)."""

    __slots__ = ("_deadline", "_token", "_t0", "_gen0")

    def __init__(self, deadline: Optional[StageDeadline],
                 token: Optional[CancellationToken] = None):
        self._deadline = deadline
        self._token = token
        # Edge-triggered cancel: only a request made AFTER this attempt
        # was armed cancels it, so a guard retry that re-arms gets a
        # clean slate instead of insta-failing on a stale request.
        self._gen0 = token.generation if token is not None else 0
        self._t0 = time.monotonic()

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    @property
    def soft_exceeded(self) -> bool:
        soft = self._deadline.soft_s if self._deadline is not None else None
        return soft is not None and self.elapsed > soft

    def check(self) -> None:
        """Cancellation checkpoint: raises :class:`StageDeadlineExceeded`
        on a hard overrun or a watchdog cancel request newer than this
        attempt."""
        if self._token is not None and self._token.generation != self._gen0:
            raise StageDeadlineExceeded(
                f"attempt cancelled by the pipeline watchdog after "
                f"{self.elapsed:.3f}s ({self._token.reason or 'hang'})")
        hard = self._deadline.hard_s if self._deadline is not None else None
        if hard is not None and self.elapsed > hard:
            raise StageDeadlineExceeded(
                f"attempt exceeded its hard stage deadline: "
                f"{self.elapsed:.3f}s > {hard}s")

    def finish(self) -> float:
        """End-of-attempt checkpoint; returns the elapsed seconds (feed it
        to :meth:`StragglerMonitor.observe`). Raises on hard overrun —
        the completed result is discarded, which is what bounds the
        stream's latency."""
        self.check()
        return self.elapsed


class StragglerMonitor:
    """Soft-overrun accounting onto the pipeline registry.

    Emits, per straggling attempt/item: the ``resilience.stragglers_total``
    counter (or ``resilience.item_stragglers_total`` at pool-item
    granularity — see ``scope``), the ``resilience.straggler_overrun_s``
    histogram of seconds past the soft budget, and a
    ``resilience.straggler`` registry event carrying provenance. Spawned
    process-pool workers have no shared registry; their monitors count
    locally and the numbers stay in-worker.
    """

    #: counter name per enforcement granularity
    _COUNTERS = {"attempt": "resilience.stragglers_total",
                 "item": "resilience.item_stragglers_total"}

    def __init__(self, deadline: Optional[StageDeadline], telemetry=None,
                 scope: str = "attempt", site: str = ""):
        if scope not in self._COUNTERS:
            raise ValueError(f"scope must be one of "
                             f"{sorted(self._COUNTERS)}, got {scope!r}")
        self.deadline = deadline
        self.site = site
        self._registry = telemetry
        self._count = (telemetry.counter(self._COUNTERS[scope])
                       if telemetry is not None else None)
        self._overrun = (telemetry.histogram("resilience.straggler_overrun_s")
                         if telemetry is not None else None)
        self.local_count = 0

    def observe(self, elapsed_s: float, key: str = "",
                worker_id: Optional[int] = None) -> bool:
        """Record one completed attempt/item duration; True = straggler."""
        soft = self.deadline.soft_s if self.deadline is not None else None
        if soft is None or elapsed_s <= soft:
            return False
        self.local_count += 1
        if self._count is not None:
            self._count.add(1)
        if self._overrun is not None:
            self._overrun.observe(elapsed_s - soft)
        if self._registry is not None:
            self._registry.record_event("resilience.straggler", {
                "site": self.site, "key": str(key)[-120:],
                "worker_id": worker_id,
                "elapsed_s": round(elapsed_s, 4),
                "soft_s": soft})
        return True
