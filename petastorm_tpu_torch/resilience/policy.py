"""Composable retry policies (the JAX package's ``resilience/policy.py``).

The reader workers' row-group retry loop runs through one
:class:`RetryPolicy` instead of a hand-rolled ``for attempt in range(...)``
loop. A policy owns:

* an :class:`ExponentialBackoff` schedule (base * multiplier**n, capped),
* a jitter mode (``none`` / ``full`` / ``decorrelated``) driven by a
  **seeded** RNG so retry schedules are reproducible run-to-run,
* per-attempt and total deadlines,
* an exception classifier separating transient failures (retry) from
  permanent answers (propagate immediately — retrying a
  ``FileNotFoundError`` only delays the real error).

Policies are plain picklable values (classifiers must be module-level
functions) so they cross the spawn boundary into process-pool workers
unchanged. With the same seed a policy gives the JAX package's schedule,
delay for delay.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

__all__ = [
    "TRANSIENT", "PERMANENT", "ExponentialBackoff", "RetryPolicy",
    "default_io_classifier", "failover_classifier", "sqlite_classifier",
    "DEFAULT_READ_POLICY", "no_retry",
]

#: Classifier verdicts.
TRANSIENT = "transient"
PERMANENT = "permanent"

# OSError subclasses that are definite answers from healthy storage, not
# outages — retrying them masks the real error.
_DEFINITE_OS_ERRORS = (FileNotFoundError, PermissionError, FileExistsError,
                       IsADirectoryError, NotADirectoryError)


def default_io_classifier(exc: BaseException) -> str:
    """Transient: connection-level IO/OS errors (pyarrow's ArrowIOError
    subclasses OSError). Permanent: definite filesystem answers
    (missing file, permission denied) and everything non-IO — a
    ``pa.ArrowInvalid``/``ValueError`` means corrupt bytes, which no retry
    will un-corrupt."""
    if isinstance(exc, _DEFINITE_OS_ERRORS):
        return PERMANENT
    if isinstance(exc, (IOError, OSError)):
        return TRANSIENT
    return PERMANENT


def failover_classifier(exc: BaseException) -> str:
    """The namenode-failover flavor: identical verdicts to the default IO
    classifier (kept as its own name so call sites document intent and can
    diverge)."""
    return default_io_classifier(exc)


def sqlite_classifier(exc: BaseException) -> str:
    """Cache-fill flavor: ``sqlite3.OperationalError`` ("database is
    locked" under concurrent readers) is transient; everything else defers
    to the IO classifier."""
    import sqlite3
    if isinstance(exc, sqlite3.OperationalError):
        return TRANSIENT
    return default_io_classifier(exc)


@dataclasses.dataclass(frozen=True)
class ExponentialBackoff:
    """The bare schedule ``min(cap, base * multiplier**n)`` for retry number
    ``n`` (0-based). Shared by time-based retries (values are seconds) and
    count-based backoffs (values are counts — e.g. the native image
    decoder's row-group skip memo)."""

    base: float = 0.1
    multiplier: float = 2.0
    cap: float = 30.0

    def __post_init__(self):
        if self.base < 0 or self.multiplier < 1.0 or self.cap < 0:
            raise ValueError(
                f"ExponentialBackoff needs base>=0, multiplier>=1, cap>=0 "
                f"(got base={self.base}, multiplier={self.multiplier}, "
                f"cap={self.cap})")

    def value(self, n: int) -> float:
        return min(self.cap, self.base * self.multiplier ** max(0, n))


_JITTER_MODES = ("none", "full", "decorrelated")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """:param max_attempts: total tries (first attempt included); ``1`` means
        no retries
    :param backoff: delay schedule between attempts
    :param jitter: ``"none"`` (exact schedule), ``"full"`` (uniform
        ``[0, d]``), or ``"decorrelated"`` (AWS-style:
        ``min(cap, uniform(base, 3 * prev))`` — spreads synchronized
        retry storms)
    :param seed: seeds the jitter RNG; every :meth:`call` replays the same
        schedule, so a failure run is reproducible. ``None`` = entropy.
    :param total_deadline_s: give up once the elapsed time since the first
        attempt exceeds this (checked between attempts)
    :param attempt_timeout_s: an attempt whose *duration* exceeded this is
        not retried even when transient — a site failing slowly (e.g. a 30 s
        connect timeout) multiplies its latency by ``max_attempts`` if
        retried; cooperative call sites can also read this field to set
        their own IO timeouts
    :param classify: ``exc -> TRANSIENT | PERMANENT`` (module-level function
        so the policy stays picklable across the worker spawn boundary)

    On exhaustion :meth:`call` re-raises the **original last exception**
    (callers keep their exception contracts; wrap at the call site when a
    domain error is wanted), after invoking ``on_give_up``.
    """

    max_attempts: int = 3
    backoff: ExponentialBackoff = dataclasses.field(
        default_factory=ExponentialBackoff)
    jitter: str = "none"
    seed: Optional[int] = None
    total_deadline_s: Optional[float] = None
    attempt_timeout_s: Optional[float] = None
    classify: Callable[[BaseException], str] = default_io_classifier

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.jitter not in _JITTER_MODES:
            raise ValueError(f"jitter must be one of {_JITTER_MODES}, "
                             f"got {self.jitter!r}")

    # ---------------------------------------------------------------- delays
    def schedule(self, n: Optional[int] = None):
        """The delays (seconds) this policy would sleep between attempts —
        ``n`` values (default: one per possible retry). With a ``seed`` the
        schedule is identical on every invocation; two policies differing
        only in seed produce different (but individually stable) jitter."""
        count = self.max_attempts - 1 if n is None else n
        rng = random.Random(self.seed)
        prev = self.backoff.base
        out = []
        for i in range(count):
            raw = self.backoff.value(i)
            if self.jitter == "full":
                d = rng.uniform(0.0, raw)
            elif self.jitter == "decorrelated":
                d = min(self.backoff.cap,
                        rng.uniform(self.backoff.base, max(self.backoff.base,
                                                           prev * 3.0)))
            else:
                d = raw
            prev = d
            out.append(d)
        return out

    # ------------------------------------------------------------------ call
    def call(self, fn, *args, on_retry=None, on_give_up=None, sleep=None,
             **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.

        ``on_retry(attempt, exc, delay_s)`` fires before each sleep (wire
        telemetry counters / handle eviction here); ``on_give_up(attempts,
        exc)`` fires once when the policy stops retrying. ``sleep`` is
        injectable for tests (defaults to ``time.sleep``)."""
        do_sleep = time.sleep if sleep is None else sleep
        delays = self.schedule()
        start = time.monotonic()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - classifier decides
                last = e
                attempt_s = time.monotonic() - t0
                if self.classify(e) == PERMANENT:
                    break
                if attempt >= self.max_attempts:
                    break
                if (self.attempt_timeout_s is not None
                        and attempt_s > self.attempt_timeout_s):
                    break
                delay = delays[attempt - 1]
                if (self.total_deadline_s is not None
                        and time.monotonic() - start + delay
                        > self.total_deadline_s):
                    break
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    do_sleep(delay)
        if on_give_up is not None:
            on_give_up(attempt, last)
        raise last

    def wrap(self, fn, **call_kwargs):
        """Decorator form: ``policy.wrap(fn)`` retries every call."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **call_kwargs, **kwargs)
        return wrapped


#: The reader workers' default: 2 retries, 0.1 s then 0.2 s apart, a seeded
#: deterministic schedule.
DEFAULT_READ_POLICY = RetryPolicy(
    max_attempts=3,
    backoff=ExponentialBackoff(base=0.1, multiplier=2.0, cap=2.0),
    jitter="none", seed=0)


def no_retry(classify: Callable[[BaseException], str] = default_io_classifier
             ) -> RetryPolicy:
    """A policy that never retries (single attempt) — lets call sites keep
    one code path while disabling resilience."""
    return RetryPolicy(max_attempts=1, classify=classify)
