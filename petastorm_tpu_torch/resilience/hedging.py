"""Hedged row-group reads: mask IO tail latency with a speculative copy (the
JAX package's ``resilience/hedging.py``).

The Dean/Barroso "tail at scale" move, applied to the one pipeline stage
whose latency is dominated by a remote system: when a row-group read has
been in flight longer than a tracked delay (the read-latency p95 off the
registry's histograms, with a static fallback until enough samples exist),
launch a *duplicate* read of the same row group on a spare thread with a
**fresh file handle** (the straggling handle may be the problem). First
completed result wins; the loser is signalled to stand down and its
result is discarded at its next checkpoint.

Determinism: both attempts read the *same* row group from the *same*
immutable Parquet file, so winner selection cannot change sample content
— a seeded epoch stays byte-identical whether the primary or the hedge
wins.

Feedback discipline: only un-hedged primary completions feed the latency
histogram — hedged reads are censored observations, and folding them in
would ratchet the p95 (and therefore the hedge delay) downward until
every read hedges.

Failure semantics keep the retry contract simple: a primary that *fails*
before the hedge delay re-raises immediately (retries belong to the
:class:`~petastorm_tpu_torch.resilience.quarantine.RowGroupGuard`, not here);
once both attempts are racing, the first success wins and a lone failure
defers to the surviving attempt. Both failing re-raises the first error.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

__all__ = ["HedgePolicy", "HedgedReadExecutor"]

#: Bounded poll while waiting on attempt results: keeps every wait in this
#: module timeout-bearing — a genuinely wedged attempt is the watchdog's to
#: catch, not ours to block on.
_RESULT_POLL_S = 0.25

#: Histogram fed by un-hedged primary reads; the quantile source.
READ_LATENCY_METRIC = "resilience.read_latency_s"


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When and how aggressively to hedge. Picklable value.

    :param quantile: launch the hedge once the primary has been in flight
        longer than this quantile of tracked read latency
    :param fallback_delay_s: static delay used until ``min_samples``
        latencies have been tracked (and always, in spawned process-pool
        workers — they cannot see the shared registry)
    :param min_delay_s/max_delay_s: clamp on the tracked delay, so a
        cold-cache p95 can neither hedge every read nor never hedge
    :param min_samples: histogram observations required before the
        tracked quantile replaces the static fallback
    :param max_concurrent: spare-slot budget — hedges beyond it are
        skipped (the primary is simply awaited), so hedging can never
        multiply worker IO more than ``1 + max_concurrent / workers``
    """

    quantile: float = 0.95
    fallback_delay_s: float = 0.10
    min_delay_s: float = 0.005
    max_delay_s: float = 5.0
    min_samples: int = 20
    max_concurrent: int = 2

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {self.quantile}")
        if self.fallback_delay_s <= 0:
            raise ValueError("fallback_delay_s must be positive")
        if not 0 < self.min_delay_s <= self.max_delay_s:
            raise ValueError(
                f"need 0 < min_delay_s <= max_delay_s "
                f"(got {self.min_delay_s}, {self.max_delay_s})")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if self.max_concurrent < 0:
            raise ValueError("max_concurrent must be >= 0")


class _Attempt:
    """One racing read on its own daemon thread."""

    def __init__(self, tag: str, fn: Callable, cancel: threading.Event,
                 results: "queue.Queue", on_exit: Optional[Callable] = None):
        self.tag = tag
        self._fn = fn
        self._cancel = cancel
        self._results = results
        self._on_exit = on_exit
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"pt-hedge-{tag}")

    def _run(self):
        try:
            if self._cancel.is_set():
                # Lost the race before starting: stand down silently (the
                # winner already delivered; an error frame would confuse
                # the both-failed accounting).
                return
            result = self._fn(self._cancel)
            self._results.put((self.tag, True, result))
        except BaseException as e:  # noqa: BLE001 - raced to the consumer
            self._results.put((self.tag, False, e))
        finally:
            if self._on_exit is not None:
                self._on_exit()


class HedgedReadExecutor:
    """Per-worker hedging engine around the row-group read call.

    ``read(primary, hedge, key)`` runs ``primary(cancel_event)`` on a
    spare thread; if no result lands within :meth:`current_delay`, it
    launches ``hedge(cancel_event)`` (callers pass a closure that opens a
    FRESH file handle) and returns whichever succeeds first. The loser's
    cancel event is set — cooperative: a blocking C read finishes and is
    discarded, a cooperative fn bails at its next checkpoint.

    Cost model: every read pays one daemon-thread spawn (~0.1 ms) so the
    caller can return the moment EITHER attempt lands while the loser is
    abandoned mid-read — a persistent runner would wedge behind its own
    abandoned attempt. That overhead is noise against the remote,
    ms-scale reads hedging exists for; pipelines on fast local stores
    should simply leave ``hedge_policy=None`` (the default), which keeps
    the zero-overhead direct path.

    Telemetry (in-process pools; spawned workers count locally):
    ``resilience.hedges_launched`` / ``resilience.hedge_wins`` /
    ``resilience.primary_wins`` counters and the
    ``resilience.read_latency_s`` histogram this executor's delay tracks.
    """

    def __init__(self, policy: HedgePolicy, telemetry=None,
                 worker_id: int = 0):
        self.policy = policy
        self.worker_id = worker_id
        self._hist = (telemetry.histogram(READ_LATENCY_METRIC)
                      if telemetry is not None else None)
        self._launched = (telemetry.counter("resilience.hedges_launched")
                          if telemetry is not None else None)
        self._hedge_wins = (telemetry.counter("resilience.hedge_wins")
                            if telemetry is not None else None)
        self._primary_wins = (telemetry.counter("resilience.primary_wins")
                              if telemetry is not None else None)
        # Spare-slot budget shared by this executor's hedges. Local stats
        # mirror the counters so spawned workers still have numbers.
        self._slots = threading.Semaphore(policy.max_concurrent)
        self.local_stats = {"hedges_launched": 0, "hedge_wins": 0,
                            "primary_wins": 0}

    # ------------------------------------------------------------------ delay
    def current_delay(self) -> float:
        """Hedge trigger delay: tracked read-latency quantile clamped to
        ``[min_delay_s, max_delay_s]``; the static fallback until the
        histogram holds ``min_samples`` observations (or forever, when no
        registry is reachable)."""
        p = self.policy
        if self._hist is None or self._hist.count < p.min_samples:
            return p.fallback_delay_s
        return min(p.max_delay_s, max(p.min_delay_s,
                                      self._hist.quantile(p.quantile)))

    # ------------------------------------------------------------------- read
    def read(self, primary: Callable, hedge: Callable, key: str = ""):
        """Race ``primary`` against a delayed ``hedge``; returns the first
        successful result. See the class docstring for the exact failure
        semantics."""
        delay = self.current_delay()
        results: queue.Queue = queue.Queue()
        cancel = threading.Event()
        t0 = time.monotonic()
        _Attempt("primary", primary, cancel, results).thread.start()

        first = self._next_result(results, timeout=delay)
        hedged = False
        if first is None:  # primary still in flight past the delay: hedge
            hedged = self._launch_hedge(hedge, cancel, results)
            first = self._next_result(results)

        tag, ok, payload = first
        if ok:
            self._record_win(tag, hedged, time.monotonic() - t0)
            cancel.set()  # loser stands down at its next checkpoint
            return payload
        if not hedged:
            raise payload  # lone primary failed: the retry policy's turn
        # One of two racing attempts failed; the survivor decides.
        tag2, ok2, payload2 = self._next_result(results)
        if ok2:
            self._record_win(tag2, hedged, time.monotonic() - t0)
            cancel.set()
            return payload2
        raise payload  # both failed: surface the first error

    # ------------------------------------------------------------ internals
    @staticmethod
    def _next_result(results: "queue.Queue", timeout: Optional[float] = None):
        """Next ``(tag, ok, payload)`` frame. With ``timeout`` this is the
        single bounded wait for the hedge decision (None on expiry);
        without it, poll until a frame arrives — every outstanding attempt
        always posts exactly one frame, so this terminates with the
        attempt (a wedged attempt is the watchdog's problem, exactly as an
        un-hedged read would be)."""
        if timeout is not None:
            try:
                return results.get(timeout=timeout)
            except queue.Empty:
                return None
        while True:
            try:
                return results.get(timeout=_RESULT_POLL_S)
            except queue.Empty:
                continue

    def _launch_hedge(self, hedge: Callable, cancel: threading.Event,
                      results: "queue.Queue") -> bool:
        if not self._slots.acquire(blocking=False):
            return False  # no spare slot: just await the primary
        self.local_stats["hedges_launched"] += 1
        if self._launched is not None:
            self._launched.add(1)
        _Attempt("hedge", hedge, cancel, results,
                 on_exit=self._slots.release).thread.start()
        return True

    def _record_win(self, tag: str, hedged: bool, elapsed_s: float) -> None:
        if hedged:
            name = "hedge_wins" if tag == "hedge" else "primary_wins"
            self.local_stats[name] += 1
            counter = (self._hedge_wins if tag == "hedge"
                       else self._primary_wins)
            if counter is not None:
                counter.add(1)
        elif self._hist is not None:
            # Un-hedged completions only: hedged latencies are censored
            # and would drag the tracked quantile into a hedge-everything
            # feedback loop.
            self._hist.observe(elapsed_s)
