"""Pipeline watchdog: a hung input pipeline fails loudly, never silently
(the JAX package's ``resilience/watchdog.py``).

The failure mode retries and crash recovery cannot see: nothing raises,
nothing crashes, and
nothing progresses — a remote read wedged in a C call, a decode stuck on
a lock, a lost condition-variable wakeup. The consumer blocks in
``pool.get_results()`` forever and the training job looks "slow" until a
human attaches a debugger.

:class:`PipelineWatchdog` is a monitor thread owned by the Reader. It
samples a *progress signature* (pool item counters and queue depths, the
``reader.rows`` counter, per-worker heartbeats where the pool exposes
them) and tracks whether the consumer is actually blocked waiting on the
pipeline (the reader's pool-wait timer calls :meth:`enter_wait` /
:meth:`exit_wait`). A hang is declared only when BOTH hold for
``hang_timeout_s``: the consumer is starving AND no component has made
progress — a consumer that simply isn't pulling (long device step,
paused iteration) can never trip it.

On detection the watchdog escalates through a ladder, each rung one
``escalation_interval`` after the previous:

1. **dump + nudge** — snapshot every live thread's stack into the
   telemetry registry (``resilience.watchdog.stack_dump`` event — the
   post-mortem a wedged production job never gets) and nudge the
   pipeline's condition variables (``pool.nudge()`` / ventilator) in
   case the hang is a lost wakeup.
2. **cancel the stuck item** — request the shared
   :class:`~petastorm_tpu_torch.resilience.deadline.CancellationToken`: every
   in-flight attempt in an in-process worker raises
   ``StageDeadlineExceeded`` at its next checkpoint and the item goes to
   the retry/quarantine machinery. On a process pool with crash
   recovery attached, **kill** the workers holding outstanding claims
   instead (SIGKILL): crash recovery detects the death and re-ventilates
   their row groups onto survivors.
3. **abort** — ``pool.abort(PipelineHungError(...))``: the blocked
   consumer's ``get_results`` raises instead of blocking forever.

Progress at any point resets the ladder (counted as
``resilience.hang_recoveries``).
"""
from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from typing import Optional

from petastorm_tpu_torch.resilience.deadline import CancellationToken

__all__ = ["PipelineHungError", "PipelineWatchdog"]

logger = logging.getLogger(__name__)

#: Frames kept per thread in a stack-dump event (bounded registry payload).
_DUMP_MAX_FRAMES = 15


class PipelineHungError(RuntimeError):
    """The pipeline made no progress for ``hang_timeout_s`` while the
    consumer was blocked on it, and the escalation ladder could not
    revive it. Raised to the consumer instead of blocking forever."""


def dump_thread_stacks(max_frames: int = _DUMP_MAX_FRAMES) -> dict:
    """``{thread_name: [frame strings]}`` for every live thread — the
    wedged-pipeline post-mortem. Module-level so tests and operators can
    call it without a watchdog."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"ident-{ident}")
        stack = traceback.format_stack(frame)[-max_frames:]
        out[name] = [line.strip() for line in stack]
    return out


class PipelineWatchdog:
    """:param pool: the reader's worker pool (thread/process/dummy)
    :param ventilator: the reader's ventilator (nudged on stage 1)
    :param telemetry: pipeline registry (events + counters land here)
    :param hang_timeout_s: no-progress-while-starving window that
        declares a hang
    :param recovery: the process pool's
        :class:`~petastorm_tpu_torch.resilience.recovery.WorkerCrashRecovery`
        ledger, when attached — enables the kill-and-re-ventilate rung
    :param cancel_token: shared token for the cooperative-cancel rung
        (in-process pools)
    :param interval_s: sample period; defaults to ``hang_timeout_s / 8``
        clamped to [0.02, 1.0]
    :param escalation_interval_s: pause between ladder rungs; defaults
        to ``2 * interval_s`` (so detection → abort spans well under one
        extra ``hang_timeout_s``)
    """

    def __init__(self, pool, ventilator=None, telemetry=None,
                 hang_timeout_s: float = 60.0, recovery=None,
                 cancel_token: Optional[CancellationToken] = None,
                 interval_s: Optional[float] = None,
                 escalation_interval_s: Optional[float] = None):
        if hang_timeout_s <= 0:
            raise ValueError(f"hang_timeout_s must be positive, "
                             f"got {hang_timeout_s}")
        self._pool = pool
        self._ventilator = ventilator
        self._telemetry = telemetry
        self._recovery = recovery
        self._token = cancel_token
        self.hang_timeout_s = hang_timeout_s
        self._interval = (interval_s if interval_s is not None
                          else min(1.0, max(0.02, hang_timeout_s / 8.0)))
        self._escalation = (escalation_interval_s
                            if escalation_interval_s is not None
                            else 2.0 * self._interval)
        self._hangs = (telemetry.counter("resilience.hangs_detected")
                       if telemetry is not None else None)
        self._recoveries = (telemetry.counter("resilience.hang_recoveries")
                            if telemetry is not None else None)
        self._kills = (telemetry.counter("resilience.watchdog_kills")
                       if telemetry is not None else None)
        self._aborts = (telemetry.counter("resilience.watchdog_aborts")
                        if telemetry is not None else None)

        self._lock = threading.Lock()
        self._waiting = False
        self._wait_since = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Escalation state (monitor thread only).
        self._stage = 0
        self._stage_at = 0.0
        self._aborted = False
        self.last_stack_dump: Optional[dict] = None
        #: Optional ``fn(PipelineHungError)`` fired when the final abort
        #: rung declares the pipeline dead, BEFORE ``pool.abort`` unblocks
        #: the consumer — the postmortem black box's trigger (the bundle
        #: then captures the hang, not the teardown that follows it).
        self.on_abort = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "PipelineWatchdog":
        if self._thread is not None:
            raise RuntimeError("PipelineWatchdog already started")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="petastorm-tpu-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------ consumer hooks
    def enter_wait(self) -> None:
        """The consumer is now blocked in ``pool.get_results()``."""
        with self._lock:
            self._waiting = True
            self._wait_since = time.monotonic()

    def exit_wait(self) -> None:
        """The consumer got a result (or an exception): that IS progress —
        the ladder re-arms."""
        with self._lock:
            self._waiting = False

    # ------------------------------------------------------------- readout
    def report(self) -> dict:
        """Queryable state: detection/escalation counters, the current
        ladder stage, and the latest stack dump (if any)."""
        with self._lock:
            return {
                "hang_timeout_s": self.hang_timeout_s,
                "stage": self._stage,
                "aborted": self._aborted,
                "hangs_detected": (self._hangs.value
                                   if self._hangs is not None else 0),
                "hang_recoveries": (self._recoveries.value
                                    if self._recoveries is not None else 0),
                "last_stack_dump": self.last_stack_dump,
            }

    # ----------------------------------------------------------- internals
    def _signature(self) -> tuple:
        """Anything that changes when the pipeline moves. Heartbeats are
        rounded so sub-interval jitter in an otherwise-stuck worker does
        not read as progress."""
        try:
            diag = self._pool.diagnostics
            sig = (diag.get("items_ventilated"), diag.get("items_processed"),
                   diag.get("output_queue_size"))
        except Exception:  # noqa: BLE001 - a torn-down pool is not progress
            sig = ()
        beats = getattr(self._pool, "heartbeats", None)
        if beats is not None:
            sig += tuple(round(b, 3) for b in beats)
        if self._telemetry is not None:
            sig += (self._telemetry.counter("reader.rows").value,)
        if self._ventilator is not None:
            sig += (self._ventilator.inflight,)
        return sig

    def _loop(self):
        last_sig = self._signature()
        last_progress = time.monotonic()
        while not self._stop.wait(self._interval):
            now = time.monotonic()
            sig = self._signature()
            if sig != last_sig:
                last_sig = sig
                last_progress = now
                # Post-abort churn (a wedged read finally returning into
                # teardown) is not a recovery: the pipeline was already
                # declared dead and the consumer told so.
                self._reset_ladder(
                    recovered=self._stage > 0 and not self._aborted)
                continue
            with self._lock:
                waiting, wait_since = self._waiting, self._wait_since
            if not waiting or self._aborted:
                continue
            hung_for = now - max(last_progress, wait_since)
            if hung_for < self.hang_timeout_s:
                continue
            self._escalate(now, hung_for)

    def _reset_ladder(self, recovered: bool) -> None:
        if recovered:
            logger.warning("Pipeline resumed progress after watchdog "
                           "intervention (stage %d)", self._stage)
            if self._recoveries is not None:
                self._recoveries.add(1)
            if self._token is not None:
                self._token.clear()
        self._stage = 0

    def _escalate(self, now: float, hung_for: float) -> None:
        if self._stage > 0 and now - self._stage_at < self._escalation:
            return  # give the previous rung time to act
        self._stage_at = now
        if self._stage == 0:
            self._detect(hung_for)
        elif self._stage == 1:
            self._cancel_or_kill()
        else:
            self._abort(hung_for)
        self._stage += 1

    def _detect(self, hung_for: float) -> None:
        self.last_stack_dump = dump_thread_stacks()
        if self._hangs is not None:
            self._hangs.add(1)
        if self._telemetry is not None:
            self._telemetry.record_event("resilience.watchdog.stack_dump", {
                "hung_for_s": round(hung_for, 3),
                "threads": self.last_stack_dump})
        logger.warning(
            "Pipeline hang detected: no progress for %.1fs with the "
            "consumer starving (hang_timeout_s=%.1f). Thread stacks "
            "recorded to telemetry; nudging the pipeline.",
            hung_for, self.hang_timeout_s)
        nudge = getattr(self._pool, "nudge", None)
        if nudge is not None:
            nudge()
        if self._ventilator is not None and hasattr(self._ventilator, "nudge"):
            self._ventilator.nudge()

    def _cancel_or_kill(self) -> None:
        killed = []
        if (self._recovery is not None
                and hasattr(self._pool, "kill_worker")):
            # Process pool with crash recovery: every worker holding an
            # outstanding claim in a globally-stalled pipeline is stuck on
            # its item — kill them; recovery re-ventilates its items.
            stuck = (self._recovery.claimed_workers()
                     - self._recovery.dead_workers)
            for wid in sorted(stuck):
                if self._pool.kill_worker(wid):
                    killed.append(wid)
                    if self._kills is not None:
                        self._kills.add(1)
        if killed:
            logger.warning("Watchdog killed stuck worker(s) %s; crash "
                           "recovery will re-ventilate their items", killed)
            return
        if self._token is not None:
            logger.warning("Watchdog requesting cooperative cancellation of "
                           "in-flight attempts")
            self._token.request("pipeline hang: no progress for "
                                f">{self.hang_timeout_s}s")

    def _abort(self, hung_for: float) -> None:
        self._aborted = True
        if self._aborts is not None:
            self._aborts.add(1)
        err = PipelineHungError(
            f"Input pipeline made no progress for {hung_for:.1f}s "
            f"(hang_timeout_s={self.hang_timeout_s}) and did not recover "
            f"after nudge/cancel escalation. Thread stacks were recorded "
            f"to the telemetry registry (resilience.watchdog.stack_dump).")
        logger.error("%s", err)
        if self.on_abort is not None:
            try:
                self.on_abort(err)
            except Exception:  # noqa: BLE001 - the abort must still happen
                logger.exception("watchdog on_abort hook failed")
        abort = getattr(self._pool, "abort", None)
        if abort is not None:
            abort(err)
