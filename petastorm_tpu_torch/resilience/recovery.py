"""Worker-crash recovery for the process pool (the JAX package's
``resilience/recovery.py``).

A spawned decode worker can die hard (OOM kill, segfault in a native
decoder, a ``worker_kill`` fault). Without recovery the pool turns any dead
PID into a fatal ``RuntimeError``. With a crash budget
(``worker_crash_budget=N`` on the reader), the pool instead re-ventilates
the dead worker's lost row groups onto the surviving workers and the epoch
completes losslessly.

:class:`WorkerCrashRecovery` is the ledger of who owns which in-flight
item. The pool sends each item down one worker's own pipe, so it knows
every item's owner when it sends it: the item at the head of a worker's
queue is *claimed* by that worker (:meth:`~WorkerCrashRecovery.on_started`),
the one it is working on. On a death the pool hands the ledger the contexts
still queued behind it (``on_worker_death(..., queued=...)``); the claimed
item and those queued are lost with the worker, and come back at once to
be re-ventilated. No claim frame crosses the ring, and no sweep waits for
the pool to quiet.

Delivery semantics are the JAX package's: a worker killed before publishing
its claimed item (the ``worker_kill`` fault site fires before processing,
and real OOM/segfault deaths overwhelmingly land inside load/decode)
re-ventilates it exactly once — data precedes the processed marker on the
same FIFO ring, and the pool acts on a death only once the dead worker's
ring is drained, so a claimed-but-unmarked item was never half-delivered.
A crash landing in the narrow window *between* the data publish and the
processed marker delivers that row group twice: recovery is at-least-once
in the worst case, never lossy. Epochs that must be duplicate-proof under
arbitrary mid-publish crashes should dedup on a sample key downstream.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

__all__ = ["CrashBudgetExceededError", "ItemStartedMessage",
           "WorkerCrashRecovery"]


class CrashBudgetExceededError(RuntimeError):
    """More workers died than ``worker_crash_budget`` tolerates."""


class ItemStartedMessage:
    """Worker -> pool control frame of the JAX package's claim protocol:
    ``worker_id`` claimed ``item_context`` and is about to process it. This
    package's pool claims from its own routing and sends none; the class
    stays in the public API that both packages export."""

    def __init__(self, worker_id: int, item_context):
        self.worker_id = worker_id
        self.item_context = item_context


class WorkerCrashRecovery:
    """Consumer-side ledger of in-flight work ownership.

    The pool feeds it ventilation/claim/processed events; on a worker death
    it returns the work items to re-ventilate. Thread-safe: the pool's poll
    loop and ``ventilate`` may run on different threads (the ventilator
    thread calls ``ventilate``).
    """

    def __init__(self, budget: int, telemetry=None):
        self.budget = budget
        self.crashes = 0
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple, tuple] = {}   # ctx -> (args, kwargs)
        self._claims: Dict[Tuple, int] = {}       # ctx -> worker_id
        self._dead: set = set()
        self._crash_counter = (telemetry.counter("resilience.worker_crashes")
                               if telemetry is not None else None)
        self._revent_counter = (
            telemetry.counter("resilience.reventilated_items")
            if telemetry is not None else None)

    # ------------------------------------------------------------- bookkeeping
    def on_ventilated(self, ctx, item) -> None:
        """``ctx`` is the ventilator's (epoch, position); items without one
        (bare pool use) cannot be tracked and are skipped."""
        if ctx is None:
            return
        with self._lock:
            self._inflight[ctx] = item

    def on_started(self, worker_id: int, ctx) -> None:
        if ctx is None:
            return
        with self._lock:
            self._claims[ctx] = worker_id

    def on_processed(self, ctx) -> None:
        if ctx is None:
            return
        with self._lock:
            self._claims.pop(ctx, None)
            self._inflight.pop(ctx, None)

    # ------------------------------------------------------------------ crash
    def on_worker_death(self, worker_id: int, exit_code,
                        queued=()) -> List[tuple]:
        """Record one crash; returns the items the dead worker had claimed
        (to re-ventilate now), then those of ``queued``, the contexts a pool
        that routes each item to one worker knows were sent to this one and
        not started. Raises :class:`CrashBudgetExceededError` when the
        budget is spent."""
        with self._lock:
            if worker_id in self._dead:
                return []
            self._dead.add(worker_id)
            self.crashes += 1
            if self.crashes > self.budget:
                raise CrashBudgetExceededError(
                    f"{self.crashes} worker crash(es) exceed "
                    f"worker_crash_budget={self.budget} "
                    f"(last: worker {worker_id}, exit code {exit_code})")
            lost = [ctx for ctx, wid in self._claims.items()
                    if wid == worker_id]
            lost += [ctx for ctx in queued
                     if ctx not in self._claims and ctx not in lost]
            items = []
            for ctx in lost:
                self._claims.pop(ctx, None)
                item = self._inflight.get(ctx)
                if item is not None:
                    items.append(item)
        if self._crash_counter is not None:
            self._crash_counter.add(1)
            if items:
                self._revent_counter.add(len(items))
        return items

    def claimed_workers(self) -> set:
        """Worker ids currently holding an outstanding (claimed, not yet
        processed) item. In a globally-stalled pipeline these are exactly
        the stuck workers — the watchdog's kill-escalation target set."""
        with self._lock:
            return set(self._claims.values())

    @property
    def dead_workers(self) -> set:
        with self._lock:
            return set(self._dead)
