"""Row-group quarantine: retry, then (opt-in) skip-and-record instead of
killing the epoch.

Worker side, a :class:`RowGroupGuard` wraps each work item's load+decode:
transient failures retry per the :class:`~petastorm_tpu_torch.resilience.policy
.RetryPolicy`; when retries exhaust (or the failure is permanent — corrupt
bytes, missing file) the guard either propagates (``degraded_mode=False``,
today's fail-fast behavior) or raises :class:`RowGroupSkipped` carrying a
:class:`QuarantineRecord` with full provenance (``degraded_mode=True``).

The worker pools translate :class:`RowGroupSkipped` into a
:class:`RowGroupSkippedMessage` on the results stream (picklable, so it
crosses the process-pool boundary like any control message) and feed it to
the consumer-side :class:`RowGroupQuarantine` aggregator the Reader owns —
``Reader.quarantine_report()`` then names every skipped piece, its
exception, and how many attempts were burned on it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

from petastorm_tpu_torch.resilience.policy import RetryPolicy, DEFAULT_READ_POLICY

__all__ = ["QuarantineRecord", "RowGroupSkipped", "RowGroupSkippedMessage",
           "RowGroupQuarantine", "RowGroupGuard"]


@dataclasses.dataclass
class QuarantineRecord:
    """Provenance of one skipped row group (picklable; crosses pools).

    ``state`` is ``quarantined`` for the read path's skip. The JAX
    package's live-data plane also records ``pending_retry`` and
    ``admitted_after_retry``; the field keeps its schema."""

    path: str
    row_group: object            # ordinal or tuple of ordinals (coalesced)
    error_type: str
    error_message: str
    attempts: int
    worker_id: Optional[int] = None
    injected: bool = False       # fault-plan-injected vs real failure
    wall_time: float = 0.0       # unix seconds, provenance only
    state: str = "quarantined"   # | "pending_retry" | "admitted_after_retry"

    @property
    def piece(self) -> str:
        """Human-readable piece id: ``path#row_group``."""
        return f"{self.path}#{self.row_group}"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["piece"] = self.piece
        return d


class RowGroupSkipped(Exception):
    """Raised by a worker's guard in degraded mode: the pool converts it to
    a :class:`RowGroupSkippedMessage` and a processed marker — the item is
    complete, its data is not coming."""

    def __init__(self, record: QuarantineRecord):
        super().__init__(record.piece)
        self.record = record


class RowGroupSkippedMessage:
    """Worker -> pool control message carrying one quarantine record."""

    def __init__(self, record: QuarantineRecord):
        self.record = record


class RowGroupQuarantine:
    """Consumer-side aggregator; thread-safe (pool readout threads and the
    consumer may both touch it). One per Reader."""

    def __init__(self, telemetry=None):
        self._lock = threading.Lock()
        self._records: List[QuarantineRecord] = []
        self._counter = (telemetry.counter("resilience.quarantined_rowgroups")
                         if telemetry is not None else None)

    def add(self, record: QuarantineRecord) -> None:
        with self._lock:
            self._records.append(record)
        if self._counter is not None:
            self._counter.add(1)

    @property
    def records(self) -> List[QuarantineRecord]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def paths(self) -> List[str]:
        return sorted({r.path for r in self.records})

    def mark_admitted(self, path: str) -> int:
        """Flip every ``pending_retry`` record for ``path`` to
        ``admitted_after_retry`` (the JAX package's live-data resolution,
        kept so the aggregator's API is that package's). Returns how many
        records flipped; the records stay in the report."""
        flipped = 0
        with self._lock:
            for r in self._records:
                if r.path == path and r.state == "pending_retry":
                    r.state = "admitted_after_retry"
                    flipped += 1
        return flipped

    def report(self) -> dict:
        """Queryable summary (JSON-safe): count, skipped pieces with full
        provenance, per-error-type and per-state tallies."""
        records = self.records
        by_error: dict = {}
        by_state: dict = {}
        for r in records:
            by_error[r.error_type] = by_error.get(r.error_type, 0) + 1
            by_state[r.state] = by_state.get(r.state, 0) + 1
        return {"quarantined": len(records),
                "by_error_type": dict(sorted(by_error.items())),
                "by_state": dict(sorted(by_state.items())),
                "pieces": [r.as_dict() for r in records]}


class RowGroupGuard:
    """Worker-side failure boundary around one work item's load+decode.

    ``run(fn, rowgroup)`` executes ``fn`` under the retry policy; every
    retry bumps ``resilience.retries_total`` (when a telemetry registry is
    reachable — in-process pools only) and invokes ``on_retry`` (handle
    eviction). On give-up: ``degraded_mode`` decides between propagating
    and raising :class:`RowGroupSkipped`.
    """

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 degraded_mode: bool = False, worker_id: Optional[int] = None,
                 telemetry=None):
        self.policy = policy if policy is not None else DEFAULT_READ_POLICY
        self.degraded_mode = degraded_mode
        self.worker_id = worker_id
        self._retries = (telemetry.counter("resilience.retries_total")
                         if telemetry is not None else None)
        self._gave_up = (telemetry.counter("resilience.giveups_total")
                         if telemetry is not None else None)

    def run(self, fn, rowgroup, on_retry=None):
        attempts = {"n": 1}

        def _on_retry(attempt, exc, delay):
            attempts["n"] = attempt + 1
            if self._retries is not None:
                self._retries.add(1)
            if on_retry is not None:
                on_retry(attempt, exc, delay)

        try:
            return self.policy.call(fn, on_retry=_on_retry)
        except RowGroupSkipped:
            raise  # already a skip decision (nested guards)
        except Exception as e:  # noqa: BLE001 - policy already classified
            if self._gave_up is not None:
                self._gave_up.add(1)
            if not self.degraded_mode:
                raise
            from petastorm_tpu_torch.resilience.faults import InjectedFault
            record = QuarantineRecord(
                path=str(getattr(rowgroup, "path", rowgroup)),
                row_group=getattr(rowgroup, "row_group", None),
                error_type=type(e).__name__,
                error_message=str(e)[:500],
                attempts=attempts["n"],
                worker_id=self.worker_id,
                injected=isinstance(e, InjectedFault),
                wall_time=time.time())  # wall-clock-ok: provenance timestamp
            raise RowGroupSkipped(record) from e
