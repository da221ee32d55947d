"""DatasetWatcher: discovery as a stage of the pipeline (the JAX package's
``discovery/watcher.py``, less its data-quality admission scorer).

It lists the store again (between epochs, or from a background thread),
diffs the listing against the current
:class:`~petastorm_tpu_torch.discovery.snapshot.DatasetSnapshot`, checks
every new file through the admission states
(:mod:`~petastorm_tpu_torch.discovery.admission`) and stages the admitted
ones for the reader to fold into its plan at a safe point.

* Listings go through
  :func:`~petastorm_tpu_torch.discovery.listing.list_data_files` (retried,
  fault site ``discovery.list``, bounded by a deadline).
* A poll whose listing fails after its retries keeps the last good
  snapshot: the failure is counted, recorded as an event and tried again
  at the next poll.
* A torn new footer waits ``pending_retry`` and is read again every poll;
  an incompatible schema drift is refused loudly while serving goes on.

Telemetry (``discovery.*``): the counters ``files_discovered``,
``files_admitted``, ``files_quarantined``, ``files_refused``,
``rowgroups_admitted``, ``schema_drift_total``, ``polls_total``; the
gauges ``files_pending``, ``snapshot_age_s`` (since the last good poll),
``ingest_lag_s`` (now less the newest admitted file's mtime) and
``max_admission_lag_s`` (the most any admitted file waited between its
mtime and its admission: the producer's cadence left out); the listing's
``list_s``, ``list_retries_total`` and ``list_failures_total``.
"""
from __future__ import annotations

import logging
import threading
import time
import warnings
from typing import Dict, List, Optional

from petastorm_tpu_torch.discovery.admission import (DRIFT_COMPATIBLE, DRIFT_INCOMPATIBLE,
                                                     STATE_ADMITTED, STATE_PENDING,
                                                     STATE_REFUSED, AdmittedFile, FileAdmission,
                                                     classify_schema_drift, read_new_file_footer)
from petastorm_tpu_torch.discovery.listing import list_data_files
from petastorm_tpu_torch.discovery.snapshot import DatasetSnapshot

logger = logging.getLogger(__name__)

__all__ = ["DatasetWatcher"]


class DatasetWatcher:
    """Incremental file discovery over one dataset root.

    :param ctx: the reader's
        :class:`~petastorm_tpu_torch.etl.dataset_metadata.DatasetContext`
    :param base_snapshot: the files already in the plan
    :param reference_schema: the dataset's Arrow schema, against which new
        files are classified (``None``: no drift check)
    :param poll_interval_s: the background poll's period; ``None`` or 0: no
        thread, polls run only when :meth:`poll_once` is called
    :param retry_policy: the listing's retry policy (default: the listing
        module's)
    :param deadline: a per-attempt ``StageDeadline`` on the listings
    :param fault_plan: a ``FaultPlan``; ``discovery.list`` and
        ``discovery.footer`` fire here
    :param telemetry: the pipeline's registry (``discovery.*``)
    :param quarantine: the reader's ``RowGroupQuarantine``, where torn new
        files wait ``pending_retry``
    :param stats_columns: the columns whose per-group statistics the
        admitting footer read harvests (the pruner's)
    """

    def __init__(self, ctx, *, base_snapshot: DatasetSnapshot, reference_schema=None,
                 poll_interval_s: Optional[float] = None, retry_policy=None, deadline=None,
                 fault_plan=None, telemetry=None, quarantine=None, stats_columns=()):
        self._ctx = ctx
        self._reference_schema = reference_schema
        self._poll_interval_s = float(poll_interval_s) if poll_interval_s else None
        self._retry_policy = retry_policy
        self._deadline = deadline
        self._fault_plan = fault_plan
        self._telemetry = telemetry
        self._quarantine = quarantine
        self._stats_columns = tuple(stats_columns)

        self._lock = threading.Lock()
        #: One discovery pass at a time: the background thread and a
        #: consumer's ``refresh_dataset()`` could otherwise admit one new
        #: file twice.
        self._poll_lock = threading.Lock()
        self._snapshot = base_snapshot
        self._pending: Dict[str, FileAdmission] = {}
        self._refused: Dict[str, FileAdmission] = {}
        #: Admitted files staged for the plan, in admission order.
        self._staged: List[AdmittedFile] = []
        #: Read without the lock by the reader before each pull.
        self.has_growth = False

        self._polls = 0
        self._failed_polls = 0
        self._last_poll_mono: Optional[float] = None
        self._newest_admitted_mtime = 0.0
        self._max_admission_lag_s = 0.0
        self._admission_log: List[dict] = []

        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self._c_discovered = self._c_admitted = self._c_quarantined = self._c_refused = \
            self._c_groups = self._c_drift = self._c_polls = None
        if telemetry is not None:
            self._c_discovered = telemetry.counter("discovery.files_discovered")
            self._c_admitted = telemetry.counter("discovery.files_admitted")
            self._c_quarantined = telemetry.counter("discovery.files_quarantined")
            self._c_refused = telemetry.counter("discovery.files_refused")
            self._c_groups = telemetry.counter("discovery.rowgroups_admitted")
            self._c_drift = telemetry.counter("discovery.schema_drift_total")
            self._c_polls = telemetry.counter("discovery.polls_total")
            telemetry.gauge("discovery.files_pending", lambda: float(len(self._pending)))
            telemetry.gauge("discovery.snapshot_age_s", self._snapshot_age_s)
            telemetry.gauge("discovery.ingest_lag_s", self._ingest_lag_s)
            telemetry.gauge("discovery.max_admission_lag_s",
                            lambda: self._max_admission_lag_s)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "DatasetWatcher":
        """Start the background poll thread (needs ``poll_interval_s``)."""
        if self._poll_interval_s is None:
            raise ValueError("start() needs poll_interval_s > 0; epoch-boundary mode calls "
                             "poll_once() instead")
        if self._thread is None:
            self._thread = threading.Thread(target=self._poll_loop, name="pt-discovery",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _poll_loop(self) -> None:
        while not self._stop_event.wait(self._poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the watcher outlives a failed poll
                logger.warning("discovery poll failed; keeping the last good snapshot",
                               exc_info=True)

    # --------------------------------------------------------------- gauges
    def _snapshot_age_s(self) -> float:
        if self._last_poll_mono is None:
            return 0.0
        return time.monotonic() - self._last_poll_mono

    def _ingest_lag_s(self) -> float:
        if not self._newest_admitted_mtime:
            return 0.0
        # Both ends are wall clock by nature: the lag is now less an mtime.
        return max(0.0, time.time() - self._newest_admitted_mtime)

    # ----------------------------------------------------------------- poll
    def poll_once(self) -> dict:
        """One pass: list, diff, check. Returns a summary. A listing that
        fails after its retries is reported in the summary (``ok`` False)
        and the last good snapshot stays; unreadable new files wait
        ``pending_retry``."""
        with self._poll_lock:
            return self._poll_once_locked()

    def _poll_once_locked(self) -> dict:
        if self._c_polls is not None:
            self._c_polls.add(1)
        with self._lock:
            self._polls += 1
        try:
            listed = list_data_files(self._ctx.filesystem, self._ctx.root_path,
                                     retry_policy=self._retry_policy, deadline=self._deadline,
                                     fault_plan=self._fault_plan, telemetry=self._telemetry)
        except Exception as e:  # noqa: BLE001 - degrade, do not interrupt serving
            with self._lock:
                self._failed_polls += 1
            if self._telemetry is not None:
                self._telemetry.record_event("discovery.list_failed", {"error": repr(e)[:200]})
            logger.warning("dataset listing failed after retries (%r); keeping the last good "
                           "snapshot", e)
            return {"ok": False, "error": repr(e)}
        self._last_poll_mono = time.monotonic()

        with self._lock:
            known = set(self._snapshot.paths)
            known.update(a.path for a in self._staged)
            pending_now = list(self._pending.values())
            refused_now = dict(self._refused)
        new_paths = [p for p in listed
                     if p not in known and p not in self._pending and p not in refused_now]
        summary = {"ok": True, "listed": len(listed), "new": len(new_paths), "admitted": 0,
                   "pending": 0, "refused": 0}
        now_wall = time.time()
        for path in new_paths:
            if self._c_discovered is not None:
                self._c_discovered.add(1)
            self._validate(FileAdmission(path=path, first_seen_wall=now_wall), summary)
        for adm in pending_now:
            self._validate(adm, summary)
        # A refused file is read again only when its bytes changed.
        for path, adm in refused_now.items():
            info = self._safe_info(path)
            if info is not None and info != (adm.size, adm.mtime):
                with self._lock:
                    self._refused.pop(path, None)
                self._validate(adm, summary)
        with self._lock:
            summary["pending_total"] = len(self._pending)
            summary["staged_total"] = len(self._staged)
        return summary

    def _safe_info(self, path: str):
        try:
            info = self._ctx.filesystem.info(path)
            return int(info.get("size", -1)), float(info.get("mtime", 0.0))
        except (OSError, ValueError, KeyError):
            return None

    def _validate(self, adm: FileAdmission, summary: dict) -> None:
        adm.attempts += 1
        adm.last_checked_wall = time.time()
        info = self._safe_info(adm.path)
        if info is not None:
            adm.size, adm.mtime = info
        try:
            n_groups, schema, stats = read_new_file_footer(
                self._ctx.filesystem, adm.path, stats_columns=self._stats_columns,
                fault_plan=self._fault_plan)
        except (OSError, ValueError) as e:
            # A file being written reads like a corrupt one: it waits and is
            # read again at the next poll.
            first_time = adm.state != STATE_PENDING or adm.attempts == 1
            adm.state = STATE_PENDING
            adm.detail = repr(e)[:300]
            with self._lock:
                self._pending[adm.path] = adm
            if first_time:
                if self._c_quarantined is not None:
                    self._c_quarantined.add(1)
                self._record_quarantine(adm, e)
            summary["pending"] += 1
            return

        if self._reference_schema is not None:
            drift, detail = classify_schema_drift(self._reference_schema, schema)
        else:
            drift, detail = "identical", ""
        adm.drift, adm.num_row_groups = drift, n_groups
        if drift == DRIFT_INCOMPATIBLE:
            adm.state = STATE_REFUSED
            adm.detail = detail
            with self._lock:
                self._pending.pop(adm.path, None)
                self._refused[adm.path] = adm
            if self._c_refused is not None:
                self._c_refused.add(1)
            if self._c_drift is not None:
                self._c_drift.add(1)
            if self._telemetry is not None:
                self._telemetry.record_event("discovery.schema_refused",
                                             {"path": adm.path, "detail": detail[:200]})
            warnings.warn(f"live discovery refused {adm.path}: incompatible schema drift "
                          f"({detail}). The reader continues on the last good snapshot; fix "
                          f"the producer")
            logger.error("discovery refused %s: %s", adm.path, detail)
            summary["refused"] += 1
            return

        was_pending = adm.state == STATE_PENDING and adm.attempts > 1
        adm.state = STATE_ADMITTED
        adm.detail = detail
        staged = AdmittedFile(path=adm.path, num_row_groups=n_groups, mtime=adm.mtime,
                              size=adm.size, drift=drift, detail=detail, stats=stats)
        now_wall = time.time()
        with self._lock:
            self._pending.pop(adm.path, None)
            self._staged.append(staged)
            self.has_growth = True
            if adm.mtime:
                self._newest_admitted_mtime = max(self._newest_admitted_mtime, adm.mtime)
                self._max_admission_lag_s = max(self._max_admission_lag_s,
                                                max(0.0, now_wall - adm.mtime))
            self._admission_log.append({"path": adm.path, "row_groups": n_groups,
                                        "drift": drift, "attempts": adm.attempts,
                                        "wall_time": now_wall})
        if self._c_admitted is not None:
            self._c_admitted.add(1)
        if self._c_groups is not None:
            self._c_groups.add(n_groups)
        if drift == DRIFT_COMPATIBLE:
            if self._c_drift is not None:
                self._c_drift.add(1)
            warnings.warn(f"live discovery admitted {adm.path} with compatible schema drift "
                          f"({detail}); readers project their planned columns, but mixed-file "
                          f"schemas deserve a look")
        if was_pending and self._quarantine is not None:
            self._quarantine.mark_admitted(adm.path)
        if self._telemetry is not None:
            self._telemetry.record_event("discovery.file_admitted",
                                         {"path": adm.path, "row_groups": n_groups,
                                          "drift": drift, "attempts": adm.attempts})
        summary["admitted"] += 1

    def _record_quarantine(self, adm: FileAdmission, exc: Exception) -> None:
        if self._quarantine is None:
            return
        from petastorm_tpu_torch.resilience.faults import InjectedFault
        from petastorm_tpu_torch.resilience.quarantine import QuarantineRecord
        self._quarantine.add(QuarantineRecord(
            path=adm.path, row_group=None, error_type=type(exc).__name__,
            error_message=str(exc)[:500], attempts=adm.attempts,
            injected=isinstance(exc, InjectedFault), state=STATE_PENDING,
            wall_time=adm.last_checked_wall))

    # ------------------------------------------------------------- draining
    def drain_staged(self) -> List[AdmittedFile]:
        """Take every staged file (admission order) and advance the snapshot
        over them, in one step; the reader extends its plan with them."""
        with self._lock:
            staged, self._staged = self._staged, []
            self.has_growth = False
            if staged:
                self._snapshot = self._snapshot.extended(
                    [(a.path, a.num_row_groups, a.mtime, a.size) for a in staged])
        return staged

    @property
    def snapshot(self) -> DatasetSnapshot:
        with self._lock:
            return self._snapshot

    def report(self) -> dict:
        """The admission state, JSON-safe (the JAX watcher's keys)."""
        with self._lock:
            return {
                "polls": self._polls,
                "failed_polls": self._failed_polls,
                "snapshot_id": self._snapshot.snapshot_id,
                "files_known": len(self._snapshot),
                "row_groups_known": self._snapshot.total_row_groups,
                "staged": [a.path for a in self._staged],
                "pending": [a.as_dict() for a in self._pending.values()],
                "refused": [a.as_dict() for a in self._refused.values()],
                "admissions": list(self._admission_log),
                "snapshot_age_s": round(self._snapshot_age_s(), 3),
                "ingest_lag_s": round(self._ingest_lag_s(), 3),
                "max_admission_lag_s": round(self._max_admission_lag_s, 3),
            }
