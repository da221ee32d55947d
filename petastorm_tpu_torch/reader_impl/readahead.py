"""Row-group readahead: Parquet reads ahead of the decode workers.

Without it a decode worker blocks on the filesystem before it decodes a
cell. A :class:`ReadaheadFetcher` is a few fetcher threads fed in
ventilation order (the reader's ventilate wrapper calls :meth:`submit`):
each reads a whole row group, every column a worker may ask for, in one
``read_row_group`` call, and keeps the Arrow table until a worker pops it
(:meth:`pop`) and slices its columns with no IO.

* **Depth**: at most ``depth`` groups ahead (ready or in flight), a live
  knob (:meth:`set_readahead_depth`, the autotune controller's
  ``readahead_depth``).
* **Bytes**: fetched tables are charged to a :class:`MemoryBudget` (the
  reader's shared one when it has one); fetchers wait while it is spent.
* **Submissions**: at most ``max_queue`` wait to be fetched; one past it
  is dropped and its item reads inline. A pop that finds its group still
  queued claims it back (the inline read wins) and the fetchers skip it.
* **Errors**: a failed fetch is discarded and counted
  (``io.readahead.fetch_errors``), never kept: the worker's inline read
  retries under its guard and owns the quarantine, so readahead neither
  loses nor repeats a group, and spends no retry.
* **Faults**: fetches consult the fault plan's ``rowgroup.read`` site
  under worker ids ``FETCHER_WORKER_ID_BASE + index``, so a spec pinned to
  a worker never fires here and the seeded streams differ from the
  workers'.
* **Hedging**: with a hedge policy each fetch is a hedged read through a
  :class:`~petastorm_tpu_torch.resilience.HedgedReadExecutor`.

Telemetry (the reader's registry): ``io.readahead.hits`` / ``misses`` /
``fetch_errors`` / ``fetched_total`` / ``submit_dropped`` counters, the
seconds counter ``io.readahead.fetch_s`` (the critical-path attributor's
"fetch" edge), the ``io.readahead.depth`` / ``bytes_in_flight`` /
``ahead`` gauges, and the ``io.bytes_read`` / ``io.rowgroups_read``
counters the inline reads feed too. In trace mode each fetch records a
``petastorm_tpu.fetch`` span on track ``fetch:{index}`` with the item's
lineage id.

In-process pools only: a spawned worker cannot pop from this process, so
the process pool ignores readahead with a warning. Every wait polls with
a timeout (:data:`_WAIT_POLL_S`): a wedged fetch is the watchdog's to
find.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)

#: Seconds of each bounded wait on the fetcher's condition.
_WAIT_POLL_S = 0.05

#: Fault-plan worker id of fetcher 0 (fetcher i is this plus i).
FETCHER_WORKER_ID_BASE = 1000


def rowgroup_key(rowgroup) -> tuple:
    """The store key of one ventilated row group."""
    return (rowgroup.path, rowgroup.row_group)


class ReadaheadFetcher:
    """:param filesystem: the filesystem the store is read through
    :param columns: every column a worker may ask for; one fetch reads them
        all
    :param depth: the most groups ahead (ready or in flight), >= 1
    :param fetchers: fetcher threads (default ``min(2, depth)``)
    :param budget: a :class:`MemoryBudget` charged per fetched table (with
        ``force=True``: the bytes exist once read); fetchers wait while it
        is spent
    :param fault_plan: consulted at ``rowgroup.read``
    :param hedge_policy: makes each fetch a hedged read
    :param telemetry: the reader's registry
    :param max_queue: the most submissions waiting to be fetched (default
        ``max(16, 4 * depth)``)
    """

    def __init__(self, filesystem, columns, depth: int = 4, fetchers: Optional[int] = None,
                 budget=None, fault_plan=None, hedge_policy=None, telemetry=None,
                 max_queue: Optional[int] = None):
        if depth < 1:
            raise ValueError(f"readahead depth must be >= 1, got {depth}")
        self._fs = filesystem
        self._columns = sorted(columns)
        self._depth = int(depth)
        self._fetchers_count = max(1, int(fetchers) if fetchers is not None else min(2, depth))
        self._max_queue = int(max_queue) if max_queue is not None else max(16, 4 * self._depth)
        self.budget = budget
        self._fault_plan = fault_plan
        self._hedge_policy = hedge_policy
        self._telemetry = telemetry

        self._cv = threading.Condition()
        self._queue: deque = deque()   # (key, rowgroup, trace) awaiting a fetch
        self._queued: dict = {}        # key -> its entries in the queue
        self._claimed: dict = {}       # key -> entries an inline read claimed back
        self._inflight: dict = {}      # key -> fetches under way
        self._ready: dict = {}         # key -> deque of (table, nbytes)
        self._ahead = 0                # ready tables + fetches under way
        self._bytes = 0                # bytes of the ready tables
        self._stop = threading.Event()
        self._threads: list = []
        self._local = threading.local()

        self._counters = self._fetch_s = self._bytes_read = self._rowgroups_read = None
        if telemetry is not None:
            self._counters = {name: telemetry.counter(f"io.readahead.{name}")
                              for name in ("hits", "misses", "fetch_errors", "fetched_total",
                                           "submit_dropped")}
            self._fetch_s = telemetry.counter("io.readahead.fetch_s")
            self._bytes_read = telemetry.counter("io.bytes_read")
            self._rowgroups_read = telemetry.counter("io.rowgroups_read")
            telemetry.gauge("io.readahead.depth", lambda: self._depth)
            telemetry.gauge("io.readahead.bytes_in_flight", lambda: self._bytes)
            telemetry.gauge("io.readahead.ahead", lambda: self._ahead)
        #: The counts, also without a registry.
        self.local_stats = {"hits": 0, "misses": 0, "fetch_errors": 0, "fetched_total": 0,
                            "submit_dropped": 0}

    def _count(self, name: str) -> None:
        self.local_stats[name] += 1
        if self._counters is not None:
            self._counters[name].add(1)

    def start(self) -> "ReadaheadFetcher":
        if self._threads:
            return self
        for i in range(self._fetchers_count):
            t = threading.Thread(target=self._fetch_loop, args=(i,), name=f"pt-readahead-{i}",
                                 daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def submit(self, rowgroup, trace: Optional[str] = None) -> None:
        """Announce one ventilated item (never blocks). ``trace`` is its
        lineage id, which the fetch span carries."""
        with self._cv:
            if len(self._queue) >= self._max_queue:
                self._count("submit_dropped")
                return
            key = rowgroup_key(rowgroup)
            self._queue.append((key, rowgroup, trace))
            self._queued[key] = self._queued.get(key, 0) + 1
            self._cv.notify_all()

    def pop(self, rowgroup, checkpoint=None):
        """The fetched table of this item, or None (a miss: read inline). A
        queued fetch is claimed back; one under way is awaited in bounded
        polls, with ``checkpoint()`` between them so a stage deadline or the
        watchdog's cancel reaches the wait."""
        key = rowgroup_key(rowgroup)
        while True:
            with self._cv:
                dq = self._ready.get(key)
                if dq:
                    table, nbytes = dq.popleft()
                    if not dq:
                        del self._ready[key]
                    self._ahead -= 1
                    self._bytes -= nbytes
                    if self.budget is not None:
                        self.budget.release(nbytes)
                    self._cv.notify_all()
                    self._count("hits")
                    return table
                if not self._inflight.get(key):
                    if self._queued.get(key, 0) > self._claimed.get(key, 0):
                        self._claimed[key] = self._claimed.get(key, 0) + 1
                    self._count("misses")
                    return None
                self._cv.wait(_WAIT_POLL_S)
            if checkpoint is not None:
                checkpoint()
            if self._stop.is_set():
                self._count("misses")
                return None

    def set_readahead_depth(self, n: int) -> None:
        """The depth as a live knob (``tools/check_knobs.py`` checks that
        only :mod:`petastorm_tpu_torch.autotune` calls it), at least 1. A
        depth below the tables held pauses fetching until workers drain
        them; no table is dropped."""
        with self._cv:
            self._depth = max(1, int(n))
            self._cv.notify_all()

    @property
    def depth(self) -> int:
        with self._cv:
            return self._depth

    def stats(self) -> dict:
        """Depth, fetchers, tables ahead, bytes held, submissions queued,
        the counts, and the stage's provenance (``stage: "fetch"`` and its
        tracks ``fetch:{index}``, the names traces show)."""
        with self._cv:
            return {"depth": self._depth, "fetchers": self._fetchers_count,
                    "ahead": self._ahead, "bytes_in_flight": self._bytes,
                    "queued": len(self._queue),
                    "provenance": {"stage": "fetch",
                                   "tracks": [f"fetch:{i}" for i in range(self._fetchers_count)]},
                    **dict(self.local_stats)}

    def close(self) -> None:
        """Stop the fetchers (bounded joins) and drop every held table,
        releasing its charge."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        with self._cv:
            self._queue.clear()
            self._queued.clear()
            self._claimed.clear()
            for dq in self._ready.values():
                for _table, nbytes in dq:
                    self._bytes -= nbytes
                    if self.budget is not None:
                        self.budget.release(nbytes)
            self._ready.clear()
            self._ahead = 0

    def _admissible(self) -> bool:
        """May another fetch start now? (Under the lock.)"""
        if self._ahead >= self._depth:
            return False
        return self.budget is None or self.budget.available > 0

    def _next_request(self):
        """The next unclaimed ``(key, rowgroup, trace)``, dropping entries
        an inline read claimed back; None when none is left. (Under the
        lock.)"""
        while self._queue:
            key, rowgroup, trace = self._queue.popleft()
            n = self._queued.get(key, 1) - 1
            if n:
                self._queued[key] = n
            else:
                self._queued.pop(key, None)
            c = self._claimed.get(key, 0)
            if c:
                if c == 1:
                    del self._claimed[key]
                else:
                    self._claimed[key] = c - 1
                continue
            return key, rowgroup, trace
        return None

    def _fetch_loop(self, idx: int) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._stop.is_set() and not (self._queue and self._admissible()):
                    self._cv.wait(_WAIT_POLL_S)
                if self._stop.is_set():
                    return
                request = self._next_request()
                if request is None:
                    continue
                key, rowgroup, trace = request
                self._inflight[key] = self._inflight.get(key, 0) + 1
                self._ahead += 1
            table = None
            t0 = time.perf_counter()
            try:
                if self._telemetry is not None:
                    with self._telemetry.span("petastorm_tpu.fetch", trace=trace, stage="fetch",
                                              track=f"fetch:{idx}"):
                        table = self._fetch(rowgroup, idx)
                else:
                    table = self._fetch(rowgroup, idx)
            except Exception as e:  # noqa: BLE001 - the inline read owns the retries
                self._count("fetch_errors")
                logger.debug("readahead fetch of %s failed (the inline read retries): %s", key, e)
            if self._fetch_s is not None:
                self._fetch_s.add(time.perf_counter() - t0)
            nbytes = int(table.nbytes) if table is not None else 0
            with self._cv:
                self._inflight[key] -= 1
                if not self._inflight[key]:
                    del self._inflight[key]
                if table is None or self._stop.is_set():
                    self._ahead -= 1
                else:
                    self._ready.setdefault(key, deque()).append((table, nbytes))
                    self._bytes += nbytes
                    if self.budget is not None:
                        self.budget.reserve(nbytes, force=True)
                    self._count("fetched_total")
                    if self._bytes_read is not None:
                        self._bytes_read.add(nbytes)
                        self._rowgroups_read.add(1)
                self._cv.notify_all()

    def _thread_state(self, idx: int) -> dict:
        """This fetcher thread's handles (and hedger): fetchers share no
        open file."""
        state = getattr(self._local, "state", None)
        if state is None:
            from petastorm_tpu_torch.reader_impl.row_reader_worker import (_HedgeHandlePool,
                                                                           _ParquetFileLRU)
            hedger = None
            if self._hedge_policy is not None:
                from petastorm_tpu_torch.resilience import HedgedReadExecutor
                hedger = HedgedReadExecutor(self._hedge_policy, telemetry=self._telemetry,
                                            worker_id=FETCHER_WORKER_ID_BASE + idx)
            state = self._local.state = {"files": _ParquetFileLRU(self._fs),
                                         "pool": _HedgeHandlePool(self._fs), "hedger": hedger}
        return state

    def _fetch(self, rowgroup, idx: int):
        from petastorm_tpu_torch.reader_impl.row_reader_worker import _read_row_group
        state = self._thread_state(idx)
        worker_id = FETCHER_WORKER_ID_BASE + idx
        if state["hedger"] is None:
            return _read_row_group(state["files"], rowgroup, self._columns,
                                   fault_plan=self._fault_plan, worker_id=worker_id)

        def attempt(_cancel):
            private = state["pool"].acquire()
            try:
                return _read_row_group(private, rowgroup, self._columns,
                                       fault_plan=self._fault_plan, worker_id=worker_id)
            finally:
                state["pool"].release(private)

        return state["hedger"].read(attempt, attempt, key=str(rowgroup.path))
