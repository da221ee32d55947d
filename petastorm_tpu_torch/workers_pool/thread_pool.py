"""Thread pool with deterministic round-robin result readout.

Work items are assigned round-robin to per-worker input queues, and results
are read round-robin from per-worker output queues, so with a seeded
ventilator the delivered order is deterministic. When the consumer opts out
of determinism (rows shuffled without a seed), readout switches to
first-come order.

Each worker publishes a :class:`VentilatedItemProcessedMessage` marker after
an item's data on the same queue, so the pool's end-of-data accounting
(items assigned == markers seen, queues drained) is exact.

With a telemetry registry (``pool.telemetry``, set by the reader before
``start()``) each worker times its items into ``worker.decode_s`` and
``pool.w{id}.items``/``pool.w{id}.busy_s``, and records a
``petastorm_tpu.worker_decode`` span (with the item's lineage id in trace
mode).

Resilience hooks, set by the reader before ``start()`` as in the JAX
package's pool: a worker's :class:`~petastorm_tpu_torch.resilience.RowGroupSkipped`
becomes a skip record on its queue, ahead of the item's processed marker,
and ``get_results`` adds it to ``pool.quarantine``; with a
``stage_deadline`` each worker counts whole items past the soft budget
(``resilience.item_stragglers_total``); ``heartbeats`` holds each worker's
last item boundary for the watchdog, which may ``nudge()`` or ``abort()``
the pool.

Each worker takes a slot of the pool's :class:`ConcurrencyGate` before an
item and frees it after: the autotune controller's live decode-concurrency
knob. The readout order does not change with the limit.
"""
from __future__ import annotations

import cProfile
import logging
import pstats
import queue
import sys
from collections import deque
import threading
import time
from traceback import format_exc
from typing import Optional

from petastorm_tpu_torch.resilience.quarantine import RowGroupSkipped, RowGroupSkippedMessage
from petastorm_tpu_torch.workers_pool import (ITEM_CONTEXT_KWARG, EmptyResultError,
                                              TimeoutWaitingForResultError,
                                              VentilatedItemProcessedMessage,
                                              WorkerFailure, add_counters,
                                              item_straggler_monitor, route_skip)

logger = logging.getLogger(__name__)

_IO_TIMEOUT_S = 0.001
_END_OF_VENTILATION_POLL_S = 0.1
#: Seconds ``join()`` waits for a worker thread after an abort: a thread
#: wedged in a read may never return, and daemon threads die with the process.
_ABORT_JOIN_S = 5.0


class WorkerTerminationRequested(Exception):
    """Raised inside a worker thread to unwind when the pool is stopping."""


class ConcurrencyGate:
    """Admission gate over live worker concurrency (the JAX package's).

    Every worker thread stays alive, but only ``limit`` of them process an
    item at once; the others park before their next item. ``set_limit`` is
    the knob (``tools/check_knobs.py`` checks that only
    :mod:`petastorm_tpu_torch.autotune` calls it): a change takes effect at
    the next item boundary, with no thread started or stopped and no item
    lost or reordered.

    Under the strict round-robin readout, a limit below the worker count
    could wedge: the consumer waits on a parked worker while every slot
    holder waits on the consumer to drain its full queue. So a slot holder
    blocked publishing into a full queue yields its slot
    (:meth:`yield_if_held`) and takes one again before it goes on.
    """

    def __init__(self, limit: int):
        self._limit = max(1, int(limit))
        self._active = 0
        self._holders: set = set()   # idents of the threads holding a slot
        self._cv = threading.Condition()

    @property
    def limit(self) -> int:
        with self._cv:
            return self._limit

    @property
    def active(self) -> int:
        with self._cv:
            return self._active

    def set_limit(self, limit: int) -> None:
        with self._cv:
            self._limit = max(1, int(limit))
            self._cv.notify_all()

    def acquire(self, stop_event) -> bool:
        """Block until a slot frees (True), or the pool stops (False)."""
        with self._cv:
            while self._active >= self._limit:
                if stop_event.is_set():
                    return False
                self._cv.wait(_END_OF_VENTILATION_POLL_S)
            self._active += 1
            self._holders.add(threading.get_ident())
            return True

    def release(self) -> None:
        """Free the calling thread's slot; no-op when it holds none."""
        self.yield_if_held()

    def yield_if_held(self) -> bool:
        """Free the calling thread's slot if it holds one; returns whether
        it did (the caller acquires again later)."""
        with self._cv:
            ident = threading.get_ident()
            if ident not in self._holders:
                return False
            self._holders.discard(ident)
            self._active = max(0, self._active - 1)
            self._cv.notify_all()
            return True

    def nudge(self) -> None:
        """Wake every parked waiter, in case a stall is a lost wakeup (they
        check again and park when it is not)."""
        with self._cv:
            self._cv.notify_all()


class _WorkerThread(threading.Thread):
    def __init__(self, worker_impl, input_queue, stop_event, put_fn, heartbeats, gate,
                 prof=None, telemetry=None, straggler=None):
        super().__init__(name=f"pt-worker-{worker_impl.worker_id}", daemon=True)
        self._worker_impl = worker_impl
        self._input_queue = input_queue
        self._stop_event = stop_event
        self._put = put_fn
        self._heartbeats = heartbeats
        self._gate = gate
        self._straggler = straggler
        self.prof = prof   # this worker's cProfile (before Python 3.12 only)
        self._telemetry = telemetry
        wid = worker_impl.worker_id
        self._decode_hist = (telemetry.histogram("worker.decode_s")
                             if telemetry is not None else None)
        self._c_items = telemetry.counter(f"pool.w{wid}.items") if telemetry is not None else None
        self._c_busy = telemetry.counter(f"pool.w{wid}.busy_s") if telemetry is not None else None

    def run(self):
        # Any exit other than a requested stop reaches the consumer as a
        # WorkerFailure: a silently dead worker would leave its items
        # unprocessed and the consumer polling forever.
        try:
            if self.prof:
                self.prof.enable()
            wid = self._worker_impl.worker_id
            while not self._stop_event.is_set():
                try:
                    args, kwargs = self._input_queue.get(block=True, timeout=_IO_TIMEOUT_S)
                except queue.Empty:
                    continue
                # The lineage id the reader adds in trace mode; the worker's
                # signature never sees it.
                trace = kwargs.pop("trace_context", None)
                # The item stays this worker's while it parks (the assignment
                # is fixed), so the readout order holds.
                if not self._gate.acquire(self._stop_event):
                    return
                self._heartbeats[wid] = time.monotonic()
                t0 = time.perf_counter()
                try:
                    if self._decode_hist is not None:
                        with self._telemetry.span("petastorm_tpu.worker_decode", trace=trace,
                                                  stage="decode", track=f"worker:{wid}"):
                            self._process_item(args, kwargs)
                        busy = time.perf_counter() - t0
                        self._decode_hist.observe(busy)
                        self._c_busy.add(busy)
                        self._c_items.add(1)
                    else:
                        self._process_item(args, kwargs)
                finally:
                    self._gate.release()
                self._put(VentilatedItemProcessedMessage(
                    wid, self._worker_impl.take_counters(), kwargs.get(ITEM_CONTEXT_KWARG)))
                self._heartbeats[wid] = time.monotonic()
                if self._straggler is not None:
                    # The whole item, publishing against a full queue included.
                    self._straggler.observe(time.perf_counter() - t0, worker_id=wid)
        except WorkerTerminationRequested:
            pass
        except Exception as e:  # noqa: BLE001 - re-raised on the consumer
            sys.stderr.write(f"Worker {self._worker_impl.worker_id} terminated: {format_exc()}\n")
            try:
                self._put(WorkerFailure(e))
            except WorkerTerminationRequested:
                pass
        finally:
            self._worker_impl.shutdown()
            if self.prof:
                self.prof.disable()

    def _process_item(self, args, kwargs):
        try:
            self._worker_impl.process(*args, **kwargs)
        except RowGroupSkipped as skip:
            # A quarantine give-up: the record stands in for the item's
            # data, and the processed marker still follows it.
            self._put(RowGroupSkippedMessage(skip.record))


class ThreadPool:
    """:param workers_count: number of worker threads
    :param results_queue_size: bound of each per-worker result queue
    :param shuffle_rows/seed: rows shuffled without a seed switch readout to
        first-come order (there is no determinism to keep)
    :param profiling_enabled: cProfile the pool and print the statistics on
        ``join()``. From Python 3.12 cProfile is one process-wide
        ``sys.monitoring`` tool that sees every thread (a second ``enable()``
        raises), so one pool-level profile covers the workers and whatever
        the consumer ran between ``start()`` and ``join()``; before 3.12 each
        worker gets its own profile and ``join()`` merges them
    """

    def __init__(self, workers_count: int, results_queue_size: int = 50,
                 shuffle_rows: bool = False, seed: Optional[int] = None,
                 profiling_enabled: bool = False):
        self.workers_count = workers_count
        self._results_queue_size = results_queue_size
        self._profiling_enabled = profiling_enabled
        self._prof = None
        #: The pipeline's telemetry registry, set by the reader before
        #: ``start()`` so the workers can time their items into it.
        self.telemetry = None
        self._strict_order = not (shuffle_rows and seed is None)
        self._stop_event = threading.Event()
        self._workers = []
        self._input_queues = []
        self._result_queues = []
        self._assigned = [0] * workers_count
        self._processed = [0] * workers_count
        self._next_assign = 0
        self._next_read = 0
        self._ventilator = None
        # Per worker, the contexts of its items not yet processed, in the
        # order it takes them: a result belongs to the first.
        self._contexts = [deque() for _ in range(workers_count)]
        #: The workers' counters, summed as their items are consumed.
        self.counters = {}
        #: The ventilator context of the item whose result ``get_results``
        #: returned last.
        self.result_context = None
        #: The reader's ``RowGroupQuarantine``: skip records go there.
        self.quarantine = None
        #: A ``StageDeadline`` whose soft budget the workers hold each whole
        #: item to (set by the reader before ``start()``).
        self.stage_deadline = None
        #: Per worker, the monotonic time of its last item boundary.
        self.heartbeats = [0.0] * workers_count
        #: The live decode-concurrency knob (the autotune controller's
        #: ``worker_concurrency``); all workers by default.
        self.concurrency_gate = ConcurrencyGate(workers_count)
        self._abort_exc = None

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._stop_event.is_set():
            raise RuntimeError("A ThreadPool cannot be restarted after stop()")
        if self._workers:
            raise RuntimeError("ThreadPool already started")
        straggler = item_straggler_monitor(self)
        for i in range(self.workers_count):
            in_q = queue.Queue()
            self._input_queues.append(in_q)
            self._result_queues.append(queue.Queue(maxsize=self._results_queue_size))
            worker = worker_class(i, self._make_put(i), worker_args)
            prof = (cProfile.Profile() if self._profiling_enabled
                    and sys.version_info < (3, 12) else None)
            self._workers.append(_WorkerThread(worker, in_q, self._stop_event,
                                               self._make_put(i), self.heartbeats,
                                               self.concurrency_gate, prof=prof,
                                               telemetry=self.telemetry, straggler=straggler))
        if self._profiling_enabled and sys.version_info >= (3, 12):
            self._prof = cProfile.Profile()
            try:
                self._prof.enable()
            except ValueError:   # another sys.monitoring tool is active
                sys.stderr.write("profiling_enabled ignored: another profiler is already "
                                 "active in this process\n")
                self._prof = None
        for w in self._workers:
            w.start()
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def _make_put(self, worker_id):
        gate = self.concurrency_gate

        def _put(data):
            # Bounded put that unwinds when the pool stops, so a worker never
            # deadlocks against a full queue nobody drains. Blocked on a full
            # queue, a slot holder yields its slot (see ConcurrencyGate) and
            # takes one again before it goes on.
            yielded = False
            try:
                while True:
                    try:
                        self._result_queues[worker_id].put(data, block=True,
                                                           timeout=_IO_TIMEOUT_S)
                        return
                    except queue.Full:
                        if self._stop_event.is_set():
                            raise WorkerTerminationRequested()
                        if not yielded:
                            yielded = gate.yield_if_held()
            finally:
                if yielded and not gate.acquire(self._stop_event):
                    raise WorkerTerminationRequested()
        return _put

    def ventilate(self, *args, **kwargs):
        wid = self._next_assign
        self._next_assign = (self._next_assign + 1) % self.workers_count
        self._assigned[wid] += 1
        self._contexts[wid].append(kwargs.get(ITEM_CONTEXT_KWARG))
        self._input_queues[wid].put((args, kwargs))

    def _worker_drained(self, wid) -> bool:
        return (self._processed[wid] == self._assigned[wid]
                and self._result_queues[wid].empty())

    def get_results(self, timeout: Optional[float] = None):
        """Next published result, in round-robin order. Raises
        :class:`EmptyResultError` once all ventilated work is done and
        drained, or after ``stop()``; re-raises worker exceptions, and the
        watchdog's error after :meth:`abort`. With ``timeout``, raises
        :class:`TimeoutWaitingForResultError` after that many seconds
        without a result (the migration drain's bounded wait)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        empty_sweeps = 0
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutWaitingForResultError()
            if self._abort_exc is not None:
                raise self._abort_exc
            if self._stop_event.is_set():
                raise EmptyResultError()
            # Completion is read BEFORE the drain check: an item ventilated
            # between the two reads then shows up as undrained.
            ventilation_done = self._ventilator is None or self._ventilator.completed()
            if ventilation_done and all(self._worker_drained(i)
                                        for i in range(self.workers_count)):
                raise EmptyResultError()
            wid = self._next_read
            if self._worker_drained(wid):
                self._next_read = (wid + 1) % self.workers_count
                empty_sweeps += 1
                if empty_sweeps >= self.workers_count:
                    time.sleep(_IO_TIMEOUT_S)
                    empty_sweeps = 0
                continue
            try:
                result = self._result_queues[wid].get(
                    block=self._strict_order, timeout=_END_OF_VENTILATION_POLL_S)
            except queue.Empty:
                if not self._strict_order:
                    self._next_read = (wid + 1) % self.workers_count
                    empty_sweeps += 1
                    if empty_sweeps >= self.workers_count:
                        time.sleep(_IO_TIMEOUT_S)
                        empty_sweeps = 0
                continue
            empty_sweeps = 0
            if route_skip(self, result):
                continue
            if isinstance(result, VentilatedItemProcessedMessage):
                self._processed[wid] += 1
                self._contexts[wid].popleft()
                add_counters(self.counters, result.counters)
                if self._ventilator:
                    self._ventilator.processed_item(result.item_context)
                self._next_read = (wid + 1) % self.workers_count
                continue
            if isinstance(result, WorkerFailure):
                self.stop()
                self.join()
                raise result.exception
            self.result_context = self._contexts[wid][0]
            return result

    def stop(self):
        if self._ventilator:
            self._ventilator.stop()
        self._stop_event.set()

    def abort(self, exc: BaseException):
        """The watchdog's last rung: a consumer blocked in
        :meth:`get_results` raises ``exc`` promptly, and teardown proceeds
        as a stop."""
        self._abort_exc = exc
        self.stop()

    def nudge(self):
        """The watchdog's first rung: wake the workers parked at the
        admission gate, in case a stall is a lost wakeup."""
        self.concurrency_gate.nudge()

    def join(self):
        for w in self._workers:
            if self._abort_exc is None:
                w.join()
                continue
            # A pipeline declared hung may hold a thread wedged for good.
            w.join(timeout=_ABORT_JOIN_S)
            if w.is_alive():
                logger.warning("Worker thread %s still wedged after abort; abandoning it "
                               "(daemon)", w.name)
        if self._prof is not None:
            self._prof.disable()
            pstats.Stats(self._prof).sort_stats("cumulative").print_stats()
            self._prof = None
        elif self._profiling_enabled:
            profs = [w.prof for w in self._workers if w.prof is not None]
            if profs:
                stats = pstats.Stats(profs[0])
                for prof in profs[1:]:
                    stats.add(prof)
                stats.sort_stats("cumulative").print_stats()

    def results_qsize(self) -> int:
        """Results queued over every worker's queue."""
        return sum(q.qsize() for q in self._result_queues)

    @property
    def diagnostics(self) -> dict:
        """The JAX package's pool schema (the same keys on every pool)."""
        ventilated = sum(self._assigned)
        processed = sum(self._processed)
        return {"output_queue_size": self.results_qsize(),
                "items_ventilated": ventilated,
                "items_processed": processed,
                "items_inprocess": ventilated - processed,
                "workers_count": self.workers_count,
                "results_queue_capacity": self._results_queue_size}
