"""Thread pool with deterministic round-robin result readout.

Work items are assigned round-robin to per-worker input queues, and results
are read round-robin from per-worker output queues, so with a seeded
ventilator the delivered order is deterministic. When the consumer opts out
of determinism (rows shuffled without a seed), readout switches to
first-come order.

Each worker publishes a :class:`VentilatedItemProcessedMessage` marker after
an item's data on the same queue, so the pool's end-of-data accounting
(items assigned == markers seen, queues drained) is exact.
"""
from __future__ import annotations

import queue
import sys
from collections import deque
import threading
import time
from traceback import format_exc
from typing import Optional

from petastorm_tpu_torch.workers_pool import (ITEM_CONTEXT_KWARG, EmptyResultError,
                                              VentilatedItemProcessedMessage,
                                              WorkerFailure, add_counters)

_IO_TIMEOUT_S = 0.001
_END_OF_VENTILATION_POLL_S = 0.1


class WorkerTerminationRequested(Exception):
    """Raised inside a worker thread to unwind when the pool is stopping."""


class _WorkerThread(threading.Thread):
    def __init__(self, worker_impl, input_queue, stop_event, put_fn):
        super().__init__(name=f"pt-worker-{worker_impl.worker_id}", daemon=True)
        self._worker_impl = worker_impl
        self._input_queue = input_queue
        self._stop_event = stop_event
        self._put = put_fn

    def run(self):
        # Any exit other than a requested stop reaches the consumer as a
        # WorkerFailure: a silently dead worker would leave its items
        # unprocessed and the consumer polling forever.
        try:
            while not self._stop_event.is_set():
                try:
                    args, kwargs = self._input_queue.get(block=True, timeout=_IO_TIMEOUT_S)
                except queue.Empty:
                    continue
                self._worker_impl.process(*args, **kwargs)
                self._put(VentilatedItemProcessedMessage(
                    self._worker_impl.worker_id, self._worker_impl.take_counters(),
                    kwargs.get(ITEM_CONTEXT_KWARG)))
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


class ThreadPool:
    """:param workers_count: number of worker threads
    :param results_queue_size: bound of each per-worker result queue
    :param shuffle_rows/seed: rows shuffled without a seed switch readout to
        first-come order (there is no determinism to keep)
    """

    def __init__(self, workers_count: int, results_queue_size: int = 50,
                 shuffle_rows: bool = False, seed: Optional[int] = None):
        self.workers_count = workers_count
        self._results_queue_size = results_queue_size
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

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._stop_event.is_set():
            raise RuntimeError("A ThreadPool cannot be restarted after stop()")
        if self._workers:
            raise RuntimeError("ThreadPool already started")
        for i in range(self.workers_count):
            in_q = queue.Queue()
            self._input_queues.append(in_q)
            self._result_queues.append(queue.Queue(maxsize=self._results_queue_size))
            worker = worker_class(i, self._make_put(i), worker_args)
            self._workers.append(_WorkerThread(worker, in_q, self._stop_event,
                                               self._make_put(i)))
        for w in self._workers:
            w.start()
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def _make_put(self, worker_id):
        def _put(data):
            # Bounded put that unwinds when the pool stops, so a worker never
            # deadlocks against a full queue nobody drains.
            while True:
                try:
                    self._result_queues[worker_id].put(data, block=True, timeout=_IO_TIMEOUT_S)
                    return
                except queue.Full:
                    if self._stop_event.is_set():
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

    def get_results(self):
        """Next published result, in round-robin order. Raises
        :class:`EmptyResultError` once all ventilated work is done and
        drained, or after ``stop()``; re-raises worker exceptions."""
        empty_sweeps = 0
        while True:
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

    def join(self):
        for w in self._workers:
            w.join()
