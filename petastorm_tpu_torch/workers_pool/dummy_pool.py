"""Inline single-threaded pool: work executes lazily inside ``get_results``.

No threads: each ``get_results`` call processes ventilated items until the
worker has published something, then hands publications out in order. The
debugging flavor, and the one whose order is trivially deterministic.

With a telemetry registry (``pool.telemetry``) the inline decode is timed
into ``worker.decode_s`` and ``pool.w0.*``, and summed in
:attr:`DummyPool.inline_decode_s`, which the reader subtracts from its pool
wait so the two stages stay apart.
"""
from __future__ import annotations

import time
from collections import deque

from petastorm_tpu_torch.workers_pool import (ITEM_CONTEXT_KWARG, EmptyResultError,
                                              VentilatedItemProcessedMessage, add_counters)


class DummyPool:
    def __init__(self):
        self.workers_count = 1
        self._pending = deque()      # ventilated (args, kwargs) not yet processed
        self._results = deque()      # published results not yet consumed
        self._worker = None
        self._ventilator = None
        self._stopped = False
        self._ventilated = 0
        self._processed = 0
        #: The worker's counters, summed as its items are consumed.
        self.counters = {}
        #: The pipeline's telemetry registry, set by the reader.
        self.telemetry = None
        self._decode_hist = None
        #: Seconds of decode run inside ``get_results`` (with a registry).
        self.inline_decode_s = 0.0

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._worker is not None:
            raise RuntimeError("DummyPool already started")
        self._worker = worker_class(0, self._results.append, worker_args)
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def ventilate(self, *args, **kwargs):
        self._ventilated += 1
        self._pending.append((args, kwargs))

    def get_results(self):
        while True:
            if self._stopped:
                raise EmptyResultError()
            while self._results:
                result = self._results.popleft()
                if isinstance(result, VentilatedItemProcessedMessage):
                    self._processed += 1
                    add_counters(self.counters, result.counters)
                    if self._ventilator:
                        self._ventilator.processed_item(result.item_context)
                    continue
                # Everything queued comes from the one item processed last.
                self.result_context = self._processing_context
                return result
            if self._pending:
                args, kwargs = self._pending.popleft()
                self._processing_context = kwargs.get(ITEM_CONTEXT_KWARG)
                self._process(args, kwargs)
                self._results.append(VentilatedItemProcessedMessage(
                    0, self._worker.take_counters(), self._processing_context))
                continue
            if self._ventilator is None or self._ventilator.completed():
                # Re-check after seeing completion: the last item may have
                # been ventilated between the check above and this one.
                if not self._pending:
                    raise EmptyResultError()
                continue
            # The ventilator thread may still be feeding us; yield briefly.
            time.sleep(0.001)

    def _process(self, args, kwargs):
        trace = kwargs.pop("trace_context", None)
        telemetry = self.telemetry
        if telemetry is None:
            self._worker.process(*args, **kwargs)
            return
        if self._decode_hist is None:
            self._decode_hist = telemetry.histogram("worker.decode_s")
            self._c_items = telemetry.counter("pool.w0.items")
            self._c_busy = telemetry.counter("pool.w0.busy_s")
        t0 = time.perf_counter()
        with telemetry.span("petastorm_tpu.worker_decode", trace=trace, stage="decode",
                            track="worker:0"):
            self._worker.process(*args, **kwargs)
        dt = time.perf_counter() - t0
        self._decode_hist.observe(dt)
        self.inline_decode_s += dt
        self._c_busy.add(dt)
        self._c_items.add(1)

    def results_qsize(self) -> int:
        return len(self._results)

    @property
    def diagnostics(self) -> dict:
        """The JAX package's pool schema; ``output_queue_size`` counts the
        pending publications, item markers included."""
        return {"output_queue_size": len(self._results),
                "items_ventilated": self._ventilated,
                "items_processed": self._processed,
                "items_inprocess": self._ventilated - self._processed,
                "workers_count": self.workers_count,
                "results_queue_capacity": 0}

    def stop(self):
        if self._ventilator:
            self._ventilator.stop()
        self._stopped = True

    def join(self):
        if self._worker is not None:
            self._worker.shutdown()
