"""Inline single-threaded pool: work executes lazily inside ``get_results``.

No threads: each ``get_results`` call processes ventilated items until the
worker has published something, then hands publications out in order. The
debugging flavor, and the one whose order is trivially deterministic.
"""
from __future__ import annotations

import time
from collections import deque

from petastorm_tpu_torch.workers_pool import (EmptyResultError,
                                              VentilatedItemProcessedMessage)


class DummyPool:
    def __init__(self):
        self.workers_count = 1
        self._pending = deque()      # ventilated (args, kwargs) not yet processed
        self._results = deque()      # published results not yet consumed
        self._worker = None
        self._ventilator = None
        self._stopped = False

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._worker is not None:
            raise RuntimeError("DummyPool already started")
        self._worker = worker_class(0, self._results.append, worker_args)
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def ventilate(self, *args, **kwargs):
        self._pending.append((args, kwargs))

    def get_results(self):
        while True:
            if self._stopped:
                raise EmptyResultError()
            while self._results:
                result = self._results.popleft()
                if isinstance(result, VentilatedItemProcessedMessage):
                    if self._ventilator:
                        self._ventilator.processed_item()
                    continue
                return result
            if self._pending:
                args, kwargs = self._pending.popleft()
                self._worker.process(*args, **kwargs)
                self._results.append(VentilatedItemProcessedMessage())
                continue
            if self._ventilator is None or self._ventilator.completed():
                # Re-check after seeing completion: the last item may have
                # been ventilated between the check above and this one.
                if not self._pending:
                    raise EmptyResultError()
                continue
            # The ventilator thread may still be feeding us; yield briefly.
            time.sleep(0.001)

    def stop(self):
        if self._ventilator:
            self._ventilator.stop()
        self._stopped = True

    def join(self):
        if self._worker is not None:
            self._worker.shutdown()
