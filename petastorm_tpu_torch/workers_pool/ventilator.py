"""Ventilator: feeds work items (row-group reads) into a pool with
backpressure and epoch semantics.

``ConcurrentVentilator`` ventilates its item list from a daemon thread:
``iterations`` full passes (``None`` = forever), an optional per-epoch order
shuffle seeded with ``seed + epoch`` (the same ``random.Random`` stream the
JAX package uses, so both packages read row groups in the same order), and
a cap on in-flight items so a slow consumer never grows memory unboundedly.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

_VENTILATION_INTERVAL_S = 0.01


class ConcurrentVentilator:
    """:param ventilate_fn: callable receiving one item's kwargs
    :param items_to_ventilate: list of kwarg-dicts, one per work item
    :param iterations: number of passes over the items (``None`` = forever)
    :param randomize_item_order: shuffle item order each pass
    :param random_seed: seed for the order shuffle; pass N reseeds with
        ``seed + N``, so orders are identical across runs and shards
    :param max_ventilation_queue_size: max in-flight (ventilated minus
        processed) items; defaults to the item count
    :param item_context_key: when set, each item additionally carries
        ``{item_context_key: (epoch, position)}``, its epoch and position
        in that epoch's order (workers key per-item RNG off it)
    """

    def __init__(self, ventilate_fn, items_to_ventilate: List[Dict[str, Any]],
                 iterations: Optional[int] = 1,
                 randomize_item_order: bool = False,
                 random_seed: Optional[int] = None,
                 max_ventilation_queue_size: Optional[int] = None,
                 item_context_key: Optional[str] = None):
        if iterations is not None and iterations <= 0:
            raise ValueError(f"iterations must be positive or None, got {iterations}")
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        self._iterations = iterations
        self._randomize = randomize_item_order
        self._seed = random_seed
        self._max_inflight = max_ventilation_queue_size or max(1, len(self._items))
        self._context_key = item_context_key
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._stop_event = threading.Event()
        self._completed_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            raise RuntimeError("Ventilator already started")
        self._thread = threading.Thread(target=self._ventilate_loop,
                                        name="ventilator", daemon=True)
        self._thread.start()

    def processed_item(self):
        """Consumer reports one item completed (backpressure credit)."""
        with self._inflight_cv:
            self._inflight = max(0, self._inflight - 1)
            self._inflight_cv.notify_all()

    def completed(self) -> bool:
        """True when every item of every pass was ventilated, or the
        ventilator was stopped (it will never ventilate again)."""
        return self._completed_event.is_set() or self._stop_event.is_set()

    def stop(self):
        self._stop_event.set()
        with self._inflight_cv:
            self._inflight_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def reset(self):
        """Restart ventilation from epoch 0 (the same seeded orders as a
        fresh ventilator). Only legal once the current run completed."""
        if not self.completed():
            raise NotImplementedError(
                "Resetting a ventilator while ventilation is in progress is not supported")
        self.stop()
        self._stop_event.clear()
        self._completed_event.clear()
        with self._inflight_cv:
            self._inflight = 0
        self.start()

    def _epoch_order(self, epoch: int) -> List[Dict[str, Any]]:
        items = list(self._items)
        if self._randomize:
            rng = random.Random(None if self._seed is None else self._seed + epoch)
            rng.shuffle(items)
        return items

    def _ventilate_loop(self):
        epoch = 0
        while (self._items and not self._stop_event.is_set()
               and (self._iterations is None or epoch < self._iterations)):
            for pos, item in enumerate(self._epoch_order(epoch)):
                with self._inflight_cv:
                    while (self._inflight >= self._max_inflight
                           and not self._stop_event.is_set()):
                        self._inflight_cv.wait(_VENTILATION_INTERVAL_S)
                    if self._stop_event.is_set():
                        return
                    self._inflight += 1
                if self._context_key is not None:
                    self._ventilate_fn(**item, **{self._context_key: (epoch, pos)})
                else:
                    self._ventilate_fn(**item)
            epoch += 1
        self._completed_event.set()
