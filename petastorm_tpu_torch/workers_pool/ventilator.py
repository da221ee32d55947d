"""Ventilator: feeds work items (row-group reads) into a pool with
backpressure and epoch semantics.

``ConcurrentVentilator`` ventilates its item list from a daemon thread:
``iterations`` full passes (``None`` = forever), an optional per-epoch order
shuffle seeded with ``seed + epoch`` (the same ``random.Random`` stream the
JAX package uses, so both packages read row groups in the same order), and
a cap on in-flight items so a slow consumer never grows memory unboundedly.

Resume (the JAX package's ``ventilator.py:69-196``): ``start_epoch`` and
``start_offset`` begin ventilation at that item of that epoch's seeded
order, and :attr:`ConcurrentVentilator.state` is the resume point, a
watermark over the ``(epoch, position)`` pairs the pool confirms, advanced
only over a contiguous prefix so that items completed out of order never
skip one still in flight.
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
    :param start_epoch/start_offset: resume: epoch ``start_epoch`` begins at
        position ``start_offset`` of its order (exact given the same items,
        seed and shuffle flag)
    """

    def __init__(self, ventilate_fn, items_to_ventilate: List[Dict[str, Any]],
                 iterations: Optional[int] = 1,
                 randomize_item_order: bool = False,
                 random_seed: Optional[int] = None,
                 max_ventilation_queue_size: Optional[int] = None,
                 item_context_key: Optional[str] = None,
                 start_epoch: int = 0, start_offset: int = 0):
        if iterations is not None and iterations <= 0:
            raise ValueError(f"iterations must be positive or None, got {iterations}")
        self._ventilate_fn = ventilate_fn
        self._items = list(items_to_ventilate)
        if self._items and not 0 <= start_offset < len(self._items):
            raise ValueError(f"start_offset {start_offset} out of range")
        self._iterations = iterations
        self._randomize = randomize_item_order
        self._seed = random_seed
        self._max_inflight = max_ventilation_queue_size or max(1, len(self._items))
        self._context_key = item_context_key
        self._start = (start_epoch, start_offset)
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._stop_event = threading.Event()
        self._completed_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The watermark: the first (epoch, position) whose completion is
        # unconfirmed. Without contexts (a pool that confirms in ventilation
        # order) the count of confirmations stands in for it.
        self._state_lock = threading.Lock()
        self._watermark = self._start
        self._completed_positions = set()
        self._context_tracking = False
        self._processed_total = 0

    def start(self):
        if self._thread is not None:
            raise RuntimeError("Ventilator already started")
        self._thread = threading.Thread(target=self._ventilate_loop,
                                        name="ventilator", daemon=True)
        self._thread.start()

    def processed_item(self, item_context=None):
        """Consumer reports one item completed (backpressure credit). With
        ``item_context``, the ``(epoch, position)`` this ventilator attached
        to the item, the watermark advances exactly; without it, completions
        are taken to come in ventilation order."""
        with self._inflight_cv:
            self._inflight = max(0, self._inflight - 1)
            self._inflight_cv.notify_all()
        with self._state_lock:
            self._processed_total += 1
            if item_context is not None:
                self._context_tracking = True
                self._completed_positions.add(tuple(item_context))
                self._watermark = self._advance(self._watermark, self._completed_positions,
                                                consume=True)

    def _advance(self, mark, done: set, consume: bool = False):
        """``mark`` moved past every position of ``done`` that continues
        it (removing those from ``done`` when ``consume``)."""
        n = max(1, len(self._items))
        while mark in done:
            if consume:
                done.remove(mark)
            epoch, pos = mark
            mark = (epoch + 1, 0) if pos + 1 >= n else (epoch, pos + 1)
        return mark

    def watermark(self, delivered=()) -> tuple:
        """The resume point ``(epoch, offset)``: the earliest item whose
        completion is unconfirmed, counting the positions in ``delivered``
        as complete too (a consumer passes those whose output it has handed
        on in full, though their confirmation is still to come)."""
        with self._state_lock:
            if self._context_tracking:
                mark, done = self._watermark, self._completed_positions | set(delivered)
            else:
                epoch, offset = self._start
                offset += self._processed_total
                n = max(1, len(self._items))
                mark, done = (epoch + offset // n, offset % n), set(delivered)
            return self._advance(mark, done)

    @property
    def state(self) -> Dict[str, Any]:
        """Resume point: ``{"epoch", "offset", "seed", "randomized"}``.
        Passed back as ``start_epoch``/``start_offset`` with the same items,
        seed and shuffle flag, ventilation continues where consumption
        stopped; items after the cursor that were already consumed are
        consumed again (bounded duplication, never loss)."""
        epoch, offset = self.watermark()
        return {"epoch": epoch, "offset": offset, "seed": self._seed,
                "randomized": self._randomize}

    @property
    def inflight(self) -> int:
        """Ventilated-but-unprocessed items now: what the ``ventilator.backlog``
        gauge samples."""
        with self._inflight_cv:
            return self._inflight

    @property
    def max_inflight(self) -> int:
        return self._max_inflight

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
        with self._state_lock:
            self._start = self._watermark = (0, 0)
            self._completed_positions.clear()
            self._processed_total = 0
        self.start()

    def _epoch_order(self, epoch: int) -> List[Dict[str, Any]]:
        items = list(self._items)
        if self._randomize:
            rng = random.Random(None if self._seed is None else self._seed + epoch)
            rng.shuffle(items)
        return items

    def _ventilate_loop(self):
        epoch, skip = self._start
        while (self._items and not self._stop_event.is_set()
               and (self._iterations is None or epoch < self._iterations)):
            order = self._epoch_order(epoch)
            for pos, item in enumerate(order[skip:], start=skip):
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
            epoch, skip = epoch + 1, 0
        self._completed_event.set()
