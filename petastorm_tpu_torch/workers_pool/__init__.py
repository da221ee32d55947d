"""Worker-pool execution runtime: a ventilator feeds work items to a pool of
workers, whose published results the reader drains."""


class EmptyResultError(RuntimeError):
    """No results are available and none are expected until the next
    ``ventilate`` call."""


#: Work-item kwarg under which the ventilator attaches its (epoch, position)
#: context (workers key their row-shuffle RNG off it).
ITEM_CONTEXT_KWARG = "shuffle_context"


class VentilatedItemProcessedMessage:
    """Worker -> pool signal: one ventilated item fully processed (the
    ventilator's backpressure credit), by worker ``worker_id``, with the
    worker's ``counters`` since its last item
    (:meth:`~.worker_base.WorkerBase.take_counters`). ``item_context``
    echoes the item's ``(epoch, position)`` when its work kwargs carried one
    (:data:`ITEM_CONTEXT_KWARG`), so the ventilator's resume watermark stays
    exact when workers finish out of order.

    A spawned worker also sends ``busy_s``, the item's seconds in the
    worker, and in trace mode ``spans``, compact ``(name, stage,
    duration_s, trace, track)`` tuples of its decode: it cannot reach the
    parent's registry, so the pool records them on arrival. In-process
    pools leave both None."""

    def __init__(self, worker_id=None, counters=None, item_context=None, spans=None,
                 busy_s=None):
        self.worker_id = worker_id
        self.counters = counters or {}
        self.item_context = item_context
        self.spans = spans
        self.busy_s = busy_s


def add_counters(total: dict, counters: dict) -> None:
    """Sum a processed message's ``counters`` into a pool's ``total``."""
    for name, n in counters.items():
        total[name] = total.get(name, 0) + n


class WorkerFailure:
    """A worker exception, carried to the consumer, where it is re-raised."""

    def __init__(self, exception):
        self.exception = exception
