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
    ventilator's backpressure credit)."""


class WorkerFailure:
    """A worker exception, carried to the consumer, where it is re-raised."""

    def __init__(self, exception):
        self.exception = exception
