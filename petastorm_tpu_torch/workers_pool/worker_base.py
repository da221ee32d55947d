"""Worker protocol: a worker consumes ventilated items and publishes results."""
from abc import abstractmethod


class WorkerBase:
    def __init__(self, worker_id: int, publish_func, args):
        """:param worker_id: unique integer id of this worker within the pool
        :param publish_func: callable the worker uses to emit results
        :param args: application-specific arguments (opaque to the pool)
        """
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    @abstractmethod
    def process(self, *args, **kwargs):
        """Process one ventilated item; publish zero or more results."""

    def shutdown(self):
        """Called once when the pool stops; release worker resources."""
