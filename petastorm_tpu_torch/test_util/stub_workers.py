"""Trivial pool workers for the pool tests (reference
petastorm/workers_pool/tests/stub_workers.py). They live in the package so
that a spawned worker process can import them by name."""
import os
import sys

from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class CoeffMultiplierWorker(WorkerBase):
    """Publishes ``value * args['coeff']``."""

    def process(self, value):
        self.publish_func(value * self.args["coeff"])


class IdentityWorker(WorkerBase):
    def process(self, value):
        self.publish_func(value)


class ContextIdentityWorker(WorkerBase):
    """Publishes ``value``; takes the ventilator's item context as the
    reader's workers do (crash recovery tracks items by it)."""

    def process(self, value, shuffle_context=None):
        self.publish_func(value)


class MultiOutputWorker(WorkerBase):
    """Publishes one result per element of the ventilated list."""

    def process(self, values):
        for v in values:
            self.publish_func(v)


class SilentWorker(WorkerBase):
    """Publishes nothing."""

    def process(self, value):
        pass


class ExceptionAtNWorker(WorkerBase):
    """Raises on ``args['bad_value']``."""

    def process(self, value):
        if value == self.args["bad_value"]:
            raise ValueError(f"poisoned value {value}")
        self.publish_func(value)


class BlobWorker(WorkerBase):
    """Publishes ``args['size']`` bytes per item, each byte ``value % 256``."""

    def process(self, value):
        self.publish_func(bytes([value % 256]) * self.args["size"])


class EnvironmentWorker(WorkerBase):
    """Publishes what a worker process sees: its pid, its
    ``CUDA_VISIBLE_DEVICES`` and whether ``torch`` is imported."""

    def process(self, value):
        self.publish_func({"pid": os.getpid(),
                           "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                           "torch_imported": "torch" in sys.modules})
