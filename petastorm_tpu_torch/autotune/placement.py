"""The decode stage's placement, thread pool (0) or process pool (1), as
a knob: when the pipeline stays producer-bound with every other knob at
its ceiling, the controller flips it, waits for the migration to apply
and settle, compares delivered rows a tick against the baseline, keeps the
winner and pins the knob (one trial a reader).

``_apply`` only requests the migration through ``migrate_fn``; the owner
calls :meth:`PlacementActuator.mark_applied` when the swap is done, or
:meth:`~PlacementActuator.mark_failed` when it aborted: the reader's
``_perform_pool_migration`` does both.
"""
from __future__ import annotations

import threading

from petastorm_tpu_torch.autotune.actuators import Actuator

__all__ = ["PlacementActuator", "POOL_BACKENDS"]

#: Actuator value -> reader_pool_type.
POOL_BACKENDS = ("thread", "process")


class PlacementActuator(Actuator):
    """:param migrate_fn: ``(backend: str) -> None``, scheduling the
        migration
    :param initial_backend: the pool type the reader started with
    """

    def __init__(self, migrate_fn, initial_backend: str, telemetry=None):
        if initial_backend not in POOL_BACKENDS:
            raise ValueError(f"placement only tunes thread<->process pools, "
                             f"got {initial_backend!r}")
        self._migrate = migrate_fn
        self._applied = threading.Event()
        self._applied.set()
        #: True when the last requested migration aborted: the controller
        #: cancels the trial built on it instead of measuring it.
        self.last_apply_failed = False
        super().__init__("placement", 0, 1, POOL_BACKENDS.index(initial_backend),
                         telemetry=telemetry)

    @property
    def backend(self) -> str:
        return POOL_BACKENDS[self.value]

    @property
    def applied(self) -> bool:
        """True once the last requested migration completed."""
        return self._applied.is_set()

    def mark_applied(self) -> None:
        self.last_apply_failed = False
        self._applied.set()

    def mark_failed(self, live_backend: str) -> None:
        """The migration aborted: take the backend actually running as the
        value without requesting another migration."""
        value = POOL_BACKENDS.index(live_backend)
        with self._lock:
            self._value = value
        if self._gauge is not None:
            self._gauge.set(value)
        self.last_apply_failed = True
        self._applied.set()

    def _apply(self, value: int) -> None:
        self._applied.clear()
        self._migrate(POOL_BACKENDS[value])
