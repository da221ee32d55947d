"""Byte ledger shared by the pipeline's host-memory holders.

The memory cache and the readahead stage each hold payloads whose sizes
are known when they are stored. A :class:`MemoryBudget` is the one ledger
they charge, so the autotune controller reads one *pressure* number
instead of guessing at the process's RSS. ``reserve()`` never blocks: it
answers whether the charge fits; a holder that must proceed anyway (the
bytes exist already) passes ``force=True``, and the overshoot shows in
``pressure``, the signal the controller backs off on.
"""
from __future__ import annotations

import pickle
import threading

__all__ = ["MemoryBudget", "payload_nbytes"]


def payload_nbytes(obj) -> int:
    """Byte size of a pipeline payload: an object's ``nbytes`` (numpy
    arrays, Arrow tables), the length of bytes and of UTF-8 text, the sum
    over a container's elements (plus a fixed charge for the container),
    32 for a scalar or None, else the pickled length (1024 when it does
    not pickle, so nothing hides from the ledger)."""
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            pass
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj.encode("utf-8", errors="replace"))
    if isinstance(obj, dict):
        return sum(payload_nbytes(k) + payload_nbytes(v) for k, v in obj.items()) + 64
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(payload_nbytes(v) for v in obj) + 56
    if obj is None or isinstance(obj, (int, float, bool)):
        return 32
    try:
        return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:  # noqa: BLE001 - an unpicklable payload is charged all the same
        return 1024


class MemoryBudget:
    """Thread-safe byte ledger of a fixed capacity.

    :param capacity_bytes: the bytes the holders may charge; ``reserve``
        answers False once a charge would pass it
    :param telemetry: optional registry: the ``budget.capacity_bytes`` and
        live ``budget.used_bytes`` gauges
    """

    def __init__(self, capacity_bytes: int, telemetry=None):
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be > 0, got {capacity_bytes}")
        self._capacity = int(capacity_bytes)
        self._used = 0
        self._lock = threading.Lock()
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    def attach_telemetry(self, telemetry) -> None:
        telemetry.gauge("budget.capacity_bytes").set(self._capacity)
        telemetry.gauge("budget.used_bytes", lambda: self.used)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    @property
    def available(self) -> int:
        with self._lock:
            return max(0, self._capacity - self._used)

    @property
    def pressure(self) -> float:
        """``used / capacity``; above 1.0 after forced charges."""
        with self._lock:
            return self._used / self._capacity

    def reserve(self, nbytes: int, force: bool = False) -> bool:
        """Charge ``nbytes`` if it fits (always, with ``force=True``);
        returns whether the charge was taken."""
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        with self._lock:
            if not force and self._used + nbytes > self._capacity:
                return False
            self._used += nbytes
            return True

    def release(self, nbytes: int) -> None:
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        with self._lock:
            self._used = max(0, self._used - nbytes)

    def would_fit(self, nbytes: int) -> bool:
        with self._lock:
            return self._used + nbytes <= self._capacity
