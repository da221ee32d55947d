"""In-memory decoded row-group cache, least recently used first out.

It holds **decoded** payloads in host memory, so a multi-epoch run reads
and decodes each row group once and serves later epochs from memory. The
row worker stores post-codec columns of the whole group (it reads
``caches_decoded``) and copies the cells it hands out, so a consumer that
writes into a row never writes into the cache; the batch worker stores the
group's Arrow table.

* **Bytes**: every entry is charged to a :class:`MemoryBudget` at
  :func:`payload_nbytes`, and the cache never holds more than its own
  ``size_limit_bytes``, even on a larger shared ledger.
* **Eviction**: the least recently hit entries go first.
* **Cost-aware admission**: an entry that would displace others is
  admitted only if it cost at least the fill seconds it displaces, so a
  group quick to fill never evicts ones slow to fill.
* **Failure safety**: a fill that raises caches nothing, so a quarantined
  group or an injected fault never poisons the cache; the fault plan's
  ``cache.fill`` site fires before each fill.

Telemetry (on the reader's registry once it is attached):
``cache.mem.hits`` / ``misses`` / ``inserts`` / ``evictions`` /
``rejected_admissions`` counters and the ``cache.mem.bytes`` /
``cache.mem.entries`` gauges.

A spawned worker gets the cache pickled as an *empty* cache of the same
policy, so each process keeps a private cache over its own items.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from petastorm_tpu_torch.autotune.budget import MemoryBudget, payload_nbytes
from petastorm_tpu_torch.cache import CacheBase

__all__ = ["InMemoryRowGroupCache"]


class _Entry:
    __slots__ = ("value", "nbytes", "fill_s")

    def __init__(self, value, nbytes: int, fill_s: float):
        self.value = value
        self.nbytes = nbytes
        self.fill_s = fill_s


class InMemoryRowGroupCache(CacheBase):
    """:param size_limit_bytes: the most bytes of payload held
    :param budget: a shared :class:`MemoryBudget` to charge (default a
        private one of ``size_limit_bytes``)
    :param fault_plan: a fault plan consulted at ``cache.fill`` on every
        miss (tests and benchmarks)
    :param telemetry: a registry; a reader attaches its own with
        :meth:`attach_telemetry`
    """

    #: The row worker stores post-codec columns under this cache.
    caches_decoded = True

    def __reduce__(self):
        # Across a process boundary: an empty cache of the same policy.
        return (type(self), (self._size_limit,), {"_fault_plan": self._fault_plan})

    def __setstate__(self, state):
        self._fault_plan = state.get("_fault_plan")

    def __init__(self, size_limit_bytes: int, budget: Optional[MemoryBudget] = None,
                 fault_plan=None, telemetry=None):
        self._size_limit = int(size_limit_bytes)
        self.budget = budget if budget is not None else MemoryBudget(self._size_limit)
        self._fault_plan = fault_plan
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._resident = 0
        self._counters = None
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    def attach_telemetry(self, telemetry) -> None:
        """Count into ``telemetry`` (in-process pools; a spawned worker's
        private cache counts nothing)."""
        self._counters = {name: telemetry.counter(f"cache.mem.{name}")
                          for name in ("hits", "misses", "inserts", "evictions",
                                       "rejected_admissions")}
        telemetry.gauge("cache.mem.bytes", lambda: self.size_bytes())
        telemetry.gauge("cache.mem.entries", lambda: len(self))
        self.budget.attach_telemetry(telemetry)

    def _count(self, name: str) -> None:
        if self._counters is not None:
            self._counters[name].add(1)

    def get(self, key, fill_cache_func):
        key = str(key)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is not None:
            self._count("hits")
            return entry.value
        self._count("misses")
        if self._fault_plan is not None:
            self._fault_plan.fire("cache.fill", key=key)
        # The fill runs outside the lock, so other threads' hits do not wait
        # behind it; a fill that raises stores nothing.
        t0 = time.perf_counter()
        value = fill_cache_func()
        self._admit(key, value, time.perf_counter() - t0)
        return value

    def _admit(self, key: str, value, fill_s: float) -> None:
        nbytes = payload_nbytes(value)
        if nbytes > self._size_limit:
            self._count("rejected_admissions")
            return
        with self._lock:
            if key in self._entries:   # another thread's fill of the same key won
                return

            def fits(freed):
                return (self._resident - freed + nbytes <= self._size_limit
                        and self.budget.would_fit(nbytes - freed))

            # Victims in LRU order until the candidate fits both this cache's
            # limit and the ledger; admitted only if they cost no more fill
            # seconds than the candidate did.
            victims, freed, victim_cost = [], 0, 0.0
            for vkey, ventry in self._entries.items():
                if fits(freed):
                    break
                victims.append(vkey)
                freed += ventry.nbytes
                victim_cost += ventry.fill_s
            if not fits(freed) or (victims and victim_cost > fill_s):
                self._count("rejected_admissions")
                return
            for vkey in victims:
                ventry = self._entries.pop(vkey)
                self._resident -= ventry.nbytes
                self.budget.release(ventry.nbytes)
                self._count("evictions")
            if not self.budget.reserve(nbytes):
                self._count("rejected_admissions")   # another holder took the bytes
                return
            self._entries[key] = _Entry(value, nbytes, fill_s)
            self._resident += nbytes
            self._count("inserts")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return str(key) in self._entries

    def size_bytes(self) -> int:
        with self._lock:
            return self._resident

    def keys(self) -> list:
        """The resident keys, least recently used first."""
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        """Entries, resident bytes, the limit and the ledger's view."""
        with self._lock:
            entries, resident = len(self._entries), self._resident
        return {"entries": entries, "resident_bytes": resident,
                "size_limit_bytes": self._size_limit,
                "budget_used_bytes": self.budget.used,
                "budget_capacity_bytes": self.budget.capacity}

    def cleanup(self):
        with self._lock:
            for entry in self._entries.values():
                self.budget.release(entry.nbytes)
            self._entries.clear()
            self._resident = 0
