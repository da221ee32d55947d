"""Row-group cache on the local disk, over the standard library's ``sqlite3``
(the JAX package's ``petastorm_tpu/local_disk_cache.py``).

* values pickled into BLOBs, one row a key;
* least recently *stored* out first, down to ``size_limit`` on each store;
* WAL journaling, so the reader's threads and spawned processes share one
  cache directory;
* a capacity check: a cache too small for 100 rows of the expected size
  raises ``ValueError``;
* the lookups and stores run under a
  :class:`~petastorm_tpu_torch.resilience.RetryPolicy` whose classifier is
  :func:`~petastorm_tpu_torch.resilience.policy.sqlite_classifier`
  ("database is locked" under concurrent readers is transient), and each
  miss fires the reader's fault plan at the ``cache.fill`` site before the
  fill runs.

The row worker stores a group's raw columns and decodes on every retrieval;
the batch worker stores the group's Arrow table. ``hits`` and ``fills``
count this process's retrievals (a spawned worker counts in its own copy);
:meth:`stored_at` reads every process's stores from the database.

Imports without torch: spawned workers unpickle it.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sqlite3
import threading
import time

from petastorm_tpu_torch.cache import CacheBase
from petastorm_tpu_torch.resilience.policy import (DEFAULT_READ_POLICY, RetryPolicy,
                                                   sqlite_classifier)

__all__ = ["LocalDiskCache"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cache (
    key TEXT PRIMARY KEY,
    value BLOB NOT NULL,
    size INTEGER NOT NULL,
    stored_at REAL NOT NULL
);
"""

#: Rows of ``expected_row_size_bytes`` the cache must hold at least.
_MIN_ROWS = 100

#: sqlite's busy timeout: how long a connection waits on another's lock.
SQLITE_TIMEOUT_S = 60.0


class LocalDiskCache(CacheBase):
    """:param path: directory of the cache database (made if missing)
    :param size_limit_bytes: the most bytes of pickled values kept
    :param expected_row_size_bytes: one entry's size, for the capacity
        check only
    :param shards: accepted for the JAX signature (sqlite needs no fan-out)
    :param cleanup: :meth:`cleanup` deletes the directory
    :param retry_policy: the schedule of the sqlite lookups and stores
        (:data:`~petastorm_tpu_torch.resilience.policy.DEFAULT_READ_POLICY`
        by default), reclassified through ``sqlite_classifier``
    :param fault_plan: fired at ``cache.fill`` on every miss
    """

    def __reduce__(self):
        # A spawned worker reopens the same directory; connections never
        # travel. The fault plan's counters restart in the child.
        return (type(self), (self._path, self._size_limit, 0, 6, self._cleanup_on_exit,
                             self._retry_policy_arg, self._fault_plan))

    def __init__(self, path: str, size_limit_bytes: int, expected_row_size_bytes: int = 0,
                 shards: int = 6, cleanup: bool = False, retry_policy: RetryPolicy = None,
                 fault_plan=None, **_ignored):
        if expected_row_size_bytes and size_limit_bytes < _MIN_ROWS * expected_row_size_bytes:
            raise ValueError(
                f"Cache size_limit_bytes={size_limit_bytes} is too small to hold {_MIN_ROWS} "
                f"rows of {expected_row_size_bytes} bytes each; increase the cache size")
        self._path = path
        self._cleanup_on_exit = cleanup
        self._size_limit = size_limit_bytes
        self._retry_policy_arg = retry_policy
        base_policy = retry_policy if retry_policy is not None else DEFAULT_READ_POLICY
        self._policy = dataclasses.replace(base_policy, classify=sqlite_classifier)
        self._fault_plan = fault_plan
        self._db_path = os.path.join(path, "cache.sqlite3")
        self._local = threading.local()
        self._all_conns = []
        self._conns_lock = threading.Lock()
        self._generation = 0
        self.hits = self.fills = 0
        self._conn()

    def _conn(self) -> sqlite3.Connection:
        """This thread's connection. A :meth:`cleanup` bumps the generation,
        and a thread whose connection it closed connects again (making the
        directory and the table again if the cleanup removed them)."""
        if getattr(self._local, "generation", -1) != self._generation:
            self._local.conn = None
        conn = getattr(self._local, "conn", None)
        if conn is None:
            with self._conns_lock:
                os.makedirs(self._path, exist_ok=True)
                conn = sqlite3.connect(self._db_path, timeout=SQLITE_TIMEOUT_S,
                                       check_same_thread=False)
                conn.execute("PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA synchronous=NORMAL")
                conn.executescript(_SCHEMA)
                self._local.conn = conn
                self._local.generation = self._generation
                self._all_conns.append(conn)
        return conn

    def get(self, key, fill_cache_func):
        key = str(key)
        # The fill is not retried here: the worker's guard owns the read's
        # and the decode's retries.
        row = self._policy.call(self._lookup, key)
        if row is not None:
            with self._conns_lock:
                self.hits += 1
            return pickle.loads(row[0])
        if self._fault_plan is not None:
            self._fault_plan.fire("cache.fill", key=key)
        value = fill_cache_func()
        blob = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        self._policy.call(self._store, key, blob)
        with self._conns_lock:
            self.fills += 1
        return value

    def _lookup(self, key):
        return self._conn().execute("SELECT value FROM cache WHERE key = ?", (key,)).fetchone()

    def _store(self, key, blob):
        conn = self._conn()
        with conn:
            conn.execute(
                "INSERT OR REPLACE INTO cache (key, value, size, stored_at) VALUES (?, ?, ?, ?)",
                (key, sqlite3.Binary(blob), len(blob), time.time()))
            self._evict_locked(conn)

    def _evict_locked(self, conn):
        (total,) = conn.execute("SELECT COALESCE(SUM(size), 0) FROM cache").fetchone()
        if total <= self._size_limit:
            return
        for key, size in conn.execute(
                "SELECT key, size FROM cache ORDER BY stored_at ASC").fetchall():
            conn.execute("DELETE FROM cache WHERE key = ?", (key,))
            total -= size
            if total <= self._size_limit:
                break

    def __len__(self):
        (n,) = self._conn().execute("SELECT COUNT(*) FROM cache").fetchone()
        return n

    def size_bytes(self) -> int:
        (total,) = self._conn().execute("SELECT COALESCE(SUM(size), 0) FROM cache").fetchone()
        return total

    def stored_at(self) -> dict:
        """``{key: time of its last store}`` over every process's stores."""
        return dict(self._conn().execute("SELECT key, stored_at FROM cache").fetchall())

    def cleanup(self):
        """Close every connection; with ``cleanup=True`` also delete the
        directory. Idempotent; a later call connects again."""
        with self._conns_lock:
            for conn in self._all_conns:
                try:
                    conn.close()
                except sqlite3.Error:
                    pass
            self._all_conns.clear()
            self._generation += 1
            if self._cleanup_on_exit:
                shutil.rmtree(self._path, ignore_errors=True)
        self._local.conn = None
