"""Pure-Python shared-memory SPSC ring, and the consumer's multi-record
reader over either ring.

:class:`PyShmRing` is the process pool's data plane when the native
``ringbuf.cpp`` cannot be built (no g++ on the host). It lives in a
:mod:`multiprocessing.shared_memory` segment with the native ring's layout,
byte for byte (and the JAX package's, so either package's producer feeds the
other's consumer)::

    [header 64 B: head u64 | tail u64 | capacity u64 | closed u32 | pad u32 |
                  waiting u64 | pad]
    [data region of `capacity` bytes]

``waiting`` is the size of the record the producer is blocked on for want
of space (aligned, with its length word), else 0 (the JAX package's
producers leave it 0, so its consumer never sees them stalled).

Records are ``[u32 len][payload]``, 8-byte aligned; ``len == 0xFFFFFFFF``
marks a wrap to the region's start. The producer writes the payload, then
the length, then publishes ``head``: a producer that dies mid-write leaves
``head`` where it was, so no consumer ever sees a torn record.

Python issues no memory fences: this ring relies on x86's total store order
and the GIL for its head and tail stores (aligned 8-byte ``struct`` stores).
The native ring uses C++11 atomics.
"""
from __future__ import annotations

import struct
import threading
import time
import weakref

from petastorm_tpu_torch.native import RingClosed, TimeoutError_

_WRAP = 0xFFFFFFFF
_ALIGN = 8
_HDR = 64
_HEAD_OFF = 0
_TAIL_OFF = 8
_CAP_OFF = 16
_CLOSED_OFF = 24
_WAITING_OFF = 32
_POLL_S = 50e-6


#: Segments whose mapping outlived close() because a view of it was alive.
_LEAKED: list = []


def _align_up(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class PyShmRing:
    """One SPSC ring over a named ``multiprocessing.shared_memory`` segment,
    with the API of :class:`~petastorm_tpu_torch.native.ShmRing`."""

    def __init__(self, name: str, capacity: int = 64 << 20, create: bool = True):
        from multiprocessing import resource_tracker, shared_memory
        self.name = name
        self._owner = create
        # shared_memory wants the name without the POSIX leading slash; both
        # refer to the same /dev/shm entry.
        if create:
            self._shm = shared_memory.SharedMemory(name.lstrip("/"), create=True,
                                                   size=_HDR + capacity)
            struct.pack_into("<QQQII", self._shm.buf, 0, 0, 0, capacity, 0, 0)
        else:
            self._shm = shared_memory.SharedMemory(name.lstrip("/"))
        # The creator unlinks in close(); neither side's resource tracker may
        # unlink the segment on its own (an attached worker's tracker would
        # pull it from under the consumer when the worker exits).
        resource_tracker.unregister(self._shm._name, "shared_memory")
        self._buf = self._shm.buf
        self.capacity = struct.unpack_from("<Q", self._buf, _CAP_OFF)[0]

    def _load(self, off: int) -> int:
        return struct.unpack_from("<Q", self._buf, off)[0]

    def _store(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self._buf, off, value)

    def head(self) -> int:
        return self._load(_HEAD_OFF)

    def tail(self) -> int:
        return self._load(_TAIL_OFF)

    def set_tail(self, value: int) -> None:
        self._store(_TAIL_OFF, value)

    @property
    def producer_closed(self) -> bool:
        return struct.unpack_from("<I", self._buf, _CLOSED_OFF)[0] != 0

    # ------------------------------------------------------------- producer
    def write_tagged(self, kind: int, payload, timeout_ms: int = -1) -> None:
        """One record of a 1-byte ``kind`` and ``payload`` (any buffer).
        Blocks while the ring is full (at most ``timeout_ms``; -1 =
        forever)."""
        view = memoryview(payload)
        if view.ndim != 1 or view.format != "B":
            view = view.cast("B")   # slice assignment needs matching formats
        msg_len = 1 + len(view)
        need = _align_up(4 + msg_len)
        cap = self.capacity
        # A record may cost `contiguous + need` (< 2 need) when it wraps, so
        # 2 need <= cap guarantees an empty ring always takes it.
        if need * 2 > cap:
            raise ValueError(f"payload of {len(view)} bytes exceeds ring capacity {cap}")
        deadline = None if timeout_ms < 0 else time.monotonic() + timeout_ms / 1000.0
        while True:
            if self.producer_closed:
                self._store(_WAITING_OFF, 0)
                raise RingClosed(f"ring {self.name} is closed")
            head = self._load(_HEAD_OFF)
            used = head - self._load(_TAIL_OFF)
            pos = head % cap
            contiguous = cap - pos
            total = need if contiguous >= need else contiguous + need
            if cap - used >= total:
                if contiguous < need:
                    if contiguous >= 4:
                        struct.pack_into("<I", self._buf, _HDR + pos, _WRAP)
                    head += contiguous
                    pos = 0
                base = _HDR + pos
                # Payload first, length second, head last (torn frames).
                self._buf[base + 4] = kind
                self._buf[base + 5:base + 5 + len(view)] = view
                struct.pack_into("<I", self._buf, base, msg_len)
                self._store(_WAITING_OFF, 0)
                self._store(_HEAD_OFF, head + need)
                return
            self._store(_WAITING_OFF, need)
            if deadline is not None and time.monotonic() > deadline:
                self._store(_WAITING_OFF, 0)
                raise TimeoutError_(f"ring {self.name} write timed out")
            time.sleep(_POLL_S)

    def close_producer(self) -> None:
        struct.pack_into("<I", self._buf, _CLOSED_OFF, 1)

    def waiting(self) -> int:
        """Bytes of the record the producer is blocked on, else 0."""
        return self._load(_WAITING_OFF)

    # ------------------------------------------------------------- consumer
    def _peek(self, timeout_ms: int):
        """``(pos, msg_len)`` of the next record, stepping over wrap
        markers; raises as the native peek does."""
        cap = self.capacity
        deadline = None if timeout_ms < 0 else time.monotonic() + timeout_ms / 1000.0
        while True:
            tail = self._load(_TAIL_OFF)
            if self._load(_HEAD_OFF) != tail:
                pos = tail % cap
                contiguous = cap - pos
                if contiguous < 4:
                    self._store(_TAIL_OFF, tail + contiguous)
                    continue
                msg_len = struct.unpack_from("<I", self._buf, _HDR + pos)[0]
                if msg_len == _WRAP:
                    self._store(_TAIL_OFF, tail + contiguous)
                    continue
                return pos, msg_len
            if self.producer_closed:
                raise RingClosed(f"ring {self.name} drained")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError_(f"ring {self.name} read timed out")
            time.sleep(_POLL_S)

    def read_tagged_view(self, timeout_ms: int = -1):
        """``(kind, zero-copy payload view)`` of the next record WITHOUT
        advancing; call :meth:`advance` once no view of it is left."""
        pos, msg_len = self._peek(timeout_ms)
        mv = self._buf[_HDR + pos + 4:_HDR + pos + 4 + msg_len]
        return mv[0], mv[1:]

    def read_tagged(self, timeout_ms: int = -1):
        """``(kind, payload bytes)`` of the next record, copied out."""
        kind, view = self.read_tagged_view(timeout_ms)
        payload = bytes(view)
        view.release()
        self.advance()
        return kind, payload

    def advance(self) -> None:
        tail = self._load(_TAIL_OFF)
        msg_len = struct.unpack_from("<I", self._buf, _HDR + tail % self.capacity)[0]
        self._store(_TAIL_OFF, tail + _align_up(4 + msg_len))

    def poll(self, timeout_ms: int = 0) -> bool:
        try:
            self._peek(timeout_ms)
            return True
        except (TimeoutError_, RingClosed):
            return False

    def discard_unread(self) -> int:
        """Drop every unread record (a dead producer's leftovers); returns
        how many."""
        n = 0
        while self.poll(0):
            self.advance()
            n += 1
        return n

    def data_view(self) -> memoryview:
        return self._buf[_HDR:]

    # ------------------------------------------------------------- lifetime
    def close(self, leak_mapping: bool = False) -> None:
        """Unmap the segment; the creator also unlinks its name. With
        ``leak_mapping`` (views of the ring are still alive), or when
        unmapping finds a view alive, only the name goes: the mapping stays
        for the process's life."""
        if self._shm is None:
            return
        shm, self._shm, self._buf = self._shm, None, None
        if not leak_mapping:
            try:
                shm.close()
            except BufferError:   # a view is alive: unmapping would crash it
                leak_mapping = True
        if leak_mapping:
            _LEAKED.append(shm)
        if self._owner:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class SegmentClaim:
    """Pins one ring record while objects that view it are alive.

    :meth:`track` registers a ``weakref.finalize`` on each such object;
    :attr:`released` turns true when the last one is collected, and only then
    may :meth:`RingReader.reap` hand the record's bytes back to the producer.
    Track the object every view of the record holds on to: the process pool
    tracks the record's memoryview that Arrow deserialized from, which every
    Arrow buffer and every numpy array or slice made from them keeps alive
    (a numpy slice does not keep the array it was sliced from alive when
    that array is itself a view, so tracking the arrays would not do).
    Finalizers fire on whichever thread drops the last reference; the
    ring's tail moves only on the consumer's thread."""

    __slots__ = ("_outstanding", "_lock", "__weakref__")

    def __init__(self):
        self._outstanding = 0
        self._lock = threading.Lock()

    def track(self, arr) -> None:
        with self._lock:
            self._outstanding += 1
        weakref.finalize(arr, self._drop)

    def _drop(self) -> None:
        with self._lock:
            self._outstanding -= 1

    @property
    def released(self) -> bool:
        with self._lock:
            return self._outstanding <= 0


class RingReader:
    """The consumer's reader over one ring (native or Python): it reads
    records ahead of the ones it has not released yet.

    The ring's own peek and advance expose only the record at the tail, so
    a view that pins the tail would stall every record behind it. Here a
    private cursor walks forward to the producer's ``head`` and hands out
    each record as a zero-copy view, while the ring's ``tail`` (the
    producer's free space) moves only past the oldest records that are
    done: :meth:`complete` (no view is left) or :meth:`claim` (a
    :class:`SegmentClaim` that has released). One consumer thread.
    """

    def __init__(self, ring):
        self.ring = ring
        mem = ring.data_view()
        self._mem = mem if mem.format == "B" else mem.cast("B")
        self._cap = ring.capacity
        self._cursor = ring.tail()
        #: [record end cursor, claim or None, completed] in read order.
        self._outstanding = []

    def _next_record(self, cursor: int, head: int):
        """``(pos, msg_len)`` of the first record at or after ``cursor``
        (stepping over wrap markers) and its cursor, or None."""
        while cursor < head:
            pos = cursor % self._cap
            contiguous = self._cap - pos
            if contiguous < 4:
                cursor += contiguous
                continue
            msg_len = struct.unpack_from("<I", self._mem, pos)[0]
            if msg_len == _WRAP:
                cursor += contiguous
                continue
            return cursor, pos, msg_len
        return None

    def try_read(self):
        """``(kind, zero-copy payload view)`` of the next unread record, or
        None when the producer has published nothing new. The caller follows
        with :meth:`complete` or :meth:`claim`."""
        found = self._next_record(self._cursor, self.ring.head())
        if found is None:
            return None
        cursor, pos, msg_len = found
        view = self._mem[pos + 4:pos + 4 + msg_len]
        self._cursor = cursor + _align_up(4 + msg_len)
        self._outstanding.append([self._cursor, None, False])
        return view[0], view[1:]

    def complete(self) -> None:
        """The record just read has no live views: releasable in order."""
        self._outstanding[-1][2] = True

    def claim(self, claim: SegmentClaim) -> None:
        """Pin the record just read until ``claim.released``."""
        self._outstanding[-1][1] = claim

    def has_pending(self) -> bool:
        """A complete unread record exists (wrap markers do not count).
        Reads nothing: the pool's crash path waits on it until a dead
        producer's ring is drained."""
        return self._next_record(self._cursor, self.ring.head()) is not None

    @property
    def outstanding(self) -> int:
        """Records read but not yet released to the producer."""
        return len(self._outstanding)

    @property
    def pinned(self) -> int:
        """Outstanding records held by an unreleased claim."""
        return sum(1 for _, c, done in self._outstanding
                   if not done and c is not None and not c.released)

    @property
    def stalled(self) -> bool:
        """True when the producer waits for space that only records the
        consumer still views can give: it is blocked on a write, every
        record it published has been read, and after :meth:`reap` the free
        bytes are fewer than its record needs."""
        need = self.ring.waiting()
        if not need:
            return False
        self.reap()
        head = self.ring.head()
        if self._cursor < head:
            return False
        contiguous = self._cap - head % self._cap
        total = need if contiguous >= need else contiguous + need
        return self._cap - (head - self.ring.tail()) < total

    def reap(self) -> int:
        """Move the ring's tail past the longest released prefix of the
        outstanding records; returns how many were released."""
        n = 0
        release_to = None
        while self._outstanding:
            end, claim, done = self._outstanding[0]
            if not done and (claim is None or not claim.released):
                break
            self._outstanding.pop(0)
            release_to = end
            n += 1
        if release_to is not None:
            self.ring.set_tail(release_to)
        return n

    def close(self) -> None:
        """Drop the reader's view of the mapping (before ``ring.close()``)."""
        try:
            self._mem.release()
        except BufferError:
            pass
