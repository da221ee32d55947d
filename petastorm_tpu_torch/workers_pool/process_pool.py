"""Process pool: spawned worker processes, fed over sockets, publishing
through shared-memory rings.

```
   main process                                  worker process (xN, spawned)
   ────────────                                  ─────────────────
   socket pair ── work items, FINISH (pickle) ──▶ Connection
   shm ring    ◀── D/S/P data, C control ──────── ring producer
```

Each worker gets one end of an ``AF_UNIX`` socket pair
(:mod:`multiprocessing.connection`), inherited as a file descriptor, for its
work items and the FINISH message, and one SPSC ring (``native`` when
``ringbuf.cpp`` builds, else the pure-Python ``py`` ring; one implementation
is pinned for the consumer and every worker) that carries everything it
sends back, in order, as tagged records:

* ``C``: a pickled control message (ready, item processed, failure);
* ``D``: a serialized result;
* ``S`` then ``P``... then ``D``: a result bigger than half the ring, sent
  as chunks after an ``S`` frame that gives its total length, so one large
  row group never deadlocks against its own backpressure.

Data and control share the ring, so an item's "processed" marker can never
overtake its data.

With a serializer whose results view their input (``aliases_input``, the
Arrow serializer of ``make_batch_reader``), a single-record ``D`` frame is
deserialized where it lies in the ring and its record is pinned by a
:class:`~petastorm_tpu_torch.reader_impl.shm_ring.SegmentClaim` until the
consumer drops the last view of it; the consumer reads on past pinned
records, and the ring's space comes back in order. A consumer that keeps
so many results that every worker with work in flight waits for space its
views hold gets a ``RuntimeError`` after ``_PINNED_STALL_S``, not a hang.
``join()`` with views still alive unlinks the ring's name but keeps its
mapping.

Workers are spawned (a fresh interpreter, never a fork: see
:mod:`.exec_in_new_process`) with ``CUDA_VISIBLE_DEVICES=""``. Starting
blocks on a ready message from every worker (``_WORKER_START_TIMEOUT_S``).
A worker exits when its parent dies (it polls ``os.getppid()``), when FINISH
arrives, or when the consumer closes its ring; ``stop()`` closes the rings,
so a worker blocked on a full ring leaves at once. A worker that dies
unexpectedly makes :meth:`ProcessPool.get_results` raise ``RuntimeError``
within ``_POLL_MS``, however busy the other workers keep it.
Unlike the thread pool, results arrive in the order workers finish.

Telemetry (``pool.telemetry``, set by the reader): the consumer times each
deserialization into ``transport.deserialize_s`` (and a
``petastorm_tpu.transport`` span), counts ``transport.zero_copy_batches`` and
``transport.zero_copy_bytes``, and records the busy seconds and, in trace
mode, the ``petastorm_tpu.worker_decode`` spans that each worker sends with
its item-processed message (``pool.w{id}.items``, ``pool.w{id}.busy_s``;
the spans re-anchored to the consumer's clock on arrival).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from multiprocessing.connection import Connection, Pipe
from traceback import format_exc

from petastorm_tpu_torch.reader_impl.epoch_plan import OrderedUnit
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.workers_pool import (ITEM_CONTEXT_KWARG, EmptyResultError,
                                              VentilatedItemProcessedMessage,
                                              WorkerFailure, add_counters)
from petastorm_tpu_torch.workers_pool.exec_in_new_process import exec_in_new_process

_CONTROL_FINISH = "FINISH"
_WORKER_START_TIMEOUT_S = 60
_JOIN_TIMEOUT_S = 30
_POLL_MS = 100
_ORPHAN_POLL_S = 1.0
_PAGE = 4096
#: Seconds every worker with work in flight may wait for ring space held by
#: the consumer's views before :meth:`ProcessPool.get_results` raises.
_PINNED_STALL_S = 60.0
#: Name prefix of the pool's shared-memory segments (``/dev/shm/<name>``).
RING_PREFIX = "pt_torch_ring_"


def prefault(ring, write: bool) -> None:
    """Touch every page of the ring's data region in this process's
    mapping: writing zeros on the producer's side (before its first record,
    so no reader can see them), reading on the consumer's. A page's first
    touch costs microseconds (5.6-5.7 us on the H100's 8-core host,
    ``tools/torch_ring_probe.py``), so a ring that has not wrapped yet would
    pay it on every record, some 2400 times per 9.6 MB row group."""
    import numpy as np
    pages = np.frombuffer(ring.data_view(), dtype=np.uint8)[::_PAGE]
    if write:
        pages[:] = 0
    else:
        int(pages.sum())
    del pages


class _WorkerReady:
    def __init__(self, worker_id):
        self.worker_id = worker_id


class ProcessPool:
    """:param workers_count: number of spawned worker processes
    :param ring_capacity: data bytes of each worker's ring
    :param serializer: how results cross the rings: pickled
        (:class:`~petastorm_tpu_torch.reader_impl.pickle_serializer.PickleSerializer`,
        the default) or as Arrow streams viewed in place
        (:class:`~petastorm_tpu_torch.reader_impl.arrow_table_serializer.ArrowTableSerializer`)
    """

    def __init__(self, workers_count: int, ring_capacity: int = 128 << 20, serializer=None):
        self.workers_count = workers_count
        self._ring_capacity = ring_capacity
        self._serializer = serializer if serializer is not None else PickleSerializer()
        #: Applied on the consumer to every deserialized result (the batch
        #: reader converts Arrow tables to numpy views here).
        self.result_transform = None
        #: Rings whose mapping ``join()`` kept because views were alive.
        self.leaked_rings = []
        self._ring_mem = {}      # worker id -> uint8 array over its ring's data
        #: ``"native"`` or ``"py"``, pinned at :meth:`start`.
        self.ring_impl = None
        #: The rings' shared-memory names (``/dev/shm`` entries without "/").
        self.ring_names = []
        self._rings = []
        self._readers = []
        self._conns = []
        self._processes = []
        self._partial = {}       # worker id -> [reassembly buffer, fill offset]
        self._poll_idx = 0
        self._polled_from = 0    # the ring of the last record read
        self._inflight = [0] * workers_count
        # Per worker, the contexts of the items sent to it and not yet
        # processed, in the order it takes them: a result belongs to the first.
        self._contexts = [deque() for _ in range(workers_count)]
        #: The ventilator context of the item whose result ``get_results``
        #: returned last.
        self.result_context = None
        self._next_worker = 0
        self._lock = threading.Lock()
        self._ventilator = None
        self._ventilated = 0
        self._processed = 0
        self._stopped = False
        self._last_alive_check = 0.0
        self._stall_since = None
        #: The workers' counters, summed as their items are consumed, and
        #: the consumer's ``zero_copy_batches`` and ``zero_copy_bytes``:
        #: results whose arrays view the ring, and those arrays' bytes.
        self.counters = {}
        #: Seconds from :meth:`start` until every worker was ready.
        self.start_seconds = None
        #: The pipeline's telemetry registry, set by the reader.
        self.telemetry = None
        self._c_deser = None
        self._c_w_items = {}
        self._c_w_busy = {}

    @property
    def worker_pids(self):
        return [p.pid for p in self._processes]

    # ------------------------------------------------------------------ api
    def start(self, worker_class, worker_args=None, ventilator=None):
        from petastorm_tpu_torch.native import make_ring, resolve_ring_impl
        from petastorm_tpu_torch.reader_impl.shm_ring import RingReader
        if self._processes:
            raise RuntimeError("ProcessPool already started")
        t0 = time.monotonic()
        self.ring_impl = resolve_ring_impl()
        token = uuid.uuid4().hex[:10]
        for worker_id in range(self.workers_count):
            name = f"/{RING_PREFIX}{token}_{worker_id}"
            ring = make_ring(name, capacity=self._ring_capacity, create=True,
                             impl=self.ring_impl)
            self._rings.append(ring)
            self._readers.append(RingReader(ring))
            self.ring_names.append(name.lstrip("/"))
            ours, theirs = Pipe(duplex=True)
            self._conns.append(ours)
            self._processes.append(exec_in_new_process(
                _worker_bootstrap, worker_id, worker_class, worker_args,
                theirs.fileno(), os.getpid(), name, self.ring_impl, self._serializer,
                pass_fds=(theirs.fileno(),)))
            theirs.close()
        # While the workers start: map the rings' pages on this side too.
        for ring in self._rings:
            prefault(ring, write=False)

        ready = set()
        deadline = t0 + _WORKER_START_TIMEOUT_S
        while len(ready) < self.workers_count:
            if time.monotonic() > deadline:
                self.stop()
                self.join()
                raise RuntimeError(f"Only {len(ready)}/{self.workers_count} workers started "
                                   f"within {_WORKER_START_TIMEOUT_S} s")
            msg = self._poll_result(_POLL_MS)
            if msg is None:
                self._check_processes_alive()
            elif isinstance(msg, _WorkerReady):
                ready.add(msg.worker_id)
            elif isinstance(msg, WorkerFailure):
                self.stop()
                self.join()
                raise msg.exception
        self.start_seconds = time.monotonic() - t0
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def ventilate(self, *args, **kwargs):
        """Send one work item to the worker with the fewest items in flight
        (round robin among equals)."""
        with self._lock:
            n = self.workers_count
            wid = min(((self._next_worker + i) % n for i in range(n)),
                      key=lambda w: self._inflight[w])
            self._next_worker = (wid + 1) % n
            self._inflight[wid] += 1
            self._ventilated += 1
            self._contexts[wid].append(kwargs.get(ITEM_CONTEXT_KWARG))
            try:
                self._conns[wid].send((args, kwargs))
            except OSError:
                # The worker is gone: the consumer's liveness check raises.
                pass

    def get_results(self):
        """The next published result. Raises :class:`EmptyResultError` once
        every ventilated item is processed and drained, or after ``stop()``;
        re-raises a worker's exception; raises ``RuntimeError`` when a worker
        died, or when the consumer's views have held every busy worker's
        ring full for ``_PINNED_STALL_S`` (dropping them lets a later call
        go on)."""
        while True:
            if self._stopped:
                raise EmptyResultError()
            # The liveness check runs on a clock, not only when the rings are
            # quiet: the other workers may keep them busy while a dead
            # worker's items are lost.
            now = time.monotonic()
            if now - self._last_alive_check >= _POLL_MS / 1000.0:
                self._last_alive_check = now
                self._check_processes_alive()
            # Completion is read BEFORE the count: an item ventilated between
            # the two reads then shows up as unprocessed.
            ventilation_done = self._ventilator is None or self._ventilator.completed()
            with self._lock:
                all_done = self._processed == self._ventilated
            if all_done and ventilation_done:
                raise EmptyResultError()
            msg = self._poll_result(_POLL_MS)
            if msg is None:
                self._check_pinned_stall()
                continue
            self._stall_since = None
            if isinstance(msg, VentilatedItemProcessedMessage):
                with self._lock:
                    self._processed += 1
                    self._inflight[msg.worker_id] -= 1
                    self._contexts[msg.worker_id].popleft()
                add_counters(self.counters, msg.counters)
                if self.telemetry is not None:
                    self._record_worker_telemetry(msg)
                if self._ventilator:
                    # Confirmed when pulled: its result came before this
                    # message on the same ring, whatever views of it live on.
                    self._ventilator.processed_item(msg.item_context)
                continue
            if isinstance(msg, WorkerFailure):
                self.stop()
                self.join()
                raise msg.exception
            if isinstance(msg, _WorkerReady):
                continue
            with self._lock:
                self.result_context = self._contexts[self._polled_from][0]
            return msg

    def _record_worker_telemetry(self, msg):
        """A worker's item in the registry: its spans (re-anchored to this
        clock, ending now, under the worker's pid) and its per-worker
        counters."""
        wid = msg.worker_id
        if msg.spans:
            self.telemetry.recorder.record_remote(msg.spans, pid=self._processes[wid].pid)
        items = self._c_w_items.get(wid)
        if items is None:
            items = self._c_w_items[wid] = self.telemetry.counter(f"pool.w{wid}.items")
            self._c_w_busy[wid] = self.telemetry.counter(f"pool.w{wid}.busy_s")
        items.add(1)
        if msg.busy_s:
            self._c_w_busy[wid].add(msg.busy_s)

    @property
    def diagnostics(self) -> dict:
        """The JAX package's pool schema; ``output_queue_size`` and
        ``results_queue_capacity`` are 0 (results cross byte-bounded rings,
        not a queue)."""
        with self._lock:
            ventilated, processed = self._ventilated, self._processed
        return {"output_queue_size": 0,
                "items_ventilated": ventilated,
                "items_processed": processed,
                "items_inprocess": ventilated - processed,
                "workers_count": self.workers_count,
                "results_queue_capacity": 0}

    def stop(self):
        """Stop ventilating, tell every worker to finish, and close the
        rings: a worker blocked on a full ring fails out of its write."""
        if self._ventilator:
            self._ventilator.stop()
        if not self._stopped:
            for conn in self._conns:
                try:
                    conn.send(_CONTROL_FINISH)
                except OSError:
                    pass
        for ring in self._rings:
            ring.close_producer()
        self._stopped = True

    @property
    def pinned(self) -> int:
        """Ring records held by a claim whose views are still alive (call
        it from the thread that reads the pool)."""
        for reader in self._readers:
            reader.reap()
        return sum(reader.pinned for reader in self._readers)

    def join(self):
        """Wait for the workers (killing any left after
        ``_JOIN_TIMEOUT_S``), then close the sockets and unlink the rings.
        A ring that still has views alive keeps its mapping (listed in
        :attr:`leaked_rings`): unmapping it would make them read freed
        memory."""
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        for p in self._processes:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for conn in self._conns:
            conn.close()
        self._conns = []
        self._ring_mem.clear()
        for reader, ring in zip(self._readers, self._rings):
            reader.reap()
            pinned = reader.pinned
            reader.close()
            if pinned:
                ring.close(leak_mapping=True)
                self.leaked_rings.append(ring.name.lstrip("/"))
            else:
                ring.close()
        self._readers = []
        self._rings = []

    # ------------------------------------------------------------ internals
    def _poll_result(self, timeout_ms: int):
        """The next complete message of any ring, round robin, or None after
        ``timeout_ms`` without one. ``C`` frames unpickle; ``S``/``P``
        chunks fill one buffer preallocated from the ``S`` frame's length,
        which the final ``D`` completes; a ``D`` frame deserializes straight
        from the mapped record. That record is released as soon as it is
        read when deserializing copies out of it (pickle), and claimed
        (:meth:`_deserialize_claimed`) when the result views it; every
        other record is released at once."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            progressed = False
            for _ in range(len(self._readers)):
                idx = self._poll_idx
                self._poll_idx = (idx + 1) % len(self._readers)
                reader = self._readers[idx]
                reader.reap()
                rec = reader.try_read()
                if rec is None:
                    continue
                progressed = True
                self._polled_from = idx
                kind, view = rec
                del rec
                if kind == ord("D") and idx not in self._partial \
                        and self._serializer.aliases_input:
                    return self._deserialize_claimed(reader, idx, view)
                try:
                    if kind == ord("C"):
                        return pickle.loads(view)
                    if kind == ord("S"):
                        self._partial[idx] = [bytearray(int.from_bytes(view[:8], "little")), 0]
                        continue
                    if idx in self._partial:
                        entry = self._partial[idx]
                        buf, off = entry
                        buf[off:off + len(view)] = view
                        entry[1] = off + len(view)
                        if kind == ord("P"):
                            continue
                        del self._partial[idx]
                        # The reassembled buffer is the consumer's own:
                        # results may view it freely.
                        return self._deserialize(memoryview(buf), idx)
                    return self._deserialize(view, idx)
                finally:
                    view.release()
                    reader.complete()
                    reader.reap()
            if not progressed:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.0001)

    def _deserialize(self, buf, idx: int):
        """Deserialize ``buf`` (from worker ``idx``'s ring) and apply
        ``result_transform``, inside an ``OrderedUnit`` envelope to its
        payload, so the envelope reaches the reader's gate whole. With a
        registry the time is the pipeline's transport stage."""
        telemetry = self.telemetry
        if telemetry is None:
            return self._deserialize_untimed(buf)
        if self._c_deser is None:
            self._c_deser = telemetry.counter("transport.deserialize_s")
        t0 = time.perf_counter()
        with telemetry.span("petastorm_tpu.transport", stage="transport",
                            track=f"transport:{idx}"):
            result = self._deserialize_untimed(buf)
        self._c_deser.add(time.perf_counter() - t0)
        return result

    def _deserialize_untimed(self, buf):
        result = self._serializer.deserialize(buf)
        if self.result_transform is None:
            return result
        if isinstance(result, OrderedUnit):
            if result.payload is not None:
                result.payload = self.result_transform(result.payload)
            return result
        return self.result_transform(result)

    def _deserialize_claimed(self, reader, idx: int, view):
        """Deserialize a ``D`` record in place and pin it until ``view`` is
        collected: every Arrow buffer deserialized from it, and every numpy
        array or slice made from those, holds ``view``, so the record's
        bytes go back to the producer only once none is left. The record is
        claimed before deserializing, so it is consumed even when
        deserializing raises. Counts the result's arrays that view the
        ring."""
        from petastorm_tpu_torch.reader_impl.shm_ring import SegmentClaim
        claim = SegmentClaim()
        claim.track(view)
        reader.claim(claim)
        try:
            result = self._deserialize(view, idx)
        finally:
            del view   # only the result's buffers may keep the record pinned
        # In deterministic mode the arrays viewing the ring are the payload's.
        payload = result.payload if isinstance(result, OrderedUnit) else result
        if isinstance(payload, dict):
            import numpy as np
            mem = self._ring_mem.get(idx)
            if mem is None:
                mem = self._ring_mem[idx] = np.frombuffer(self._rings[idx].data_view(),
                                                          dtype=np.uint8)
            viewing = [v for v in payload.values() if isinstance(v, np.ndarray) and v.size
                       and np.may_share_memory(v, mem)]
            if viewing:
                nbytes = sum(v.nbytes for v in viewing)
                add_counters(self.counters, {"zero_copy_batches": 1, "zero_copy_bytes": nbytes})
                if self.telemetry is not None:
                    self.telemetry.counter("transport.zero_copy_batches").add(1)
                    self.telemetry.counter("transport.zero_copy_bytes").add(nbytes)
        return result

    def _check_pinned_stall(self):
        """Raise once every worker with items in flight has waited
        ``_PINNED_STALL_S`` for ring space that only records the consumer
        still views can give: nothing else would ever wake them."""
        with self._lock:
            busy = [i for i, n in enumerate(self._inflight) if n > 0]
        if not busy or not all(self._readers[i].stalled for i in busy):
            self._stall_since = None
            return
        now = time.monotonic()
        if self._stall_since is None:
            self._stall_since = now
        if now - self._stall_since < _PINNED_STALL_S:
            return
        raise RuntimeError(
            f"Reader stalled: for {_PINNED_STALL_S:g} s every worker has waited for ring space "
            f"held by {self.pinned} result(s) the consumer still views. On the process pool a "
            f"result's columns view the shared-memory ring until dropped: copy what you keep "
            f"(np.array(col), tensor.clone()), or read with reader_pool_type='thread'")

    def _check_processes_alive(self):
        for i, p in enumerate(self._processes):
            rc = p.poll()
            if rc is None or rc == 0 or self._stopped:
                continue
            self.stop()
            self.join()
            raise RuntimeError(f"Worker process {i} died unexpectedly with exit code {rc}")


# ------------------------------------------------------------- worker side
def _watch_parent(parent_pid: int) -> None:
    """Exit hard once the parent is gone (the worker is re-parented)."""
    while os.getppid() == parent_pid:
        time.sleep(_ORPHAN_POLL_S)
    os._exit(0)


def _worker_bootstrap(worker_id, worker_class, worker_args, conn_fd, parent_pid, ring_name,
                      ring_impl, serializer):
    """Entry function of a spawned worker process (reference
    petastorm/workers_pool/process_pool.py:330)."""
    from petastorm_tpu_torch.native import RingClosed, make_ring

    threading.Thread(target=_watch_parent, args=(parent_pid,), daemon=True).start()
    conn = Connection(conn_fd)
    ring = make_ring(ring_name, create=False, impl=ring_impl)
    prefault(ring, write=True)
    max_frame = max(4096, int(ring.capacity) // 2 - 4096)

    def send_ctrl(obj):
        ring.write_tagged(ord("C"), pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def publish(data):
        payload = memoryview(serializer.serialize(data))
        if len(payload) > max_frame:
            ring.write_tagged(ord("S"), len(payload).to_bytes(8, "little"))
            while len(payload) > max_frame:
                ring.write_tagged(ord("P"), payload[:max_frame])
                payload = payload[max_frame:]
        ring.write_tagged(ord("D"), payload)

    def next_item():
        """The next work item, or None on FINISH or a closed socket."""
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return None
        return None if msg == _CONTROL_FINISH else msg

    worker = None
    try:
        worker = worker_class(worker_id, publish, worker_args)
        send_ctrl(_WorkerReady(worker_id))
        while not ring.producer_closed and (item := next_item()) is not None:
            args, kwargs = item
            # In trace mode the reader adds the item's lineage id: the decode
            # is sent back as a span under it (this process's clock is not
            # the consumer's, so only its duration travels).
            trace = kwargs.pop("trace_context", None)
            t0 = time.perf_counter()
            worker.process(*args, **kwargs)
            busy_s = time.perf_counter() - t0
            spans = ([("petastorm_tpu.worker_decode", "decode", busy_s, trace,
                       f"worker:{worker_id}")] if trace is not None else None)
            send_ctrl(VentilatedItemProcessedMessage(worker_id, worker.take_counters(),
                                                     kwargs.get(ITEM_CONTEXT_KWARG),
                                                     spans=spans, busy_s=busy_s))
    except RingClosed:
        pass   # the consumer stopped and closed the ring: a clean exit
    except Exception as e:  # noqa: BLE001 - shipped to the consumer
        sys.stderr.write(f"Worker {worker_id} exception:\n{format_exc()}\n")
        try:
            pickle.dumps(e)
        except Exception:  # noqa: BLE001 - an exception that does not pickle
            e = RuntimeError(f"Worker {worker_id} failed: {e!r}")
        try:
            send_ctrl(WorkerFailure(e))
        except RingClosed:
            pass
    finally:
        if worker is not None:
            worker.shutdown()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
