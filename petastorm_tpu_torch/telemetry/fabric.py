"""Telemetry fabric: live cross-process metric streaming + fleet rollup
(the JAX package's ``telemetry/fabric.py``, over the standard library's
sockets).

Every other observability surface here is either in-process or a file
merged after the fact; the fabric makes the federation plane *live*
(docs/observability.md "Telemetry fabric"):

* :class:`TelemetryPublisher` — a daemon thread attachable to any
  pipeline registry (``make_reader``/``make_batch_reader
  (telemetry_publish=)``, ``MeshDataLoader``, or the
  :data:`TELEMETRY_PUBLISH_ENV` environment variable) that streams
  versioned, delta-encoded metric windows to an aggregator: sparse
  cumulative counters (only changed entries ride each window —
  cumulative values self-resync after dropped/missed windows), gauges,
  changed histogram bucket vectors, new bounded event batches, fresh
  timeline windows from a publisher-owned
  :class:`~petastorm_tpu_torch.telemetry.timeseries.MetricsTimeline`, and a
  cumulative :func:`~petastorm_tpu_torch.telemetry.accounting.accounting_totals`
  record. Every window doubles as a heartbeat. Abandonment-safe like the
  periodic exporter: a publisher whose owner never calls ``stop()``
  still sends its final window from an atexit finalizer.
* :class:`TelemetryAggregator` — binds an address and runs the
  federation machinery *continuously*: member streams (keyed ``h{N}``,
  ``w{id}``, ``tenant-...`` — keying stays a naming convention) rebuild
  per-member snapshots and timeline rings; member counter deltas fold
  into a fleet registry whose attached timeline derives aggregate series
  (``rows_per_s`` across the fleet) watched by the anomaly bank and SLO
  rules; remote clocks re-anchor via a live handshake (each message
  carries the sender's ``perf_counter``; the aggregator keeps the
  minimum-latency offset estimate); and member silence — missed
  heartbeats — is a first-class ``anomaly.member_silent`` detection,
  recorded through the standard anomaly counters/events so ``telemetry
  check`` gates on it unmodified. :meth:`TelemetryAggregator.flush` writes
  the fleet state in the existing snapshot JSON schema, so the whole file
  toolchain (``telemetry top``/``timeline``/``check --anomaly``) consumes
  aggregator output with zero changes.

The wire: the JAX package's messages (the same JSON objects, the same
:data:`FABRIC_SCHEMA_VERSION`), one UTF-8 JSON object per frame, each
frame a 4-byte big-endian length and the payload, over a stream socket:
``tcp://host:port`` (TCP; ``*`` binds every interface, port 0 an ephemeral
port, :attr:`TelemetryAggregator.addr` then names the bound one) or
``ipc:///path`` (a Unix-domain socket). Where the JAX fabric's ZeroMQ
PUSH socket bounds a send by its high-water mark and timeout, a publisher
here connects lazily, waits at most one interval for a connect or a send,
and on failure drops the window, counts it in ``fabric.send_errors`` and
reconnects on the next one: it never blocks the pipeline and never raises
into it. The aggregator accepts any number of publishers and drains them
through :mod:`selectors`.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import select
import selectors
import socket
import stat
import struct
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from petastorm_tpu_torch.telemetry.accounting import (AccountingLedger,
                                                      accounting_totals)
from petastorm_tpu_torch.telemetry.federation import (federate_snapshots,
                                                      federate_timelines)
from petastorm_tpu_torch.telemetry.timeseries import (DEFAULT_WINDOW_COUNT,
                                                      MetricsTimeline)

logger = logging.getLogger(__name__)

__all__ = ["FABRIC_SCHEMA_VERSION", "TELEMETRY_PUBLISH_ENV",
           "fabric_available", "publish_addr_from_env",
           "TelemetryPublisher", "TelemetryAggregator"]

#: Wire schema version. Every fabric message carries ``"v"``; an
#: aggregator ignores (and counts) messages from a NEWER schema instead
#: of misparsing them, so mixed-build fleets degrade honestly.
FABRIC_SCHEMA_VERSION = 1

#: Environment variable: an address (``tcp://host:port`` /
#: ``ipc:///path``) enables a :class:`TelemetryPublisher` on every
#: Reader / MeshDataLoader registry in the process.
TELEMETRY_PUBLISH_ENV = "PETASTORM_TPU_TELEMETRY_PUBLISH"

#: Bound on event records shipped per window (per publisher): the
#: registry's rings are bounded too, but a publish gap must not dump an
#: unbounded backlog into one frame.
EVENTS_PER_WINDOW = 64

#: A member is silent after this many missed heartbeat intervals. 1.5
#: (not 2.0) keeps the *detection* — which also waits for the next
#: aggregator tick — inside the documented two-heartbeat bound.
SILENCE_AFTER_HEARTBEATS = 1.5

#: Frame header: the payload's length, 4 bytes big-endian.
_FRAME = struct.Struct(">I")

#: Largest frame an aggregator accepts; a longer declared length means a
#: corrupt stream, whose connection is dropped.
MAX_FRAME_BYTES = 64 << 20


def fabric_available() -> bool:
    """Whether the fabric's transport is there: always, since it is the
    standard library's."""
    return True


def publish_addr_from_env(environ=None) -> Optional[str]:
    """The publish address :data:`TELEMETRY_PUBLISH_ENV` requests, or
    None."""
    value = (environ if environ is not None else os.environ).get(
        TELEMETRY_PUBLISH_ENV, "").strip()
    return value or None


def parse_addr(addr: str) -> Tuple[int, object]:
    """``(address family, socket address)`` of a ``tcp://host:port`` or
    ``ipc:///path`` address; ``ValueError`` for anything else."""
    if addr.startswith("ipc://"):
        path = addr[len("ipc://"):]
        if not path:
            raise ValueError(f"empty ipc:// path in {addr!r}")
        return socket.AF_UNIX, path
    if addr.startswith("tcp://"):
        host, sep, port = addr[len("tcp://"):].rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"{addr!r}: expected tcp://host:port")
        host = host.strip("[]")
        if host in ("*", ""):
            host = "0.0.0.0"
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        return family, (host, int(port))
    raise ValueError(f"{addr!r}: the telemetry fabric takes tcp://host:port "
                     f"or ipc:///path")


def encode_frame(msg: dict) -> bytes:
    """One message as a wire frame: length prefix + UTF-8 JSON."""
    payload = json.dumps(msg).encode("utf-8")
    return _FRAME.pack(len(payload)) + payload


#: Publishers started but not yet stopped — same abandonment-safety
#: pattern as the periodic exporter's atexit flush: a reader torn down
#: without ``close()`` still ships its final (``bye``) window.
_LIVE_PUBLISHERS: "weakref.WeakSet" = weakref.WeakSet()
_ATEXIT_REGISTERED = False
_ATEXIT_LOCK = threading.Lock()


def _flush_live_publishers() -> None:
    for pub in list(_LIVE_PUBLISHERS):
        try:
            pub.stop()
        except Exception:  # noqa: BLE001 - interpreter exit: best-effort only
            pass


def _register_atexit_flush() -> None:
    global _ATEXIT_REGISTERED
    with _ATEXIT_LOCK:
        if not _ATEXIT_REGISTERED:
            atexit.register(_flush_live_publishers)
            _ATEXIT_REGISTERED = True


class TelemetryPublisher:
    """Streams one registry's metrics to an aggregator as delta-encoded
    windows (module doc: wire format). ``member`` defaults to the
    registry's ``pipeline_id`` — mesh hosts pass ``h{N}``, pool owners
    ``w{id}``, the data service a tenant-scoped key. Self-telemetry rides
    the same registry (``fabric.published_windows`` et al.), so publish
    health is visible in the stream it publishes."""

    def __init__(self, registry, addr: str, member: Optional[str] = None,
                 tenant: Optional[str] = None, interval_s: float = 1.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._family, self._sockaddr = parse_addr(addr)
        self._registry = registry
        self.addr = addr
        self.member = str(member) if member else registry.pipeline_id
        self.tenant = tenant
        self._interval = float(interval_s)
        self._sock: Optional[socket.socket] = None
        self._started = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._send_lock = threading.Lock()
        self._seq = 0
        self._last_counters: Dict[str, float] = {}
        self._last_hist_sig: Dict[str, tuple] = {}
        self._last_event_seq = 0
        self._shipped_windows = 0
        #: Publisher-owned timeline: windows to ship exist even when the
        #: owning pipeline runs no sampler of its own (separate object —
        #: never double-feeds ``registry.timeline``).
        self.timeline = MetricsTimeline(interval_s=self._interval,
                                        window_count=DEFAULT_WINDOW_COUNT)
        self._c_windows = registry.counter("fabric.published_windows")
        self._c_bytes = registry.counter("fabric.published_bytes")
        self._c_errors = registry.counter("fabric.send_errors")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "TelemetryPublisher":
        if self._thread is not None:
            raise RuntimeError("TelemetryPublisher already started")
        self._started = True
        self._send(self._base_msg("hello", hello=True))
        _register_atexit_flush()
        _LIVE_PUBLISHERS.add(self)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-tpu-telemetry-pub")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.publish_once()
            except Exception:  # noqa: BLE001 - publisher must not die mid-run
                logger.exception("telemetry publish tick failed")

    def stop(self) -> None:
        """Idempotent: ships the final window (type ``bye``) and closes
        the socket. Safe to call after the owning reader is already
        closed — the registry outlives the reader."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self._interval + 5.0)
        _LIVE_PUBLISHERS.discard(self)
        if self._started:
            try:
                self.publish_once(final=True)
            except Exception:  # noqa: BLE001 - teardown best-effort
                pass
            with self._send_lock:
                self._started = False
                self._close_locked()

    # ------------------------------------------------------------ publishing
    def _base_msg(self, mtype: str, hello: bool = False) -> dict:
        self._seq += 1
        msg = {"v": FABRIC_SCHEMA_VERSION, "type": mtype,
               "member": self.member,
               "pipeline_id": self._registry.pipeline_id,
               "tenant": self.tenant, "seq": self._seq,
               "t_perf": time.perf_counter(),
               "interval_s": self._interval}
        if hello:
            msg["pid"] = os.getpid()
            msg["created_at"] = self._registry.created_at
        return msg

    def _build_window(self, final: bool) -> dict:
        view = self._registry.metrics_view()
        msg = self._base_msg("bye" if final else "window")
        counters = view.get("counters", {})
        changed = {k: v for k, v in counters.items()
                   if self._last_counters.get(k) != v}
        self._last_counters = dict(counters)
        msg["counters"] = changed
        msg["gauges"] = {k: v for k, v in view.get("gauges", {}).items()
                         if v is not None}
        hists = {}
        for name, h in view.get("histograms", {}).items():
            sig = (h.get("count"), h.get("sum"))
            if self._last_hist_sig.get(name) != sig:
                self._last_hist_sig[name] = sig
                hists[name] = h
        msg["histograms"] = hists
        events: List[dict] = []
        for name, ring in self._registry.events().items():
            for ev in ring:
                if ev["seq"] > self._last_event_seq:
                    events.append({"name": name, "seq": ev["seq"],
                                   "payload": ev["payload"]})
        if events:
            events.sort(key=lambda e: e["seq"])
            events = events[-EVENTS_PER_WINDOW:]
            self._last_event_seq = events[-1]["seq"]
            msg["events"] = events
        self.timeline.sample(view)
        ring = self.timeline.windows()
        total = self._shipped_windows
        fresh = [w for w in ring if w["index"] >= total]
        if fresh:
            self._shipped_windows = fresh[-1]["index"] + 1
            msg["timeline"] = {"interval_s": self.timeline.interval_s,
                               "windows": fresh}
        msg["accounting"] = accounting_totals(view)
        return msg

    def publish_once(self, final: bool = False) -> bool:
        """Build and send one window; returns whether the send succeeded
        (an absent or slow aggregator drops the frame and counts it).
        Delta state is only touched by the publisher thread and the
        (post-join) ``stop()`` caller, so the window builds lock-free;
        only the socket send races ``stop()``'s close."""
        if not self._started:
            return False
        return self._send(self._build_window(final))

    def _close_locked(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _peer_closed_locked(self) -> bool:
        """Whether the aggregator closed this connection (an aggregator
        that restarted): a readable socket with nothing to read. The
        aggregator never writes, so readable means EOF or an error."""
        try:
            readable, _, _ = select.select([self._sock], [], [], 0)
            if not readable:
                return False
            return self._sock.recv(1, socket.MSG_PEEK) == b""
        except OSError:
            return True

    def _connect_locked(self) -> None:
        sock = socket.socket(self._family, socket.SOCK_STREAM)
        try:
            sock.settimeout(self._interval)
            sock.connect(self._sockaddr)
        except OSError:
            sock.close()
            raise
        self._sock = sock

    def _send(self, msg: dict) -> bool:
        frame = encode_frame(msg)
        with self._send_lock:
            if not self._started:
                return False
            try:
                if self._sock is not None and self._peer_closed_locked():
                    self._close_locked()
                if self._sock is None:
                    self._connect_locked()
                # sendall's timeout bounds the whole frame: a slow
                # aggregator costs at most one interval.
                self._sock.sendall(frame)
            except OSError:
                # Absent, slow or restarted aggregator: drop the window
                # (cumulative encoding self-heals), reconnect next time.
                self._close_locked()
                self._c_errors.add(1)
                return False
        self._c_windows.add(1)
        self._c_bytes.add(len(frame) - _FRAME.size)
        return True


class _Connection:
    """One publisher's connection inside the aggregator: its socket and
    the bytes of a frame not yet complete."""

    __slots__ = ("sock", "buf")

    def __init__(self, sock):
        self.sock = sock
        self.buf = bytearray()


class _MemberState:
    """One stream's reconstruction state inside the aggregator."""

    __slots__ = ("key", "pipeline_id", "tenant", "counters", "applied",
                 "gauges", "histograms", "windows", "interval_s",
                 "heartbeat_s", "last_seq", "last_seen", "clock_offset_s",
                 "silent", "left", "resyncs", "windows_received")

    def __init__(self, key: str):
        self.key = key
        self.pipeline_id: Optional[str] = None
        self.tenant: Optional[str] = None
        #: Latest cumulative totals as the member reported them.
        self.counters: Dict[str, float] = {}
        #: Restart-corrected cumulative totals (sum of applied deltas) —
        #: what federation merges, so a member-side ``reset()`` never
        #: un-counts fleet progress.
        self.applied: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, dict] = {}
        self.windows: List[dict] = []
        self.interval_s = 1.0
        self.heartbeat_s = 1.0
        self.last_seq = 0
        self.last_seen: Optional[float] = None
        #: ``local perf_counter - remote perf_counter``; min over
        #: arrivals = the least-network-latency estimate.
        self.clock_offset_s: Optional[float] = None
        self.silent = False
        self.left = False
        self.resyncs = 0
        self.windows_received = 0

    def snapshot(self) -> dict:
        return {"counters": dict(self.applied),
                "gauges": dict(self.gauges),
                "histograms": dict(self.histograms)}

    def timeline_dict(self) -> dict:
        return {"interval_s": self.interval_s,
                "window_count": DEFAULT_WINDOW_COUNT,
                "windows_total": self.windows_received,
                "windows": list(self.windows)}


class TelemetryAggregator:
    """Continuous fleet rollup over fabric streams (module doc).

    Owns a fleet :class:`~petastorm_tpu_torch.telemetry.registry.
    TelemetryRegistry` — member counter deltas fold into it under bare
    names, its attached timeline derives the aggregate series, and the
    anomaly bank + SLO rules run on those — plus an
    :class:`~petastorm_tpu_torch.telemetry.accounting.AccountingLedger`
    billing every window to ``(pipeline_id, tenant)``. Drive it with
    :meth:`start`/:meth:`stop` (background thread) or :meth:`poll_once`
    (inline, e.g. from the ``telemetry top --connect`` render loop).
    """

    def __init__(self, addr: str, key_label: str = "member",
                 interval_s: float = 1.0, slo_rules=None,
                 anomaly_rules=None, registry=None, on_silent=None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        from petastorm_tpu_torch.telemetry.anomaly import AnomalyMonitor
        from petastorm_tpu_torch.telemetry.registry import TelemetryRegistry
        from petastorm_tpu_torch.telemetry.slo import SloWatcher
        family, sockaddr = parse_addr(addr)
        self.key_label = key_label
        self._interval = float(interval_s)
        self.registry = registry if registry is not None \
            else TelemetryRegistry()
        self.timeline = MetricsTimeline(interval_s=self._interval)
        self.registry.timeline = self.timeline
        self.anomaly = AnomalyMonitor(self.registry, rules=anomaly_rules)
        self.timeline.add_listener(self.anomaly.observe_window)
        # Not start()ed: tick() drives check_once inline so SLO rules
        # evaluate on the same cadence as the aggregate timeline.
        self._slo = SloWatcher(self.registry, rules=slo_rules,
                               interval_s=self._interval)
        self.ledger = AccountingLedger()
        self._members: Dict[str, _MemberState] = {}
        self._lock = threading.Lock()
        self._on_silent = on_silent
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_tick: Optional[float] = None
        self._c_received = self.registry.counter("fabric.windows_received")
        self._c_joined = self.registry.counter("fabric.members_joined")
        self._c_left = self.registry.counter("fabric.members_left")
        self._c_resyncs = self.registry.counter("fabric.member_resyncs")
        self._c_bad = self.registry.counter("fabric.bad_messages")
        self._c_silent = self.registry.counter("anomaly.member_silent_total")
        self._c_detections = self.registry.counter("anomaly.detections_total")
        self.registry.gauge("fabric.members_live",
                            fn=lambda: float(len(self.live_members())))
        self._ipc_path = sockaddr if family == socket.AF_UNIX else None
        if self._ipc_path is not None:
            _unlink_stale_socket(self._ipc_path)
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        try:
            if family != socket.AF_UNIX:
                self._listener.setsockopt(socket.SOL_SOCKET,
                                          socket.SO_REUSEADDR, 1)
            self._listener.bind(sockaddr)
            self._listener.listen(128)
        except OSError:
            self._listener.close()
            raise
        self._listener.setblocking(False)
        #: The bound address (a ``tcp://...:0`` request names its port).
        self.addr = addr
        if family != socket.AF_UNIX:
            host, port = self._listener.getsockname()[:2]
            self.addr = f"tcp://[{host}]:{port}" if family == socket.AF_INET6 \
                else f"tcp://{host}:{port}"
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ, None)
        self._io_lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "TelemetryAggregator":
        if self._thread is not None:
            raise RuntimeError("TelemetryAggregator already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="petastorm-tpu-telemetry-agg")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - aggregator must not die mid-run
                logger.exception("telemetry aggregator poll failed")

    def poll_once(self, timeout_s: Optional[float] = None) -> int:
        """Drain ready messages (bounded wait), then run due ticks;
        returns the number of messages handled."""
        wait_s = (timeout_s if timeout_s is not None
                  else min(self._interval / 2, 0.2))
        handled = 0
        with self._io_lock:
            if self._closed:
                return 0
            for key, _mask in self._selector.select(max(wait_s, 0.001)):
                if key.data is None:
                    self._accept_all()
                else:
                    handled += self._read(key.data)
        now = time.perf_counter()
        if self._last_tick is None or now - self._last_tick >= self._interval:
            self.tick(now)
        return handled

    def _accept_all(self) -> None:
        while True:
            try:
                sock, _peer = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                logger.exception("telemetry aggregator accept failed")
                return
            sock.setblocking(False)
            self._selector.register(sock, selectors.EVENT_READ,
                                    _Connection(sock))

    def _read(self, conn: _Connection) -> int:
        """Read what one connection has; handle every complete frame.
        EOF (a publisher that stopped or reconnects) drops any partial
        frame with the connection."""
        handled = 0
        while True:
            try:
                chunk = conn.sock.recv(1 << 20)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                chunk = b""
            if not chunk:
                self._drop(conn)
                break
            conn.buf += chunk
            while len(conn.buf) >= _FRAME.size:
                (length,) = _FRAME.unpack_from(conn.buf)
                if length > MAX_FRAME_BYTES:
                    # Not a fabric stream: count it, close it.
                    self._c_bad.add(1)
                    self._drop(conn)
                    return handled
                if len(conn.buf) < _FRAME.size + length:
                    break
                raw = bytes(conn.buf[_FRAME.size:_FRAME.size + length])
                del conn.buf[:_FRAME.size + length]
                self._handle_raw(raw)
                handled += 1
        return handled

    def _drop(self, conn: _Connection) -> None:
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.close()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5.0)
            self._thread = None
        with self._io_lock:
            if self._closed:
                return
            self._closed = True
            for key in list(self._selector.get_map().values()):
                if key.data is not None:
                    key.data.sock.close()
            self._selector.close()
            self._listener.close()
            if self._ipc_path is not None:
                _unlink_stale_socket(self._ipc_path)

    # ------------------------------------------------------------ ingest
    def _handle_raw(self, raw: bytes) -> None:
        try:
            msg = json.loads(raw.decode("utf-8"))
            version = int(msg["v"])
            member = str(msg["member"])
            mtype = msg["type"]
        except Exception:  # noqa: BLE001 - malformed frame: count, never crash
            self._c_bad.add(1)
            return
        if version > FABRIC_SCHEMA_VERSION or mtype not in (
                "hello", "window", "bye"):
            self._c_bad.add(1)
            return
        self.handle_message(member, mtype, msg)

    def handle_message(self, member: str, mtype: str, msg: dict) -> None:
        now = time.perf_counter()
        with self._lock:
            state = self._members.get(member)
            if state is None:
                state = self._members[member] = _MemberState(member)
                self._c_joined.add(1)
            rejoined = state.left or state.silent
            pipeline_id = msg.get("pipeline_id")
            if state.pipeline_id is not None \
                    and pipeline_id != state.pipeline_id:
                # Same key, new incarnation: drop delta baselines so the
                # fresh process's cumulative totals read as a restart,
                # not a negative delta.
                state.counters = {}
                state.last_seq = 0
                state.resyncs += 1
                self._c_resyncs.add(1)
            state.pipeline_id = pipeline_id
            state.tenant = msg.get("tenant")
            state.heartbeat_s = float(msg.get("interval_s")
                                      or state.heartbeat_s)
            state.last_seen = now
            state.left = (mtype == "bye")
            if state.silent:
                state.silent = False
                self.registry.record_event(
                    "fabric.member_rejoined",
                    {"member": member, "missed": msg.get("seq")})
            if rejoined and mtype != "hello":
                state.resyncs += 1
                self._c_resyncs.add(1)
            t_perf = msg.get("t_perf")
            if t_perf is not None:
                offset = now - float(t_perf)
                if state.clock_offset_s is None \
                        or offset < state.clock_offset_s:
                    # Min over arrivals: the estimate with the least
                    # network/queueing latency baked in (live handshake
                    # form of the trace plane's per-file re-anchor).
                    state.clock_offset_s = offset
            if mtype == "hello":
                return
            seq = int(msg.get("seq", 0))
            if state.last_seq and seq > state.last_seq + 1:
                state.resyncs += 1
                self._c_resyncs.add(1)
            state.last_seq = seq
            self._apply_window(state, msg)
        if mtype == "bye":
            self._c_left.add(1)

    def _apply_window(self, state: _MemberState, msg: dict) -> None:
        self._c_received.add(1)
        state.windows_received += 1
        for name, cum in (msg.get("counters") or {}).items():
            cum = float(cum)
            prev = state.counters.get(name)
            delta = cum - prev if prev is not None and cum >= prev \
                else max(cum, 0.0)
            state.counters[name] = cum
            state.applied[name] = round(
                state.applied.get(name, 0.0) + delta, 6)
            if delta > 0:
                # Fold the member's progress into the fleet registry
                # under the bare name: the aggregate timeline/anomaly/SLO
                # machinery then sees fleet-sum counters exactly as a
                # single pipeline's.
                self.registry.counter(name).add(delta)
        for name, value in (msg.get("gauges") or {}).items():
            state.gauges[name] = value
        for name, h in (msg.get("histograms") or {}).items():
            state.histograms[name] = h
        for ev in msg.get("events") or ():
            payload = dict(ev.get("payload") or {})
            payload.setdefault("member", state.key)
            self.registry.record_event(ev["name"], payload)
        tl = msg.get("timeline")
        if tl:
            state.interval_s = float(tl.get("interval_s")
                                     or state.interval_s)
            offset = state.clock_offset_s or 0.0
            for w in tl.get("windows", ()):
                state.windows.append(dict(
                    w, t_s=round(float(w["t_s"]) + offset, 6)))
            del state.windows[:-DEFAULT_WINDOW_COUNT]
        acct = msg.get("accounting")
        if acct and state.pipeline_id:
            self.ledger.apply(state.pipeline_id, state.tenant, acct,
                              member=state.key)

    # ------------------------------------------------------------ ticking
    def tick(self, now: Optional[float] = None) -> None:
        """One aggregation beat: silence detection over every member,
        then an aggregate timeline window (anomaly bank runs as its
        listener) and an SLO evaluation on the fleet registry."""
        now = time.perf_counter() if now is None else now
        self._last_tick = now
        newly_silent: List[dict] = []
        with self._lock:
            for state in self._members.values():
                if state.left or state.silent or state.last_seen is None:
                    continue
                quiet_s = now - state.last_seen
                limit = SILENCE_AFTER_HEARTBEATS * state.heartbeat_s
                if quiet_s > limit:
                    state.silent = True
                    newly_silent.append(
                        {"rule": "member_silent", "kind": "silence",
                         "member": state.key, "quiet_s": round(quiet_s, 3),
                         "heartbeat_s": state.heartbeat_s,
                         "tenant": state.tenant})
        for det in newly_silent:
            # Entry-edge, standard anomaly conventions: composes with
            # `telemetry check` / SLO counter rules unmodified.
            self._c_silent.add(1)
            self._c_detections.add(1)
            self.registry.record_event("anomaly.member_silent", det)
            logger.warning("Fabric member silent: %(member)s quiet for "
                           "%(quiet_s)ss (heartbeat %(heartbeat_s)ss)", det)
            if self._on_silent is not None:
                try:
                    self._on_silent(det)
                except Exception:  # noqa: BLE001 - callback must not kill ticks
                    logger.exception("on_silent callback failed")
        self.timeline.sample(self.registry.metrics_view(), now_s=now)
        try:
            self._slo.check_once()
        except Exception:  # noqa: BLE001 - SLO eval must not kill the beat
            logger.exception("aggregate SLO evaluation failed")

    # ------------------------------------------------------------ readout
    def live_members(self) -> List[str]:
        with self._lock:
            return sorted(k for k, s in self._members.items()
                          if not s.left and not s.silent
                          and s.last_seen is not None)

    def members_report(self) -> dict:
        with self._lock:
            return {k: {"pipeline_id": s.pipeline_id, "tenant": s.tenant,
                        "silent": s.silent, "left": s.left,
                        "resyncs": s.resyncs,
                        "windows_received": s.windows_received,
                        "heartbeat_s": s.heartbeat_s,
                        "clock_offset_s": s.clock_offset_s}
                    for k, s in sorted(self._members.items())}

    def federated_snapshot(self) -> dict:
        with self._lock:
            members = {k: s.snapshot() for k, s in self._members.items()}
        return federate_snapshots(members, key_label=self.key_label)

    def federated_timeline(self) -> dict:
        with self._lock:
            members = {k: s.timeline_dict()
                       for k, s in self._members.items()}
        return federate_timelines(members, key_label=self.key_label)

    def fleet_snapshot(self) -> dict:
        """The flushable fleet state: a standard registry snapshot (fleet
        counters, aggregate timeline, anomaly/SLO events — everything
        ``telemetry top``/``check --anomaly`` already consume) extended
        with the federation rollup, per-member federated timeline,
        member states, and the accounting ledger."""
        snap = self.registry.snapshot()
        snap["federation"] = self.federated_snapshot()
        snap["fleet_timeline"] = self.federated_timeline()
        snap["fabric_members"] = self.members_report()
        snap["accounting"] = self.ledger.report()
        return snap

    def flush(self, path: str, fmt: str = "json") -> None:
        """Atomically write :meth:`fleet_snapshot` to ``path`` in the
        existing snapshot formats (``telemetry check --anomaly`` gates
        the file in CI exactly like a single-pipeline export)."""
        from petastorm_tpu_torch.telemetry.exporters import write_snapshot
        write_snapshot(path, self.fleet_snapshot(), fmt)


def _unlink_stale_socket(path: str) -> None:
    """Remove a Unix socket file left at ``path`` (a previous aggregator's),
    never a file of another kind."""
    try:
        if stat.S_ISSOCK(os.stat(path).st_mode):
            os.unlink(path)
    except OSError:
        pass
