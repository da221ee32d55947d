"""The telemetry fabric of petastorm_tpu_torch held against the JAX
package's, and its standard-library transport.

No JAX socket is ever opened: the two fabrics meet through
``TelemetryPublisher._build_window`` and ``TelemetryAggregator.
handle_message`` (the JAX aggregator is built over a stand-in for its zmq
module that binds nothing). The port's own transport is exercised over
``tcp://127.0.0.1`` and ``ipc://``: hello, windows and bye, a reconnect after
the aggregator restarts, windows dropped and counted with no hang when no
aggregator listens or one never reads, malformed and newer-version frames
counted in ``fabric.bad_messages``, the atexit ``bye``, and the CLI's
``serve`` and ``top --connect``. Waits are bounded and wait on a condition.
"""
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import uuid

import pytest

from petastorm_tpu import telemetry as jt
from petastorm_tpu.telemetry import fabric as jfab
from petastorm_tpu_torch import telemetry as tt
from petastorm_tpu_torch.telemetry import fabric as tfab
from petastorm_tpu_torch.telemetry.__main__ import main as torch_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _NoSocket:
    """What the JAX aggregator's constructor and ``stop`` call on a zmq
    socket, doing nothing."""

    def setsockopt(self, *_):
        pass

    def bind(self, _addr):
        pass

    def close(self):
        pass


class _NoZmq:
    """A stand-in for the JAX fabric's zmq module: no socket is opened."""
    PULL = PUSH = RCVHWM = SNDHWM = LINGER = SNDTIMEO = NOBLOCK = 0

    class Context:
        @staticmethod
        def instance():
            return _NoZmq.Context()

        def socket(self, _kind):
            return _NoSocket()


@pytest.fixture
def jax_aggregator(monkeypatch):
    monkeypatch.setattr(jfab, "zmq", _NoZmq)
    made = []

    def make(**kw):
        agg = jfab.TelemetryAggregator("ipc:///nowhere", **kw)
        made.append(agg)
        return agg
    yield make
    for agg in made:
        agg.stop()


@pytest.fixture
def ipc_addr():
    # Short /tmp path: AF_UNIX paths are limited to about 100 characters.
    path = f"/tmp/pttfab-{uuid.uuid4().hex[:12]}"
    yield f"ipc://{path}"
    if os.path.exists(path):
        os.unlink(path)


def _wait(cond, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def _poll_until(agg, cond, timeout_s=10.0):
    return _wait(lambda: (agg.poll_once(timeout_s=0.01), cond())[1], timeout_s)


def _counters(reg):
    return reg.metrics_view()["counters"]


# ---------------------------------------------------------- the messages
def _evolve(pkg, reg, step):
    reg.counter("reader.rows").add(100 * (step + 1))
    reg.counter("io.bytes_read").add(4096)
    if step % 2:
        reg.counter("cache.mem.hits").add(1)
    reg.gauge("ventilator.backlog").set(float(step))
    reg.gauge("dead.gauge", fn=lambda: None)
    reg.histogram("worker.decode_s").observe(0.01 * (step + 1))
    if step != 1:
        reg.histogram("loader.host_wait_seconds").observe(0.2)
    # Step 2 records 80 events over 5 names (a ring keeps 16 a name): more
    # than EVENTS_PER_WINDOW.
    for name in range(5 if step == 2 else 1):
        for k in range(16 if step == 2 else step):
            reg.record_event(f"resilience.e{name}", {"step": step, "k": k})


def _mask(msg):
    msg = dict(msg)
    for key in ("t_perf", "pid", "pipeline_id", "created_at"):
        msg.pop(key, None)
    if "timeline" in msg:
        tl = msg["timeline"]
        msg["timeline"] = {"interval_s": tl["interval_s"],
                           "windows": [(w["index"], sorted(w["series"]))
                                       for w in tl["windows"]]}
    return msg


def _messages(fab, pkg, member="h0", tenant="alpha", steps=4):
    reg = pkg.TelemetryRegistry()
    pub = fab.TelemetryPublisher(reg, "ipc:///nowhere", member=member, tenant=tenant,
                                 interval_s=0.5)
    msgs = [pub._base_msg("hello", hello=True)]
    for step in range(steps):
        _evolve(pkg, reg, step)
        msgs.append(pub._build_window(final=False))
    msgs.append(pub._build_window(final=True))
    return msgs, reg


def test_publishers_build_the_jax_messages():
    jax_msgs, jreg = _messages(jfab, jt)
    torch_msgs, treg = _messages(tfab, tt)
    assert [_mask(m) for m in torch_msgs] == [_mask(m) for m in jax_msgs]
    assert torch_msgs[0]["pid"] == os.getpid() and torch_msgs[0]["created_at"] == treg.created_at
    assert all(m["pipeline_id"] == treg.pipeline_id for m in torch_msgs)
    assert len(torch_msgs[3]["events"]) == tfab.EVENTS_PER_WINDOW == jfab.EVENTS_PER_WINDOW
    assert torch_msgs[-1]["type"] == "bye" and "accounting" in torch_msgs[-1]
    assert (tfab.FABRIC_SCHEMA_VERSION, tfab.TELEMETRY_PUBLISH_ENV,
            tfab.SILENCE_AFTER_HEARTBEATS) == (jfab.FABRIC_SCHEMA_VERSION,
                                               jfab.TELEMETRY_PUBLISH_ENV,
                                               jfab.SILENCE_AFTER_HEARTBEATS)


def _stream(builder):
    """Three members' messages, interleaved, one member never says bye and
    one restarts as a new incarnation under its key."""
    fab, pkg = builder
    a, _ = _messages(fab, pkg, member="h0", tenant="alpha")
    b, _ = _messages(fab, pkg, member="h1", tenant="beta", steps=3)
    c, _ = _messages(fab, pkg, member="h2", tenant=None, steps=2)
    a2, _ = _messages(fab, pkg, member="h0", tenant="alpha", steps=2)
    b = b[:-1]              # h1 goes quiet without a bye
    del a[3]                # a window lost on the way
    stream = []
    for i in range(max(len(a), len(b), len(c))):
        for msgs in (a, b, c):
            if i < len(msgs):
                stream.append(msgs[i])
    return stream + a2


def _mask_members(report):
    return {k: dict(v, clock_offset_s=None) for k, v in report.items()}


def _fold(agg, stream):
    for msg in stream:
        agg.handle_message(str(msg["member"]), msg["type"], msg)
    agg.tick(now=time.perf_counter() + 100.0)   # every member still live goes silent
    fleet = agg.registry.metrics_view()["counters"]
    silent = [{k: v for k, v in e["payload"].items() if k != "quiet_s"}
              for e in agg.registry.events("anomaly.member_silent")]
    return {"members": _mask_members(agg.members_report()),
            "federated": agg.federated_snapshot(),
            "timeline_series": sorted(agg.federated_timeline()["series"]),
            "ledger": agg.ledger.report(), "silent": silent,
            "fleet": {k: v for k, v in fleet.items() if not k.startswith("timeline.")}}


@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_aggregators_fold_either_packages_stream_alike(builder, jax_aggregator, ipc_addr):
    stream = _stream({"jax": (jfab, jt), "torch": (tfab, tt)}[builder])
    theirs = _fold(jax_aggregator(interval_s=0.5), stream)
    ours_agg = tfab.TelemetryAggregator(ipc_addr, interval_s=0.5)
    try:
        ours = _fold(ours_agg, stream)
    finally:
        ours_agg.stop()
    # pipeline ids are per registry: compare the ledgers by tenant and fields
    for rep in (ours, theirs):
        for row in rep["ledger"]["pipelines"]:
            row["pipeline_id"] = "p"
        for m in rep["members"].values():
            m["pipeline_id"] = "p"
    assert ours == theirs
    members = ours["members"]
    assert members["h0"]["resyncs"] >= 2 and members["h2"]["left"] and members["h1"]["silent"]
    assert [s["member"] for s in ours["silent"]] == ["h1"]
    assert ours["ledger"]["tenants"]["alpha"]["rows"] == 1000 + 300
    assert ours["fleet"]["fabric.members_joined"] == 3


def test_refused_frames_are_counted_alike(jax_aggregator, ipc_addr):
    frames = [b"not json at all", json.dumps({"v": 2, "type": "window", "member": "x"}).encode(),
              json.dumps({"v": 1, "type": "mystery", "member": "x"}).encode(),
              json.dumps({"v": 1, "type": "window"}).encode(), b"\xff\xfe"]
    theirs = jax_aggregator(interval_s=1.0)
    ours = tfab.TelemetryAggregator(ipc_addr, interval_s=1.0)
    try:
        for raw in frames:
            theirs._handle_raw(raw)
            ours._handle_raw(raw)
        assert _counters(ours.registry)["fabric.bad_messages"] \
            == _counters(theirs.registry)["fabric.bad_messages"] == len(frames)
        assert not ours.members_report()
    finally:
        ours.stop()


# --------------------------------------------------------- the transport
@pytest.mark.parametrize("kind", ["tcp", "ipc"])
def test_hello_windows_and_bye_over_the_wire(kind, ipc_addr):
    agg = tfab.TelemetryAggregator("tcp://127.0.0.1:0" if kind == "tcp" else ipc_addr,
                                   interval_s=0.1)
    regs = [tt.TelemetryRegistry() for _ in range(3)]
    try:
        pubs = [tfab.TelemetryPublisher(reg, agg.addr, member=f"h{i}", tenant=f"t{i % 2}",
                                        interval_s=60.0).start()
                for i, reg in enumerate(regs)]
        assert _poll_until(agg, lambda: len(agg.members_report()) == 3)
        for step in range(3):
            for i, reg in enumerate(regs):
                reg.counter("reader.rows").add(10 * (i + 1))
                assert pubs[i].publish_once()
        for pub in pubs:
            pub.stop()
        assert _poll_until(agg, lambda: all(m["left"] for m in agg.members_report().values()))
        fleet = _counters(agg.registry)
        assert fleet["reader.rows"] == 3 * (10 + 20 + 30)
        assert fleet["fabric.members_joined"] == 3 and fleet["fabric.members_left"] == 3
        assert fleet["fabric.windows_received"] == 3 * 4 and not fleet.get("fabric.bad_messages")
        assert agg.ledger.report()["tenants"]["t0"]["rows"] == 3 * (10 + 30)
        for reg in regs:
            c = _counters(reg)
            assert c["fabric.published_windows"] == 5 and not c.get("fabric.send_errors")
            assert c["fabric.published_bytes"] > 0
        assert agg.addr.startswith(kind)
    finally:
        agg.stop()
    if kind == "ipc":
        assert not os.path.exists(ipc_addr[len("ipc://"):])


@pytest.mark.parametrize("kind", ["tcp", "ipc"])
def test_a_publisher_reconnects_after_the_aggregator_restarts(kind, ipc_addr):
    first = tfab.TelemetryAggregator("tcp://127.0.0.1:0" if kind == "tcp" else ipc_addr,
                                     interval_s=0.1)
    reg = tt.TelemetryRegistry()
    pub = tfab.TelemetryPublisher(reg, first.addr, member="h0", interval_s=60.0).start()
    try:
        reg.counter("reader.rows").add(5)
        assert pub.publish_once()
        assert _poll_until(first, lambda: _counters(first.registry).get("reader.rows") == 5)
        first.stop()
        reg.counter("reader.rows").add(3)
        assert not pub.publish_once()        # the aggregator is gone: dropped, counted
        errors = _counters(reg)["fabric.send_errors"]
        assert errors >= 1
        second = tfab.TelemetryAggregator(first.addr, interval_s=0.1)
        try:
            reg.counter("reader.rows").add(2)
            assert pub.publish_once()        # a new connection on the next window
            # Cumulative counters: the new aggregator sees the whole 10.
            assert _poll_until(second, lambda: _counters(second.registry).get("reader.rows")
                               == 10)
            assert _counters(reg)["fabric.send_errors"] == errors
        finally:
            pub.stop()
            second.stop()
    finally:
        pub.stop()
        first.stop()


def test_no_aggregator_drops_windows_without_a_hang(ipc_addr):
    for addr in (ipc_addr, "tcp://127.0.0.1:1"):
        reg = tt.TelemetryRegistry()
        t0 = time.perf_counter()
        pub = tfab.TelemetryPublisher(reg, addr, interval_s=0.05).start()
        assert not pub.publish_once() and not pub.publish_once()
        pub.stop()
        pub.stop()   # idempotent
        assert time.perf_counter() - t0 < 5.0
        # hello, two windows, the bye, and whatever the thread sent
        assert _counters(reg)["fabric.send_errors"] >= 4
        assert not _counters(reg).get("fabric.published_windows")


def test_a_send_to_an_aggregator_that_never_reads_waits_one_interval(ipc_addr):
    path = ipc_addr[len("ipc://"):]
    stalled = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stalled.bind(path)
    stalled.listen(4)   # never accepts, never reads
    try:
        reg = tt.TelemetryRegistry()
        for i in range(20000):
            reg.counter(f"bulk.counter_{i:05d}_with_a_long_name_to_fill_the_buffers").add(1)
        pub = tfab.TelemetryPublisher(reg, ipc_addr, interval_s=0.2)
        pub._started = True   # publish without the background thread
        t0 = time.perf_counter()
        sent = [pub.publish_once() for _ in range(3)]
        elapsed = time.perf_counter() - t0
        assert False in sent and elapsed < 3 * (0.2 + 0.5) + 1.0
        assert _counters(reg)["fabric.send_errors"] >= 1
        pub._started = False
    finally:
        stalled.close()


def test_malformed_frames_on_the_wire_are_counted(ipc_addr):
    agg = tfab.TelemetryAggregator(ipc_addr, interval_s=0.1)
    try:
        path = ipc_addr[len("ipc://"):]
        good = tfab.encode_frame({"v": 1, "type": "window", "member": "x", "seq": 1,
                                  "counters": {"reader.rows": 4.0}})
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(path)
            s.sendall(b"\x00\x00\x00\x05{bad}" + tfab.encode_frame({"v": 99, "type": "window",
                                                                     "member": "x"})
                      + good[:3])
            s.sendall(good[3:])   # a frame split across writes
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(path)
            s.sendall(b"\xff\xff\xff\xff garbage that claims 4 GiB")
        assert _poll_until(agg, lambda: _counters(agg.registry).get("fabric.bad_messages") == 3
                           and _counters(agg.registry).get("reader.rows") == 4.0)
        assert list(agg.members_report()) == ["x"]
    finally:
        agg.stop()


def test_the_atexit_flush_sends_the_bye_of_an_abandoned_publisher():
    agg = tfab.TelemetryAggregator("tcp://127.0.0.1:0", interval_s=0.1)
    code = ("import sys\n"
            "from petastorm_tpu_torch.telemetry import TelemetryRegistry\n"
            "from petastorm_tpu_torch.telemetry.fabric import TelemetryPublisher\n"
            "reg = TelemetryRegistry()\n"
            "TelemetryPublisher(reg, sys.argv[1], member='abandoned', interval_s=60).start()\n"
            "reg.counter('reader.rows').add(7)\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code, agg.addr], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                              text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        assert _poll_until(agg, lambda: agg.members_report().get("abandoned", {}).get("left"))
        assert _counters(agg.registry)["reader.rows"] == 7
    finally:
        agg.stop()


def test_many_publishers_racing_lose_no_update(ipc_addr):
    """More publisher threads than cores, each adding rows and sending
    windows while its registry's counters move, into one aggregator whose
    own thread folds them (switch interval shortened): the fleet total and
    the ledger equal the rows added, and every member leaves."""
    threads_n = 2 * (os.cpu_count() or 4)
    agg = tfab.TelemetryAggregator(ipc_addr, interval_s=0.05).start()
    regs = [tt.TelemetryRegistry() for _ in range(threads_n)]
    pubs = [tfab.TelemetryPublisher(reg, ipc_addr, member=f"w{i}", tenant=f"t{i % 3}",
                                    interval_s=60.0) for i, reg in enumerate(regs)]
    errors = []

    def run(i):
        try:
            pubs[i].start()
            for step in range(20):
                regs[i].counter("reader.rows").add(i + 1)
                regs[i].histogram("worker.decode_s").observe(0.001 * step)
                pubs[i].publish_once()
            pubs[i].stop()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=run, args=(i,)) for i in range(threads_n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60.0)
        assert not any(w.is_alive() for w in workers) and not errors, errors
    finally:
        sys.setswitchinterval(switch)
    try:
        assert _wait(lambda: len(agg.members_report()) == threads_n
                     and all(m["left"] for m in agg.members_report().values()), 20.0)
        want = sum(20 * (i + 1) for i in range(threads_n))
        assert _counters(agg.registry)["reader.rows"] == want
        tenants = agg.ledger.report()["tenants"]
        assert sum(tenants[t]["rows"] for t in tenants) == want
        assert not _counters(agg.registry).get("fabric.bad_messages")
        assert not any(_counters(reg).get("fabric.send_errors") for reg in regs)
    finally:
        agg.stop()


def test_addresses_and_the_environment():
    assert tfab.fabric_available() and tt.fabric_available()
    env = {tfab.TELEMETRY_PUBLISH_ENV: " tcp://127.0.0.1:5556 "}
    assert tfab.publish_addr_from_env(env) == jfab.publish_addr_from_env(env)
    assert tfab.publish_addr_from_env({}) is None
    assert tfab.parse_addr("tcp://*:5556") == (socket.AF_INET, ("0.0.0.0", 5556))
    assert tfab.parse_addr("ipc:///tmp/x") == (socket.AF_UNIX, "/tmp/x")
    for bad in ("inproc://x", "tcp://host", "tcp://h:port", "ipc://"):
        with pytest.raises(ValueError):
            tfab.parse_addr(bad)
    with pytest.raises(ValueError):
        tfab.TelemetryPublisher(tt.TelemetryRegistry(), "tcp://127.0.0.1:1", interval_s=0)


def test_a_bound_address_is_refused_to_a_second_aggregator():
    first = tfab.TelemetryAggregator("tcp://127.0.0.1:0", interval_s=0.1)
    try:
        with pytest.raises(OSError):
            tfab.TelemetryAggregator(first.addr, interval_s=0.1)
    finally:
        first.stop()


# ------------------------------------------------------------------- CLI
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = torch_cli(argv)
    return rc, out.getvalue()


def test_serve_flush_feeds_check_and_top(tmp_path):
    addr = f"tcp://127.0.0.1:{_free_port()}"
    path = tmp_path / "fleet.json"
    result = {}
    server = threading.Thread(target=lambda: result.update(
        zip(("rc", "out"), _cli(["serve", addr, "--interval", "0.2", "--count", "4",
                                 "--flush", str(path)]))))
    reg = tt.TelemetryRegistry()
    # A long heartbeat: the test sends every window itself, rows flowing
    # until the server has made its last beat.
    pub = tfab.TelemetryPublisher(reg, addr, member="h0", tenant="alpha", interval_s=60.0)
    server.start()
    try:
        pub.start()
        assert _wait(pub.publish_once)   # the server is up
        sent = 0
        while server.is_alive() and sent < 2000:
            reg.counter("reader.rows").add(5)
            sent += pub.publish_once()
            time.sleep(0.01)   # the rows' pace
    finally:
        server.join(30.0)
        pub.stop()
    assert not server.is_alive() and result["rc"] == 0, result
    snap = json.loads(path.read_text())
    assert snap["fabric_members"]["h0"]["tenant"] == "alpha"
    assert snap["accounting"]["tenants"]["alpha"]["rows"] > 0
    assert _cli(["check", str(path), "--anomaly"])[0] == 0
    rc, out = _cli(["top", str(path), "--count", "1", "--no-clear"])
    assert rc == 0 and "fabric members" in out and "per-tenant accounting" in out


def test_top_connect_renders_the_live_fleet():
    addr = f"tcp://127.0.0.1:{_free_port()}"
    result = {}
    top = threading.Thread(target=lambda: result.update(
        zip(("rc", "out"), _cli(["top", "--connect", addr, "--interval", "1.0", "--count", "1",
                                 "--no-clear"]))))
    top.start()
    reg = tt.TelemetryRegistry()
    pub = tfab.TelemetryPublisher(reg, addr, member="h7", tenant="beta", interval_s=60.0)
    try:
        pub.start()
        reg.counter("reader.rows").add(9)
        assert _wait(lambda: pub.publish_once() or not top.is_alive(), 10.0)
    finally:
        top.join(30.0)
        pub.stop()
    assert result["rc"] == 0 and "petastorm-tpu top" in result["out"]
    assert "h7" in result["out"] and "beta" in result["out"]
