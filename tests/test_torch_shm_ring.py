"""The port's shared-memory ring (``petastorm_tpu_torch.native.ShmRing``,
``reader_impl.shm_ring.PyShmRing`` and ``RingReader``) on both
implementations, following the JAX package's ring tests
(``tests/test_zerocopy.py``), then the ring protocol across the two
packages (a JAX producer read by the port's consumer and the reverse, the
payloads equal byte for byte) and the port's pickle serializer against the
JAX package's on the same rows. Rings of 8 KiB to 1 MiB."""
import pickle
import threading
import time
import uuid

import numpy as np
import pytest

from petastorm_tpu.native import make_ring as jax_make_ring
from petastorm_tpu.native import ring_available as jax_ring_available
from petastorm_tpu.reader_impl.pickle_serializer import PickleSerializer as JaxPickleSerializer
from petastorm_tpu_torch.native import RingClosed, TimeoutError_, make_ring, ring_available
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.reader_impl.shm_ring import PyShmRing, RingReader, SegmentClaim


def _ring_name():
    return f"/pttest_{uuid.uuid4().hex[:10]}"


def _impls():
    return ["py", "native"] if ring_available() else ["py"]


@pytest.fixture
def ring_pair(request):
    """(consumer, producer) of one segment: ``request.param`` is
    ``(impl, capacity)``."""
    impl, capacity = request.param
    name = _ring_name()
    cons = make_ring(name, capacity=capacity, create=True, impl=impl)
    prod = make_ring(name, create=False, impl=impl)
    yield cons, prod
    prod.close()
    cons.close()


def _pairs(capacity):
    return [pytest.param((impl, capacity), id=impl) for impl in _impls()]


def test_native_ring_builds_here():
    """The sandbox has g++: the native ring must build (the card's probe
    asserts the same)."""
    assert ring_available()


@pytest.mark.parametrize("ring_pair", _pairs(1 << 16), indirect=True)
def test_wraparound_many_records(ring_pair):
    cons, prod = ring_pair
    for i in range(300):
        payload = bytes([i % 251]) * (800 + (i * 37) % 700)
        prod.write_tagged(ord("D"), payload, timeout_ms=2000)
        kind, view = cons.read_tagged_view(timeout_ms=2000)
        assert kind == ord("D") and bytes(view) == payload
        view.release()
        cons.advance()


@pytest.mark.parametrize("ring_pair", _pairs(1 << 15), indirect=True)
def test_reader_reads_ahead_of_claims_and_releases_in_order(ring_pair):
    class FakeClaim:
        released = False

    cons, prod = ring_pair
    reader = RingReader(cons)
    payloads = [bytes([i]) * 600 for i in range(12)]
    for p in payloads[:8]:
        prod.write_tagged(ord("D"), p, timeout_ms=2000)
    claims = []
    for i in range(8):
        _, view = reader.try_read()
        assert bytes(view) == payloads[i]
        view.release()
        claims.append(FakeClaim())
        reader.claim(claims[-1])
    assert reader.try_read() is None
    assert reader.outstanding == 8 and reader.pinned == 8 and reader.reap() == 0
    claims[2].released = True
    assert reader.reap() == 0            # in order: 0 and 1 still pinned
    claims[0].released = claims[1].released = True
    assert reader.reap() == 3
    for p in payloads[8:]:
        prod.write_tagged(ord("D"), p, timeout_ms=2000)
    for i in range(8, 12):
        _, view = reader.try_read()
        assert bytes(view) == payloads[i]
        view.release()
        reader.complete()
    for c in claims:
        c.released = True
    assert reader.reap() == 9 and reader.outstanding == 0
    reader.close()


def test_torn_frame_never_surfaces():
    """A producer that dies mid-write leaves no readable record: payload
    bytes after the first record, but neither length nor head published."""
    name = _ring_name()
    cons = PyShmRing(name, capacity=1 << 14, create=True)
    prod = PyShmRing(name, create=False)
    try:
        prod.write_tagged(ord("D"), b"good" * 10, timeout_ms=1000)
        base = 64 + prod.head() % prod.capacity
        prod._buf[base + 4:base + 12] = b"tornnnnn"
        kind, view = cons.read_tagged_view(timeout_ms=200)
        assert bytes(view) == b"good" * 10
        view.release()
        cons.advance()
        assert not cons.poll(0) and cons.discard_unread() == 0
    finally:
        prod.close()
        cons.close()


@pytest.mark.parametrize("ring_pair", _pairs(1 << 14), indirect=True)
def test_discard_unread_after_a_producer_death(ring_pair):
    """A dead producer's records are dropped in one sweep, and the whole
    span is free again."""
    cons, prod = ring_pair
    for i in range(5):
        prod.write_tagged(ord("D"), bytes([i]) * 100, timeout_ms=1000)
    assert cons.read_tagged(timeout_ms=1000) == (ord("D"), bytes([0]) * 100)
    assert cons.discard_unread() == 4 and not cons.poll(0)
    assert cons.tail() == cons.head()


@pytest.mark.parametrize("ring_pair", _pairs(1 << 13), indirect=True)
def test_blocking_write_times_out_and_oversize_is_refused(ring_pair):
    cons, prod = ring_pair
    big = b"x" * 3000
    prod.write_tagged(ord("D"), big, timeout_ms=500)
    prod.write_tagged(ord("D"), big, timeout_ms=500)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError_):
        prod.write_tagged(ord("D"), big, timeout_ms=50)
    assert time.monotonic() - t0 < 5
    with pytest.raises(ValueError):
        prod.write_tagged(ord("D"), b"y" * (1 << 13), timeout_ms=10)
    cons.close_producer()
    with pytest.raises(RingClosed):
        prod.write_tagged(ord("D"), b"z", timeout_ms=10)


@pytest.mark.parametrize("ring_pair", _pairs(1 << 14), indirect=True)
def test_chunked_payload_reassembly(ring_pair):
    """S (total length), P chunks, final D: reassembled byte for byte while
    the ring's backpressure engages mid-payload (threaded producer)."""
    cons, prod = ring_pair
    payload = np.random.default_rng(0).integers(0, 256, 60_000, dtype=np.uint8).tobytes()
    max_frame = 4096

    def produce():
        mv = memoryview(payload)
        prod.write_tagged(ord("S"), len(mv).to_bytes(8, "little"), timeout_ms=10_000)
        while len(mv) > max_frame:
            prod.write_tagged(ord("P"), mv[:max_frame], timeout_ms=10_000)
            mv = mv[max_frame:]
        prod.write_tagged(ord("D"), mv, timeout_ms=10_000)

    t = threading.Thread(target=produce)
    t.start()
    reader = RingReader(cons)
    buf, off, kinds = None, 0, []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        rec = reader.try_read()
        if rec is None:
            time.sleep(0.0005)
            continue
        kind, view = rec
        kinds.append(chr(kind))
        if kind == ord("S"):
            buf = bytearray(int.from_bytes(view[:8], "little"))
        else:
            buf[off:off + len(view)] = view
            off += len(view)
        view.release()
        reader.complete()
        reader.reap()
        if kind == ord("D"):
            break
    t.join()
    reader.close()
    assert bytes(buf) == payload
    assert kinds[0] == "S" and kinds[-1] == "D" and set(kinds[1:-1]) == {"P"}


@pytest.mark.parametrize("ring_pair", _pairs(1 << 16), indirect=True)
def test_segment_claim_holds_a_record_until_its_arrays_are_collected(ring_pair):
    """A claim pins its record until the last array it tracks is gone;
    only then does the reader hand the bytes back to the producer."""
    cons, prod = ring_pair
    reader = RingReader(cons)
    prod.write_tagged(ord("D"), np.arange(64, dtype=np.uint8).tobytes(), timeout_ms=1000)
    _, view = reader.try_read()
    a = np.frombuffer(view, dtype=np.uint8)
    b = a[4:8]                 # b's base is a: it keeps a alive
    claim = SegmentClaim()
    claim.track(a)
    reader.claim(claim)
    tail = cons.tail()
    del a
    assert not claim.released and reader.pinned == 1 and reader.reap() == 0
    assert cons.tail() == tail
    assert b.tolist() == [4, 5, 6, 7]
    del b
    assert claim.released and reader.pinned == 0 and reader.reap() == 1
    assert cons.tail() == cons.head()
    reader.close()


# --------------------------------------------------- across the two packages
def _cross_impls():
    both = ring_available() and jax_ring_available()
    return ["py", "native"] if both else ["py"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("impl", _cross_impls())
def test_protocol_across_packages(impl, direction):
    """One segment, one package's producer and the other's consumer: the
    records arrive byte-equal, through wraparound, in both directions; and
    the consumer's RingReader reads the other package's records."""
    name = _ring_name()
    make_cons, make_prod = ((make_ring, jax_make_ring) if direction == "jax_to_port"
                            else (jax_make_ring, make_ring))
    cons = make_cons(name, capacity=1 << 15, create=True, impl=impl)
    prod = make_prod(name, create=False, impl=impl)
    try:
        rng = np.random.default_rng(11)
        for i in range(120):
            payload = rng.integers(0, 256, 500 + 17 * i, dtype=np.uint8).tobytes()
            kind = ord("DPC"[i % 3])
            prod.write_tagged(kind, payload, timeout_ms=2000)
            got_kind, got = cons.read_tagged(timeout_ms=2000)
            assert (got_kind, got) == (kind, payload)
        if direction == "jax_to_port":
            reader = RingReader(cons)
            for i in range(3):
                prod.write_tagged(ord("D"), bytes([i]) * 1000, timeout_ms=2000)
            for i in range(3):
                kind, view = reader.try_read()
                assert kind == ord("D") and bytes(view) == bytes([i]) * 1000
                view.release()
                reader.complete()
            assert reader.reap() == 3 and cons.tail() == cons.head()
            reader.close()
        cons.close_producer()
        assert prod.producer_closed
    finally:
        prod.close()
        cons.close()


def _rows():
    rng = np.random.default_rng(5)
    return [{"id": np.int64(i), "image": rng.integers(0, 256, (8, 6, 3), dtype=np.uint8),
             "label": np.int32(i % 3), "name": f"row{i}"} for i in range(7)]


def test_pickle_serializer_matches_the_jax_packages():
    rows = _rows()
    port, jax = PickleSerializer(), JaxPickleSerializer()
    assert port.serialize(rows) == jax.serialize(rows)
    for got in (port.deserialize(jax.serialize(rows)),
                jax.deserialize(memoryview(port.serialize(rows)))):
        assert len(got) == len(rows)
        for g, w in zip(got, rows):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["image"], w["image"])
            assert g["id"] == w["id"] and g["name"] == w["name"]


def test_view_rows_pickle_across_processes_by_schema():
    """Schema-view namedtuples (NGram windows cross the pool as them)
    unpickle through the cache, as the JAX package's do."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("Tok", [UnischemaField("ts", np.int64, (), ScalarCodec(np.int64), False),
                               UnischemaField("token", np.int32, (), ScalarCodec(np.int32),
                                              False)])
    row = schema.make_namedtuple_from_dict({"ts": np.int64(3), "token": np.int32(9)})
    back = pickle.loads(pickle.dumps({0: row}))[0]
    assert type(back) is type(row) and back == row
