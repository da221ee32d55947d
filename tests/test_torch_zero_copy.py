"""The process pool's zero-copy columns (``make_batch_reader`` on
``reader_pool_type="process"``): workers publish Arrow streams into their
shared-memory rings, and the consumer's numpy columns view the ring. A
record stays pinned while any view of it lives (a column, a slice of one, a
tensor made from one), is never overwritten meanwhile, and goes back to
its worker once the last view is dropped; closing the reader with views
alive keeps the mapping. A consumer that keeps so many results that every
worker waits for ring space gets an error instead of a hang, and the
in-memory loader, which keeps a whole store, pins nothing. On both ring
implementations, with 1 MiB rings."""
import gc
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import reader as reader_module
from petastorm_tpu_torch.benchmark.scalar_bench import generate_tensor_dataset
from petastorm_tpu_torch.loader import BatchedDataLoader, InMemBatchedDataLoader
from petastorm_tpu_torch.native import make_ring, ring_available
from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import LEAD, ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.shm_ring import RingReader, SegmentClaim
from petastorm_tpu_torch.workers_pool import process_pool
from torch_columnar_stores import row_keys

RING = 1 << 20
IMPLS = ["py", "native"] if ring_available() else ["py"]
ROWS, GROUP = 5120, 256   # 20 records of 141 KB: 7 fit a ring, 14 the two rings


@pytest.fixture(params=IMPLS)
def ring_impl(request, monkeypatch):
    """Pins the ring implementation and 1 MiB rings."""
    from petastorm_tpu_torch import native
    monkeypatch.setattr(native, "resolve_ring_impl", lambda: request.param)
    monkeypatch.setattr(reader_module, "ring_capacity_for", lambda workers: RING)
    return request.param


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return generate_tensor_dataset(f"file://{tmp_path_factory.mktemp('zero_copy')}/tensor",
                                   rows=ROWS, row_group_size=GROUP)


def _reader(url, **kwargs):
    kwargs = {"reader_pool_type": "process", "workers_count": 2, "seed": 0, **kwargs}
    return make_batch_reader(url, **kwargs)


def _ring_arrays(pool):
    return [np.frombuffer(ring.data_view(), dtype=np.uint8) for ring in pool._rings]


def _views_ring(arr, rings) -> bool:
    return any(np.may_share_memory(arr, mem) for mem in rings)


def _copy(batch):
    return {k: np.array(v) for k, v in batch.items()}


def _unchanged(batch, snapshot) -> bool:
    return all(np.asarray(batch[k]).tobytes() == v.tobytes() for k, v in snapshot.items())


def test_columns_view_the_ring_on_8_byte_boundaries(store, ring_impl):
    with _reader(store) as reader:
        assert reader.pool.ring_impl == ring_impl
        rings = _ring_arrays(reader.pool)
        batch = reader.next_batch()
        assert batch["emb0"].shape == (GROUP, 64) and batch["id"].dtype == np.int64
        for name, col in batch.items():
            assert _views_ring(col, rings), name
            assert col.ctypes.data % 8 == 0, name
        counters = reader.counters
        assert counters["zero_copy_batches"] == 1
        assert counters["zero_copy_bytes"] == sum(v.nbytes for v in batch.values())
        del batch, rings


def test_every_row_arrives_once(store, ring_impl):
    with _reader(store, num_epochs=2) as reader:
        cols = []
        while True:
            try:
                cols.append(_copy(reader.next_batch()))
            except StopIteration:
                break
        assert reader.counters["zero_copy_batches"] == 2 * ROWS // GROUP
    got = {k: np.concatenate([c[k] for c in cols]) for k in cols[0]}
    assert np.array_equal(np.sort(got["id"]), np.repeat(np.arange(ROWS), 2))
    with make_batch_reader(store, reader_pool_type="dummy", num_epochs=2) as reader:
        want = [reader.next_batch() for _ in range(2 * ROWS // GROUP)]
    assert row_keys(got) == row_keys({k: np.concatenate([w[k] for w in want]) for k in want[0]})


def test_a_claimed_record_is_pinned_not_completed(store, ring_impl):
    """The record under a live batch is claimed (not marked complete), so
    the ring's tail cannot pass it; dropping the batch releases it."""
    with _reader(store, workers_count=1) as reader:
        pool = reader.pool
        batch = reader.next_batch()
        ring, ring_reader = pool._rings[0], pool._readers[0]
        pinned = [(claim, done) for _, claim, done in ring_reader._outstanding
                  if claim is not None and not claim.released]
        assert len(pinned) == 1 and pinned[0][1] is False
        assert pool.pinned == 1
        tail = ring.tail()
        assert tail < ring.head() or ring_reader.outstanding >= 1
        claim = pinned[0][0]
        del batch, pinned
        assert claim.released and pool.pinned == 0
        assert ring.tail() > tail


@pytest.mark.parametrize("hold", ["batch", "slice", "tensor"])
def test_a_held_view_stays_unchanged_while_the_reader_moves_on(store, ring_impl, hold):
    """A batch, a slice of a column whose array is gone (numpy's slice does
    not keep that array alive), or a tensor made from a column: the record
    stays pinned and its bytes unchanged while the reader reads more than
    three ring capacities further, then goes back once dropped."""
    with _reader(store, num_epochs=None) as reader:
        pool = reader.pool
        batch = reader.next_batch()
        if hold == "batch":
            held = batch
        elif hold == "slice":
            held = {"emb1": batch["emb1"][3:9], "id": batch["id"][3:9]}
        else:
            held = {"f0": torch.from_numpy(batch["f0"]), "emb0": torch.from_numpy(batch["emb0"])}
        snapshot = _copy(held)
        del batch
        gc.collect()
        assert pool.pinned == 1
        moved = 0
        while moved <= 3 * RING:
            moved += sum(v.nbytes for v in reader.next_batch().values())
        assert pool.pinned == 1
        assert _unchanged(held, snapshot)
        del held
        assert pool.pinned == 0


def test_closing_the_reader_keeps_a_held_batch_readable(store, ring_impl):
    with _reader(store) as reader:
        batch = reader.next_batch()
        snapshot = _copy(batch)
    pool = reader.pool
    # The ring the batch came from keeps its mapping; the other is unmapped.
    assert len(pool.leaked_rings) == 1 and pool.leaked_rings[0] in pool.ring_names
    assert not [n for n in pool.ring_names if os.path.exists(f"/dev/shm/{n}")]
    assert all(p.poll() is not None for p in pool._processes)
    assert _unchanged(batch, snapshot)
    assert float(batch["emb0"].sum()) == float(snapshot["emb0"].sum())
    del batch
    with _reader(store) as reader:   # a new reader after the leak
        assert reader.next_batch()["f0"].shape == (GROUP,)
    assert not reader.pool.leaked_rings


def test_closing_the_reader_after_the_batches_are_dropped_leaks_nothing(store, ring_impl):
    with _reader(store) as reader:
        for _ in range(5):
            reader.next_batch()
        assert reader.pool.pinned == 0
    assert not reader.pool.leaked_rings


def test_noop_buffer_slices_pin_until_served_and_shuffled_batches_copy(store, ring_impl):
    """Through the loader's host batches (no staging thread): a plain
    batch is a slice of a record that stays pinned; the shuffling buffer
    copies every group in, so no record stays pinned."""
    with _reader(store, num_epochs=None) as reader:
        loader = BatchedDataLoader(reader, batch_size=100, device="cpu")
        batches = loader._host_batches()
        held = next(batches)
        rings = _ring_arrays(reader.pool)
        assert all(_views_ring(v, rings) for v in held.values())
        snapshot = _copy(held)
        for _ in range(4 * RING // (100 * 552)):
            next(batches)
        assert _unchanged(held, snapshot) and reader.pool.pinned >= 1
        batches.close()
        del held, rings
        assert reader.pool.pinned == 0
    with _reader(store, num_epochs=None) as reader:
        loader = BatchedDataLoader(reader, batch_size=100, shuffling_queue_capacity=1000,
                                   seed=0, device="cpu")
        batches = loader._host_batches()
        held = next(batches)
        assert reader.pool.pinned == 0
        batches.close()


def test_cpu_tensors_view_the_ring_until_dropped(store, ring_impl):
    with _reader(store) as reader:
        loader = BatchedDataLoader(reader, batch_size=GROUP // 2, device="cpu", prefetch=1)
        it = iter(loader)
        batch = next(it)
        spans = [(int(np.frombuffer(r.data_view(), np.uint8).ctypes.data), r.capacity)
                 for r in reader.pool._rings]
        ptr = batch["emb0"].data_ptr()
        assert any(lo <= ptr < lo + n for lo, n in spans)
        snapshot = {k: v.clone() for k, v in batch.items()}
        it.close()
    assert reader.pool.leaked_rings   # the batch outlived the reader
    assert all(torch.equal(batch[k], v) for k, v in snapshot.items())
    del batch


def test_serializer_puts_the_stream_on_an_8_byte_boundary():
    import pyarrow as pa
    table = pa.table({"x": np.arange(10, dtype=np.float64),
                      "v": pa.FixedSizeListArray.from_arrays(pa.array(np.arange(30.0)), 3)})
    payload = ArrowTableSerializer().serialize(table)
    assert bytes(memoryview(payload)[:LEAD]) == b"\0" * LEAD
    record = np.zeros(len(payload) + 16, np.uint8)
    start = (5 - record.ctypes.data) % 8   # where a ring record's payload lies
    record[start:start + len(payload)] = np.frombuffer(payload, np.uint8)
    out = ArrowTableSerializer().deserialize(memoryview(record)[start:start + len(payload)])
    assert out.equals(table)
    x = out.column("x").to_numpy()
    assert np.may_share_memory(x, record) and x.ctypes.data % 8 == 0


def test_the_ring_reports_a_producer_held_back_by_a_claimed_record(ring_impl):
    """``waiting()`` is set while the producer is blocked on a full ring and
    cleared once it writes; ``RingReader.stalled`` is true only while the
    space it needs is held by a claimed record."""
    name = f"/pttest_{uuid.uuid4().hex[:10]}"
    cons = make_ring(name, capacity=1 << 15, create=True, impl=ring_impl)
    prod = make_ring(name, create=False, impl=ring_impl)
    reader = RingReader(cons)
    record = b"x" * 12000   # two fit in 32 KiB, a third wraps and waits
    prod.write_tagged(ord("D"), record, timeout_ms=1000)
    _, view = reader.try_read()
    held = np.frombuffer(view, np.uint8)
    del view
    claim = SegmentClaim()
    claim.track(held)
    reader.claim(claim)
    assert prod.waiting() == 0 and not reader.stalled
    prod.write_tagged(ord("D"), record, timeout_ms=1000)
    writer = threading.Thread(target=prod.write_tagged, args=(ord("D"), record, 10000))
    writer.start()
    deadline = time.monotonic() + 5
    while not cons.waiting() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cons.waiting() == (4 + 1 + len(record) + 7) // 8 * 8
    assert not reader.stalled            # an unread record is left
    reader.try_read()
    reader.complete()
    assert reader.stalled and reader.pinned == 1
    del held
    assert not reader.stalled            # reaping freed the space
    writer.join(5)
    assert not writer.is_alive() and cons.waiting() == 0
    reader.close()
    prod.close()
    cons.close()


def test_a_consumer_that_keeps_every_group_gets_an_error_not_a_hang(store, ring_impl,
                                                                    monkeypatch):
    """Kept groups fill both rings (the store is larger than both): the read
    raises instead of waiting forever, and goes on once they are dropped."""
    monkeypatch.setattr(process_pool, "_PINNED_STALL_S", 0.5)
    with _reader(store) as reader:
        kept = []
        with pytest.raises(RuntimeError, match="Reader stalled"):
            while True:
                kept.append(reader.next_batch())
        assert 0 < len(kept) < ROWS // GROUP and reader.pool.pinned == len(kept)
        ids = [np.array(batch["id"]) for batch in kept]
        del kept
        while True:
            try:
                ids.append(np.array(reader.next_batch()["id"]))
            except StopIteration:
                break
    assert np.array_equal(np.sort(np.concatenate(ids)), np.arange(ROWS))


def test_in_memory_loader_reads_a_store_larger_than_the_rings(store, ring_impl, monkeypatch):
    """The in-memory loader keeps the whole store but copies each group as
    it arrives: no record stays pinned, and the read ends (a regression
    raises within seconds instead of hanging)."""
    monkeypatch.setattr(process_pool, "_PINNED_STALL_S", 5.0)
    with _reader(store) as reader:
        loader = InMemBatchedDataLoader(reader, batch_size=GROUP, shuffle=False, device="cpu")
        assert reader.pool.pinned == 0
        assert reader.counters["zero_copy_batches"] == ROWS // GROUP
        data = loader._data
        assert np.array_equal(np.sort(data["id"]), np.arange(ROWS))
        rings = _ring_arrays(reader.pool)
        assert not any(_views_ring(v, rings) for v in data.values())
        del rings
    with make_batch_reader(store, reader_pool_type="dummy") as reader:
        want = [reader.next_batch() for _ in range(ROWS // GROUP)]
    want = {k: np.concatenate([w[k] for w in want]) for k in want[0]}
    assert row_keys(data) == row_keys(want)
