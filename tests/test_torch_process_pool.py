"""The port's process pool (``workers_pool.process_pool.ProcessPool``) and
``make_reader(reader_pool_type="process")`` on the CPU, with 2 spawned
workers and rings of 1-4 MiB: the pool cases of the JAX package's
``tests/test_workers_pool.py`` on both ring implementations, chunked results,
the fast stop on a full ring, a worker's exception and a killed worker,
clean teardown, the workers' environment (no CUDA device, no torch), then
rows and NGram windows against the JAX package's process reader and the
port's thread reader (multisets: a process pool delivers in the order its
workers finish), and both benches' result keys on processes."""
import hashlib
import os
import signal
import time

import numpy as np
import pytest

from petastorm_tpu.etl.writer import materialize_dataset_local as jax_materialize
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.native import ring_available
from petastorm_tpu_torch.reader import (DEFAULT_RING_CAPACITY, MIN_RING_CAPACITY,
                                        decode_threads_for, make_reader, ring_capacity_for)
from petastorm_tpu_torch.test_util.stub_workers import (BlobWorker, CoeffMultiplierWorker,
                                                        EnvironmentWorker, ExceptionAtNWorker,
                                                        IdentityWorker, MultiOutputWorker,
                                                        SilentWorker)
from petastorm_tpu_torch.workers_pool import EmptyResultError
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

IMPLS = ["py", "native"] if ring_available() else ["py"]


@pytest.fixture(params=IMPLS)
def ring_impl(request, monkeypatch):
    """Pins the pool's ring implementation."""
    from petastorm_tpu_torch import native
    monkeypatch.setattr(native, "resolve_ring_impl", lambda: request.param)
    return request.param


def _drain(pool):
    out = []
    while True:
        try:
            out.append(pool.get_results())
        except EmptyResultError:
            return out


def _assert_gone(pool):
    """Every worker exited and no ring segment is left in /dev/shm."""
    assert pool.ring_names and all(p.poll() is not None for p in pool._processes)
    assert not [n for n in pool.ring_names if os.path.exists(f"/dev/shm/{n}")]


def test_matches_ventilated_items(ring_impl):
    pool = ProcessPool(2, ring_capacity=1 << 20)
    vent = ConcurrentVentilator(pool.ventilate, [{"value": i} for i in range(20)])
    pool.start(CoeffMultiplierWorker, {"coeff": 3}, ventilator=vent)
    assert pool.ring_impl == ring_impl and pool.start_seconds < 60
    assert sorted(_drain(pool)) == [3 * i for i in range(20)]
    pool.stop()
    pool.join()
    _assert_gone(pool)


def test_manual_ventilation_then_empty_and_more_outputs():
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(IdentityWorker)
    for i in range(5):
        pool.ventilate(value=i)
    assert sorted(pool.get_results() for _ in range(5)) == list(range(5))
    with pytest.raises(EmptyResultError):
        pool.get_results()
    pool.ventilate(value=99)                 # ventilating again revives the pool
    assert pool.get_results() == 99
    pool.stop()
    pool.join()
    _assert_gone(pool)

    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(MultiOutputWorker)
    for values in ([1, 2, 3], [], [4]):
        pool.ventilate(values=values)
    assert sorted(_drain(pool)) == [1, 2, 3, 4]
    pool.stop()
    pool.join()

    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(SilentWorker)
    for i in range(7):
        pool.ventilate(value=i)
    assert _drain(pool) == []
    pool.stop()
    pool.join()


def test_worker_exception_is_raised_in_the_consumer(ring_impl):
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(ExceptionAtNWorker, {"bad_value": 3})
    for i in range(6):
        pool.ventilate(value=i)
    with pytest.raises(ValueError, match="poisoned value 3"):
        _drain(pool)
    _assert_gone(pool)


def test_results_over_half_the_ring_come_in_chunks(ring_impl):
    """1.5 MiB results through 1 MiB rings: S, P..., D frames, reassembled
    byte for byte."""
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(BlobWorker, {"size": 3 << 19})
    for i in range(6):
        pool.ventilate(value=i)
    got = sorted(_drain(pool))
    assert got == sorted(bytes([i]) * (3 << 19) for i in range(6))
    pool.stop()
    pool.join()
    _assert_gone(pool)


def test_stop_with_full_rings_is_fast():
    """Workers blocked on full rings: stop() closes the rings, so their
    writes fail at once and join() does not wait for its kill deadline."""
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(BlobWorker, {"size": 300 << 10})
    for i in range(40):
        pool.ventilate(value=i)
    pool.get_results()
    time.sleep(1.0)             # both workers now block on their full rings
    t0 = time.monotonic()
    pool.stop()
    pool.join()
    assert time.monotonic() - t0 < 10
    _assert_gone(pool)


def test_workers_see_no_cuda_device_and_import_no_torch(tmp_path, monkeypatch):
    """Workers start from another working directory (the package is found
    through PYTHONPATH), see CUDA_VISIBLE_DEVICES="" and never import
    torch."""
    monkeypatch.chdir(tmp_path)
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.start(EnvironmentWorker)
    for i in range(4):
        pool.ventilate(value=i)
    seen = _drain(pool)
    pool.stop()
    pool.join()
    assert {s["pid"] for s in seen} <= set(pool.worker_pids) and len(seen) == 4
    assert all(s["cuda_visible_devices"] == "" and not s["torch_imported"] for s in seen)
    assert os.getpid() not in pool.worker_pids


def test_ring_capacity_is_sized_against_free_shared_memory():
    assert ring_capacity_for(8, free_bytes=64 << 30) == DEFAULT_RING_CAPACITY
    assert ring_capacity_for(8, free_bytes=512 << 20) == 64 << 20
    assert ring_capacity_for(8, free_bytes=8 * MIN_RING_CAPACITY) == MIN_RING_CAPACITY
    with pytest.raises(RuntimeError, match="/dev/shm"):
        ring_capacity_for(8, free_bytes=100 << 20)
    assert ring_capacity_for(2) >= MIN_RING_CAPACITY   # this host's /dev/shm
    cores = os.cpu_count() or 1
    assert decode_threads_for(1) == min(4, cores) and decode_threads_for(4 * cores) == 1


# ------------------------------------------------------------------ reader
@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """An image store written by the JAX package (PNG and JPEG columns)."""
    from petastorm_tpu.codecs import CompressedImageCodec as JaxImageCodec
    from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
    from petastorm_tpu.unischema import Unischema as JaxUnischema
    from petastorm_tpu.unischema import UnischemaField as JaxField
    schema = JaxUnischema("Imgs", [
        JaxField("id", np.int64, (), JaxScalarCodec(np.int64), False),
        JaxField("png", np.uint8, (12, 16, 3), JaxImageCodec("png"), False),
        JaxField("jpeg", np.uint8, (12, 16, 3), JaxImageCodec("jpeg", 90), False)])
    url = f"file://{tmp_path_factory.mktemp('procstore')}/store"
    rng = np.random.default_rng(8)
    with jax_materialize(url, schema, rows_per_row_group=10) as w:
        for i in range(60):
            img = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
            w.write_row({"id": np.int64(i), "png": img, "jpeg": img})
    return url


def _digest(rows):
    return sorted((int(r.id), hashlib.sha1(r.png.tobytes()).hexdigest(),
                   hashlib.sha1(r.jpeg.tobytes()).hexdigest()) for r in rows)


def test_process_rows_equal_the_jax_process_reader_and_the_thread_reader(jax_store):
    kw = dict(workers_count=2, seed=5, shuffle_rows=True, num_epochs=2)
    with make_reader(jax_store, reader_pool_type="process", **kw) as reader:
        got = _digest(reader)
        counters = reader.counters
        pool = reader.pool
    with make_reader(jax_store, reader_pool_type="thread", **kw) as reader:
        threads = _digest(reader)
    with jax_make_reader(jax_store, reader_pool_type="process", **kw) as reader:
        want = _digest(reader)
    assert len(got) == 120 and got == want == threads
    # Both image columns went through the native batch call in the workers.
    assert counters == {"images_native": 240, "images_codec": 0}
    _assert_gone(pool)


def test_a_killed_worker_raises_instead_of_hanging(jax_store):
    reader = make_reader(jax_store, reader_pool_type="process", workers_count=2, num_epochs=None)
    try:
        next(reader)
        os.kill(reader.pool.worker_pids[0], signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="died unexpectedly"):
            for _ in range(100_000):
                next(reader)
        assert time.monotonic() - t0 < 10
    finally:
        reader.stop()
        reader.join()
    _assert_gone(reader.pool)


@pytest.mark.parametrize("dense", [True, False])
def test_ngram_windows_through_processes_equal_the_thread_pools(tmp_path, dense):
    from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
    from petastorm_tpu_torch.ngram import NGram
    url = f"file://{tmp_path}/tok"
    write_token_store(url, windows=6, window=8, vocab=97)

    def windows(pool_type):
        ngram = NGram({o: ["ts", "token"] for o in range(8)}, delta_threshold=1,
                      timestamp_field="ts", timestamp_overlap=False, dense=dense)
        with make_reader(url, schema_fields=ngram, reader_pool_type=pool_type, workers_count=2,
                         seed=1) as reader:
            out = list(reader)
        if dense:
            return sorted((w["ts"].tolist(), w["token"].tolist()) for w in out)
        return sorted([(w[o].ts, w[o].token) for o in range(8)] for w in out)

    got = windows("process")
    assert len(got) == 6 and got == windows("thread")


def test_llm_bench_runs_on_processes_with_the_thread_runs_keys(tmp_path):
    from petastorm_tpu_torch.benchmark.llm_bench import run_llm_bench, write_token_store
    url = f"file://{tmp_path}/tok"
    write_token_store(url, windows=16, window=16, vocab=128)
    run = dict(steps=2, batch_size=8, window=16, workers_count=2, device="cpu",
               model_kwargs=dict(vocab=128, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                                 hidden=64))
    got = run_llm_bench(url, pool_type="process", **run)
    want = run_llm_bench(url, pool_type="thread", **run)
    assert set(got) == set(want)
    assert got["tokens_per_step"] == 128 and np.isfinite(got["loss_last"])


def test_image_columns_written_by_the_port_decode_in_processes(tmp_path):
    """The port's writer, a JPEG column with a null-free id, one worker:
    the same rows as the dummy pool, in some order."""
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                             UnischemaField("image", np.uint8, (8, 8, 3),
                                            CompressedImageCodec("jpeg", 85), False)])
    url = f"file://{tmp_path}/s"
    rng = np.random.default_rng(4)
    with materialize_dataset_local(url, schema, rows_per_row_group=4) as w:
        for i in range(10):
            w.write_row({"id": i, "image": rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)})

    def rows(pool_type):
        with make_reader(url, reader_pool_type=pool_type, workers_count=1) as reader:
            return sorted((int(r.id), r.image.tobytes()) for r in reader)

    assert rows("process") == rows("dummy")


@pytest.mark.parametrize("type_name", ["int8", "uint16", "int32", "int64", "uint64", "float16",
                                       "float32", "float64"])
def test_numeric_columns_read_from_the_arrow_buffers_equal_to_numpy(type_name):
    """The worker reads null-free numeric columns from Arrow's buffers (no
    pandas import in a worker): the values and dtype of ``to_numpy``,
    over several chunks and a sliced offset."""
    import pyarrow as pa
    from petastorm_tpu_torch.reader_impl.row_reader_worker import _column_values
    t = getattr(pa, type_name)()
    vals = np.arange(10).astype(t.to_pandas_dtype())
    col = pa.chunked_array([pa.array(vals[:4], type=t), pa.array(vals[4:], type=t)]).slice(1, 7)
    got, want = _column_values(col), col.to_numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    empty = pa.chunked_array([], type=t)
    assert _column_values(empty).dtype == empty.to_numpy().dtype and not len(_column_values(empty))
