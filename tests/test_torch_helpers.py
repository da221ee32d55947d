"""The port's ``BatchingTableQueue`` and ``compute_correlation_distance``
against the JAX package's: the cases of ``tests/test_batch_queue_cli_depth.py``
on both queues, their batches equal, and the correlation distance of the
same readers equal."""
import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.pyarrow_helpers.batching_table_queue import \
    BatchingTableQueue as JaxBatchingTableQueue
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.test_util.shuffling_analysis import \
    compute_correlation_distance as jax_correlation_distance
from petastorm_tpu_torch.pyarrow_helpers.batching_table_queue import BatchingTableQueue
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.test_util.shuffling_analysis import compute_correlation_distance

QUEUES = {"port": BatchingTableQueue, "jax": JaxBatchingTableQueue}


def _table(start, n):
    return pa.table({"id": np.arange(start, start + n, dtype=np.int64),
                     "x": np.arange(start, start + n, dtype=np.float64) * 0.5})


def _drain(q):
    out = []
    while not q.empty():
        out.append(q.get())
    return out


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_rechunk_one_table_into_smaller_batches(pkg):
    q = QUEUES[pkg](batch_size=4)
    q.put(_table(0, 10))
    batches = _drain(q)
    assert [len(b) for b in batches] == [4, 4]
    assert [b.column("id").to_pylist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_rechunk_across_table_boundaries(pkg):
    q = QUEUES[pkg](batch_size=4)
    q.put(_table(0, 10))
    q.put(_table(10, 10))
    batches = _drain(q)
    assert all(len(b) == 4 for b in batches)
    assert [i for b in batches for i in b.column("id").to_pylist()] == list(range(20))


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_batch_larger_than_single_table(pkg):
    q = QUEUES[pkg](batch_size=16)
    for s in range(0, 30, 10):
        q.put(_table(s, 10))
    assert q.get().column("id").to_pylist() == list(range(16))
    assert q.empty()


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_batch_size_one_and_refusals(pkg):
    q = QUEUES[pkg](batch_size=1)
    q.put(_table(0, 3))
    q.put(_table(3, 0))
    assert [q.get().column("id").to_pylist() for _ in range(3)] == [[0], [1], [2]]
    with pytest.raises(RuntimeError, match="Not enough rows"):
        q.get()
    with pytest.raises(ValueError, match="positive"):
        QUEUES[pkg](batch_size=0)


def test_random_table_and_batch_sizes_equal_jax():
    rng = np.random.default_rng(7)
    for batch_size in rng.integers(1, 9, 5):
        queues = [BatchingTableQueue(int(batch_size)), JaxBatchingTableQueue(int(batch_size))]
        start = 0
        for _ in range(6):
            n = int(rng.integers(1, 12))
            for q in queues:
                q.put(_table(start, n))
            start += n
        port, jax = (_drain(q) for q in queues)
        assert [b.to_pydict() for b in port] == [b.to_pydict() for b in jax]
        ids = [i for b in port for i in b.column("id").to_pylist()]
        assert ids == list(range(len(ids))) and start - len(ids) < batch_size


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from dataset_utils import create_test_dataset
    url = f"file://{tmp_path_factory.mktemp('shuffling')}/ds"
    create_test_dataset(url, num_rows=60, rows_per_row_group=5)
    return url


@pytest.mark.parametrize("shuffle", [False, True])
def test_correlation_distance_equals_jax(store, shuffle):
    def factory(make):
        return lambda: make(store, schema_fields=["id"], reader_pool_type="dummy",
                            shuffle_row_groups=shuffle, seed=5)
    got = compute_correlation_distance(factory(make_reader), num_runs=2)
    want = jax_correlation_distance(factory(jax_make_reader), num_runs=2)
    assert got == pytest.approx(want, abs=1e-12)
    assert (got > 0.999) is (not shuffle)


def test_correlation_distance_needs_two_rows():
    class _One:
        def __enter__(self):
            return iter([type("R", (), {"id": 1})()])

        def __exit__(self, *exc):
            return False
    with pytest.raises(ValueError, match="at least 2 rows"):
        compute_correlation_distance(_One)
