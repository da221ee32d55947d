"""The port's disk row-group cache (``petastorm_tpu_torch.local_disk_cache``,
the readers' ``cache_*`` arguments and ``cleanup_cache()``) held to the JAX
package's on the CPU: the cases of ``tests/test_disk_cache.py`` run through
both packages with equal outcomes, each package reads the other's cache
directory, then the readers with ``cache_type="local-disk"`` against the
JAX readers on the same stores (equal rows each pass, equal fills and hits,
counted by wrapping both classes' ``get``), the plan's validation and
lowering, and the spawned workers' reopening of the directory. Controls:
a cache whose fill stores the decoded columns instead of the raw ones must
fail the row comparison."""
import os
import pickle

import numpy as np
import pytest

import petastorm_tpu.local_disk_cache as jdisk
import petastorm_tpu_torch.local_disk_cache as tdisk
from petastorm_tpu.cache import NullCache as JaxNullCache
from petastorm_tpu.plan import lower_reader_kwargs as jax_lower
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.plan import lower_reader_kwargs
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
import petastorm_tpu_torch.resilience as tres
from petastorm_tpu_torch.resilience import FaultPlan, FaultSpec
from resilience_parity import fast_policy

CACHES = [jdisk.LocalDiskCache, tdisk.LocalDiskCache]


def both(fn):
    return [fn(cls) for cls in CACHES]


def same(pair):
    assert pair[1] == pair[0]
    return pair[1]


def keys_in(cache) -> list:
    return sorted(k for (k,) in cache._conn().execute("SELECT key FROM cache").fetchall())


# ------------------------------------------------- tests/test_disk_cache.py
@pytest.mark.parametrize("null", [JaxNullCache, NullCache])
def test_null_cache_always_fills(null):
    calls = []
    c = null()
    assert c.get("k", lambda: calls.append(1) or 41) == 41
    assert c.get("k", lambda: calls.append(1) or 42) == 42
    assert len(calls) == 2


def test_disk_cache_hit_and_miss(tmp_path):
    def run(cls):
        c = cls(str(tmp_path / cls.__module__), size_limit_bytes=10 << 20)
        calls = []

        def fill():
            calls.append(1)
            return {"x": np.arange(5)}

        v1, v2 = c.get("key1", fill), c.get("key1", fill)
        np.testing.assert_array_equal(v1["x"], v2["x"])
        return len(calls), v2["x"].tolist()
    assert same(both(run)) == (1, [0, 1, 2, 3, 4])
    port = tdisk.LocalDiskCache(str(tmp_path / tdisk.__name__), size_limit_bytes=10 << 20)
    assert port.fills == 0 and port.get("key1", lambda: 1 / 0)["x"].tolist() == [0, 1, 2, 3, 4]
    assert port.hits == 1


def test_disk_cache_eviction(tmp_path):
    big = np.zeros(10_000, np.uint8)   # about 10 KB pickled

    def run(cls):
        c = cls(str(tmp_path / cls.__module__), size_limit_bytes=50_000)
        for i in range(20):
            c.get(f"k{i}", lambda: big)
        hits = []
        c.get("k19", lambda: hits.append(1) or big)
        return c.size_bytes() <= 50_000, len(c), keys_in(c), hits
    fits, n, keys, hits = same(both(run))
    assert fits and n < 20 and "k19" in keys and not hits


def test_capacity_sanity_check(tmp_path):
    def run(cls):
        with pytest.raises(ValueError, match="too small") as e:
            cls(str(tmp_path / cls.__module__), size_limit_bytes=1000,
                expected_row_size_bytes=1000)
        return str(e.value)
    same(both(run))


def test_cache_persists_across_instances(tmp_path):
    def run(cls):
        path = str(tmp_path / cls.__module__)
        c1 = cls(path, size_limit_bytes=1 << 20)
        c1.get("k", lambda: "value")
        c1.cleanup()
        return cls(path, size_limit_bytes=1 << 20).get("k", lambda: "WRONG")
    assert same(both(run)) == "value"


def test_cleanup_removes_dir_when_requested(tmp_path):
    def run(cls):
        path = str(tmp_path / cls.__module__)
        c = cls(path, size_limit_bytes=1 << 20, cleanup=True)
        c.get("k", lambda: 1)
        c.cleanup()
        return os.path.exists(path)
    assert same(both(run)) is False


# ------------------------------------------------------------ the port's own
@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)], ids=["jax->port", "port->jax"])
def test_each_package_reads_the_others_directory(tmp_path, writer, reader):
    path = str(tmp_path / "shared")
    CACHES[writer](path, size_limit_bytes=1 << 20).get("k", lambda: {"a": np.arange(3)})
    got = CACHES[reader](path, size_limit_bytes=1 << 20).get("k", lambda: "WRONG")
    np.testing.assert_array_equal(got["a"], np.arange(3))


def test_pickle_reopens_the_same_directory(tmp_path):
    c = tdisk.LocalDiskCache(str(tmp_path / "c"), size_limit_bytes=1 << 20)
    c.get("k", lambda: "value")
    again = pickle.loads(pickle.dumps(c))
    assert again is not c and len(again) == 1 and again.get("k", lambda: "WRONG") == "value"
    assert set(again.stored_at()) == {"k"}


def test_fill_fault_site_fires_on_misses_only(tmp_path):
    plan = FaultPlan([FaultSpec(site="cache.fill", kind="ioerror", at=2)], seed=0)
    c = tdisk.LocalDiskCache(str(tmp_path / "c"), size_limit_bytes=1 << 20, fault_plan=plan)
    c.get("k0", lambda: 0)
    with pytest.raises(OSError):
        c.get("k1", lambda: 1)
    assert c.get("k1", lambda: 1) == 1 and c.get("k0", lambda: "WRONG") == 0
    assert (c.fills, c.hits) == (2, 1) and sorted(c.stored_at()) == ["k0", "k1"]


# ------------------------------------------------------------------ readers
class _Counts:
    """Wraps both classes' ``get`` to count gets and fills over a read."""

    def __init__(self, monkeypatch):
        self.gets = self.fills = 0
        for cls in CACHES:
            monkeypatch.setattr(cls, "get", self._wrap(cls.get))

    def _wrap(self, get):
        def counted(cache, key, fill):
            self.gets += 1

            def counted_fill():
                self.fills += 1
                return fill()
            return get(cache, key, counted_fill)
        return counted

    def take(self):
        out = (self.fills, self.gets - self.fills)
        self.gets = self.fills = 0
        return out


def _pass_rows(reader, batched):
    if batched:
        return [{k: v[i] for k, v in s._asdict().items()} for s in reader
                for i in range(len(s.id))]
    return [s._asdict() for s in reader]


def _two_passes(factory, url, batched, counts, **kwargs):
    """Two passes through one reader, ``reset()`` between them: each pass's
    rows by id and its (fills, hits)."""
    out = []
    with factory(url, num_epochs=1, **kwargs) as reader:
        for _ in range(2):
            if reader.last_row_consumed:
                reader.reset()
            rows = _pass_rows(reader, batched)
            out.append(({int(r["id"]): r for r in rows}, len(rows), counts.take()))
    return out


def _same_cells(a: dict, b: dict) -> bool:
    if sorted(a) != sorted(b):
        return False
    for rid, row in a.items():
        for name, cell in row.items():
            other = b[rid][name]
            if isinstance(cell, np.ndarray) or isinstance(other, np.ndarray):
                if not np.array_equal(np.asarray(cell), np.asarray(other)):
                    return False
            elif cell != other and not (cell != cell and other != other):
                return False
    return True


@pytest.mark.parametrize("kind", ["row", "batch"])
@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_disk_cache_readers_equal_jax(synthetic_dataset, scalar_dataset, tmp_path, monkeypatch,
                                      kind, pool):
    batched = kind == "batch"
    url = scalar_dataset.url if batched else synthetic_dataset.url
    jax_factory, factory = ((jax_make_batch_reader, make_batch_reader) if batched
                            else (jax_make_reader, make_reader))
    counts = _Counts(monkeypatch)
    kw = dict(reader_pool_type=pool, workers_count=3, shuffle_row_groups=True, seed=5,
              cache_type="local-disk", cache_size_limit=1 << 30)
    jax_run = _two_passes(jax_factory, url, batched, counts,
                          cache_location=str(tmp_path / "jax"), **kw)
    port_run = _two_passes(factory, url, batched, counts,
                           cache_location=str(tmp_path / "port"), **kw)
    plain = _two_passes(factory, url, batched, counts, reader_pool_type=pool, workers_count=3,
                        shuffle_row_groups=True, seed=5)
    for (jrows, jn, jcounts), (prows, pn, pcounts), (rows, n, _) in zip(jax_run, port_run,
                                                                        plain):
        assert pn == jn == n == 100 and sorted(prows) == list(range(100))
        assert _same_cells(prows, jrows) and _same_cells(prows, rows)
        assert pcounts == jcounts
    assert [c for _, _, c in port_run] == [(10, 0), (0, 10)]


def test_cleanup_cache_empties_the_cache(synthetic_dataset, tmp_path):
    path = str(tmp_path / "c")
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy", cache_type="local-disk",
                     cache_location=path, cache_size_limit=1 << 30,
                     cache_extra_settings={"cleanup": True}) as reader:
        assert len(list(reader)) == 100
        assert len(tdisk.LocalDiskCache(path, 1 << 30)) == 10
        reader.cleanup_cache()
        assert not os.path.exists(path)
    assert len(tdisk.LocalDiskCache(path, 1 << 30)) == 0
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy") as reader:
        reader.cleanup_cache()   # no cache: a no-op


def test_process_workers_reopen_the_directory(synthetic_dataset, tmp_path):
    """Spawned workers unpickle the cache as the same directory: a process
    reader after a thread reader's fill hits every group and stores
    nothing."""
    path = str(tmp_path / "c")
    kw = dict(cache_type="local-disk", cache_location=path, cache_size_limit=1 << 30,
              schema_fields=["id", "matrix"])
    with make_reader(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                     **kw) as reader:
        threads = {int(r.id): r.matrix for r in reader}
    stored = tdisk.LocalDiskCache(path, 1 << 30).stored_at()
    with make_reader(synthetic_dataset.url, reader_pool_type="process", workers_count=2,
                     **kw) as reader:
        procs = {int(r.id): r.matrix for r in reader}
    assert sorted(procs) == sorted(threads) == list(range(100)) and len(stored) == 10
    assert all(np.array_equal(procs[i], threads[i]) for i in procs)
    assert tdisk.LocalDiskCache(path, 1 << 30).stored_at() == stored


def test_fill_fault_is_retried_by_the_worker_guard(synthetic_dataset, tmp_path):
    plan = FaultPlan([FaultSpec(site="cache.fill", kind="ioerror", at=2)], seed=0)
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy", cache_type="local-disk",
                     cache_location=str(tmp_path / "c"), cache_size_limit=1 << 30,
                     fault_plan=plan, retry_policy=fast_policy(tres)) as reader:
        ids = [int(r.id) for r in reader]
        retries = reader.telemetry.snapshot()["counters"].get("resilience.retries_total", 0)
    assert sorted(ids) == list(range(100)) and retries == 1


def test_memory_and_disk_caches_refused_as_jax(synthetic_dataset, tmp_path):
    kw = dict(cache_type="local-disk", cache_location=str(tmp_path / "c"),
              cache_size_limit=1 << 30, memory_cache_size_bytes=1 << 20)
    errors = []
    for factory in (jax_make_reader, make_reader, make_batch_reader):
        with pytest.raises(ValueError, match="mutually exclusive with cache_type") as e:
            factory(synthetic_dataset.url, **kw)
        errors.append(str(e.value))
    assert errors[1] == errors[0] == errors[2]


def test_small_limit_raises_the_capacity_error(synthetic_dataset, tmp_path):
    with pytest.raises(ValueError, match="too small to hold 100 rows"):
        make_reader(synthetic_dataset.url, cache_type="local-disk",
                    cache_location=str(tmp_path / "c"), cache_size_limit=1000,
                    cache_row_size_estimate=1000)
    with pytest.raises(ValueError, match="Unknown cache_type"):
        make_reader(synthetic_dataset.url, cache_type="memcached")


def test_lowering_cache_node_equal_jax(tmp_path):
    kw = {"reader_pool_type": "thread", "workers_count": 2, "cache_type": "local-disk",
          "cache_location": str(tmp_path), "cache_size_limit": 1 << 20}

    def node(plan):
        n = plan.operators["cache"]
        return n.name, n.layer, n.kind, n.capacity, n.induced_by, tuple(n.downstream)
    assert node(lower_reader_kwargs("row", dict(kw))) == node(jax_lower("row", dict(kw)))


# ------------------------------------------------------------------ control
def _disk_passes_match(url, path, plain, **kw) -> bool:
    """Two passes (fills, then hits) of a disk-cached reader give the rows
    of ``plain``; False on any difference or error."""
    try:
        with make_reader(url, cache_type="local-disk", cache_location=path,
                         cache_size_limit=1 << 30, **kw) as reader:
            first = {int(r["id"]): r for r in _pass_rows(reader, False)}
            reader.reset()
            second = {int(r["id"]): r for r in _pass_rows(reader, False)}
    except Exception:  # noqa: BLE001 - any failure is a mismatch here
        return False
    return _same_cells(first, plain) and _same_cells(second, plain)


def test_control_decoded_values_in_the_raw_tier_fail_the_rows(synthetic_dataset, tmp_path,
                                                              monkeypatch):
    """The raw tier keeps raw columns and decodes each retrieval. A fill that
    stores the decoded columns instead serves rows decoded twice, which the
    comparison with an uncached reader must catch."""
    kw = dict(reader_pool_type="dummy", shuffle_row_groups=False,
              schema_fields=["id", "image_png", "matrix"])
    with make_reader(synthetic_dataset.url, **kw) as reader:
        plain = {int(r["id"]): r for r in _pass_rows(reader, False)}
    assert _disk_passes_match(synthetic_dataset.url, str(tmp_path / "good"), plain, **kw)
    real = RowReaderWorker._read_columns

    def decoded_fill(self, rowgroup, columns, zero_copy=True):
        data, n = real(self, rowgroup, columns)
        return (data, n) if zero_copy else (self._decode_columns(data, np.arange(n)), n)
    monkeypatch.setattr(RowReaderWorker, "_read_columns", decoded_fill)
    assert not _disk_passes_match(synthetic_dataset.url, str(tmp_path / "bad"), plain, **kw)
