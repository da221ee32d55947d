"""petastorm_tpu_torch.spark (the dataset converter and ``dataset_as_rdd``)
against the JAX package's, on the same DataFrames of the conftest's
``spark_session`` (the in-repo minispark engine when pyspark is missing).

Each case converts the same frame with both packages and holds the port's
stores, row counts, cache decisions, shards and loaders' rows to the JAX
converter's; the loaders run on the CPU (``device="cpu"``,
``torch_device="cpu"``).
"""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.spark.spark_dataset_converter as jax_sdc
import petastorm_tpu_torch.spark.spark_dataset_converter as sdc
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.spark.spark_dataset_converter import (PARENT_CACHE_DIR_URL_CONF,
                                                               _wait_files_available,
                                                               make_spark_converter)

READ = dict(shuffle_row_groups=False, reader_pool_type="dummy")


@pytest.fixture()
def cache_url(tmp_path):
    return f"file://{tmp_path}/converter_cache"


@pytest.fixture()
def jax_cache_url(tmp_path):
    return f"file://{tmp_path}/jax_converter_cache"


@pytest.fixture(autouse=True)
def _reset_converter_caches():
    for module in (sdc, jax_sdc):
        with module._cache_lock:
            module._converter_cache.clear()
    yield
    for module in (sdc, jax_sdc):
        with module._cache_lock:
            module._converter_cache.clear()


def _make_df(spark, rows=20):
    from pyspark.sql.types import DoubleType, LongType, StringType, StructField, StructType
    schema = StructType([StructField("id", LongType(), False),
                         StructField("x", DoubleType(), False),
                         StructField("name", StringType(), False)])
    return spark.createDataFrame([(i, float(i) * 0.5, f"row{i}") for i in range(rows)], schema)


def _both(df, cache_url, jax_cache_url, **kwargs):
    return (make_spark_converter(df, parent_cache_dir_url=cache_url, **kwargs),
            jax_sdc.make_spark_converter(df, parent_cache_dir_url=jax_cache_url, **kwargs))


def _rows(factory, url, columns=("id", "x", "name")):
    """Every row of a batched read, as sorted tuples of ``columns``."""
    with factory(url, **READ) as reader:
        out = []
        for batch in reader:
            cols = [getattr(batch, c) for c in columns]
            out.extend(zip(*[[v.item() if hasattr(v, "item") else v for v in c] for c in cols]))
    return sorted(out)


def _arrow_type(url, column):
    fs, path = get_filesystem_and_path_or_paths(url)
    f = [p for p in fs.find(path) if p.endswith(".parquet")][0]
    with fs.open(f, "rb") as handle:
        return pq.ParquetFile(handle).schema_arrow.field(column).type


def test_materialize_and_read_back(spark_session, cache_url, jax_cache_url):
    df = _make_df(spark_session)
    conv, jconv = _both(df, cache_url, jax_cache_url)
    assert len(conv) == len(jconv) == 20
    got = _rows(make_batch_reader, conv.cache_dir_url)
    assert got == _rows(jax_make_batch_reader, jconv.cache_dir_url)
    assert got == [(i, i * 0.5, f"row{i}") for i in range(20)]
    conv.delete()
    jconv.delete()


def test_cache_hit_on_same_plan(spark_session, cache_url, jax_cache_url):
    df = _make_df(spark_session)
    conv, jconv = _both(df, cache_url, jax_cache_url)
    again, jagain = _both(df, cache_url, jax_cache_url)
    assert (again is conv) == (jagain is jconv) is True
    conv.delete()
    jconv.delete()


def test_cache_hit_on_recreated_identical_frame(spark_session, cache_url, jax_cache_url):
    """The minispark engine keys a plan by its content, so a recreated frame
    hits the cache in both packages (real Spark gives it new expression
    ids)."""
    df1 = _make_df(spark_session)
    if not hasattr(type(df1), "_count_invocations"):
        pytest.skip("content-keyed plans are a minispark property")
    conv, jconv = _both(df1, cache_url, jax_cache_url)
    again, jagain = _both(_make_df(spark_session), cache_url, jax_cache_url)
    assert (again is conv) == (jagain is jconv) is True
    conv.delete()
    jconv.delete()


def test_cache_miss_on_different_plan(spark_session, cache_url, jax_cache_url):
    c10, j10 = _both(_make_df(spark_session, rows=10), cache_url, jax_cache_url)
    c12, j12 = _both(_make_df(spark_session, rows=12), cache_url, jax_cache_url)
    assert c10 is not c12 and c10.cache_dir_url != c12.cache_dir_url
    assert (len(c10), len(c12)) == (len(j10), len(j12)) == (10, 12)
    for conv in (c10, c12, j10, j12):
        conv.delete()


def test_dataset_size_from_footers_not_count(spark_session, cache_url, jax_cache_url):
    df = _make_df(spark_session, rows=33)
    if not hasattr(type(df), "_count_invocations"):
        pytest.skip("the count of count() calls is a minispark property")
    type(df)._count_invocations[0] = 0
    conv, jconv = _both(df, cache_url, jax_cache_url)
    assert len(conv) == len(jconv) == 33
    assert type(df)._count_invocations[0] == 0
    conv.delete()
    jconv.delete()


def test_vector_to_array_conversion(spark_session, cache_url, jax_cache_url):
    from pyspark.ml.linalg import Vectors, VectorUDT
    from pyspark.sql.types import LongType, StructField, StructType
    schema = StructType([StructField("id", LongType(), False),
                         StructField("features", VectorUDT(), False)])
    df = spark_session.createDataFrame([(0, Vectors.dense([1.0, 2.0, 3.0])),
                                        (1, Vectors.sparse(3, [0, 2], [4.0, 5.0]))], schema)
    conv, jconv = _both(df, cache_url, jax_cache_url)

    def vectors(factory, url):
        got = {}
        with factory(url, **READ) as reader:
            for batch in reader:
                for i, vec in zip(batch.id, batch.features):
                    got[int(i)] = np.asarray(vec)
        return got

    got, want = vectors(make_batch_reader, conv.cache_dir_url), \
        vectors(jax_make_batch_reader, jconv.cache_dir_url)
    assert got.keys() == want.keys() == {0, 1}
    for i in got:
        assert got[i].dtype == want[i].dtype == np.float32   # dtype="float32" by default
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[1], [4.0, 0.0, 5.0])
    assert _arrow_type(conv.cache_dir_url, "features") == _arrow_type(jconv.cache_dir_url,
                                                                      "features")
    conv.delete()
    jconv.delete()


@pytest.mark.parametrize("dtype,want", [("float32", pa.float32()), (None, pa.float64()),
                                        ("float64", pa.float64())])
def test_precision(spark_session, cache_url, jax_cache_url, dtype, want):
    conv, jconv = _both(_make_df(spark_session), cache_url, jax_cache_url, dtype=dtype)
    assert _arrow_type(conv.cache_dir_url, "x") == _arrow_type(jconv.cache_dir_url, "x") == want
    conv.delete()
    jconv.delete()


def test_unsupported_precision_raises_like_jax(spark_session, cache_url, jax_cache_url):
    for make, url in ((make_spark_converter, cache_url),
                      (jax_sdc.make_spark_converter, jax_cache_url)):
        with pytest.raises(ValueError, match="float16"):
            make(_make_df(spark_session), parent_cache_dir_url=url, dtype="float16")


def test_make_torch_dataloader_round_trip(spark_session, cache_url, jax_cache_url):
    import torch
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    conv, jconv = _both(_make_df(spark_session), cache_url, jax_cache_url)
    with conv.make_torch_dataloader(batch_size=5, num_epochs=1, torch_device="cpu",
                                    **READ) as loader:
        assert isinstance(loader, BatchedDataLoader)
        batches = list(loader)
    with jconv.make_torch_dataloader(batch_size=5, num_epochs=1, **READ) as jloader:
        jbatches = list(jloader)
    assert [b["id"].tolist() for b in batches] == [b["id"].tolist() for b in jbatches]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.float32
               for b in batches)
    assert sorted(i for b in batches for i in b["id"].tolist()) == list(range(20))
    conv.delete()
    jconv.delete()


def test_make_torch_dataloader_data_loader_fn_and_shuffle(spark_session, cache_url,
                                                          jax_cache_url):
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    captured = {}

    def spy_loader_fn(reader, batch_size, **kwargs):
        captured["kwargs"], captured["batch_size"] = dict(kwargs), batch_size
        return BatchedDataLoader(reader, batch_size, torch_device="cpu", **kwargs)

    conv, jconv = _both(_make_df(spark_session, rows=30), cache_url, jax_cache_url)
    with conv.make_torch_dataloader(batch_size=10, num_epochs=1, shuffling_queue_capacity=16,
                                    data_loader_fn=spy_loader_fn, **READ) as loader:
        ids = [int(v) for b in loader for v in b["id"]]
    assert captured == {"kwargs": {"shuffling_queue_capacity": 16}, "batch_size": 10}
    with jconv.make_torch_dataloader(batch_size=10, num_epochs=1, shuffling_queue_capacity=16,
                                     **READ) as jloader:
        jids = [int(v) for b in jloader for v in b["id"]]
    assert sorted(ids) == sorted(jids) == list(range(30))
    conv.delete()
    jconv.delete()


def test_make_tf_dataset_round_trip(spark_session, cache_url, jax_cache_url):
    pytest.importorskip("tensorflow")
    conv, jconv = _both(_make_df(spark_session, rows=50), cache_url, jax_cache_url)

    def read(c, **kwargs):
        with c.make_tf_dataset(num_epochs=1, **kwargs, **READ) as dataset:
            batches = [{k: np.asarray(v) for k, v in b.items()} for b in dataset]
        return [len(b["id"]) for b in batches], [b["id"].tolist() for b in batches], batches

    sizes, ids, batches = read(conv)
    jsizes, jids, jbatches = read(jconv)
    assert sizes == jsizes == [32, 18] and ids == jids
    assert [b["name"].tolist() for b in batches] == [b["name"].tolist() for b in jbatches]
    # The reference's keywords: the row stream shuffled, prefetch and workers.
    sizes, ids, _ = read(conv, workers_count=2, prefetch=2, shuffling_queue_capacity=20,
                         batch_size=25)
    assert sizes == [25, 25] and sorted(sum(ids, [])) == list(range(50))
    assert sum(ids, []) != list(range(50))
    conv.delete()
    jconv.delete()


def test_make_device_loader_round_trip(spark_session, cache_url, jax_cache_url):
    import torch
    conv, jconv = _both(_make_df(spark_session), cache_url, jax_cache_url)
    with conv.make_device_loader(batch_size=10, num_epochs=1, device="cpu", **READ) as loader:
        batches = list(loader)
    with jconv.make_jax_loader(batch_size=10, num_epochs=1, **READ) as jloader:
        jbatches = list(jloader)
    assert [b["id"].tolist() for b in batches] == [np.asarray(b["id"]).tolist()
                                                   for b in jbatches]
    assert all(isinstance(b["x"], torch.Tensor) for b in batches)
    conv.delete()
    jconv.delete()


def test_make_device_loader_shards_auto_like_jax(spark_session, cache_url, jax_cache_url):
    """One process is rank 0: ``cur_shard="auto"`` with ``shard_count=2``
    reads shard 0, as the JAX loader does with ``jax.process_index()``."""
    conv, jconv = _both(_make_df(spark_session, rows=40), cache_url, jax_cache_url)
    kwargs = dict(batch_size=4, shard_count=2, num_epochs=1, steps_per_epoch=None, **READ)
    with conv.make_device_loader(device="cpu", **kwargs) as loader:
        ids = [i for b in loader for i in b["id"].tolist()]
    with jconv.make_jax_loader(**kwargs) as jloader:
        jids = [i for b in jloader for i in np.asarray(b["id"]).tolist()]
    assert ids == jids and 0 < len(ids) < 40
    conv.delete()
    jconv.delete()


def test_make_device_loader_auto_aligned_steps(spark_session, cache_url, jax_cache_url):
    """``steps_per_epoch="auto"`` over 2 shards cuts both shards' passes at
    ``aligned_steps_per_epoch``, the JAX loaders' count; None reads whole
    passes."""
    from petastorm_tpu.jax import aligned_steps_per_epoch as jax_aligned
    from petastorm_tpu_torch.loader import aligned_steps_per_epoch
    conv, jconv = _both(_make_df(spark_session), cache_url, jax_cache_url)
    expected = aligned_steps_per_epoch(conv.cache_dir_url, batch_size=3, shard_count=2)
    assert expected == jax_aligned(jconv.cache_dir_url, batch_size=3, shard_count=2)
    counts, jcounts = [], []
    for shard in (0, 1):
        kwargs = dict(batch_size=3, cur_shard=shard, shard_count=2, num_epochs=None, **READ)
        with conv.make_device_loader(device="cpu", **kwargs) as loader:
            counts.append(sum(1 for _ in loader))
        with jconv.make_jax_loader(**kwargs) as jloader:
            jcounts.append(sum(1 for _ in jloader))
    assert counts == jcounts == [expected, expected]
    with conv.make_device_loader(batch_size=3, cur_shard=0, shard_count=2, num_epochs=1,
                                 steps_per_epoch=None, device="cpu", **READ) as loader:
        assert sum(1 for _ in loader) >= expected
    conv.delete()
    jconv.delete()


def test_make_device_loader_auto_steps_stand_down_for_a_predicate(spark_session, cache_url):
    from petastorm_tpu_torch.predicates import in_set
    conv = make_spark_converter(_make_df(spark_session), parent_cache_dir_url=cache_url)
    with conv.make_device_loader(batch_size=2, cur_shard=0, shard_count=2, num_epochs=1,
                                 predicate=in_set({0, 2, 4, 6}, "id"), device="cpu",
                                 **READ) as loader:
        assert loader._steps_per_epoch is None
        ids = sorted(i for b in loader for i in b["id"].tolist())
    assert set(ids) <= {0, 2, 4, 6}
    conv.delete()


def test_delete_removes_store_and_cache_entry(spark_session, cache_url):
    conv = make_spark_converter(_make_df(spark_session), parent_cache_dir_url=cache_url)
    fs, path = get_filesystem_and_path_or_paths(conv.cache_dir_url)
    assert fs.exists(path) and conv.cache_dir_url in sdc._dirs_to_delete
    conv.delete()
    assert not fs.exists(path)
    assert conv.cache_dir_url not in sdc._dirs_to_delete
    assert conv not in sdc._converter_cache.values()
    again = make_spark_converter(_make_df(spark_session), parent_cache_dir_url=cache_url)
    assert again is not conv
    assert fs.exists(get_filesystem_and_path_or_paths(again.cache_dir_url)[1])
    again.delete()


def test_parent_cache_dir_from_spark_conf(spark_session, cache_url):
    spark_session.conf.set(PARENT_CACHE_DIR_URL_CONF, cache_url)
    try:
        conv = make_spark_converter(_make_df(spark_session))
        assert conv.cache_dir_url.startswith(cache_url)
        conv.delete()
    finally:
        spark_session.conf.set(PARENT_CACHE_DIR_URL_CONF, "")


def test_missing_parent_cache_dir_raises(spark_session):
    with pytest.raises(ValueError, match="cache directory"):
        make_spark_converter(_make_df(spark_session))


def test_small_file_warning(spark_session, cache_url):
    with pytest.warns(UserWarning, match="smaller than 50 MB"):
        conv = make_spark_converter(_make_df(spark_session), parent_cache_dir_url=cache_url)
    conv.delete()


def test_env_rank_defaults_shard_the_torch_loader_like_jax(spark_session, cache_url,
                                                           jax_cache_url, monkeypatch):
    conv, jconv = _both(_make_df(spark_session, rows=40), cache_url, jax_cache_url)

    def read_ids(c, **kwargs):
        with c.make_torch_dataloader(batch_size=5, num_epochs=1, **kwargs, **READ) as loader:
            return sorted(i for b in loader for i in b["id"].tolist())

    shards = []
    for rank in ("0", "1"):
        monkeypatch.setenv("HOROVOD_RANK", rank)
        monkeypatch.setenv("HOROVOD_SIZE", "2")
        shards.append(read_ids(conv, torch_device="cpu"))
        assert shards[-1] == read_ids(jconv)
    # An explicit choice wins over the environment.
    assert read_ids(conv, torch_device="cpu", cur_shard=None) == list(range(40))
    monkeypatch.delenv("HOROVOD_RANK")
    monkeypatch.delenv("HOROVOD_SIZE")
    assert shards[0] and shards[1] and set(shards[0]).isdisjoint(shards[1])
    assert sorted(shards[0] + shards[1]) == read_ids(conv, torch_device="cpu") == list(range(40))
    conv.delete()
    jconv.delete()


def _materialize_schema(package):
    codecs = __import__(f"{package}.codecs", fromlist=["ScalarCodec"])
    unischema = __import__(f"{package}.unischema", fromlist=["Unischema"])
    return unischema.Unischema("MS", [
        unischema.UnischemaField("id", np.int64, (), codecs.ScalarCodec(np.int64), False),
        unischema.UnischemaField("x", np.float64, (), codecs.ScalarCodec(np.float64), False),
    ])


def _spark_write(spark, url, rows):
    from pyspark.sql.types import DoubleType, LongType, StructField, StructType
    schema = StructType([StructField("id", LongType(), False),
                         StructField("x", DoubleType(), False)])
    spark.createDataFrame([(i, i * 0.5) for i in range(rows)], schema).write.parquet(url)


def test_materialize_dataset_spark_path(spark_session, tmp_path):
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
    url, jurl = f"file://{tmp_path}/spark_store", f"file://{tmp_path}/jax_spark_store"
    with materialize_dataset(spark_session, url, _materialize_schema("petastorm_tpu_torch"),
                             row_group_size_mb=1):
        _spark_write(spark_session, url, 30)
    with jax_materialize(spark_session, jurl, _materialize_schema("petastorm_tpu"),
                         row_group_size_mb=1):
        _spark_write(spark_session, jurl, 30)
    with make_reader(url, **READ) as r:
        rows = sorted((s.id, s.x) for s in r)
    with jax_make_reader(jurl, **READ) as r:
        assert rows == sorted((s.id, s.x) for s in r) == [(i, i * 0.5) for i in range(30)]
    # The JAX reader reads the port's store too: the metadata is shared.
    with jax_make_reader(url, **READ) as r:
        assert sorted((s.id, s.x) for s in r) == rows
    hadoop = spark_session.sparkContext._jsc.hadoopConfiguration()
    assert hadoop.get("parquet.block.size") is None


def test_materialize_dataset_summary_metadata(spark_session, tmp_path):
    from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
    url, jurl = f"{tmp_path}/spark_sum", f"{tmp_path}/jax_spark_sum"
    with materialize_dataset(spark_session, f"file://{url}",
                             _materialize_schema("petastorm_tpu_torch"),
                             use_summary_metadata=True):
        _spark_write(spark_session, f"file://{url}", 20)
    with jax_materialize(spark_session, f"file://{jurl}", _materialize_schema("petastorm_tpu"),
                         use_summary_metadata=True):
        _spark_write(spark_session, f"file://{jurl}", 20)
    md, jmd = pq.read_metadata(f"{url}/_metadata"), pq.read_metadata(f"{jurl}/_metadata")
    assert md.num_row_groups == jmd.num_row_groups >= 2
    assert md.num_rows == jmd.num_rows == 20
    assert md.row_group(0).column(0).file_path


def test_materialize_dataset_needs_pyspark(tmp_path, monkeypatch):
    import builtins
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset
    real_import = builtins.__import__

    def no_pyspark(name, *args, **kwargs):
        if name == "pyspark" or name.startswith("pyspark."):
            raise ImportError("no pyspark")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyspark)
    with pytest.raises(ImportError, match="materialize_dataset_local"):
        with materialize_dataset(None, f"file://{tmp_path}/x",
                                 _materialize_schema("petastorm_tpu_torch")):
            pass


def test_unischema_as_spark_schema_equals_jax(spark_session):
    from dataset_utils import TestSchema
    from petastorm_tpu_torch.unischema import Unischema
    port_schema = Unischema.from_dict(TestSchema.to_dict())
    got, want = port_schema.as_spark_schema(), TestSchema.as_spark_schema()
    assert [(f.name, f.dataType.simpleString(), f.nullable) for f in got.fields] == \
        [(f.name, f.dataType.simpleString(), f.nullable) for f in want.fields]
    by_name = {f.name: f.dataType.typeName() for f in got.fields}
    assert by_name["image_png"] == by_name["matrix"] == "binary"
    assert by_name["id"] == "long" and by_name["decimal_col"].startswith("decimal")


class _FlakyFs:
    """Each path invisible for its first ``invisible_for`` exists() calls."""

    def __init__(self, invisible_for=2):
        self.calls = {}
        self.invisible_for = invisible_for

    def exists(self, path):
        n = self.calls.get(path, 0)
        self.calls[path] = n + 1
        return n >= self.invisible_for


def test_wait_files_available_polls_until_visible():
    fs = _FlakyFs(invisible_for=2)
    _wait_files_available(fs, ["a", "b"], timeout_s=5, poll_interval_s=0.01)
    assert fs.calls["a"] >= 3 and fs.calls["b"] >= 3


def test_wait_files_available_times_out():
    with pytest.raises(RuntimeError, match="Timed out"):
        _wait_files_available(_FlakyFs(invisible_for=10 ** 9), ["never"], timeout_s=0.05,
                              poll_interval_s=0.01)


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("schema_fields,names", [
    (None, None), (["id", "matrix"], {"id", "matrix"}), (["id.*"], {"id", "id2"})],
    ids=["every field", "subset", "regex"])
def test_dataset_as_rdd_equals_jax(spark_session, synthetic_dataset, schema_fields, names):
    from petastorm_tpu.spark.spark_utils import dataset_as_rdd as jax_dataset_as_rdd
    from petastorm_tpu_torch.spark.spark_utils import dataset_as_rdd
    rows = dataset_as_rdd(synthetic_dataset.url, spark_session,
                          schema_fields=schema_fields).collect()
    jrows = jax_dataset_as_rdd(synthetic_dataset.url, spark_session,
                               schema_fields=schema_fields).collect()
    assert len(rows) == len(jrows) == len(synthetic_dataset.rows)
    assert type(rows[0]).__name__ == type(jrows[0]).__name__
    if names is not None:
        assert set(rows[0]._fields) == names
    for r, j in zip(sorted(rows, key=lambda r: r.id), sorted(jrows, key=lambda r: r.id)):
        assert r._fields == j._fields
        assert all(_same(getattr(r, f), getattr(j, f)) for f in r._fields), r.id


@pytest.mark.parametrize("kwargs", [dict(shard_seed=3), dict(filters=[("part", "in", {0, 2})]),
                                    dict(shard_seed=5, filters=[("part", "!=", 1)])],
                         ids=["shard_seed", "filters", "both"])
def test_aligned_steps_under_shard_seed_and_filters_equal_jax(tmp_path, kwargs):
    """``make_device_loader``'s auto steps pass the reader's ``shard_seed``
    and partition ``filters`` to ``aligned_steps_per_epoch``, whose count
    must be the JAX function's, and the count every shard's reader can
    deliver."""
    from petastorm_tpu.jax import aligned_steps_per_epoch as jax_aligned
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.loader import aligned_steps_per_epoch
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("P", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                             UnischemaField("part", np.int32, (), ScalarCodec(np.int32), False)])
    url = f"file://{tmp_path}/parts"
    rows = [{"id": i, "part": np.int32(i % 3)} for i in range(240)]
    with materialize_dataset_local(url, schema, rows_per_row_group=7,
                                   partition_by=["part"]) as w:
        w.write_rows(rows)
    steps = aligned_steps_per_epoch(url, batch_size=5, shard_count=3, **kwargs)
    assert steps == jax_aligned(url, batch_size=5, shard_count=3, **kwargs)
    for shard in range(3):
        with make_batch_reader(url, cur_shard=shard, shard_count=3, **kwargs, **READ) as r:
            assert sum(len(b.id) for b in r) // 5 >= steps
