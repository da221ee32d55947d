"""The port's adapters and tools against the JAX package's, on the same stores:

* ``petastorm_tpu_torch.pytorch`` (the reference torch adapter: bool ->
  uint8, uint16 -> int32, ``transform_fn``, ``collate_fn`` with
  ``decimal_friendly_collate``) against ``petastorm_tpu.pytorch``;
* ``petastorm_tpu_torch.tf_utils`` (``make_petastorm_dataset`` on rows,
  batches, NGram and dense NGram windows; ``tf_tensors``) against
  ``petastorm_tpu.tf_utils``;
* the ``copy_dataset``, ``generate_metadata`` and ``metadata_util`` CLIs
  against the JAX ones, and ``-d tf`` in the throughput CLI;
* the read side's API the converter and the tools use:
  ``get_filesystem_and_path_or_paths``, ``write_dataset_metadata`` on a URL
  and its statistics, ``get_schema_from_dataset_url``,
  ``Unischema.make_namedtuple`` and ``cur_shard="auto"``.

Values must be equal: the same rows, dtypes and shapes (exact, no
tolerance: nothing here computes).
"""
import io
import json
import os
from contextlib import redirect_stdout
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu import pytorch as jax_pytorch
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.writer import materialize_dataset_local as jax_materialize
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import pytorch
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

READ = dict(shuffle_row_groups=False, reader_pool_type="dummy", num_epochs=1)


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if hasattr(v, "numpy"):
        return v.numpy()
    return np.asarray(v)


def assert_same(got, want):
    got, want = _to_numpy(got), _to_numpy(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) if got.dtype.kind != "f" else \
        np.array_equal(got, want, equal_nan=True)


def assert_same_batches(batches, jbatches):
    assert len(batches) == len(jbatches) > 0
    for b, j in zip(batches, jbatches):
        assert set(b) == set(j)
        for k in b:
            assert type(b[k]) is type(j[k]), k
            assert_same(b[k], j[k])


@pytest.fixture(scope="module")
def tf():
    """TensorFlow, for the tests of ``tf_utils`` alone."""
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def flag_store(tmp_path_factory):
    """bool, uint16 and float columns, written by the JAX writer."""
    url = f"file://{tmp_path_factory.mktemp('flags')}/ds"
    schema = JaxUnischema("Flags", [
        JaxField("id", np.int64, (), JaxScalarCodec(np.int64), False),
        JaxField("flag", np.bool_, (), JaxScalarCodec(np.bool_), False),
        JaxField("small", np.uint16, (2, 3), JaxNdarrayCodec(), False),
        JaxField("vec", np.float32, (4,), JaxNdarrayCodec(), False)])
    rng = np.random.default_rng(0)
    with jax_materialize(url, schema, rows_per_row_group=8) as w:
        w.write_rows([{"id": i, "flag": bool(i % 3 == 0),
                       "small": rng.integers(0, 2 ** 16, (2, 3)).astype(np.uint16),
                       "vec": rng.normal(size=4).astype(np.float32)} for i in range(30)])
    return url


# ------------------------------------------------------------------ pytorch
def test_row_loader_types_equal_the_jax_adapter(flag_store):
    with make_reader(flag_store, **READ) as r:
        batches = list(pytorch.DataLoader(r, batch_size=8, torch_device="cpu"))
    with jax_make_reader(flag_store, **READ) as r:
        jbatches = list(jax_pytorch.DataLoader(r, batch_size=8))
    assert_same_batches(batches, jbatches)
    assert batches[0]["flag"].dtype == torch.uint8
    assert batches[0]["small"].dtype == torch.int32
    assert batches[0]["flag"].tolist() == [1, 0, 0, 1, 0, 0, 1, 0]


def test_the_package_loader_keeps_bool(flag_store):
    """Only the adapter turns bool into uint8."""
    from petastorm_tpu_torch.loader import DataLoader
    with make_reader(flag_store, **READ) as r:
        batch = next(iter(DataLoader(r, batch_size=8, device="cpu")))
    assert batch["flag"].dtype == torch.bool


def test_batched_loader_equals_the_jax_adapter(scalar_dataset):
    kwargs = dict(schema_fields=["id", "float_col", "vector_col", "int_col"], **READ)
    with make_batch_reader(scalar_dataset.url, **kwargs) as r:
        batches = list(pytorch.BatchedDataLoader(r, batch_size=32, torch_device="cpu"))
    with jax_make_batch_reader(scalar_dataset.url, **kwargs) as r:
        jbatches = list(jax_pytorch.BatchedDataLoader(r, batch_size=32))
    assert_same_batches(batches, jbatches)
    assert [len(b["id"]) for b in batches] == [32, 32, 32]


def _double(arr):
    return arr * 2


@pytest.mark.parametrize("loader", ["BatchedDataLoader", "InMemBatchedDataLoader"])
def test_transform_fn_replaces_the_column_conversion(scalar_dataset, loader):
    kwargs = dict(schema_fields=["id", "int_col"], **READ)
    extra = {"shuffle": False} if loader == "InMemBatchedDataLoader" else {}
    with make_batch_reader(scalar_dataset.url, **kwargs) as r:
        batches = list(getattr(pytorch, loader)(r, batch_size=25, torch_device="cpu",
                                                transform_fn=_double, **extra))
    with jax_make_batch_reader(scalar_dataset.url, **kwargs) as r:
        jbatches = list(getattr(jax_pytorch, loader)(r, batch_size=25, transform_fn=_double,
                                                     **extra))
    assert_same_batches(batches, jbatches)
    assert isinstance(batches[0]["id"], np.ndarray)
    assert batches[0]["id"].tolist() == [2 * i for i in range(25)]


def test_inmem_loader_equals_the_jax_adapter(flag_store):
    with make_batch_reader(flag_store, **READ) as r:
        batches = list(pytorch.InMemBatchedDataLoader(r, batch_size=10, torch_device="cpu",
                                                      num_epochs=2, shuffle=False))
    with jax_make_batch_reader(flag_store, **READ) as r:
        jbatches = list(jax_pytorch.InMemBatchedDataLoader(r, batch_size=10, num_epochs=2,
                                                           shuffle=False))
    assert_same_batches(batches, jbatches)
    assert len(batches) == 6 and batches[0]["flag"].dtype == torch.uint8


@pytest.mark.parametrize("drop_last", [None, True])
def test_collate_fn_with_decimal_friendly_collate(synthetic_dataset, drop_last):
    kwargs = dict(schema_fields=["id", "decimal_col", "matrix"], **READ)
    with make_reader(synthetic_dataset.url, **kwargs) as r:
        batches = list(pytorch.DataLoader(r, batch_size=30, drop_last=drop_last,
                                          collate_fn=pytorch.decimal_friendly_collate))
    with jax_make_reader(synthetic_dataset.url, **kwargs) as r:
        jbatches = list(jax_pytorch.DataLoader(r, batch_size=30, drop_last=drop_last,
                                               collate_fn=jax_pytorch.decimal_friendly_collate))
    assert len(batches) == len(jbatches) == (4 if drop_last is None else 3)
    for b, j in zip(batches, jbatches):
        assert b["decimal_col"] == j["decimal_col"]
        assert torch.equal(b["id"], j["id"]) and torch.equal(b["matrix"], j["matrix"])


@pytest.mark.parametrize("batch", [
    [Decimal("1.5"), Decimal("2")], [{"a": 1, "b": Decimal("0.1")}, {"a": 2, "b": Decimal("3")}],
    [np.ones(3, np.float32), np.zeros(3, np.float32)], [1.5, 2.5], [], ["x", "y"]],
    ids=["decimals", "dicts", "arrays", "floats", "empty", "strings"])
def test_decimal_friendly_collate_equals_jax(batch):
    got, want = pytorch.decimal_friendly_collate(batch), jax_pytorch.decimal_friendly_collate(batch)
    if isinstance(want, dict):
        assert set(got) == set(want)
        got, want = list(got.values()), list(want.values())
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert type(g) is type(w)
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w


def test_adapter_refusals(synthetic_dataset):
    with make_reader(synthetic_dataset.url, schema_fields=["id"], **READ) as r:
        with pytest.raises(ValueError, match="torch_device"):
            pytorch.DataLoader(r, batch_size=4, torch_device="cpu", collate_fn=list)
        with pytest.raises(ValueError, match="echo"):
            pytorch.DataLoader(r, batch_size=4, collate_fn=list, echo=2)
        with pytest.raises(TypeError, match="torch_device"):
            pytorch.DataLoader(r, batch_size=4, device="cpu")
        with pytest.raises(ValueError, match="state_dict"):
            pytorch.DataLoader(r, batch_size=4, collate_fn=list).state_dict()


def test_the_adapter_defaults_to_the_card(synthetic_dataset):
    """Without ``torch_device`` the adapter stages onto the card, so a host
    without one refuses instead of staying on the CPU (on a card host,
    ``tests/test_torch_cuda.py`` holds the default)."""
    if torch.cuda.is_available():
        pytest.skip("holds the default on a host without a GPU")
    with make_reader(synthetic_dataset.url, schema_fields=["id"], **READ) as r:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pytorch.DataLoader(r, batch_size=4)


# ------------------------------------------------------------------ tf_utils
def _tf_rows(module, factory, url, **kwargs):
    with factory(url, **kwargs) as reader:
        return [{k: v.numpy() for k, v in s.items()}
                for s in module.make_petastorm_dataset(reader)]


def test_tf_row_path_equals_jax(synthetic_dataset, tf):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils
    kwargs = dict(schema_fields=["id", "matrix", "decimal_col", "partition_key",
                                 "matrix_uint16", "image_png"], **READ)
    rows = _tf_rows(tf_utils, make_reader, synthetic_dataset.url, **kwargs)
    jrows = _tf_rows(jax_tf_utils, jax_make_reader, synthetic_dataset.url, **kwargs)
    assert_same_batches(rows, jrows)
    assert rows[0]["matrix_uint16"].dtype == np.int32
    assert float(rows[1]["decimal_col"].decode()) == pytest.approx(0.1)


def test_tf_batch_path_equals_jax(scalar_dataset, tf):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils

    def read(module, factory):
        with factory(scalar_dataset.url, schema_fields=["id", "float_col", "vector_col"],
                     **READ) as reader:
            ds = module.make_petastorm_dataset(reader).unbatch().batch(25)
            return [{k: v.numpy() for k, v in b.items()} for b in ds]

    batches, jbatches = read(tf_utils, make_batch_reader), read(jax_tf_utils, jax_make_batch_reader)
    assert_same_batches(batches, jbatches)
    assert [len(b["id"]) for b in batches] == [25, 25, 25, 25]
    assert batches[0]["vector_col"].shape == (25, 4)


@pytest.fixture(scope="module")
def seq_store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('seq')}/ds"
    schema = JaxUnischema("Seq", [
        JaxField("ts", np.int64, (), JaxScalarCodec(np.int64), False),
        JaxField("value", np.float32, (2,), JaxNdarrayCodec(), False),
        JaxField("label", np.int32, (), JaxScalarCodec(np.int32), False)])
    rng = np.random.default_rng(0)
    with jax_materialize(url, schema, rows_per_row_group=20) as w:
        w.write_rows([{"ts": i if i <= 10 else i + 4,
                       "value": rng.normal(size=2).astype(np.float32),
                       "label": np.int32(i)} for i in range(20)])
    return url


def _ngram_windows(module, factory, ngram, url):
    with factory(url, schema_fields=ngram, **READ) as reader:
        return list(module.make_petastorm_dataset(reader))


def test_tf_ngram_path_equals_jax(seq_store, tf):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils
    fields = {0: ["ts", "value"], 1: ["ts", "label"]}
    windows = _ngram_windows(tf_utils, make_reader,
                             NGram(fields, delta_threshold=1, timestamp_field="ts"), seq_store)
    jwindows = _ngram_windows(jax_tf_utils, jax_make_reader,
                              JaxNGram(fields, delta_threshold=1, timestamp_field="ts"), seq_store)
    assert len(windows) == len(jwindows) == 18
    for w, j in zip(windows, jwindows):
        assert set(w) == set(j) == {0, 1}
        for off in w:
            assert w[off]._fields == j[off]._fields
            for name in w[off]._fields:
                assert_same(getattr(w[off], name), getattr(j[off], name))


def test_tf_dense_ngram_path_equals_jax(seq_store, tf):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils
    kwargs = dict(delta_threshold=1, timestamp_field="ts", timestamp_overlap=False, dense=True)
    fields = {o: ["ts", "value"] for o in range(3)}
    windows = _ngram_windows(tf_utils, make_reader, NGram(fields, **kwargs), seq_store)
    jwindows = _ngram_windows(jax_tf_utils, jax_make_reader, JaxNGram(fields, **kwargs), seq_store)
    assert_same_batches([{k: v.numpy() for k, v in w.items()} for w in windows],
                        [{k: v.numpy() for k, v in w.items()} for w in jwindows])
    assert windows[0]["value"].shape == (3, 2)


def _graph_samples(tf, module, factory, url, count, **kwargs):
    with factory(url, **READ, **kwargs) as reader:
        graph = tf.Graph()
        with graph.as_default():
            sample = module.tf_tensors(reader)
            shapes = ({off: [t.shape.as_list() for t in s] for off, s in sample.items()}
                      if isinstance(sample, dict) else [t.shape.as_list() for t in sample])
            with tf.compat.v1.Session(graph=graph) as sess:
                return shapes, [sess.run(sample) for _ in range(count)]


def test_tf_tensors_equal_jax(synthetic_dataset, tf):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils
    kwargs = dict(schema_fields=["id", "matrix", "decimal_col"])
    shapes, got = _graph_samples(tf, tf_utils, make_reader, synthetic_dataset.url, 5, **kwargs)
    jshapes, want = _graph_samples(tf, jax_tf_utils, jax_make_reader, synthetic_dataset.url, 5,
                                   **kwargs)
    assert shapes == jshapes == [[], [], [32, 16, 3]]
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for a, b in zip(g, w):
            assert_same(a, b)


def test_tf_tensors_ngram_equal_jax(seq_store, tf):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils
    fields = {0: ["ts", "value"], 1: ["ts"]}
    kwargs = dict(delta_threshold=1, timestamp_field="ts")
    _, got = _graph_samples(tf, tf_utils, make_reader, seq_store, 3,
                            schema_fields=NGram(fields, **kwargs))
    _, want = _graph_samples(tf, jax_tf_utils, jax_make_reader, seq_store, 3,
                             schema_fields=JaxNGram(fields, **kwargs))
    for g, w in zip(got, want):
        assert set(g) == set(w) == {0, 1}
        for off in g:
            for a, b in zip(g[off], w[off]):
                assert_same(a, b)
    assert got[1][0].ts - got[0][0].ts == 1


@pytest.mark.parametrize("value", [Decimal("1.25"), np.datetime64("2024-01-02T03:04:05"),
                                   np.array(["2024-01-01", "2024-01-02"], "datetime64[D]"),
                                   np.array([Decimal("0.5"), Decimal("2")], dtype=object),
                                   np.arange(3)], ids=lambda v: type(v).__name__)
def test_tf_sanitizing_equals_jax(value):
    from petastorm_tpu import tf_utils as jax_tf_utils
    from petastorm_tpu_torch import tf_utils
    got, want = tf_utils._sanitize_value(value), jax_tf_utils._sanitize_value(value)
    assert type(got) is type(want)
    assert np.array_equal(got, want)


# --------------------------------------------------------------------- CLIs
def _read_rows(url):
    with jax_make_reader(url, **READ) as r:
        return sorted(tuple(np.asarray(v).tobytes() if v is not None else None for v in row)
                      for row in r)


def test_copy_dataset_cli_equals_jax(synthetic_dataset, tmp_path):
    from petastorm_tpu.tools.copy_dataset import main as jax_main
    from petastorm_tpu_torch.tools.copy_dataset import main
    args = ["--field-regex", "id", "id2", "matrix", "--rows-per-row-group", "20"]
    target, jtarget = f"file://{tmp_path}/copy", f"file://{tmp_path}/jax_copy"
    assert main([synthetic_dataset.url, target, *args]) == 0
    assert jax_main([synthetic_dataset.url, jtarget, *args]) == 0
    rows = _read_rows(target)
    assert len(rows) == 100 and rows == _read_rows(jtarget)
    with make_reader(target, **READ) as r:
        assert set(next(r)._fields) == {"id", "id2", "matrix"}
    assert sorted(pq.read_metadata(f"{tmp_path}/copy/_common_metadata").metadata) == \
        sorted(pq.read_metadata(f"{tmp_path}/jax_copy/_common_metadata").metadata)


def test_copy_dataset_not_null_filter_equals_jax(synthetic_dataset, tmp_path):
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jax_copy
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    kwargs = dict(field_regex=["id", "nullable_int"], not_null_fields=["nullable_int"])
    copied = copy_dataset(synthetic_dataset.url, f"file://{tmp_path}/nn", **kwargs)
    assert copied == jax_copy(synthetic_dataset.url, f"file://{tmp_path}/jnn", **kwargs) == 34
    assert _read_rows(f"file://{tmp_path}/nn") == _read_rows(f"file://{tmp_path}/jnn")


def test_copy_dataset_overwrite_semantics(synthetic_dataset, tmp_path):
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset, main
    target = f"file://{tmp_path}/copy_ow"
    copy_dataset(synthetic_dataset.url, target, field_regex=["id"])
    with pytest.raises(ValueError, match="overwrite"):
        copy_dataset(synthetic_dataset.url, target, field_regex=["id"])
    assert main([synthetic_dataset.url, target, "--field-regex", "id", "--overwrite-output",
                 "--row-group-size-mb", "1", "--partition-count", "8",
                 "--hdfs-driver", "libhdfs3"]) == 0
    with make_reader(target, **READ) as r:
        assert len(list(r)) == 100


@pytest.mark.parametrize("where", ["same", "below", "above"])
def test_copy_dataset_refuses_nested_paths(synthetic_dataset, where):
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jax_copy
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    src = synthetic_dataset.url.replace("file://", "")
    target = {"same": synthetic_dataset.url, "below": f"file://{src}/sub",
              "above": f"file://{os.path.dirname(src)}"}[where]
    for copy in (copy_dataset, jax_copy):
        with pytest.raises(ValueError, match="nested|same path"):
            copy(synthetic_dataset.url, target, overwrite_output=True)


def _plain_store(path, rows=50):
    path.mkdir()
    pq.write_table(pa.table({"a": np.arange(rows), "b": np.arange(rows) * 0.5}),
                   f"{path}/x.parquet", row_group_size=10)
    return f"file://{path}"


def _kv(path):
    md = pq.read_metadata(f"{path}/_common_metadata").metadata
    return {k: json.loads(v) for k, v in md.items() if k.startswith(b"petastorm-tpu.")}


@pytest.mark.parametrize("argv", [[], ["--use-inferred-schema"], ["--use-summary-metadata"],
                                  ["--master", "local[2]", "--spark-driver-memory", "2g"]],
                         ids=["plain", "inferred", "summary", "spark-flags"])
def test_generate_metadata_cli_equals_jax(tmp_path, argv):
    from petastorm_tpu.etl.generate_metadata import main as jax_main
    from petastorm_tpu_torch.etl.generate_metadata import main
    url, jurl = _plain_store(tmp_path / "port"), _plain_store(tmp_path / "jax")
    assert main(["--dataset_url", url, *argv]) == 0
    assert jax_main(["--dataset_url", jurl, *argv]) == 0
    assert _kv(tmp_path / "port") == _kv(tmp_path / "jax")
    if "--use-summary-metadata" in argv:
        md, jmd = (pq.read_metadata(f"{tmp_path / p}/_metadata") for p in ("port", "jax"))
        assert md.num_row_groups == jmd.num_row_groups == 5
    with make_reader(url, **READ) as r:
        assert sorted(int(s.a) for s in r) == list(range(50))


def test_generate_metadata_reference_spelling_and_unischema_class(tmp_path, capsys):
    from dataset_utils import TestSchema
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, get_schema
    from petastorm_tpu_torch.etl.generate_metadata import main
    url = _plain_store(tmp_path / "plain2", rows=30)
    assert main([url]) == 0
    assert "3 row groups indexed" in capsys.readouterr().out
    assert set(get_schema(DatasetContext(url)).fields) == {"a", "b"}
    assert main(["--dataset_url", url, "--unischema_class", "dataset_utils.TestSchema"]) == 0
    assert set(get_schema(DatasetContext(url)).fields) == set(TestSchema.fields)
    with pytest.raises(SystemExit):
        main([url, "--dataset_url", url + "_other"])


def test_metadata_util_cli_output_equals_jax(tmp_path, capsys):
    """On a fresh store (the session's synthetic store may carry indexes
    other tests built), without and then with a row-group index."""
    from dataset_utils import create_test_dataset
    from petastorm_tpu.etl.metadata_util import main as jax_main
    from petastorm_tpu.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.etl.metadata_util import main
    url = f"file://{tmp_path}/indexed"
    create_test_dataset(url, num_rows=20, rows_per_row_group=5)

    def outputs(*argv):
        out = []
        for run in (main, jax_main):
            assert run([url, "--skip-schema", *argv]) == 0
            out.append(capsys.readouterr().out)
        return out

    plain = outputs()
    assert plain[0] == plain[1]
    assert "4 row groups in 2 files" in plain[0] and "no row-group indexes" in plain[0]
    build_rowgroup_index(url, [SingleFieldIndexer("id2_index", "id2")])
    indexed = outputs("--print-values")
    assert indexed[0] == indexed[1] and "index 'id2_index': 10 values" in indexed[0]


def test_metadata_util_prints_the_schema(synthetic_dataset, capsys):
    from petastorm_tpu_torch.etl.metadata_util import main
    assert main([synthetic_dataset.url]) == 0
    out = capsys.readouterr().out
    assert "TestSchema" in out and "decimal_col" in out


def test_throughput_cli_reads_through_tf(tmp_path, tf):
    from petastorm_tpu_torch.benchmark import cli
    from petastorm_tpu_torch.benchmark.hello_world import generate_hello_world_dataset
    url = generate_hello_world_dataset(f"file://{tmp_path}/hello", rows_count=6,
                                       rows_per_row_group=2)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main([url, "-d", "tf", "-m", "3", "-n", "12", "--json"]) == 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert result["samples_per_second"] > 0 and result["input_stall_percent"] is None


def test_spark_session_cli_builds_a_session(spark_session):
    import argparse
    from petastorm_tpu_torch.tools.spark_session_cli import (add_configure_spark_arguments,
                                                             configure_spark)
    parser = argparse.ArgumentParser()
    add_configure_spark_arguments(parser)
    args = parser.parse_args(["--master", "local[2]", "--spark-session-config", "a.b=1"])
    assert configure_spark(args) is not None
    with pytest.raises(ValueError, match="key=value"):
        configure_spark(parser.parse_args(["--spark-session-config", "novalue"]))


def test_the_converter_needs_pyspark_only_when_called():
    import importlib
    module = importlib.import_module("petastorm_tpu_torch.spark.spark_dataset_converter")
    with pytest.raises((ImportError, ValueError)):
        module.make_spark_converter(None)


# ------------------------------------------- the converter's read-side API
@pytest.mark.parametrize("url", ["/tmp/x/", "file:///tmp/a", ["file:///tmp/a", "/tmp/b"],
                                 "memory://bucket/x"], ids=["bare", "file", "list", "memory"])
def test_get_filesystem_and_path_or_paths_equals_jax(url):
    from petastorm_tpu.fs_utils import get_filesystem_and_path_or_paths as jax_resolve
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
    fs, path = get_filesystem_and_path_or_paths(url)
    jfs, jpath = jax_resolve(url)
    assert type(fs) is type(jfs) and path == jpath


@pytest.mark.parametrize("url", ["/tmp/x/", "file:///tmp/a", "memory://bucket/x"],
                         ids=["bare", "file", "memory"])
def test_filesystem_resolver_equals_jax(url):
    from petastorm_tpu.fs_utils import FilesystemResolver as JaxResolver
    from petastorm_tpu_torch.fs_utils import FilesystemResolver
    got, want = FilesystemResolver(url), JaxResolver(url)
    assert type(got.filesystem()) is type(want.filesystem())
    assert got.get_dataset_path() == want.get_dataset_path()
    assert got.parsed_dataset_url == want.parsed_dataset_url


def test_mixed_urls_and_hdfs_are_refused(monkeypatch):
    """Mixed URLs are refused; an hdfs:// store whose namenode does not
    answer is refused by the HA connector (its connection is mocked: no
    namenode is contacted)."""
    from petastorm_tpu_torch.fs_utils import FilesystemResolver, get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.hdfs.namenode import HdfsConnectError, HdfsConnector

    def refuse(cls, netloc, user=None, **kwargs):
        raise IOError(f"no route to {netloc}")
    monkeypatch.setattr(HdfsConnector, "hdfs_connect_namenode", classmethod(refuse))
    with pytest.raises(ValueError, match="share scheme"):
        get_filesystem_and_path_or_paths(["file:///a", "memory://b"])
    with pytest.raises(HdfsConnectError, match="namenode:8020"):
        FilesystemResolver("hdfs://namenode:8020/ds", hadoop_configuration={})
    with pytest.raises(ValueError, match="empty"):
        get_filesystem_and_path_or_paths([])


def test_write_dataset_metadata_on_a_url_returns_the_jax_statistics(scalar_dataset, tmp_path):
    import shutil
    from petastorm_tpu.etl.dataset_metadata import write_dataset_metadata as jax_write
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset_metadata
    src = scalar_dataset.url[len("file://"):]
    for name in ("port", "jax"):
        shutil.copytree(src, tmp_path / name, ignore=shutil.ignore_patterns("_*"))
    stats = write_dataset_metadata(f"file://{tmp_path}/port", None)
    jstats = jax_write(f"file://{tmp_path}/jax", None)
    assert stats == jstats and stats["total_rows"] == 100 and stats["num_files"] == 2
    assert _kv(tmp_path / "port") == _kv(tmp_path / "jax")


def test_get_schema_from_dataset_url_and_namedtuples_equal_jax(synthetic_dataset):
    from petastorm_tpu.etl.dataset_metadata import get_schema_from_dataset_url as jax_get
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url
    schema, jschema = get_schema_from_dataset_url(synthetic_dataset.url), \
        jax_get(synthetic_dataset.url)
    assert schema.to_dict() == jschema.to_dict()
    view, jview = (s.create_schema_view(["id", "id2"]) for s in (schema, jschema))
    row = view.make_namedtuple(id=1, id2=2, unused=3)
    assert tuple(row) == tuple(jview.make_namedtuple(id=1, id2=2, unused=3)) == (1, 2)
    assert type(row).__name__ == type(jview.make_namedtuple(id=1, id2=2)).__name__
    assert tuple(view.make_namedtuple_tf(5, id2=6)) == tuple(jview.make_namedtuple_tf(5, id2=6))
    with pytest.raises(KeyError):
        view.make_namedtuple(id=1)


@pytest.mark.parametrize("factory,jax_factory,kwargs", [
    (make_reader, jax_make_reader, {"schema_fields": ["id"]}),
    (make_batch_reader, jax_make_batch_reader, {"schema_fields": ["id"]})],
    ids=["make_reader", "make_batch_reader"])
@pytest.mark.parametrize("shard_count", [None, 2])
def test_cur_shard_auto_in_one_process_equals_jax(synthetic_dataset, factory, jax_factory,
                                                  kwargs, shard_count):
    """One process is shard 0, of ``shard_count`` or 1, in both packages."""
    def ids(make, **extra):
        with make(synthetic_dataset.url, cur_shard="auto", shard_count=shard_count,
                  **kwargs, **extra, **READ) as r:
            return sorted(int(i) for row in r for i in np.atleast_1d(row.id))
    got = ids(factory)
    assert got == ids(jax_factory)
    assert len(got) == (100 if shard_count is None else 50)


def test_cur_shard_auto_reads_the_rank_of_an_initialised_group(synthetic_dataset, monkeypatch):
    """With a ``torch.distributed`` group, "auto" is (rank, world size)."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)

    def ids(**shard):
        with make_reader(synthetic_dataset.url, schema_fields=["id"], **shard, **READ) as r:
            return sorted(int(row.id) for row in r)
    assert ids(cur_shard="auto") == ids(cur_shard=1, shard_count=3)
    assert ids(cur_shard="auto", shard_count=2) == ids(cur_shard=1, shard_count=2)
