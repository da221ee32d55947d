"""petastorm_tpu_torch's ``make_batch_reader`` against the JAX package's, on
the same seeded plain Parquet stores (``torch_columnar_stores``): the
scalar bench's store, the tensor bench's schema, declared and undeclared
list columns, columns with nulls, and a store of four files. Group by group
on the dummy pool, in file order and with seeded shuffles, bit for bit;
the thread and process pools against the dummy pool as multisets of rows;
``convert_early_to_numpy``; and the inferred schema against the JAX
package's."""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxDatasetContext
from petastorm_tpu.etl.dataset_metadata import infer_or_load_unischema as jax_infer
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu_torch import reader as reader_module
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, infer_or_load_unischema
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.reader_impl.batch_reader_worker import arrow_table_to_numpy_dict
from petastorm_tpu_torch.unischema import Unischema
from torch_columnar_stores import assert_same_columns, row_keys, write_stores

STORES = ["scalar", "tensor", "lists", "nulls", "four_files"]
#: Stores whose columns are all numeric and fixed-shape (rows compare as bytes).
NUMERIC = ["scalar", "tensor", "four_files"]
ORDERS = {"file order": dict(shuffle_row_groups=False),
          "shuffled rows": dict(shuffle_rows=True, seed=3),
          "shuffled groups and rows": dict(shuffle_row_groups=True, shuffle_rows=True, seed=11),
          "two epochs": dict(seed=5, num_epochs=2)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return write_stores(tmp_path_factory.mktemp("columnar"))


def _groups(make, url, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make(url, **kwargs) as reader:
            out = []
            while True:
                try:
                    out.append(reader.next_batch())
                except StopIteration:
                    return out


def _concat(groups):
    return {k: np.concatenate([g[k] for g in groups]) for k in groups[0]}


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("store", STORES)
def test_groups_equal_the_jax_reader_on_the_dummy_pool(stores, store, order):
    kwargs = dict(reader_pool_type="dummy", **ORDERS[order])
    want = _groups(jax_make_batch_reader, stores[store], **kwargs)
    got = _groups(make_batch_reader, stores[store], **kwargs)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert_same_columns(g, w)


@pytest.mark.parametrize("store", STORES)
def test_namedtuple_of_columns_per_group(stores, store):
    with make_batch_reader(stores[store], reader_pool_type="dummy",
                           shuffle_row_groups=False) as reader, \
            jax_make_batch_reader(stores[store], reader_pool_type="dummy",
                                  shuffle_row_groups=False) as jax_reader:
        assert reader.batched_output and jax_reader.batched_output
        for got, want in zip(reader, jax_reader):
            assert got._fields == want._fields
            assert_same_columns(got._asdict(), want._asdict())
        assert reader.last_row_consumed


@pytest.mark.parametrize("fields", [["id", "f1", "emb0"], ["f[0-3]"], ["emb.*", "id"]])
def test_schema_fields_names_and_regexes(stores, fields):
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False, schema_fields=fields)
    want = _groups(jax_make_batch_reader, stores["tensor"], **kwargs)
    got = _groups(make_batch_reader, stores["tensor"], **kwargs)
    assert [list(g) for g in got] == [list(w) for w in want]
    for g, w in zip(got, want):
        assert_same_columns(g, w)


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_sharding_reads_the_jax_readers_groups(stores, shard):
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False, cur_shard=shard,
                  shard_count=3)
    want = _groups(jax_make_batch_reader, stores["four_files"], **kwargs)
    got = _groups(make_batch_reader, stores["four_files"], **kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_columns(g, w)


@pytest.mark.parametrize("pool", ["thread", "process"])
@pytest.mark.parametrize("store", NUMERIC)
def test_pools_give_the_dummy_pools_rows(stores, store, pool):
    want = _concat(_groups(make_batch_reader, stores[store], reader_pool_type="dummy", seed=1,
                           shuffle_rows=True))
    got = _concat(_groups(make_batch_reader, stores[store], reader_pool_type=pool,
                          workers_count=2, seed=1, shuffle_rows=True))
    assert row_keys(got) == row_keys(want)


def test_thread_pool_keeps_the_dummy_pools_order(stores):
    for g, w in zip(_groups(make_batch_reader, stores["tensor"], reader_pool_type="thread",
                            workers_count=3, seed=7, shuffle_rows=True),
                    _groups(make_batch_reader, stores["tensor"], reader_pool_type="dummy",
                            seed=7, shuffle_rows=True)):
        assert_same_columns(g, w)


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_lists_and_nulls_on_every_pool(stores, pool):
    """Object and list columns cross every pool: rows matched by ``id``."""
    for store in ("lists", "nulls"):
        want = _concat(_groups(make_batch_reader, stores[store], reader_pool_type="dummy",
                               shuffle_row_groups=False))
        got = _concat(_groups(make_batch_reader, stores[store], reader_pool_type=pool,
                              workers_count=2, seed=2))
        order = np.argsort(got["id"], kind="stable")
        assert_same_columns({k: v[order] for k, v in got.items()}, want)


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
@pytest.mark.parametrize("store", ["tensor", "lists"])
def test_convert_early_to_numpy_gives_the_same_columns(stores, store, pool):
    kwargs = dict(reader_pool_type=pool, workers_count=1, shuffle_row_groups=False)
    want = _groups(make_batch_reader, stores[store], **kwargs)
    got = _groups(make_batch_reader, stores[store], convert_early_to_numpy=True, **kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_columns(g, w)


def test_convert_early_to_numpy_matches_the_jax_reader(stores):
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False, convert_early_to_numpy=True)
    for g, w in zip(_groups(make_batch_reader, stores["lists"], **kwargs),
                    _groups(jax_make_batch_reader, stores["lists"], **kwargs)):
        assert_same_columns(g, w)


@pytest.mark.parametrize("store", STORES)
def test_inferred_schema_equals_the_jax_packages(stores, store):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = infer_or_load_unischema(DatasetContext(stores[store]))
        want = jax_infer(JaxDatasetContext(stores[store]))
    assert got.to_dict() == want.to_dict()


def test_from_arrow_schema_maps_every_type_as_the_jax_package():
    import pyarrow as pa
    schema = pa.schema([("b", pa.bool_()), ("i8", pa.int8()), ("u16", pa.uint16()),
                        ("h", pa.float16()), ("d", pa.float64()), ("s", pa.string()),
                        ("raw", pa.large_binary()), ("day", pa.date32()),
                        ("ts", pa.timestamp("ms")), ("dec", pa.decimal128(10, 2)),
                        ("fsl", pa.list_(pa.int32(), 5)), ("var", pa.list_(pa.float32())),
                        pa.field("opt", pa.int64(), nullable=False)])
    assert Unischema.from_arrow_schema(schema).to_dict() == \
        JaxUnischema.from_arrow_schema(schema).to_dict()
    bad = pa.schema([("ok", pa.int32()), ("nested", pa.struct([("x", pa.int32())]))])
    with pytest.raises(ValueError, match="nested"):
        Unischema.from_arrow_schema(bad)
    with pytest.warns(UserWarning, match="nested"):
        assert list(Unischema.from_arrow_schema(bad, omit_unsupported_fields=True).fields) == \
            ["ok"]


def test_arrow_table_to_numpy_dict_force_copy():
    import pyarrow as pa
    table = pa.table({"x": np.arange(6, dtype=np.float32),
                      "v": pa.FixedSizeListArray.from_arrays(pa.array(np.arange(12.0)), 2)})
    schema = Unischema.from_arrow_schema(table.schema)
    views = arrow_table_to_numpy_dict(table, schema)
    copies = arrow_table_to_numpy_dict(table, schema, force_copy=True)
    assert views["v"].shape == (6, 2) and views["x"].base is not None
    for name in ("x", "v"):
        assert np.array_equal(views[name], copies[name])
        assert copies[name].base is None


def test_stored_schema_wins_over_inference(stores):
    schema = infer_or_load_unischema(DatasetContext(stores["lists"]))
    assert schema.name == "lists" and schema.fields["declared_i64"].shape == (2,)


def test_row_reader_still_needs_a_petastorm_store_and_batch_reader_refuses_ngram(stores):
    from petastorm_tpu_torch.errors import MetadataError
    with pytest.raises(MetadataError):
        make_reader(stores["scalar"], reader_pool_type="dummy")
    ngram = NGram({0: ["id"], 1: ["id"]}, delta_threshold=1, timestamp_field="id")
    with pytest.raises(ValueError, match="NGram"):
        make_batch_reader(stores["tensor"], schema_fields=ngram, reader_pool_type="dummy")
    with pytest.raises(TypeError, match="next_batch"):
        reader_module.Reader.next_batch(SimpleNamespace(_batched=False))
