"""petastorm_tpu_torch.reader / etl against the JAX package, both directions.

A store written by the JAX writer is read by both packages: same rows, same
order (dummy pool, with and without a seeded shuffle), same multiset
(thread pool). A store written by the port's writer is read by the JAX
reader, with an equal schema.
"""
from decimal import Decimal

import numpy as np
import pytest

from dataset_utils import create_test_dataset
from petastorm_tpu.etl.dataset_metadata import (DatasetContext as JaxContext,
                                                get_schema as jax_get_schema)
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch import codecs as tcodecs
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, get_schema
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('jax_store')}/ds"
    create_test_dataset(url, num_rows=60, rows_per_row_group=6)
    return url


def _same_value(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def assert_same_rows(port_rows, jax_rows):
    assert len(port_rows) == len(jax_rows) > 0
    for p, j in zip(port_rows, jax_rows):
        assert p._fields == j._fields
        for name in p._fields:
            assert _same_value(getattr(p, name), getattr(j, name)), name


def _read(factory, url, **kwargs):
    with factory(url, **kwargs) as reader:
        return list(reader)


@pytest.mark.parametrize("kwargs", [
    dict(shuffle_row_groups=False),
    dict(seed=7, shuffle_row_groups=True, shuffle_rows=True),
    dict(seed=3, shuffle_row_groups=True, num_epochs=2, cur_shard=1, shard_count=3),
    dict(seed=11, shuffle_rows=True, schema_fields=["id", "image_png", "decimal_col"]),
], ids=["plain", "seeded_shuffle", "sharded_two_epochs", "view"])
def test_dummy_pool_rows_equal_and_in_jax_order(jax_store, kwargs):
    kwargs = dict(kwargs, reader_pool_type="dummy")
    assert_same_rows(_read(make_reader, jax_store, **kwargs),
                     _read(jax_make_reader, jax_store, **kwargs))


def test_thread_pool_gives_the_same_multiset(jax_store):
    kwargs = dict(reader_pool_type="thread", workers_count=3, seed=5,
                  shuffle_row_groups=True, shuffle_rows=True)
    port = sorted(_read(make_reader, jax_store, **kwargs), key=lambda r: int(r.id))
    ref = sorted(_read(jax_make_reader, jax_store, **kwargs), key=lambda r: int(r.id))
    assert_same_rows(port, ref)


def test_reset_replays_the_seeded_pass(jax_store):
    with make_reader(jax_store, reader_pool_type="dummy", seed=2, shuffle_rows=True) as reader:
        first = list(reader)
        reader.reset()
        second = list(reader)
    assert_same_rows(first, second)


def test_schema_of_jax_store_equals_jax_schema(jax_store):
    assert get_schema(DatasetContext(jax_store)).to_dict() == \
        jax_get_schema(JaxContext(jax_store)).to_dict()


def test_shard_out_of_range_and_empty_shard_raise(jax_store):
    with pytest.raises(ValueError):
        make_reader(jax_store, cur_shard=3, shard_count=3)
    # "auto" is a rank (test_torch_adapters_and_tools.py); another string is not.
    with pytest.raises(ValueError):
        make_reader(jax_store, cur_shard="first", shard_count=2)
    with pytest.raises(NoDataAvailableError):
        make_reader(jax_store, cur_shard=15, shard_count=16)


PortSchema = Unischema("PortSchema", [
    UnischemaField("id", np.int64, (), tcodecs.ScalarCodec(np.int64), False),
    UnischemaField("name", str, (), tcodecs.ScalarCodec(str), False),
    UnischemaField("price", Decimal, (), tcodecs.ScalarCodec(Decimal), False),
    UnischemaField("jpeg", np.uint8, (16, 24, 3), tcodecs.CompressedImageCodec("jpeg"), False),
    UnischemaField("png", np.uint8, (16, 24), tcodecs.CompressedImageCodec("png"), False),
    UnischemaField("tensor", np.float32, (4, 5), tcodecs.NdarrayCodec(), False),
    UnischemaField("packed", np.int16, (7,), tcodecs.CompressedNdarrayCodec(), False),
    UnischemaField("maybe", np.int32, (), tcodecs.ScalarCodec(np.int32), True),
])


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('port_store')}/ds"
    rng = np.random.default_rng(0)
    rows = []
    for i in range(40):
        grad = np.linspace(0, 200, 24, dtype=np.float32)[None, :, None]
        rows.append({
            "id": i, "name": f"row-{i}", "price": Decimal(i) / Decimal(4),
            "jpeg": (grad + rng.integers(0, 30, (16, 24, 3))).astype(np.uint8),
            "png": rng.integers(0, 256, (16, 24), dtype=np.uint8),
            "tensor": rng.normal(size=(4, 5)).astype(np.float32),
            "packed": rng.integers(-100, 100, 7).astype(np.int16),
            **({"maybe": np.int32(i)} if i % 2 else {}),
        })
    with materialize_dataset_local(url, PortSchema, rows_per_row_group=8) as w:
        w.write_rows(rows)
    return url, rows


def test_port_store_read_by_jax_reader(port_store):
    url, rows = port_store
    jax_rows = _read(jax_make_reader, url, reader_pool_type="dummy", shuffle_row_groups=False)
    assert [int(r.id) for r in jax_rows] == list(range(40))
    for r, want in zip(jax_rows, rows):
        assert r.name == want["name"] and r.price == want["price"]
        assert r.maybe == want.get("maybe")
        for k in ("png", "tensor", "packed"):
            np.testing.assert_array_equal(getattr(r, k), want[k])
        assert r.jpeg.shape == (16, 24, 3)   # lossy codec: shape only
    assert_same_rows(_read(make_reader, url, reader_pool_type="dummy", shuffle_row_groups=False),
                     jax_rows)


def test_port_store_schema_equals_under_jax(port_store):
    url, _ = port_store
    jax_schema = jax_get_schema(JaxContext(url))
    assert jax_schema.to_dict() == PortSchema.to_dict()
    assert [type(f.codec).__name__ for f in jax_schema] == \
        [type(f.codec).__name__ for f in PortSchema]
    assert get_schema(DatasetContext(url)) == PortSchema


def test_hive_partitioned_jax_store(tmp_path):
    from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
    from petastorm_tpu.etl.writer import materialize_dataset_local as jax_materialize
    from petastorm_tpu.unischema import Unischema as JaxUnischema
    from petastorm_tpu.unischema import UnischemaField as JaxField
    url = f"file://{tmp_path}/ds"
    schema = JaxUnischema("Parted", [JaxField("id", np.int64, (), JaxScalarCodec(np.int64), False),
                                     JaxField("part", str, (), JaxScalarCodec(str), False)])
    with jax_materialize(url, schema, rows_per_row_group=4, partition_by=["part"]) as w:
        w.write_rows({"id": i, "part": f"p{i % 3}"} for i in range(30))
    kwargs = dict(reader_pool_type="dummy", seed=6, shuffle_rows=True)
    port = _read(make_reader, url, **kwargs)
    assert_same_rows(port, _read(jax_make_reader, url, **kwargs))
    assert sorted(int(r.id) for r in port) == list(range(30))
