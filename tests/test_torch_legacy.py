"""Stores written by petastorm itself, read by the port and held to the JAX
package: the committed ``tests/data/legacy_ref/`` store (bytes made by
petastorm 0.13.1's own code; the expected values are petastorm's codecs'
own decode), pickles made with stand-in ``petastorm.*`` modules (the cases
of ``tests/test_legacy.py``), the unpickler's refusals, a migration by
``copy_dataset``, and a store that ``tests/torch_legacy_store.py`` links
from the port's own files."""
import contextlib
import glob
import json
import os
import pickle
import sys
import types
import typing
from collections import OrderedDict
from decimal import Decimal

import numpy as np
import pytest

from petastorm_tpu import reader as jax_reader
from petastorm_tpu.etl import legacy as jax_legacy
from petastorm_tpu_torch import codecs as tcodecs
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.etl import legacy
from petastorm_tpu_torch.etl.dataset_metadata import (UNISCHEMA_KEY, DatasetContext, get_schema,
                                                      load_row_groups)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from torch_legacy_store import (image_store_fields, link_reference_store,
                                reference_unischema_pickle)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "legacy_ref")
FIXTURE_URL = f"file://{FIXTURE_DIR}"
PART_URLS = [f"file://{p}" for p in sorted(glob.glob(f"{FIXTURE_DIR}/part-*.parquet"))]
IMAGE_FIELDS = ("image_png", "image_jpeg", "matrix", "packed")


def _expected():
    with open(os.path.join(FIXTURE_DIR, "expected_scalars.json")) as f:
        scalars = json.load(f)
    return {r["id"]: r for r in scalars}, np.load(os.path.join(FIXTURE_DIR, "expected_values.npz"))


def _check_against_petastorm(rows):
    """``tests/test_legacy_ref_fixture.py``'s comparisons: every value
    equals petastorm's codecs' decode of the same bytes."""
    scalars, arrays = _expected()
    assert len(rows) == 20 and {int(s.id) for s in rows} == set(scalars)
    for s in rows:
        i = int(s.id)
        exp = scalars[i]
        assert s.name == exp["name"]
        assert abs(float(s.weight) - exp["weight"]) < 1e-12
        assert Decimal(str(s.dec)) == Decimal(exp["dec"])
        for name in IMAGE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(s, name)), arrays[f"{name}_{i}"],
                                          err_msg=f"{name} row {i}")
        assert s.image_png.dtype == np.uint8 and s.image_jpeg.dtype == np.uint8
        assert s.matrix.dtype == np.float64 and s.packed.dtype == np.float32


def _rows(make, url, **kwargs):
    with make(url, shuffle_row_groups=False, **kwargs) as r:
        return sorted(r, key=lambda s: int(s.id))


def _assert_rows_equal(got, want):
    assert [int(s.id) for s in got] == [int(s.id) for s in want]
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for name in g._fields:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b and type(a) is type(b), name


def test_fixture_schema_equals_jax():
    from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxContext
    from petastorm_tpu.etl.dataset_metadata import get_schema as jax_get_schema
    got = get_schema(DatasetContext(FIXTURE_URL))
    want = jax_get_schema(JaxContext(FIXTURE_URL))
    assert list(got.fields) == list(want.fields)
    for name, f in got.fields.items():
        w = want.fields[name]
        assert (f.name, f.shape, f.nullable, repr(f.numpy_dtype)) == \
            (w.name, w.shape, w.nullable, repr(w.numpy_dtype))
        assert type(f.codec).__name__ == type(w.codec).__name__
        assert type(f.codec).__module__ == "petastorm_tpu_torch.codecs"
    assert got.image_jpeg.codec.quality == 80 and got.dec.numpy_dtype is Decimal
    assert np.dtype(got.id.codec.storage_dtype) == np.int32


@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_fixture_rows_equal_petastorm_and_jax(pool):
    got = _rows(make_reader, FIXTURE_URL, reader_pool_type=pool, workers_count=2)
    _check_against_petastorm(got)
    _assert_rows_equal(got, _rows(jax_reader.make_reader, FIXTURE_URL, reader_pool_type="dummy"))


def test_fixture_sharded_on_threads_covers_every_row_once():
    seen = []
    for shard in (0, 1):
        with make_reader(FIXTURE_URL, shuffle_row_groups=False, reader_pool_type="thread",
                         workers_count=2, cur_shard=shard, shard_count=2) as r:
            seen.append({int(s.id) for s in r})
    assert seen[0] and seen[1] and not seen[0] & seen[1]
    assert seen[0] | seen[1] == set(range(20))


def _batch_columns(make, url_or_urls, pool="dummy"):
    with make(url_or_urls, shuffle_row_groups=False, reader_pool_type=pool,
              workers_count=2) as r:
        batches = list(r)
    out = {}
    for name in batches[0]._fields:
        out[name] = np.concatenate([np.asarray(getattr(b, name)) for b in batches])
    order = np.argsort(out["id"], kind="stable")
    return {k: v[order] for k, v in out.items()}


@pytest.mark.parametrize("source,pool", [("root", "dummy"), ("urls", "dummy"),
                                         ("urls", "process")])
def test_batch_readers_give_jax_raw_columns(source, pool):
    """The raw (undecoded) columns of the fixture, from its root or from
    the list of its two part files, in both packages."""
    url = FIXTURE_URL if source == "root" else PART_URLS
    got = _batch_columns(make_batch_reader, url, pool)
    want = _batch_columns(jax_reader.make_batch_reader, url)
    root = _batch_columns(make_batch_reader, FIXTURE_URL)
    assert sorted(got) == sorted(want) == sorted(root)
    assert len(got["id"]) == 20
    for name in got:
        assert [bytes(v) if isinstance(v, (bytes, bytearray)) else v for v in got[name]] == \
            [bytes(v) if isinstance(v, (bytes, bytearray)) else v for v in want[name]], name
        assert list(got[name]) == list(root[name]), name


def test_row_reader_refuses_a_url_list_as_jax_does():
    """A URL list reads no sidecar, so it carries no petastorm schema: both
    row readers refuse it (the batch readers read it)."""
    from petastorm_tpu.errors import MetadataError as JaxMetadataError
    from petastorm_tpu_torch.errors import MetadataError
    with pytest.raises(MetadataError, match="make_batch_reader"):
        make_reader(PART_URLS, reader_pool_type="dummy")
    with pytest.raises(JaxMetadataError):
        jax_reader.make_reader(PART_URLS, reader_pool_type="dummy")


def test_fixture_plan_uses_petastorm_row_group_map():
    refs = load_row_groups(DatasetContext(FIXTURE_URL))
    from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxContext
    from petastorm_tpu.etl.dataset_metadata import load_row_groups as jax_load
    assert [(r.path, r.row_group) for r in refs] == \
        [(r.path, r.row_group) for r in jax_load(JaxContext(FIXTURE_URL))]
    assert len(refs) >= 2


def test_compat_arguments_are_warned_about_and_ignored():
    with pytest.warns(UserWarning, match="hdfs_driver is ignored"):
        with make_reader(FIXTURE_URL, reader_pool_type="dummy", hdfs_driver="libhdfs3",
                         convert_early_to_numpy=True) as r:
            assert len(list(r)) == 20
    with pytest.warns(DeprecationWarning, match="pyarrow_serialize"):
        make_reader(FIXTURE_URL, reader_pool_type="dummy", pyarrow_serialize=True).stop()
    with pytest.warns(UserWarning, match="hdfs_driver is ignored"):
        make_batch_reader(FIXTURE_URL, reader_pool_type="dummy", hdfs_driver="libhdfs").stop()


@pytest.mark.parametrize("convert", [False, True])
def test_batch_reader_serializer_choice_and_refusal(convert):
    """A given serializer carries the groups (a PickleSerializer either
    way); an Arrow one with ``convert_early_to_numpy`` is refused, by both
    packages."""
    from petastorm_tpu.reader_impl.arrow_table_serializer import \
        ArrowTableSerializer as JaxArrowTableSerializer
    from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
    from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
    with make_batch_reader(FIXTURE_URL, reader_pool_type="process", workers_count=1,
                           shuffle_row_groups=False, convert_early_to_numpy=convert,
                           serializer=PickleSerializer()) as r:
        assert sorted(int(i) for b in r for i in b.id) == list(range(20))
    for make, serializer in ((make_batch_reader, ArrowTableSerializer()),
                             (jax_reader.make_batch_reader, JaxArrowTableSerializer())):
        refused = pytest.raises(ValueError, match="PickleSerializer") if convert \
            else contextlib.nullcontext()
        with refused:
            make(FIXTURE_URL, reader_pool_type="dummy", convert_early_to_numpy=convert,
                 serializer=serializer).stop()


def test_refresh_of_a_url_list_is_refused_with_the_jax_message():
    with pytest.raises(ValueError, match="single dataset root") as port:
        make_batch_reader(PART_URLS, reader_pool_type="dummy", refresh_interval_s=1.0)
    with pytest.raises(ValueError, match="single dataset root") as jax:
        jax_reader.make_batch_reader(PART_URLS, reader_pool_type="dummy",
                                     refresh_interval_s=1.0)
    assert str(port.value) == str(jax.value)


# ------------------------------------------------- pickles of stand-in modules
@pytest.fixture
def fake_petastorm_modules():
    """Modules shaped like petastorm's (and pyspark's), under either package
    name petastorm used, installed while the test pickles with them."""
    saved = {}

    def install(package="petastorm"):
        class UnischemaField(typing.NamedTuple):
            name: str
            numpy_dtype: object
            shape: tuple
            codec: object = None
            nullable: bool = False

        class Unischema:
            def __init__(self, name, fields):
                self._name = name
                self._fields = OrderedDict((f.name, f) for f in fields)

        class ScalarCodec:
            def __init__(self, spark_type):
                self._spark_type = spark_type

        class NdarrayCodec:
            pass

        class CompressedNdarrayCodec:
            pass

        class CompressedImageCodec:
            def __init__(self, image_codec="png", quality=80):
                self.image_codec = image_codec
                self.quality = quality

        class StringType:
            pass

        class IntegerType:
            pass

        mods = {name: types.ModuleType(name)
                for name in (package, f"{package}.unischema", f"{package}.codecs", "pyspark",
                             "pyspark.sql", "pyspark.sql.types")}
        for cls, mod in ((Unischema, "unischema"), (UnischemaField, "unischema"),
                         (ScalarCodec, "codecs"), (NdarrayCodec, "codecs"),
                         (CompressedNdarrayCodec, "codecs"), (CompressedImageCodec, "codecs")):
            cls.__module__, cls.__qualname__ = f"{package}.{mod}", cls.__name__
            setattr(mods[cls.__module__], cls.__name__, cls)
        for cls in (StringType, IntegerType):
            cls.__module__, cls.__qualname__ = "pyspark.sql.types", cls.__name__
            setattr(mods["pyspark.sql.types"], cls.__name__, cls)
        for name, mod in mods.items():
            saved.setdefault(name, sys.modules.get(name))
            sys.modules[name] = mod
        return types.SimpleNamespace(**{c.__name__: c for c in (
            Unischema, UnischemaField, ScalarCodec, NdarrayCodec, CompressedNdarrayCodec,
            CompressedImageCodec, StringType, IntegerType)})

    yield install
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


def _depickled_by_both(data):
    got, want = legacy.depickle_legacy_unischema(data), jax_legacy.depickle_legacy_unischema(data)
    assert list(got.fields) == list(want.fields)
    for name, f in got.fields.items():
        w = want.fields[name]
        assert (f.shape, f.nullable, repr(f.numpy_dtype), type(f.codec).__name__) == \
            (w.shape, w.nullable, repr(w.numpy_dtype), type(w.codec).__name__)
    return got


@pytest.mark.parametrize("package", ["petastorm", "dataset_toolkit"])
@pytest.mark.parametrize("protocol", [2, 4])
def test_depickle_synthetic_legacy_unischema(fake_petastorm_modules, package, protocol):
    m = fake_petastorm_modules(package)
    old = m.Unischema("Old", [
        m.UnischemaField("id", np.int32, (), m.ScalarCodec(m.IntegerType()), False),
        m.UnischemaField("name", np.str_, (), m.ScalarCodec(m.StringType()), True),
        m.UnischemaField("image", np.uint8, (10, 10, 3), m.CompressedImageCodec("jpeg", 90),
                         False),
        m.UnischemaField("mat", np.float64, (2, 3), m.NdarrayCodec(), False),
        m.UnischemaField("packed", np.float32, (None, 2), m.CompressedNdarrayCodec(), False),
    ])
    schema = _depickled_by_both(pickle.dumps(old, protocol=protocol))
    assert isinstance(schema, Unischema) and type(schema) is Unischema
    assert all(type(f) is UnischemaField for f in schema.fields.values())
    assert set(schema.fields) == {"id", "name", "image", "mat", "packed"}
    assert type(schema.id.codec) is tcodecs.ScalarCodec
    assert np.dtype(schema.id.codec.storage_dtype) == np.int32
    assert schema.fields["name"].codec.storage_dtype is str
    assert type(schema.image.codec) is tcodecs.CompressedImageCodec
    assert (schema.image.codec.image_codec, schema.image.codec.quality) == ("jpeg", 90)
    assert type(schema.mat.codec) is tcodecs.NdarrayCodec
    assert type(schema.packed.codec) is tcodecs.CompressedNdarrayCodec
    assert schema.fields["name"].nullable is True and schema.mat.shape == (2, 3)
    assert b"_Legacy" not in pickle.dumps(schema)


@pytest.mark.parametrize("ext,codec", [(".png", "png"), (".jpg", "jpeg"), (".JPEG", "jpeg")])
def test_reference_image_extensions_normalise(fake_petastorm_modules, ext, codec):
    m = fake_petastorm_modules()
    image = m.CompressedImageCodec()
    image.__dict__ = {"_image_codec": ext, "_quality": 70}
    data = pickle.dumps(m.Unischema("S", [m.UnischemaField("i", np.uint8, (4, 4, 3), image)]),
                        protocol=2)
    got = _depickled_by_both(data).i.codec
    assert (got.image_codec, got.quality) == (codec, 70)


def test_an_exotic_image_codec_warns_and_reencodes_as_png(fake_petastorm_modules):
    m = fake_petastorm_modules()
    image = m.CompressedImageCodec()
    image.__dict__ = {"_image_codec": ".bmp", "_quality": 80}
    data = pickle.dumps(m.Unischema("S", [m.UnischemaField("i", np.uint8, (4, 4, 3), image)]),
                        protocol=2)
    with pytest.warns(UserWarning, match="'bmp' is not supported for re-encoding"):
        got = legacy.depickle_legacy_unischema(data)
    assert got.i.codec.image_codec == "png"


def test_pyspark_restore_and_python2_reconstructor_rebuild_fields():
    field = legacy._pyspark_restore("UnischemaField",
                                    ("name", "numpy_dtype", "shape", "codec", "nullable"),
                                    ("x", np.int64, (), None, True))
    assert (field.name, field.shape, field.nullable) == ("x", (), True)
    other = legacy._pyspark_restore("Point", ("a", "b"), (1, 2))
    assert (other.a, other.b) == (1, 2)
    rebuilt = legacy._legacy_reconstructor(legacy._LegacyUnischemaField, tuple,
                                           ("y", np.float32, (3,), None, False))
    assert isinstance(rebuilt, UnischemaField) and rebuilt.shape == (3,)
    u = legacy.RestrictedUnpickler.find_class
    assert u(None, "__builtin__", "set") is set
    assert u(None, "copy_reg", "_reconstructor") is legacy._legacy_reconstructor
    assert u(None, "numpy", "unicode_") is np.str_
    assert u(None, "pyspark.sql.types", "LongType")._np is np.int64


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo not run",))


@pytest.mark.parametrize("payload", ["function", "reduce", "module"])
def test_restricted_unpickler_blocks_arbitrary_classes(payload):
    if payload == "function":
        data = pickle.dumps(os.system)
    elif payload == "reduce":
        data = pickle.dumps({"x": _Evil()})
    else:
        data = pickle.dumps(Unischema("S", [UnischemaField("a", np.int64, ())]))
    for loads in (legacy.restricted_loads, jax_legacy.restricted_loads):
        with pytest.raises(pickle.UnpicklingError, match="disallowed"):
            loads(data)
    with pytest.raises(pickle.UnpicklingError, match="disallowed"):
        legacy.depickle_legacy_unischema(data)


def test_a_pickle_of_another_type_is_refused():
    with pytest.raises(pickle.UnpicklingError, match="unexpected type"):
        legacy.depickle_legacy_unischema(pickle.dumps(OrderedDict(a=1), protocol=2))


# ----------------------------------------------------- migration and writing
def test_copy_dataset_migrates_the_fixture(tmp_path):
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    dst = f"file://{tmp_path}/migrated"
    assert copy_dataset(FIXTURE_URL, dst, rows_per_row_group=5, workers_count=1) == 20
    assert UNISCHEMA_KEY in DatasetContext(dst).key_value_metadata()
    original = _rows(make_reader, FIXTURE_URL, reader_pool_type="dummy")
    migrated = _rows(make_reader, dst, reader_pool_type="dummy")
    # The JPEG is encoded again, so only its shape survives; every lossless
    # field comes through equal.
    for got, want in zip(migrated, original):
        assert got.image_jpeg.shape == want.image_jpeg.shape == (24, 24, 3)
        for name in set(got._fields) - {"image_jpeg"}:
            a, b = getattr(got, name), getattr(want, name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
    _assert_rows_equal(_rows(jax_reader.make_reader, dst, reader_pool_type="dummy"), migrated)


@pytest.fixture(scope="module")
def linked_store(tmp_path_factory):
    """A 64x64 JPEG store written by the port, linked into petastorm's
    format: 40 rows, 5 groups of 8 in 3 files."""
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    tmp = tmp_path_factory.mktemp("linked")
    schema = Unischema("ImageNetLike", [
        UnischemaField("id", np.int64, (), tcodecs.ScalarCodec(np.int64), False),
        UnischemaField("image", np.uint8, (64, 64, 3), tcodecs.CompressedImageCodec("jpeg", 90),
                       False)])
    rng = np.random.default_rng(26)
    with materialize_dataset_local(f"file://{tmp}/src", schema, rows_per_row_group=8,
                                   rows_per_file=16) as w:
        for i in range(40):
            w.write_row({"id": i, "image": rng.integers(0, 255, (64, 64, 3), np.uint8)})
    files = sorted(glob.glob(f"{tmp}/src/*.parquet"))
    pickled = reference_unischema_pickle("ImageNetLike", image_store_fields((64, 64, 3), 90))
    link_reference_store(files, f"{tmp}/ref", pickled)
    return {"src": f"file://{tmp}/src", "ref": f"file://{tmp}/ref", "files": files,
            "pickled": pickled}


def test_linked_store_carries_only_petastorm_keys(linked_store):
    kv = DatasetContext(linked_store["ref"]).key_value_metadata()
    assert set(kv) == {b"dataset-toolkit.unischema.v1",
                       b"dataset-toolkit.num_row_groups_per_file.v1"}
    assert b"cpetastorm.unischema\nUnischema\n" in linked_store["pickled"]
    assert b"cpetastorm.codecs\nCompressedImageCodec\n" in linked_store["pickled"]
    assert b"cpyspark.sql.types\nLongType\n" in linked_store["pickled"]
    assert "petastorm" not in sys.modules and "pyspark.sql.types" not in sys.modules


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_linked_store_reads_equal_in_both_packages(linked_store, pool):
    got = _rows(make_reader, linked_store["ref"], reader_pool_type=pool, workers_count=2)
    want = _rows(jax_reader.make_reader, linked_store["ref"], reader_pool_type="dummy")
    same = _rows(make_reader, linked_store["src"], reader_pool_type="dummy")
    assert len(got) == 40
    _assert_rows_equal(got, want)
    _assert_rows_equal(got, same)


def test_linked_store_schema_reaches_spawned_workers_as_plain_classes(linked_store):
    """The depickled schema crosses the spawn boundary with no shim type."""
    with make_reader(linked_store["ref"], reader_pool_type="process", workers_count=2,
                     shuffle_row_groups=False) as r:
        schema = r.schema
        ids = sorted(int(s.id) for s in r)
    assert ids == list(range(40))
    assert type(schema.image.codec) is tcodecs.CompressedImageCodec
    assert b"_Legacy" not in pickle.dumps(schema)
