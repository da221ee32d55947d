"""Decode fast paths and small public API of petastorm_tpu_torch against the
JAX package:

* ``utils.decode.batch_decode_ndarrays``/``batch_decode_scalars`` and the
  codecs' cached-header ``.npy``/``.npz`` decodes equal the JAX functions
  and per-cell ``np.load``, with ``None`` cells, 0-d, Fortran-order,
  heterogeneous, compressed and corrupt cells (exact: decoding is bit
  for bit);
* ``codecs.register_codec``: a store naming a user codec reads in both
  packages, and the codec sees bytes;
* ``Reader.next`` and ``NGram.make_namedtuple`` behave as the JAX ones;
* ``storage_options=`` and ``filesystem=`` reach the store through the
  readers, the writer, ``aligned_steps_per_epoch``,
  ``get_schema_from_dataset_url`` and ``dataset_as_rdd``, and a
  ``memory://`` store reads as the JAX readers read it.
"""
import io
import warnings

import fsspec
import numpy as np
import pyarrow as pa
import pytest
from fsspec.implementations.memory import MemoryFileSystem

import petastorm_tpu.codecs as jcodecs
import petastorm_tpu.utils.decode as jdecode
import petastorm_tpu_torch.codecs as codecs
import petastorm_tpu_torch.utils.decode as decode
from petastorm_tpu.etl.writer import materialize_dataset_local as jax_materialize
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.loader import aligned_steps_per_epoch
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.reader_impl.row_reader_worker import _decode_column
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue()


def _npz(a) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, arr=a)
    return buf.getvalue()


def _arrow_views(cells):
    """The cells as the zero-copy read path hands them out: memoryviews
    into one Arrow binary buffer (signed format)."""
    arr = pa.array(cells, pa.binary())
    offs = np.frombuffer(arr.buffers()[1], np.int32, count=len(cells) + 1)
    mv = memoryview(arr.buffers()[2]).cast("b")
    return [mv[offs[i]:offs[i + 1]] for i in range(len(cells))], arr


def _columns(seed: int):
    """name -> (field shape, dtype, cells): homogeneous columns, a 0-d one,
    Fortran-order, heterogeneous shapes and one with a None cell."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, dtype in (("f32", (4, 3), np.float32), ("i64", (5,), np.int64),
                               ("u8", (2, 2, 3), np.uint8), ("f16", (7,), np.float16),
                               ("zero_d", (), np.float64)):
        vals = [rng.integers(0, 200, shape).astype(dtype) for _ in range(9)]
        out[name] = (shape, dtype, [_npy(v) for v in vals])
    out["fortran"] = ((3, 4), np.float32, [_npy(np.asfortranarray(
        rng.normal(size=(3, 4)).astype(np.float32))) for _ in range(6)])
    out["ragged"] = ((None,), np.int32, [_npy(np.arange(i, dtype=np.int32))
                                        for i in range(1, 7)])
    with_none = [_npy(rng.normal(size=(2,)).astype(np.float32)) for _ in range(5)]
    with_none[2] = None
    out["with_none"] = ((2,), np.float32, with_none)
    return out


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("views", [False, True], ids=["bytes", "arrow_views"])
def test_batch_decode_ndarrays_equals_the_jax_function_and_np_load(seed, views):
    for name, (shape, dtype, cells) in _columns(seed).items():
        field = UnischemaField(name, dtype, shape, codecs.NdarrayCodec(), True)
        jfield = JaxField(name, dtype, shape, jcodecs.NdarrayCodec(), True)
        src, _keep = _arrow_views(cells) if views and None not in cells else (cells, None)
        for indices in (np.arange(len(cells)), np.arange(len(cells))[::-2], np.array([1])):
            got = decode.batch_decode_ndarrays(field, field.codec, src, indices)
            want = jdecode.batch_decode_ndarrays(jfield, jfield.codec, src, indices)
            assert _same(got, want), (name, indices)
            applies = name not in ("fortran", "ragged", "with_none") and len(indices) > 1
            assert (got is not None) == applies, name
            per_cell = [None if cells[i] is None else np.load(io.BytesIO(cells[i]))
                        for i in indices]
            if got is not None:
                assert _same(list(got), per_cell)
            # The worker's decode of the column: the batch or the per-cell path.
            column = _decode_column(field, field.codec, src, indices)
            assert _same(list(column), per_cell), name


def test_batch_decode_ndarrays_refuses_other_codecs_and_short_columns():
    cells = [_npy(np.ones(3, np.float32))] * 4
    field = UnischemaField("x", np.float32, (3,), codecs.CompressedNdarrayCodec(), False)
    assert decode.batch_decode_ndarrays(field, field.codec, cells, [0, 1]) is None

    class Sub(codecs.NdarrayCodec):
        pass
    assert decode.batch_decode_ndarrays(field, Sub(), cells, [0, 1]) is None
    assert decode.batch_decode_ndarrays(field, codecs.NdarrayCodec(), [b"junk"] * 2, [0, 1]) \
        is None is jdecode.batch_decode_ndarrays(field, jcodecs.NdarrayCodec(), [b"junk"] * 2,
                                                 [0, 1])


@pytest.mark.parametrize("dtype,src", [
    (np.int32, np.arange(10, dtype=np.int64)), (np.float64, np.linspace(0, 1, 10)),
    (np.uint8, np.arange(10, dtype=np.int16)), (np.int64, np.arange(10.0)),
    (np.bool_, np.arange(10) % 2), (np.str_, np.arange(10)),
    (np.int32, [1, None, 3, 4, 5, 6, 7, 8, 9, 10])])
def test_batch_decode_scalars_equals_the_jax_function(dtype, src):
    field = UnischemaField("s", dtype, (), codecs.ScalarCodec(dtype), True)
    jfield = JaxField("s", dtype, (), jcodecs.ScalarCodec(dtype), True)
    indices = [9, 0, 3, 3]
    got = decode.batch_decode_scalars(field, field.codec, src, indices)
    want = jdecode.batch_decode_scalars(jfield, jfield.codec, src, indices)
    assert _same(got, want)
    if got is not None:
        assert _same(list(got), [field.codec.decode(field, src[i]) for i in indices])
    assert _same(list(_decode_column(field, field.codec, src, indices)),
                 [None if src[i] is None else field.codec.decode(field, src[i])
                  for i in indices])


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_decodes_equal_the_jax_codecs_and_np_load(seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(3, 5)).astype(np.float32), np.array(7, np.int16),
              rng.integers(0, 9, (2, 0, 3)).astype(np.uint8),
              np.asfortranarray(rng.normal(size=(4, 2))), np.array(["ab", "c"])]
    for a in arrays:
        for encode, ours, theirs in ((_npy, codecs.NdarrayCodec(), jcodecs.NdarrayCodec()),
                                     (_npz, codecs.CompressedNdarrayCodec(),
                                      jcodecs.CompressedNdarrayCodec())):
            blob = encode(a)
            want = np.load(io.BytesIO(blob))
            want = want["arr"] if isinstance(want, np.lib.npyio.NpzFile) else want
            for cell in (blob, memoryview(blob), _arrow_views([blob])[0][0]):
                got = ours.decode(None, cell)
                assert _same(got, want) and _same(got, theirs.decode(None, cell))
                assert got.flags.writeable
        assert codecs.npy_header_meta(_npy(a)) == jcodecs.npy_header_meta(_npy(a))
    assert codecs.npy_header_meta(b"not npy") is None is jcodecs.npy_header_meta(b"not npy")


def test_corrupt_compressed_cells_raise_in_both_packages():
    blob = bytearray(_npz(np.arange(100, dtype=np.float32)))
    blob[len(blob) // 2] ^= 0xFF
    for codec in (codecs.CompressedNdarrayCodec(), jcodecs.CompressedNdarrayCodec()):
        with pytest.raises(Exception) as err:
            codec.decode(None, bytes(blob))
        assert not isinstance(err.value, AssertionError)
    truncated = _npz(np.arange(100, dtype=np.float32))[:60]
    assert codecs._fast_npz_decode(truncated) is None is jcodecs._fast_npz_decode(truncated)


def _tagged_codec(base, register):
    """A user codec (the same class name in both packages) that must see
    bytes."""
    class TaggedBlobCodec(base):
        def encode(self, field, value):
            return b"TAG" + value

        def decode(self, field, encoded):
            assert isinstance(encoded, bytes), type(encoded)
            return encoded[3:]

        def arrow_type(self, field):
            return pa.binary()

        def to_dict(self):
            return {"type": "TaggedBlobCodec"}

        @classmethod
        def from_dict(cls, doc):
            return cls()
    return register(TaggedBlobCodec)


def test_a_registered_user_codec_reads_in_both_packages(tmp_path):
    ours = _tagged_codec(codecs.DataframeColumnCodec, codecs.register_codec)
    theirs = _tagged_codec(jcodecs.DataframeColumnCodec, jcodecs.register_codec)
    assert codecs.codec_from_dict({"type": "TaggedBlobCodec"}).__class__ is ours
    schema = JaxUnischema("B", [JaxField("id", np.int64, (), jcodecs.ScalarCodec(np.int64), False),
                                JaxField("blob", bytes, (), theirs(), False)])
    url = f"file://{tmp_path}/ds"
    with jax_materialize(url, schema, rows_per_row_group=5) as w:
        w.write_rows([{"id": i, "blob": bytes([i, i])} for i in range(20)])
    with jax_make_reader(url, shuffle_row_groups=False, reader_pool_type="dummy",
                         rowgroup_pruning=False) as j:
        want = [(r.id, r.blob) for r in j]
    for pool in ("dummy", "thread"):
        with make_reader(url, shuffle_row_groups=False, reader_pool_type=pool,
                         workers_count=2) as r:
            got = sorted((row.id, row.blob) for row in r)
        assert got == want == [(i, bytes([i, i])) for i in range(20)]
    with pytest.raises(ValueError, match="register it with register_codec"):
        codecs.codec_from_dict({"type": "NotRegisteredCodec"})


def test_reader_next_and_ngram_make_namedtuple_behave_as_the_jax_ones(synthetic_dataset):
    kw = dict(schema_fields=["id", "id2"], reader_pool_type="dummy", shuffle_row_groups=False)
    with make_reader(synthetic_dataset.url, **kw) as r, \
            jax_make_reader(synthetic_dataset.url, rowgroup_pruning=False, **kw) as j:
        for _ in range(100):
            a, b = r.next(), j.next()
            assert (a.id, a.id2) == (b.id, b.id2)
        for reader in (r, j):
            with pytest.raises(StopIteration):
                reader.next()
    fields = {0: ["id", "id2"], 1: ["id"]}
    ngram = NGram(fields, delta_threshold=1, timestamp_field="id")
    jngram = JaxNGram(fields, delta_threshold=1, timestamp_field="id")
    kw = dict(schema_fields=ngram, reader_pool_type="dummy", shuffle_row_groups=False)
    with make_reader(synthetic_dataset.url, **kw) as r, \
            jax_make_reader(synthetic_dataset.url, rowgroup_pruning=False,
                            **{**kw, "schema_fields": jngram}) as j:
        window, jwindow = r.next(), j.next()
        assert ngram.make_namedtuple(r.schema, window) is window
        assert jngram.make_namedtuple(j.schema, jwindow) is jwindow
        assert {o: tuple(v) for o, v in window.items()} == \
            {o: tuple(v) for o, v in jwindow.items()}


class _Guarded(MemoryFileSystem):
    """An in-memory filesystem that opens only with ``token="s3cret"``: a
    store behind it reads only where ``storage_options`` reach it."""
    protocol = ("pttguard",)

    @classmethod
    def _strip_protocol(cls, path):
        return MemoryFileSystem._strip_protocol(path.removeprefix("pttguard://"))

    def __init__(self, token=None, **kw):
        if token != "s3cret":
            raise PermissionError("storage_options did not reach the filesystem")
        super().__init__(**kw)


_SCHEMA = Unischema("S", [UnischemaField("id", np.int64, (), codecs.ScalarCodec(np.int64), False),
                          UnischemaField("m", np.float32, (2, 3), codecs.NdarrayCodec(), False)])
_OPTS = {"token": "s3cret"}


@pytest.fixture()
def guarded_store():
    fsspec.register_implementation("pttguard", _Guarded, clobber=True)
    url = "pttguard://guarded/ds"
    with materialize_dataset_local(url, _SCHEMA, rows_per_row_group=5, storage_options=_OPTS) as w:
        w.write_rows([{"id": i, "m": np.full((2, 3), i, np.float32)} for i in range(20)])
    yield url
    _Guarded(**_OPTS).rm("/guarded", recursive=True)


def _ids(reader):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if reader.batched_output:
            return [int(i) for batch in reader for i in batch.id]
        return [int(row.id) for row in reader]


@pytest.mark.parametrize("pool", ["thread", "dummy"])
@pytest.mark.parametrize("how", ["storage_options", "filesystem"])
def test_storage_options_and_filesystem_reach_the_store(guarded_store, pool, how):
    arg = ({"storage_options": _OPTS} if how == "storage_options"
           else {"filesystem": _Guarded(**_OPTS)})
    kw = dict(reader_pool_type=pool, workers_count=2, shuffle_row_groups=False, **arg)
    with make_reader(guarded_store, **kw) as r:
        rows = _ids(r)
    with make_batch_reader(guarded_store, **kw) as r:
        batch_rows = _ids(r)
    with jax_make_reader(guarded_store, rowgroup_pruning=False, **kw) as j:
        want = _ids(j)
    with jax_make_batch_reader(guarded_store, rowgroup_pruning=False, **kw) as j:
        batch_want = _ids(j)
    assert rows == want == batch_rows == batch_want == list(range(20))
    assert aligned_steps_per_epoch(guarded_store, 3, shard_count=2, **arg) == 3
    assert list(get_schema_from_dataset_url(guarded_store, **arg).fields) == ["id", "m"]


def test_without_the_options_the_guarded_store_is_refused(guarded_store):
    for call in (lambda: make_reader(guarded_store),
                 lambda: get_schema_from_dataset_url(guarded_store),
                 lambda: aligned_steps_per_epoch(guarded_store, 3),
                 lambda: materialize_dataset_local(guarded_store + "2", _SCHEMA).__enter__()):
        with pytest.raises(PermissionError):
            call()


def test_a_memory_store_reads_as_the_jax_readers_read_it():
    url = "memory://torch_decode_api/ds"
    try:
        with materialize_dataset_local(url, _SCHEMA, rows_per_row_group=4,
                                       filesystem=MemoryFileSystem()) as w:
            w.write_rows([{"id": i, "m": np.full((2, 3), i, np.float32)} for i in range(12)])
        for arg in ({"filesystem": MemoryFileSystem()}, {"storage_options": {}}):
            kw = dict(shuffle_row_groups=False, reader_pool_type="dummy", **arg)
            with make_reader(url, **kw) as r, \
                    jax_make_reader(url, rowgroup_pruning=False, **kw) as j:
                got, want = list(r), list(j)
            assert [int(x.id) for x in got] == [int(x.id) for x in want] == list(range(12))
            assert all(np.array_equal(a.m, b.m) for a, b in zip(got, want))
    finally:
        MemoryFileSystem().rm("/torch_decode_api", recursive=True)


def test_dataset_as_rdd_passes_the_options(monkeypatch):
    """The schema is read through the options; Spark reads the files."""
    from petastorm_tpu_torch.spark import spark_utils
    seen = {}

    def fake_schema(url, storage_options=None, filesystem=None):
        seen.update(url=url, storage_options=storage_options, filesystem=filesystem)
        raise RuntimeError("stop here")
    monkeypatch.setattr(spark_utils, "get_schema_from_dataset_url", fake_schema)
    fs = MemoryFileSystem()
    with pytest.raises(RuntimeError, match="stop here"):
        spark_utils.dataset_as_rdd("memory://x", None, storage_options=_OPTS, filesystem=fs)
    assert seen == {"url": "memory://x", "storage_options": _OPTS, "filesystem": fs}
