"""petastorm_tpu_torch.ngram and the NGram reader/loader path against the
JAX package.

Window assembly (``_window_starts``, ``form_ngram``, ``form_ngram_dense``,
``densify_windows``) on the same rows; token windows through ``make_reader``
+ ``DataLoader(device="cpu")`` against the JAX chain on stores from both
writers, dense and row windows, ordered and shuffled over two epochs: the
arrays must be identical. ``write_token_store`` writes the same rows as the
JAX package's.
"""
import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu.benchmark.llm_bench import write_token_store as jax_write_token_store
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.etl.writer import materialize_dataset_local as jax_materialize
from petastorm_tpu.jax.loader import DataLoader as JaxDataLoader
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import DataLoader, NGram, make_reader
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

# Timestamps with gaps of 2 and 5 and a repeated value.
_TS = np.array([0, 1, 2, 3, 5, 6, 7, 8, 9, 14, 15, 16, 16, 17, 18, 19, 20, 21], np.int64)


def _schemas():
    port = Unischema("W", [UnischemaField("ts", np.int64, (), ScalarCodec(np.int64), False),
                           UnischemaField("val", np.float32, (), ScalarCodec(np.float32), False),
                           UnischemaField("vec", np.float32, (2,), NdarrayCodec(), False)])
    jax = JaxUnischema("W", [JaxField("ts", np.int64, (), JaxScalarCodec(np.int64), False),
                             JaxField("val", np.float32, (), JaxScalarCodec(np.float32), False),
                             JaxField("vec", np.float32, (2,), JaxNdarrayCodec(), False)])
    return port, jax


def _rows():
    rng = np.random.default_rng(0)
    return [{"ts": t, "val": np.float32(rng.normal()),
             "vec": rng.normal(size=2).astype(np.float32)} for t in _TS]


def _both(fields, **kw):
    return NGram(fields, **kw), JaxNGram(fields, **kw)


@pytest.mark.parametrize("length", [1, 2, 3, 5])
@pytest.mark.parametrize("threshold", [1, 2, 10])
@pytest.mark.parametrize("overlap", [True, False])
def test_window_starts_match(length, threshold, overlap):
    fields = {o: ["ts"] for o in range(length)}
    port, jax = _both(fields, delta_threshold=threshold, timestamp_field="ts",
                      timestamp_overlap=overlap)
    assert port._window_starts(_TS) == jax._window_starts(_TS)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("fields", [
    {-1: ["ts", "val"], 0: ["ts", "val"], 1: ["ts", "val"]},
    {0: ["ts", "v.*"], 1: ["val"]},     # regex names, different fields per offset
], ids=["same_fields", "regex_mixed"])
def test_form_ngram_matches(fields, overlap):
    port_schema, jax_schema = _schemas()
    port, jax = _both(fields, delta_threshold=1, timestamp_field="ts", timestamp_overlap=overlap)
    port.resolve_regex_field_names(port_schema)
    jax.resolve_regex_field_names(jax_schema)
    assert port.get_field_names_at_all_timesteps() == jax.get_field_names_at_all_timesteps()
    got = port.form_ngram(_rows(), port_schema)
    want = jax.form_ngram(_rows(), jax_schema)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for off in g:
            assert g[off]._fields == w[off]._fields
            for name in g[off]._fields:
                np.testing.assert_array_equal(getattr(g[off], name), getattr(w[off], name))


def test_dense_assembly_equals_densified_rows_and_jax():
    port_schema, jax_schema = _schemas()
    fields = {o: ["ts", "val", "vec"] for o in range(3)}
    port, jax = _both(fields, delta_threshold=1, timestamp_field="ts", dense=True)
    port.resolve_regex_field_names(port_schema)
    jax.resolve_regex_field_names(jax_schema)
    rows = _rows()
    cols = {n: np.stack([r[n] for r in rows]) for n in ("ts", "val", "vec")}
    order = np.random.default_rng(1).permutation(len(rows))
    shuffled = {n: c[order] for n, c in cols.items()}
    unshuffle = np.argsort(shuffled["ts"], kind="stable")
    dense = port.form_ngram_dense(shuffled, unshuffle)
    # the rows in the same order (two rows share a timestamp)
    sorted_rows = [rows[order[i]] for i in unshuffle]
    densified = port.densify_windows(port.form_ngram(sorted_rows, port_schema))
    want = jax.form_ngram_dense(shuffled, unshuffle)
    assert len(dense) == len(densified) == len(want) > 0
    for a, b, c in zip(dense, densified, want):
        for name in ("ts", "val", "vec"):
            assert a[name].shape[0] == 3
            np.testing.assert_array_equal(a[name], b[name])
            np.testing.assert_array_equal(a[name], c[name])
            assert a[name].base is None   # copied out of the row group


def test_dense_requires_one_field_set():
    with pytest.raises(ValueError, match="same field set"):
        NGram({0: ["ts", "val"], 1: ["ts"]}, delta_threshold=1, timestamp_field="ts", dense=True)
    with pytest.raises(ValueError, match="consecutive"):
        NGram({0: ["ts"], 2: ["ts"]}, delta_threshold=1, timestamp_field="ts")


# ----------------------------------------------------------- reader + loader
WINDOW, WINDOWS = 16, 6


@pytest.fixture(scope="module", params=["jax_writer", "port_writer"])
def token_store(request, tmp_path_factory):
    """A token store with an extra fixed-shape ndarray column (decoded
    column-major on the dense path) and a time gap inside one row group."""
    url = f"file://{tmp_path_factory.mktemp('tokens')}/ds"
    rng = np.random.default_rng(5)
    if request.param == "jax_writer":
        schema = JaxUnischema("Tok", [
            JaxField("ts", np.int64, (), JaxScalarCodec(np.int64), False),
            JaxField("token", np.int32, (), JaxScalarCodec(np.int32), False),
            JaxField("emb", np.float32, (3,), JaxNdarrayCodec(), False)])
        writer = jax_materialize
    else:
        schema = Unischema("Tok", [
            UnischemaField("ts", np.int64, (), ScalarCodec(np.int64), False),
            UnischemaField("token", np.int32, (), ScalarCodec(np.int32), False),
            UnischemaField("emb", np.float32, (3,), NdarrayCodec(), False)])
        writer = materialize_dataset_local
    with writer(url, schema, rows_per_row_group=WINDOW) as w:
        for i in range(WINDOW * WINDOWS):
            w.write_row({"ts": np.int64(i + (3 if i % (3 * WINDOW) > WINDOW // 2 else 0)),
                         "token": np.int32(rng.integers(0, 1000)),
                         "emb": rng.normal(size=3).astype(np.float32)})
    return url


def _ngrams(dense, fields, length, overlap):
    spec = {o: list(fields) for o in range(length)}
    kw = dict(delta_threshold=1, timestamp_field="ts", timestamp_overlap=overlap, dense=dense)
    return NGram(spec, **kw), JaxNGram(spec, **kw)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "rows"])
@pytest.mark.parametrize("reader_kwargs,loader_kwargs", [
    (dict(reader_pool_type="dummy", shuffle_row_groups=False), {}),
    (dict(reader_pool_type="thread", workers_count=2, seed=9, shuffle_rows=True, num_epochs=2),
     dict(shuffling_queue_capacity=5, seed=4)),
], ids=["ordered", "shuffled_two_epochs"])
def test_token_windows_match_jax_chain(token_store, dense, reader_kwargs, loader_kwargs):
    port_ng, jax_ng = _ngrams(dense, ["ts", "token", "e.*"], length=4, overlap=False)
    with make_reader(token_store, schema_fields=port_ng, **reader_kwargs) as reader:
        port = list(DataLoader(reader, batch_size=3, device="cpu", **loader_kwargs))
    with jax_make_reader(token_store, schema_fields=jax_ng, **reader_kwargs) as reader:
        ref = list(JaxDataLoader(reader, batch_size=3, **loader_kwargs))
    assert len(port) == len(ref) > 0
    for got, want in zip(port, ref):
        assert sorted(got) == sorted(want) == ["emb", "token", "ts"]
        assert got["token"].shape == (3, 4) and str(got["token"].dtype) == "torch.int32"
        assert got["emb"].shape == (3, 4, 3)
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_row_windows_with_different_fields_per_offset(token_store):
    spec = {0: ["ts", "token"], 1: ["token"], 2: ["ts", "emb"]}
    kw = dict(delta_threshold=1, timestamp_field="ts", timestamp_overlap=True)
    with make_reader(token_store, schema_fields=NGram(spec, **kw), reader_pool_type="dummy",
                     shuffle_row_groups=False) as reader:
        port = list(DataLoader(reader, batch_size=4, device="cpu"))
    with jax_make_reader(token_store, schema_fields=JaxNGram(spec, **kw),
                         reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        ref = list(JaxDataLoader(reader, batch_size=4))
    assert len(port) == len(ref) > 0
    for got, want in zip(port, ref):
        assert sorted(got) == sorted(want) == ["emb/2", "token/0", "token/1", "ts/0", "ts/2"]
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_write_token_store_matches_jax(tmp_path):
    port_url, jax_url = f"file://{tmp_path}/port", f"file://{tmp_path}/jax"
    write_token_store(port_url, windows=3, window=40, vocab=500, seed=2)
    jax_write_token_store(jax_url, windows=3, window=40, vocab=500, seed=2)
    port_files = sorted(p.name for p in (tmp_path / "port").glob("*.parquet"))
    jax_files = sorted(p.name for p in (tmp_path / "jax").glob("*.parquet"))
    assert port_files == jax_files
    for name in port_files:
        a, b = pq.ParquetFile(tmp_path / "port" / name), pq.ParquetFile(tmp_path / "jax" / name)
        assert a.metadata.num_row_groups == b.metadata.num_row_groups == 3
        for g in range(3):
            assert a.read_row_group(g).equals(b.read_row_group(g))
