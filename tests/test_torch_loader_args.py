"""The loaders' ``pad_variable_length_to``, ``keep_host_fields`` and
``shuffle_fast_rng`` against the JAX loaders: the same reader settings give
the same batches, byte for byte, over rows, NGram windows and the lazy
plane's columns. The JAX reference is its loader's host batch after its
dtype sanitization (what it would stage), as in ``test_torch_loader.py``."""
import numpy as np
import pytest
import torch

from dataset_utils import create_test_dataset
from petastorm_tpu.jax.dtypes import sanitize_batch as jax_sanitize_batch
from petastorm_tpu.jax.loader import DataLoader as JaxDataLoader
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.reader_impl.shuffling_buffer import \
    RandomShufflingBuffer as JaxRandomShufflingBuffer
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.reader_impl.shuffling_buffer import RandomShufflingBuffer

FIELDS = ["id", "id2", "partition_key", "matrix_uint16", "varlen"]
WIDENED = {np.dtype(np.uint16): torch.int32}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('loader_args')}/ds"
    create_test_dataset(url, num_rows=50, rows_per_row_group=5)
    return url


def _port_batches(url, reader_kwargs, loader_kwargs):
    with make_reader(url, **reader_kwargs) as reader:
        return list(DataLoader(reader, device="cpu", **loader_kwargs))


def _jax_batches(url, reader_kwargs, loader_kwargs, ngram=None):
    """The JAX loader's staged columns: its host batches sanitized, the
    host-only columns kept or dropped by ``keep_host_fields``."""
    keep = loader_kwargs.get("keep_host_fields", True)
    if ngram is not None:
        reader_kwargs = dict(reader_kwargs, schema_fields=ngram)
    with jax_make_reader(url, **reader_kwargs) as reader:
        loader = JaxDataLoader(reader, **loader_kwargs)
        out = []
        for hb in loader._host_batches():
            device_cols, host_cols = jax_sanitize_batch(hb)
            out.append({**device_cols, **(host_cols if keep else {})})
        return out


def _same(port: dict, ref: dict):
    assert set(port) == set(ref)
    for name, want in ref.items():
        got = port[name]
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            if want.dtype in WIDENED:
                assert got.dtype == WIDENED[want.dtype]
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                got = got.numpy()
                assert got.dtype == want.dtype and got.shape == want.shape, name
                assert got.tobytes() == want.tobytes(), name
        else:
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _assert_equal_streams(port, ref):
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        _same(p, r)


READER = dict(reader_pool_type="dummy", shuffle_row_groups=False, schema_fields=FIELDS)


@pytest.mark.parametrize("pad", [3, 6, {"varlen": 4}], ids=["cut", "int", "dict"])
@pytest.mark.parametrize("materialization", ["eager", "lazy"])
def test_padded_rows_and_columns_equal_jax(store, pad, materialization):
    reader_kwargs = dict(READER, row_materialization=materialization)
    loader_kwargs = dict(batch_size=8, pad_variable_length_to=pad)
    port = _port_batches(store, reader_kwargs, loader_kwargs)
    _assert_equal_streams(port, _jax_batches(store, reader_kwargs, loader_kwargs))
    target = pad["varlen"] if isinstance(pad, dict) else pad
    first = port[0]
    assert first["varlen"].shape == (8, target) and first["varlen__len"].dtype == torch.int32
    ids = first["id"].numpy()
    np.testing.assert_array_equal(first["varlen__len"].numpy(), ids % 5 + 1)
    np.testing.assert_array_equal(first["varlen"][1, :min(target, int(ids[1]) % 5 + 1)].numpy(),
                                  np.arange(min(target, int(ids[1]) % 5 + 1)))


def test_without_padding_a_variable_field_stays_a_host_column(store):
    port = _port_batches(store, READER, dict(batch_size=8))
    _assert_equal_streams(port, _jax_batches(store, READER, dict(batch_size=8)))
    assert port[0]["varlen"].dtype == object and "varlen__len" not in port[0]


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("pad", [None, 5], ids=["host", "padded"])
def test_keep_host_fields(store, keep, pad):
    loader_kwargs = dict(batch_size=8, keep_host_fields=keep, pad_variable_length_to=pad)
    port = _port_batches(store, READER, loader_kwargs)
    _assert_equal_streams(port, _jax_batches(store, READER, loader_kwargs))
    host = {"partition_key"} | ({"varlen"} if pad is None else set())
    assert (host <= set(port[0])) is keep
    assert ("id" in port[0]) and (("varlen__len" in port[0]) is (pad is not None))


NGRAMS = {"homogeneous": {0: ["id", "varlen"], 1: ["id", "varlen"]},
          "heterogeneous": {0: ["id", "varlen"], 1: ["id"], 2: ["id", "varlen"]}}


@pytest.mark.parametrize("shape", sorted(NGRAMS))
@pytest.mark.parametrize("pad", [4, {"varlen": 2}], ids=["int", "dict"])
def test_padded_ngram_windows_equal_jax(store, shape, pad):
    spec = NGRAMS[shape]
    reader_kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=False)
    loader_kwargs = dict(batch_size=4, pad_variable_length_to=pad)
    with make_reader(store, schema_fields=NGram(spec, delta_threshold=1, timestamp_field="id"),
                     **reader_kwargs) as reader:
        port = list(DataLoader(reader, device="cpu", **loader_kwargs))
    ref = _jax_batches(store, reader_kwargs, loader_kwargs,
                       ngram=JaxNGram(spec, delta_threshold=1, timestamp_field="id"))
    _assert_equal_streams(port, ref)
    target = pad["varlen"] if isinstance(pad, dict) else pad
    key = "varlen" if shape == "homogeneous" else "varlen/0"
    assert port[0][key].shape[-1] == target and (key + "__len") in port[0]


def test_an_unpadded_variable_field_in_windows_raises_as_jax(store):
    ngram = NGram(NGRAMS["homogeneous"], delta_threshold=1, timestamp_field="id")
    with make_reader(store, schema_fields=ngram, reader_pool_type="dummy") as reader:
        with pytest.raises(ValueError, match="pad_variable_length_to"):
            list(DataLoader(reader, batch_size=4, device="cpu"))
    jngram = JaxNGram(NGRAMS["homogeneous"], delta_threshold=1, timestamp_field="id")
    with jax_make_reader(store, schema_fields=jngram, reader_pool_type="dummy") as reader:
        with pytest.raises(ValueError, match="pad_variable_length_to"):
            list(JaxDataLoader(reader, batch_size=4)._host_batches())


@pytest.mark.parametrize("fast", [True, False])
def test_shuffle_buffer_stream_equals_jax(store, fast):
    reader_kwargs = dict(reader_pool_type="dummy", seed=3, num_epochs=2, schema_fields=["id"])
    loader_kwargs = dict(batch_size=9, shuffling_queue_capacity=20, seed=11,
                         shuffle_fast_rng=fast, drop_last=False)
    port = _port_batches(store, reader_kwargs, loader_kwargs)
    _assert_equal_streams(port, _jax_batches(store, reader_kwargs, loader_kwargs))
    other = _port_batches(store, reader_kwargs, dict(loader_kwargs, shuffle_fast_rng=not fast))
    assert [b["id"].tolist() for b in port] != [b["id"].tolist() for b in other]


@pytest.mark.parametrize("batched_rng", [True, False])
@pytest.mark.parametrize("capacity,low,high", [(30, 5, 20), (7, 0, 3), (100, 40, 90)])
def test_buffer_draws_equal_jax(batched_rng, capacity, low, high):
    kw = dict(min_after_retrieve=low, extra_capacity=50, seed=42, batched_rng=batched_rng)
    bufs = [RandomShufflingBuffer(capacity, **kw), JaxRandomShufflingBuffer(capacity, **kw)]
    out = [[], []]
    for start in range(0, 200, 10):
        for b, o in zip(bufs, out):
            b.add_many(list(range(start, start + 10)))
            while b.size > high:
                o.append(b.retrieve())
    for b, o in zip(bufs, out):
        b.finish()
        while b.can_retrieve:
            o.append(b.retrieve())
    assert out[0] == out[1] and sorted(out[0]) == list(range(200))


def test_defaults_are_the_jax_loaders():
    import inspect
    port = inspect.signature(DataLoader).parameters
    jax = inspect.signature(JaxDataLoader).parameters
    assert port["shuffle_fast_rng"].default is jax["shuffle_fast_rng"].default is True
    from petastorm_tpu.jax.loader import LoaderBase as JaxLoaderBase
    from petastorm_tpu_torch.loader.loader import LoaderBase
    for name in ("pad_variable_length_to", "keep_host_fields"):
        assert inspect.signature(LoaderBase).parameters[name].default == \
            inspect.signature(JaxLoaderBase).parameters[name].default
        assert port[name].default == inspect.signature(JaxLoaderBase).parameters[name].default
