"""petastorm_tpu_torch.loader.DeviceCachedDataset against the JAX package's
``jax/device_cache.py`` (``device="cpu"`` here; the ``cuda``-marked case in
``tests/test_torch_cuda.py`` runs an epoch on the card).

With ``shuffle=False`` the batches equal the JAX cache's bit for bit. A
shuffled epoch's order comes from a ``torch.Generator``, which cannot match
``jax.random``, so it is held to the semantics of
``tests/test_device_cache.py:21-77`` instead (its sharded case is not
ported). JAX runs without x64 here, so its cache holds the int64 ``id``
column as int32; the values are compared, and the port keeps int64 (the
dtype its loaders deliver)."""
import numpy as np
import pytest
import torch

from petastorm_tpu.jax import DeviceCachedDataset as JaxDeviceCachedDataset
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.loader import DeviceCachedDataset
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

READ = dict(schema_fields=["id", "matrix"], shuffle_row_groups=False,
            reader_pool_type="dummy", num_epochs=1)


@pytest.fixture(scope="module")
def cache(request):
    synthetic = request.getfixturevalue("synthetic_dataset")
    with make_reader(synthetic.url, **READ) as reader:
        return DeviceCachedDataset(reader, device="cpu")


@pytest.fixture(scope="module")
def jax_cache(request):
    synthetic = request.getfixturevalue("synthetic_dataset")
    with jax_make_reader(synthetic.url, **READ) as reader:
        return JaxDeviceCachedDataset(reader)


@pytest.mark.parametrize("batch_size,drop_last", [(10, True), (30, True), (30, False),
                                                  (100, True)])
def test_unshuffled_batches_equal_the_jax_caches(cache, jax_cache, batch_size, drop_last):
    got = list(cache.batches(batch_size, num_epochs=2, shuffle=False, drop_last=drop_last))
    want = list(jax_cache.batches(batch_size, num_epochs=2, shuffle=False,
                                  drop_last=drop_last))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["id"].dtype == torch.int64 and g["matrix"].dtype == torch.float32
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_columns_rows_and_bytes_equal_the_jax_caches(cache, jax_cache):
    assert cache.columns == jax_cache.columns == ["id", "matrix"]
    assert cache.num_rows == jax_cache.num_rows == 100
    assert cache.nbytes() == jax_cache.nbytes() + 100 * 4   # id: int64 against int32


def test_all_rows_served_each_epoch(cache):
    assert cache.num_rows == 100
    for seed in (1, 2):
        ids = torch.cat([b["id"] for b in cache.batches(20, num_epochs=1, seed=seed)])
        assert sorted(ids.tolist()) == list(range(100))


def test_batches_live_on_the_cache_device(cache):
    batch = next(cache.batches(10))
    assert isinstance(batch["id"], torch.Tensor) and batch["id"].device.type == "cpu"
    assert batch["matrix"].shape == (10, 32, 16, 3)


def test_seeded_determinism_and_epoch_reshuffle(cache):
    a = [b["id"] for b in cache.batches(25, num_epochs=2, seed=7)]
    b = [x["id"] for x in cache.batches(25, num_epochs=2, seed=7)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    epoch1, epoch2 = torch.cat(a[:4]), torch.cat(a[4:])
    assert sorted(epoch1.tolist()) == sorted(epoch2.tolist())
    assert not torch.equal(epoch1, epoch2)
    other = torch.cat([x["id"] for x in cache.batches(25, num_epochs=1, seed=8)])
    assert not torch.equal(epoch1, other)


def test_gathered_rows_are_the_cached_rows(cache):
    """A gathered batch is byte-equal to the cache's rows at its ids."""
    batch = next(cache.batches(16, seed=3))
    rows = batch["id"]
    assert torch.equal(batch["matrix"], cache._data["matrix"][rows])


def test_no_shuffle_is_sequential(cache):
    ids = torch.cat([b["id"] for b in cache.batches(50, shuffle=False)])
    assert torch.equal(ids, torch.arange(100, dtype=ids.dtype))


def test_drop_last_false_ragged_tail(cache):
    batches = list(cache.batches(30, drop_last=False, shuffle=False))
    assert [len(b["id"]) for b in batches] == [30, 30, 30, 10]
    shuffled = list(cache.batches(30, drop_last=False, seed=1))
    assert sorted(torch.cat([b["id"] for b in shuffled]).tolist()) == list(range(100))


def test_batch_too_large_raises(cache):
    with pytest.raises(ValueError, match="exceeds"):
        next(cache.batches(101))


def test_from_batch_reader(scalar_dataset):
    kw = dict(schema_fields=["id", "int_col", "string_col"], shuffle_row_groups=False,
              reader_pool_type="dummy")
    with make_batch_reader(scalar_dataset.url, **kw) as reader:
        with pytest.warns(UserWarning, match="string_col"):
            cache = DeviceCachedDataset(reader, device="cpu")
    with jax_make_batch_reader(scalar_dataset.url, **kw) as reader:
        with pytest.warns(UserWarning, match="string_col"):
            jax_cache = JaxDeviceCachedDataset(reader)
    assert "string_col" not in cache.columns
    assert cache.columns == jax_cache.columns
    assert cache.num_rows == 100
    assert cache.nbytes() > 0
    got = next(cache.batches(100, shuffle=False))
    want = next(jax_cache.batches(100, shuffle=False))
    np.testing.assert_array_equal(got["int_col"].numpy(), np.asarray(want["int_col"]))


def test_no_device_representable_column_raises(scalar_dataset):
    with make_batch_reader(scalar_dataset.url, schema_fields=["string_col"],
                           shuffle_row_groups=False, reader_pool_type="dummy") as reader:
        with pytest.warns(UserWarning), pytest.raises(ValueError,
                                                      match="device-representable|batchable"):
            DeviceCachedDataset(reader, device="cpu")
