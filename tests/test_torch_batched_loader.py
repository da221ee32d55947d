"""petastorm_tpu_torch's batched loaders against the JAX package's, on the
same seeded stores and reader settings (the dummy pool): ``BatchedDataLoader``
plain and shuffled, ``InMemBatchedDataLoader``, the ``drop_last`` and
``pad_last`` tails, ``steps_per_epoch`` and ``aligned_steps_per_epoch``,
and the scalar bench. Batch for batch and bit for bit, on ``device="cpu"``.

The reference is the JAX loader's host batch after the JAX package's dtype
sanitization, before ``device_put`` (JAX without x64 would narrow 64-bit
columns on the device, which says nothing about the loader)."""
import itertools
import warnings

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu.benchmark.scalar_bench import generate_scalar_dataset as jax_generate_scalar
from petastorm_tpu.jax.dtypes import sanitize_batch as jax_sanitize_batch
from petastorm_tpu.jax.loader import BatchedDataLoader as JaxBatchedDataLoader
from petastorm_tpu.jax.loader import InMemBatchedDataLoader as JaxInMemBatchedDataLoader
from petastorm_tpu.jax.loader import aligned_steps_per_epoch as jax_aligned_steps_per_epoch
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu_torch.benchmark.scalar_bench import (batched_loader_throughput,
                                                        generate_scalar_dataset)
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.loader import (BatchedDataLoader, DataLoader, InMemBatchedDataLoader,
                                        aligned_steps_per_epoch)
from petastorm_tpu_torch.loader.batched_buffer import (BatchedNoopShufflingBuffer,
                                                       BatchedRandomShufflingBuffer)
from petastorm_tpu_torch.reader import make_batch_reader
from torch_columnar_stores import assert_same_columns, write_stores

LOADERS = {
    "plain": dict(batch_size=64),
    "shuffled 8192": dict(batch_size=64, shuffling_queue_capacity=8192, seed=0),
    "shuffled streaming": dict(batch_size=32, shuffling_queue_capacity=200,
                               min_after_retrieve=50, seed=0),
    "keep tail": dict(batch_size=48, drop_last=False),
    "pad tail": dict(batch_size=48, pad_last=True),
}
READERS = {"file order": dict(shuffle_row_groups=False),
           "seeded shuffle": dict(seed=4, shuffle_rows=True)}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("batched")
    out = write_stores(root)
    out["big_scalar"] = generate_scalar_dataset(f"file://{root}/big_scalar", rows=20_000)
    return out


def _numpy(batch: dict) -> dict:
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def _port(loader_cls, url, reader_kwargs, loader_kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_batch_reader(url, reader_pool_type="dummy", **reader_kwargs) as reader:
            loader = loader_cls(reader, device="cpu", **loader_kwargs)
            for batch in loader:
                assert all(v.device.type == "cpu" for v in batch.values()
                           if isinstance(v, torch.Tensor))
                yield _numpy(batch)


def _jax(loader_cls, url, reader_kwargs, loader_kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_make_batch_reader(url, reader_pool_type="dummy", **reader_kwargs) as reader:
            for hb in loader_cls(reader, **loader_kwargs)._host_batches():
                device_cols, host_cols = jax_sanitize_batch(hb)
                yield {**device_cols, **host_cols}


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_same_columns(dict(sorted(g.items())), dict(sorted(w.items())))


@pytest.mark.parametrize("reader", list(READERS))
@pytest.mark.parametrize("loader", list(LOADERS))
@pytest.mark.parametrize("store", ["scalar", "tensor", "lists", "nulls", "four_files"])
def test_batched_loader_equals_the_jax_loader(stores, store, loader, reader):
    _assert_same_batches(
        _port(BatchedDataLoader, stores[store], READERS[reader], LOADERS[loader]),
        _jax(JaxBatchedDataLoader, stores[store], READERS[reader], LOADERS[loader]))


@pytest.mark.parametrize("min_after", [None, 1024])
def test_shuffled_loader_streams_through_its_buffer_as_the_jax_loader(stores, min_after):
    """The JAX breakdown run's settings (batch 1024, capacity 8192, seed 0)
    on a store larger than the buffer: retrieval runs while groups are
    still added."""
    kwargs = dict(batch_size=1024, shuffling_queue_capacity=8192, seed=0,
                  min_after_retrieve=min_after)
    reader_kwargs = dict(seed=8)
    _assert_same_batches(_port(BatchedDataLoader, stores["big_scalar"], reader_kwargs, kwargs),
                         _jax(JaxBatchedDataLoader, stores["big_scalar"], reader_kwargs, kwargs))


@pytest.mark.parametrize("kwargs", [dict(seed=3), dict(seed=3, num_epochs=3),
                                    dict(shuffle=False, num_epochs=2),
                                    dict(seed=1, drop_last=False), dict(seed=1, pad_last=True)],
                         ids=["shuffled", "three epochs", "in order", "keep tail", "pad tail"])
@pytest.mark.parametrize("store", ["scalar", "tensor", "lists", "nulls"])
def test_in_memory_loader_equals_the_jax_loader(stores, store, kwargs):
    kwargs = dict(batch_size=40, **kwargs)
    reader_kwargs = dict(shuffle_row_groups=False)
    _assert_same_batches(_port(InMemBatchedDataLoader, stores[store], reader_kwargs, kwargs),
                         _jax(JaxInMemBatchedDataLoader, stores[store], reader_kwargs, kwargs))


def test_tails(stores):
    """700 rows in batches of 48: 14 full batches, then 28 rows dropped,
    kept, or padded with a ``__valid__`` mask."""
    def batches(**kwargs):
        return list(_port(BatchedDataLoader, stores["scalar"], READERS["file order"],
                          dict(batch_size=48, **kwargs)))
    assert [len(b["f0"]) for b in batches()] == [48] * 14
    assert [len(b["f0"]) for b in batches(drop_last=False)] == [48] * 14 + [28]
    padded = batches(pad_last=True)
    assert [len(b["f0"]) for b in padded] == [48] * 15
    assert "__valid__" not in padded[0]
    assert padded[-1]["__valid__"].tolist() == [True] * 28 + [False] * 20
    assert not padded[-1]["i0"][28:].any()


def test_object_columns_keep_their_first_decision(stores):
    """The lists store: ``uniform`` densifies, ``ragged`` is dropped with
    one warning; the decision holds for the stream."""
    with make_batch_reader(stores["lists"], reader_pool_type="dummy",
                           shuffle_row_groups=False) as reader:
        loader = BatchedDataLoader(reader, batch_size=16, device="cpu")
        with pytest.warns(UserWarning, match="ragged"):
            batches = list(loader)
    assert all(set(b) == {"id", "declared_f32", "declared_i64", "gaps", "uniform"}
               for b in batches)
    assert batches[0]["uniform"].shape == (16, 4) and batches[0]["uniform"].dtype == torch.float64
    assert torch.isnan(torch.cat([b["declared_f32"] for b in batches])).any()
    assert loader._object_column_mode["ragged"] == "drop"


def test_object_column_that_changes_form_raises():
    loader = BatchedDataLoader(type("R", (), {"batched_output": True})(), 4, device="cpu")
    first = np.empty(2, object)
    first[0], first[1] = np.ones(3), np.zeros(3)
    assert loader._batchable_columns({"v": first})["v"].shape == (2, 3)
    nulls = np.empty(2, object)
    nulls[0] = np.ones(3)
    assert np.isnan(loader._batchable_columns({"v": nulls})["v"][1]).all()
    ragged = np.empty(2, object)
    ragged[0], ragged[1] = np.ones(3), np.ones(4)
    with pytest.raises(ValueError, match="'v' batched as shape"):
        loader._batchable_columns({"v": ragged})


def test_batched_loader_refuses_a_row_reader():
    with pytest.raises(TypeError, match="make_batch_reader"):
        BatchedDataLoader(type("R", (), {"batched_output": False})(), 4, device="cpu")


@pytest.mark.parametrize("loader_kwargs", [dict(), dict(shuffling_queue_capacity=300, seed=2)],
                         ids=["plain", "shuffled"])
def test_steps_per_epoch_passes_continue_one_stream(stores, loader_kwargs):
    """With ``num_epochs=None``, passes of ``steps_per_epoch`` batches are
    consecutive cuts of the JAX loader's stream: no staged batch is lost
    between them."""
    url, steps = stores["scalar"], 4
    want = list(itertools.islice(
        _jax(JaxBatchedDataLoader, url, dict(shuffle_row_groups=False, num_epochs=None),
             dict(batch_size=64, **loader_kwargs)), 3 * steps))
    with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                           num_epochs=None) as reader:
        loader = BatchedDataLoader(reader, batch_size=64, device="cpu", steps_per_epoch=steps,
                                   **loader_kwargs)
        got = []
        for _ in range(3):
            passed = [_numpy(b) for b in loader]
            assert len(passed) == steps
            got += passed
        loader.close()
    _assert_same_batches(got, want)


@pytest.mark.parametrize("loader_cls", [BatchedDataLoader, InMemBatchedDataLoader])
def test_steps_per_epoch_raises_when_the_stream_runs_dry(stores, loader_cls):
    with make_batch_reader(stores["scalar"], reader_pool_type="dummy",
                           shuffle_row_groups=False) as reader:
        loader = loader_cls(reader, batch_size=64, device="cpu", steps_per_epoch=12)
        with pytest.raises(RuntimeError, match="stream ended after 10 of 12 steps_per_epoch"):
            list(loader)
        # The dead pipeline is dropped: a new pass builds another.
        assert loader._persistent_it is None


def test_steps_per_epoch_on_the_row_loader(tmp_path):
    """The row loader takes ``steps_per_epoch`` from the same base."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False)])
    url = f"file://{tmp_path}/rows"
    with materialize_dataset_local(url, schema, rows_per_row_group=10) as writer:
        for i in range(25):
            writer.write_row({"id": i})
    with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                     num_epochs=None) as reader:
        loader = DataLoader(reader, batch_size=4, device="cpu", steps_per_epoch=2)
        ids = [b["id"].tolist() for _ in range(3) for b in loader]
        loader.close()
    assert sum(ids, []) == [i % 25 for i in range(24)]


def test_loaders_validate_their_arguments():
    fake = type("R", (), {"batched_output": True})()
    for bad in (dict(batch_size=0), dict(batch_size=2, echo=0),
                dict(batch_size=2, steps_per_epoch=0)):
        with pytest.raises(ValueError):
            BatchedDataLoader(fake, device="cpu", **bad)
    with pytest.raises(ValueError, match="min_after_retrieve"):
        BatchedRandomShufflingBuffer(10, 10, 2)
    buf = BatchedNoopShufflingBuffer(2)
    with pytest.raises(RuntimeError, match="Nothing"):
        buf.retrieve()


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shard_count", [1, 2, 3, 4])
def test_aligned_steps_per_epoch_equals_the_jax_function(stores, shard_count, drop_last):
    url = stores["four_files"]
    want = jax_aligned_steps_per_epoch(url, 50, shard_count=shard_count, drop_last=drop_last)
    assert aligned_steps_per_epoch(url, 50, shard_count=shard_count, drop_last=drop_last) == want


def test_aligned_steps_per_epoch_defaults_and_errors(stores):
    url = stores["four_files"]
    assert aligned_steps_per_epoch(url, 64) == jax_aligned_steps_per_epoch(url, 64) == 1000 // 64
    with pytest.raises(NoDataAvailableError, match="zero row groups"):
        aligned_steps_per_epoch(url, 8, shard_count=17)
    with pytest.raises(ValueError, match="fewer than one batch"):
        aligned_steps_per_epoch(url, 400, shard_count=4)
    with pytest.raises(ValueError, match="batch_size"):
        aligned_steps_per_epoch(url, 0)


def test_aligned_steps_match_what_every_shard_delivers(stores):
    url = stores["four_files"]
    steps = aligned_steps_per_epoch(url, 50, shard_count=3)
    delivered = []
    for shard in range(3):
        with make_batch_reader(url, reader_pool_type="dummy", cur_shard=shard,
                               shard_count=3) as reader:
            delivered.append(len(list(BatchedDataLoader(reader, batch_size=50, device="cpu"))))
    assert steps == min(delivered)


def test_scalar_store_is_the_jax_benchs(tmp_path):
    port = generate_scalar_dataset(f"file://{tmp_path}/port", rows=3000, row_group_size=512)
    ref = jax_generate_scalar(f"file://{tmp_path}/jax", rows=3000, row_group_size=512)
    got = pq.ParquetFile(port[len("file://"):] + "/part0.parquet")
    want = pq.ParquetFile(ref[len("file://"):] + "/part0.parquet")
    assert got.read().equals(want.read())
    assert got.metadata.num_row_groups == want.metadata.num_row_groups == 6


@pytest.mark.parametrize("pool_type", ["thread", "process"])
def test_batched_loader_throughput_on_cpu(stores, pool_type):
    rate = batched_loader_throughput(stores["big_scalar"], batch_size=256, workers_count=2,
                                     warmup_batches=2, measure_batches=10, pool_type=pool_type,
                                     device="cpu")
    assert rate > 0
