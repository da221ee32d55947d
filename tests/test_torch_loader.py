"""petastorm_tpu_torch.loader.DataLoader(device="cpu") against the JAX
DataLoader on the same reader settings: the same batches, byte for byte,
including the drop-last / pad-last tail and a seeded shuffling buffer.

The reference is the JAX loader's host batch after the JAX package's dtype
sanitization, before ``device_put`` (JAX without x64 would narrow 64-bit
columns on the device, which says nothing about the loader). Where PyTorch
lacks a dtype the port widens it (uint16 -> int32); those columns are held
value-equal and checked for the widened dtype.
"""
import threading
import time

import numpy as np
import pytest
import torch

from dataset_utils import create_test_dataset
from petastorm_tpu.jax.dtypes import sanitize_batch as jax_sanitize_batch
from petastorm_tpu.jax.loader import DataLoader as JaxDataLoader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.loader import loader as loader_module
from petastorm_tpu_torch.reader import make_reader

FIELDS = ["id", "id2", "partition_key", "image_png", "matrix", "matrix_uint16",
          "decimal_col", "varlen"]
WIDENED = {np.dtype(np.uint16): torch.int32}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('loader_store')}/ds"
    create_test_dataset(url, num_rows=50, rows_per_row_group=5)
    return url


def _batches(loader_cls, reader_factory, url, reader_kwargs, loader_kwargs):
    with reader_factory(url, schema_fields=FIELDS, **reader_kwargs) as reader:
        return list(loader_cls(reader, **loader_kwargs))


def _jax_host_batches(url, reader_kwargs, loader_kwargs):
    with jax_make_reader(url, schema_fields=FIELDS, **reader_kwargs) as reader:
        loader = JaxDataLoader(reader, **loader_kwargs)
        out = []
        for hb in loader._host_batches():
            device_cols, host_cols = jax_sanitize_batch(hb)
            out.append({**device_cols, **host_cols})
        return out


def assert_same_batch(port: dict, ref: dict):
    assert set(port) == set(ref)
    for name, want in ref.items():
        got = port[name]
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            assert got.device.type == "cpu"
            if want.dtype in WIDENED:
                assert got.dtype == WIDENED[want.dtype]
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                got = got.numpy()
                assert got.dtype == want.dtype and got.shape == want.shape, name
                assert got.tobytes() == want.tobytes(), name
        else:   # host columns: strings, ragged object arrays
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reader_kwargs,loader_kwargs", [
    (dict(reader_pool_type="dummy", shuffle_row_groups=False), dict(batch_size=8)),
    (dict(reader_pool_type="dummy", shuffle_row_groups=False),
     dict(batch_size=8, drop_last=False)),
    (dict(reader_pool_type="dummy", seed=4, shuffle_rows=True),
     dict(batch_size=8, pad_last=True)),
    (dict(reader_pool_type="dummy", seed=9, num_epochs=2),
     dict(batch_size=12, shuffling_queue_capacity=20, seed=5, pad_last=True)),
    (dict(reader_pool_type="thread", workers_count=3, seed=1, shuffle_rows=True),
     dict(batch_size=7, shuffling_queue_capacity=16, min_after_retrieve=4, seed=2)),
], ids=["drop_last", "short_tail", "pad_last", "shuffle_buffer", "thread_pool"])
def test_batches_equal_jax_loader(store, reader_kwargs, loader_kwargs):
    port = _batches(DataLoader, make_reader, store, reader_kwargs,
                    dict(loader_kwargs, device="cpu"))
    ref = _jax_host_batches(store, reader_kwargs, loader_kwargs)
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert_same_batch(p, r)


def test_second_iteration_resets_the_reader(store):
    with make_reader(store, schema_fields=["id"], reader_pool_type="dummy",
                     shuffle_row_groups=False) as reader:
        loader = DataLoader(reader, batch_size=10, device="cpu")
        first = [b["id"].tolist() for b in loader]
        second = [b["id"].tolist() for b in loader]
    assert first == second and len(first) == 5


def test_default_device_is_cuda_and_raises_without_a_gpu(store, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with make_reader(store, schema_fields=["id"], reader_pool_type="dummy") as reader:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataLoader(reader, batch_size=4)
        with pytest.raises(ValueError):
            DataLoader(reader, batch_size=4, device="meta")


def test_closing_an_abandoned_loader_stops_staging_and_the_reader(store):
    before = set(threading.enumerate())
    reader = make_reader(store, schema_fields=["id"], reader_pool_type="thread",
                         workers_count=2, seed=0)
    with DataLoader(reader, batch_size=5, prefetch=1, device="cpu") as loader:
        it = iter(loader)
        assert len(next(it)["id"]) == 5
    deadline = time.monotonic() + 5.0
    while any(t.is_alive() for t in set(threading.enumerate()) - before):
        assert time.monotonic() < deadline, "loader or reader threads outlived close()"
        time.sleep(0.01)
    it.close()


def test_staging_error_reaches_the_consumer(store, monkeypatch):
    def boom(*_a, **_k):
        raise OSError("disk on fire")
    monkeypatch.setattr(loader_module, "sanitize_batch", boom)
    with make_reader(store, schema_fields=["id"], reader_pool_type="dummy") as reader:
        with pytest.raises(OSError, match="disk on fire"):
            list(DataLoader(reader, batch_size=4, device="cpu"))
