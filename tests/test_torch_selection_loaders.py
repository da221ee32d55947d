"""The loaders over transformed readers, on ``device="cpu"``: a field whose
shape or dtype ``edit_fields`` changed and a field removed collate under
the transformed schema. The batches are held against the JAX reader's rows
(or groups) under the same settings, stacked with numpy; and the staging
layout that packs a batch into one buffer gives the columns back bit for
bit."""
import functools
import warnings

import numpy as np
import pytest
import torch

import petastorm_tpu.predicates as jp
import petastorm_tpu_torch.predicates as tp
from petastorm_tpu.reader import (make_batch_reader as jax_make_batch_reader,
                                  make_reader as jax_make_reader)
from petastorm_tpu.transform import TransformSpec as JaxSpec
from petastorm_tpu_torch.loader import BatchedDataLoader, DataLoader, InMemBatchedDataLoader
from petastorm_tpu_torch.loader.loader import _OWN_COPY_BYTES, _STAGE_ALIGN, BatchLayout
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.test_util import transforms as tt
from petastorm_tpu_torch.transform import TransformSpec
from test_torch_selection import batch_store, row_store  # noqa: F401 - fixtures

BATCH = 8


def _crop_spec(spec):
    return spec(functools.partial(tt.center_crop, field="image", size=4),
                edit_fields=[("image", np.uint8, (4, 4, 3), False)],
                removed_fields=["name"])


def _cast_spec(spec):
    return spec(functools.partial(tt.scale_and_drop, name="label", factor=0.5, drop="name"),
                edit_fields=[("label", np.float32, (), False)], removed_fields=["name"],
                batched=True)


def _jax_rows(url, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_make_reader(url, reader_pool_type="dummy", **kwargs) as reader:
            return list(reader)


@pytest.mark.parametrize("spec", [_crop_spec, _cast_spec], ids=["crop", "batched cast"])
def test_data_loader_collates_the_transformed_rows(row_store, spec):  # noqa: F811
    kwargs = dict(seed=3, predicate=None, filters=[("part", "in", [0, 2, 3])])
    with make_reader(row_store, reader_pool_type="dummy", transform_spec=spec(TransformSpec),
                     **kwargs) as reader:
        batches = list(DataLoader(reader, batch_size=BATCH, device="cpu"))
        schema = reader.schema
    rows = _jax_rows(row_store, transform_spec=spec(JaxSpec), **kwargs)
    assert "name" not in schema.fields
    assert len(batches) == len(rows) // BATCH
    for b, batch in enumerate(batches):
        assert set(batch) == set(schema.fields)
        for name, field in schema.fields.items():
            want = np.stack([np.asarray(getattr(r, name))
                             for r in rows[b * BATCH:(b + 1) * BATCH]])
            got = batch[name]
            assert isinstance(got, torch.Tensor) and got.shape == (BATCH,) + field.shape
            assert got.numpy().dtype == np.dtype(field.numpy_dtype) == want.dtype
            assert got.numpy().tobytes() == want.tobytes(), name


def _batch_spec(spec):
    return spec(functools.partial(tt.double_as_matrix, name="mat", source="vec", shape=(3, 2)),
                edit_fields=[("mat", np.float32, (3, 2), False)], removed_fields=["s", "vec"])


@pytest.mark.parametrize("pool", ["thread", "process"])
def test_batched_loader_collates_the_transformed_groups(batch_store, pool):  # noqa: F811
    kwargs = dict(seed=4, shuffle_row_groups=False)
    with make_batch_reader(batch_store, reader_pool_type=pool, workers_count=1,
                           transform_spec=_batch_spec(TransformSpec),
                           predicate=tp.in_range("i0", 200), **kwargs) as reader:
        batches = [{k: v.clone() for k, v in b.items()}
                   for b in BatchedDataLoader(reader, batch_size=BATCH, device="cpu")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_make_batch_reader(batch_store, reader_pool_type="dummy",
                                   transform_spec=_batch_spec(JaxSpec),
                                   predicate=jp.in_range("i0", 200), **kwargs) as reader:
            groups = list(reader)
    want = {name: np.concatenate([getattr(g, name) for g in groups])
            for name in groups[0]._fields}
    assert set(want) == {"id", "i0", "f0", "mat"} == set(batches[0])
    n = len(batches) * BATCH
    assert n == len(want["id"]) // BATCH * BATCH
    for name in want:
        got = torch.cat([b[name] for b in batches]).numpy()
        assert got.shape[1:] == want[name].shape[1:] and got.dtype == want[name].dtype
        assert got.tobytes() == want[name][:n].tobytes(), name
    assert want["mat"].shape[1:] == (3, 2)


def test_in_memory_loader_keeps_the_transformed_columns(batch_store):  # noqa: F811
    with make_batch_reader(batch_store, reader_pool_type="dummy",
                           transform_spec=_batch_spec(TransformSpec)) as reader:
        loader = InMemBatchedDataLoader(reader, batch_size=BATCH, shuffle=False, device="cpu")
        batch = next(iter(loader))
    assert set(batch) == {"id", "i0", "f0", "mat"} and batch["mat"].shape == (BATCH, 3, 2)


@pytest.mark.parametrize("columns", [
    {"a": np.arange(7, dtype=np.int64), "b": np.ones((7, 3, 5), np.float32),
     "c": np.array([True, False] * 3 + [True]), "d": np.arange(21, dtype=np.uint8).reshape(7, 3)},
    {"x": np.zeros((0, 4), np.float64), "y": np.arange(3, dtype=np.int16),
     "z": np.full((3, 1), 2.5, np.float16)},
    {"h": torch.arange(12, dtype=torch.bfloat16).reshape(4, 3), "i": np.arange(4, dtype=np.int8)},
], ids=["mixed", "empty column", "bf16 tensor"])
def test_batch_layout_views_give_the_columns_back(columns):
    layout = BatchLayout(columns)
    buffer = torch.zeros(layout.total, dtype=torch.uint8)
    views = layout.views(buffer)
    for k, v in columns.items():
        if isinstance(v, torch.Tensor):
            views[k].copy_(v)
        else:
            np.copyto(views[k].numpy(), v, casting="no")
    again = layout.views(buffer)
    ends = []
    for k, v in columns.items():
        want = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        assert again[k].dtype == want.dtype and again[k].shape == want.shape
        assert torch.equal(again[k], want)
        if want.numel():   # an empty view may point anywhere
            offset = again[k].data_ptr() - buffer.data_ptr()
            assert offset % _STAGE_ALIGN == 0 and offset >= (ends[-1] if ends else 0)
            ends.append(offset + want.numel() * want.element_size())
    assert layout.total % _STAGE_ALIGN == 0 and ends[-1] <= layout.total


def test_a_kept_small_column_keeps_no_large_column_alive():
    """Each span of a batch's layout is one copy and one allocation: the
    columns under 1 MiB share one, each larger column has its own. Here the
    copy is a clone on the host, as the stager's is a copy to the card."""
    cols = {"image": np.arange(16 * 192 * 192 * 3, dtype=np.int64).astype(np.uint8)
            .reshape(16, 192, 192, 3),
            "label": np.arange(16, dtype=np.int64), "id": np.arange(16, dtype=np.int32),
            "mask": np.ones(_OWN_COPY_BYTES, np.bool_)}
    layout = BatchLayout(cols)
    buffer = torch.zeros(layout.total, dtype=torch.uint8)
    for k, v in layout.views(buffer).items():
        np.copyto(v.numpy(), cols[k], casting="no")
    staged = layout.views(buffer, copy=torch.clone)
    assert list(staged) == list(cols) and len(layout.spans) == 3
    for k, v in cols.items():
        assert np.array_equal(staged[k].numpy(), v), k
    storage = {k: t.untyped_storage() for k, t in staged.items()}
    assert storage["label"].data_ptr() == storage["id"].data_ptr()
    assert storage["label"].nbytes() == 3 * _STAGE_ALIGN   # 128 + 64 bytes
    assert storage["image"].nbytes() == cols["image"].nbytes
    assert storage["mask"].nbytes() == _OWN_COPY_BYTES
    assert len({s.data_ptr() for s in storage.values()}) == 3
