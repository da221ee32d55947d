"""``Unischema.as_tensor_specs`` and the loaders' ``PipelineMetrics`` and
profiler spans in petastorm_tpu_torch, against the JAX package.

* The spec against ``as_shape_dtype_structs``: the same fields and shapes;
  the dtypes those of the port's loaders under ``DEFAULT_POLICY``, which
  widen uint16 to int32 (PyTorch has no full uint16), turn datetime64 into
  int64 nanoseconds and keep uint64 on the host. Then against real
  batches' shapes and dtypes.
* ``loader.metrics`` counts the same batches, samples and staged bytes as
  the JAX loader's over the same store, and the spans
  ``petastorm_tpu.host_batch`` and ``petastorm_tpu.stage`` appear in a
  ``torch.profiler`` trace (the staging thread's: ``profile_all_threads``).
"""
import warnings
from decimal import Decimal

import numpy as np
import pytest
import torch

from petastorm_tpu.jax import BatchedDataLoader as JaxBatchedDataLoader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.jax import InMemBatchedDataLoader as JaxInMemBatchedDataLoader
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.loader import BatchedDataLoader, DataLoader, InMemBatchedDataLoader
from petastorm_tpu_torch.metrics import PipelineMetrics, trace, traced_span
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

FIXED = ["id", "id2", "image_png", "matrix", "matrix_uint16", "nullable_int"]
#: The dtypes the port's loaders deliver where they differ from the field's.
WIDENED = {np.dtype(np.uint16): torch.int32}


def _torch_dtype(np_dtype):
    return WIDENED.get(np.dtype(np_dtype), torch.from_numpy(np.empty(0, np_dtype)).dtype)


@pytest.mark.parametrize("batch_size", [None, 8])
def test_specs_equal_the_jax_structs(synthetic_dataset, batch_size):
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy") as r, \
            jax_make_reader(synthetic_dataset.url, reader_pool_type="dummy") as j:
        fixed = r.schema.create_schema_view(FIXED + ["partition_key", "decimal_col"])
        jax_fixed = j.schema.create_schema_view(FIXED + ["partition_key", "decimal_col"])
        got = fixed.as_tensor_specs(batch_size=batch_size)
        want = jax_fixed.as_shape_dtype_structs(batch_size=batch_size)
        assert set(got) == set(want) == set(FIXED)
        for name, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[name].shape)
            assert spec.dtype == _torch_dtype(want[name].dtype), name
        with pytest.raises(ValueError, match="variable dimension"):
            r.schema.as_tensor_specs()
        with pytest.raises(ValueError, match="variable dimension"):
            j.schema.as_shape_dtype_structs()
        got = r.schema.as_tensor_specs(batch_size=4, variable_dim=5)
        want = j.schema.as_shape_dtype_structs(batch_size=4, variable_dim=5)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


def test_specs_follow_the_default_policy():
    fields = [("when", np.dtype("datetime64[us]"), torch.int64), ("big", np.uint64, None),
              ("flag", np.bool_, torch.bool), ("half", np.float16, torch.float16),
              ("wide", np.uint32, torch.int64), ("raw", bytes, None), ("amount", Decimal, None)]
    schema = Unischema("S", [UnischemaField(n, d, (2,)) for n, d, _ in fields])
    jax_schema = JaxUnischema("S", [JaxField(n, d, (2,)) for n, d, _ in fields])
    got = schema.as_tensor_specs()
    assert {k: v.dtype for k, v in got.items()} == {n: t for n, _, t in fields if t is not None}
    assert set(got) | {"big"} == set(jax_schema.as_shape_dtype_structs())


def test_specs_match_real_batches(synthetic_dataset, scalar_dataset):
    with make_reader(synthetic_dataset.url, schema_fields=FIXED[:-1], reader_pool_type="dummy",
                     shuffle_row_groups=False) as r:
        specs = r.schema.as_tensor_specs(batch_size=8)
        batch = next(iter(DataLoader(r, batch_size=8, device="cpu")))
    assert set(batch) == set(specs)
    for name, spec in specs.items():
        assert batch[name].shape == spec.shape and batch[name].dtype == spec.dtype, name
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_batch_reader(scalar_dataset.url, reader_pool_type="dummy",
                               shuffle_row_groups=False) as r:
            # vector_col: a (None,) list of 4 floats a row, which the
            # loader densifies.
            specs = r.schema.as_tensor_specs(batch_size=8, variable_dim=4)
            batch = next(iter(BatchedDataLoader(r, batch_size=8, device="cpu")))
    tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    assert set(tensors) == set(specs) == {"id", "int_col", "float_col", "vector_col"}
    for name, t in tensors.items():
        assert t.shape == specs[name].shape and t.dtype == specs[name].dtype, name


# -------------------------------------------------------------------- metrics
def _counts(metrics):
    d = metrics.as_dict()
    return {k: d[k] for k in ("batches", "samples", "bytes_staged")}


def _run(loader_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loader = loader_factory()
        n = sum(1 for _ in loader)
        return n, _counts(loader.metrics)


@pytest.mark.parametrize("batch_size", [16, 25])
def test_data_loader_metrics_equal_the_jax_loaders(synthetic_dataset, batch_size):
    kw = dict(schema_fields=["id", "id2", "matrix"], reader_pool_type="dummy",
              shuffle_row_groups=False)
    with make_reader(synthetic_dataset.url, **kw) as r, \
            jax_make_reader(synthetic_dataset.url, **kw) as j:
        got = _run(lambda: DataLoader(r, batch_size=batch_size, drop_last=False, device="cpu"))
        want = _run(lambda: JaxDataLoader(j, batch_size=batch_size, drop_last=False))
    assert got == want
    n, counts = got
    assert counts["samples"] == 100 and counts["batches"] == n
    assert counts["bytes_staged"] == 100 * (8 + 4 + 32 * 16 * 3 * 4)


def test_batched_and_in_memory_loader_metrics_equal_the_jax_loaders(scalar_dataset):
    kw = dict(schema_fields=["id", "float_col", "int_col"], reader_pool_type="dummy",
              shuffle_row_groups=False)
    with make_batch_reader(scalar_dataset.url, **kw) as r, \
            jax_make_batch_reader(scalar_dataset.url, **kw) as j:
        got = _run(lambda: BatchedDataLoader(r, batch_size=30, device="cpu"))
        want = _run(lambda: JaxBatchedDataLoader(j, batch_size=30))
    assert got == want and got[1]["batches"] == 3
    with make_batch_reader(scalar_dataset.url, **kw) as r, \
            jax_make_batch_reader(scalar_dataset.url, **kw) as j:
        got = _run(lambda: InMemBatchedDataLoader(r, batch_size=40, num_epochs=2, seed=1,
                                                  drop_last=False, device="cpu"))
        want = _run(lambda: JaxInMemBatchedDataLoader(j, batch_size=40, num_epochs=2, seed=1,
                                                      drop_last=False))
    assert got == want and got[1]["samples"] == 200


def test_pipeline_metrics_reset_returns_what_it_held():
    m = PipelineMetrics()
    m.record_batch(8, 64, 0.5, 0.25)
    m.record_batch(4, 32, 0.125, 0.0)
    assert (m.batches, m.samples, m.bytes_staged) == (2, 12, 96)
    assert m.host_wait_s == 0.625 and m.stage_s == 0.25
    assert m.reset() == {"batches": 2, "samples": 12, "bytes_staged": 96,
                         "host_wait_s": 0.625, "stage_s": 0.25}
    assert m.as_dict()["batches"] == 0


def test_loader_spans_show_in_a_profiler_trace(synthetic_dataset):
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with make_reader(synthetic_dataset.url, schema_fields=["id"], reader_pool_type="dummy") as r:
        loader = DataLoader(r, batch_size=10, device="cpu", prefetch=1)
        it = iter(loader)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=config) as prof:
            next(it)
            next(it)
            with traced_span("outer"), trace("inner"):
                pass
        it.close()
    names = [e.name for e in prof.events()]
    assert names.count("petastorm_tpu.host_batch") >= 2
    assert names.count("petastorm_tpu.stage") >= 2
    assert "outer" in names and "inner" in names
