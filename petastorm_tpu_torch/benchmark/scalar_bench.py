"""Scalar-store benchmark: the columnar path (``make_batch_reader`` ->
``BatchedDataLoader``) on a plain Parquet store, staged onto a device.

The counterpart of the JAX package's ``benchmark/scalar_bench.py``: the
same store, the same loader settings; the rate here includes staging onto
``device`` (pinned buffers and a host-to-device copy on ``"cuda"``), which
``device="cpu"`` leaves out, so the two rates give the staging's cost.
"""
from __future__ import annotations

import os
import time


def generate_scalar_dataset(output_url: str, rows: int = 100_000, float_cols: int = 16,
                            int_cols: int = 4, row_group_size: int = 2048, seed: int = 0) -> str:
    """A plain Parquet store of numeric columns (no petastorm metadata):
    ``f0..`` float32 standard normals and ``i0..`` int64 in [0, 1000),
    drawn from ``np.random.default_rng(seed)``, in one file. The same bytes
    as the JAX package's store of the same arguments."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = output_url.replace("file://", "")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    cols = {f"f{i}": rng.standard_normal(rows).astype(np.float32) for i in range(float_cols)}
    cols.update({f"i{i}": rng.integers(0, 1000, rows).astype(np.int64) for i in range(int_cols)})
    pq.write_table(pa.table(cols), os.path.join(path, "part0.parquet"),
                   row_group_size=row_group_size)
    return output_url


def generate_tensor_dataset(output_url: str, rows: int = 50_000, files: int = 1,
                            row_group_size: int = 2048, list_size: int = 64, seed: int = 0) -> str:
    """A plain Parquet store of the JAX package's ``tensor_50k`` schema
    (``bench.py``): ``id`` int64 (``arange(rows)``), ``f0..f7`` float32 and
    ``emb0``, ``emb1`` float32 ``FixedSizeList(list_size)`` columns, standard
    normals from ``np.random.default_rng(seed)``, in ``files`` files of
    consecutive ids (``part0.parquet``...). With the defaults, the JAX
    bench's store."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = output_url.replace("file://", "")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    cols = {"id": np.arange(rows, dtype=np.int64)}
    cols.update({f"f{i}": rng.standard_normal(rows).astype(np.float32) for i in range(8)})
    for j in range(2):
        flat = rng.standard_normal(rows * list_size).astype(np.float32)
        cols[f"emb{j}"] = pa.FixedSizeListArray.from_arrays(pa.array(flat), list_size)
    table = pa.table(cols)
    bounds = np.linspace(0, rows, files + 1).astype(int)
    for k in range(files):
        pq.write_table(table.slice(bounds[k], bounds[k + 1] - bounds[k]),
                       os.path.join(path, f"part{k}.parquet"), row_group_size=row_group_size)
    return output_url


def batched_loader_throughput(dataset_url: str, batch_size: int = 1024, workers_count: int = 3,
                              warmup_batches: int = 10, measure_batches: int = 300,
                              pool_type: str = "thread", device="cuda") -> float:
    """Rows per second through ``make_batch_reader(num_epochs=None,
    shuffle_row_groups=False)`` -> ``BatchedDataLoader(batch_size)`` onto
    ``device``, over ``measure_batches`` batches after ``warmup_batches``.
    On a CUDA device the window ends when the last batch's copy has
    landed."""
    import torch

    from petastorm_tpu_torch.loader import BatchedDataLoader
    from petastorm_tpu_torch.reader import make_batch_reader

    with make_batch_reader(dataset_url, num_epochs=None, shuffle_row_groups=False,
                           reader_pool_type=pool_type, workers_count=workers_count) as reader:
        with BatchedDataLoader(reader, batch_size=batch_size, device=device) as loader:
            it = iter(loader)
            for _ in range(warmup_batches):
                next(it)
            cuda = loader._device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(loader._device)
            t0 = time.perf_counter()
            n = 0
            for _ in range(measure_batches):
                batch = next(it)
                n += len(next(iter(batch.values())))
            if cuda:
                torch.cuda.synchronize(loader._device)
            dt = time.perf_counter() - t0
            it.close()
    return n / dt
