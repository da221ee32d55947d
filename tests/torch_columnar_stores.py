"""Small plain Parquet stores for the columnar-path tests of
petastorm_tpu_torch, written from seeded numpy with pyarrow, and the
comparisons the tests share. Imports neither JAX nor the JAX package."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.benchmark.scalar_bench import (generate_scalar_dataset,
                                                        generate_tensor_dataset)


def _with_nulls(values, mask):
    return [None if m else v for v, m in zip(values, mask)]


def write_lists_store(url, rows=120, row_group_size=25, seed=2):
    """List columns. ``declared_f32`` and ``declared_i64`` are variable
    Arrow lists with null rows whose shapes, (3,) and (2,), a stored
    Unischema declares; ``gaps`` is a ``FixedSizeList(3)`` float32 with null
    elements; ``ragged`` (float32, null rows) and ``uniform`` (float64,
    always 4 long) are undeclared ``(None,)`` lists."""
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, write_dataset_metadata
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    path = url[len("file://"):]
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    gaps = rng.standard_normal((rows, 3)).astype(np.float32).tolist()
    for row in gaps:
        if rng.random() < 0.2:
            row[rng.integers(0, 3)] = None
    table = pa.table({
        "id": np.arange(rows, dtype=np.int64),
        "declared_f32": pa.array(_with_nulls(rng.standard_normal((rows, 3)).astype(np.float32)
                                             .tolist(), rng.random(rows) < 0.15),
                                 type=pa.list_(pa.float32())),
        "declared_i64": pa.array(_with_nulls(rng.integers(-9, 9, (rows, 2)).tolist(),
                                             rng.random(rows) < 0.15), type=pa.list_(pa.int64())),
        "gaps": pa.array(gaps, type=pa.list_(pa.float32(), 3)),
        "ragged": pa.array(_with_nulls([rng.standard_normal(rng.integers(0, 6)).astype(np.float32)
                                        .tolist() for _ in range(rows)], rng.random(rows) < 0.1),
                           type=pa.list_(pa.float32())),
        "uniform": pa.array(rng.standard_normal((rows, 4)).tolist(), type=pa.list_(pa.float64())),
    })
    pq.write_table(table, f"{path}/part0.parquet", row_group_size=row_group_size)
    write_dataset_metadata(DatasetContext(url), Unischema("lists", [
        UnischemaField("id", np.int64, ()),
        UnischemaField("declared_f32", np.float32, (3,), nullable=True),
        UnischemaField("declared_i64", np.int64, (2,), nullable=True),
        UnischemaField("gaps", np.float32, (3,)),
        UnischemaField("ragged", np.float32, (None,), nullable=True),
        UnischemaField("uniform", np.float64, (None,))]))
    return url


def write_nulls_store(url, rows=120, row_group_size=25, seed=3):
    """Scalar columns with nulls (float32, int32, string), a boolean and
    a timestamp column, in two files."""
    path = url[len("file://"):]
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    table = pa.table({
        "id": np.arange(rows, dtype=np.int64),
        "f32": pa.array(_with_nulls(rng.standard_normal(rows).astype(np.float32).tolist(),
                                    rng.random(rows) < 0.2), type=pa.float32()),
        "i32": pa.array(_with_nulls(rng.integers(-50, 50, rows).tolist(), rng.random(rows) < 0.2),
                        type=pa.int32()),
        "name": pa.array(_with_nulls([f"row {i}" for i in range(rows)], rng.random(rows) < 0.2)),
        "flag": pa.array(rng.random(rows) < 0.5),
        "when": pa.array(np.datetime64("2024-01-01", "us")
                         + rng.integers(0, 10**9, rows).astype("timedelta64[us]")),
    })
    half = rows // 2
    pq.write_table(table.slice(0, half), f"{path}/a.parquet", row_group_size=row_group_size)
    pq.write_table(table.slice(half), f"{path}/b.parquet", row_group_size=row_group_size)
    return url


def write_stores(root):
    """``{name: url}`` of every store, under ``root``."""
    root = str(root)
    return {
        "scalar": generate_scalar_dataset(f"file://{root}/scalar", rows=700, row_group_size=64),
        "tensor": generate_tensor_dataset(f"file://{root}/tensor", rows=600, row_group_size=50,
                                          list_size=16),
        "lists": write_lists_store(f"file://{root}/lists"),
        "nulls": write_nulls_store(f"file://{root}/nulls"),
        "four_files": generate_tensor_dataset(f"file://{root}/four_files", rows=1000, files=4,
                                              row_group_size=64, list_size=8, seed=1),
    }


def assert_same_array(got, want, what=""):
    """Equal dtype, shape and bytes; object arrays element by element."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    if want.dtype != object:
        assert got.tobytes() == want.tobytes(), what
        return
    for a, b in zip(got, want):
        if b is None or not isinstance(b, np.ndarray):
            assert type(a) is type(b) and (a == b or (a != a and b != b)), (what, a, b)
        else:
            assert isinstance(a, np.ndarray), (what, a)
            assert_same_array(a, b, what)


def assert_same_columns(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert_same_array(got[name], want[name], name)


def row_keys(cols: dict) -> list:
    """Every row of a numeric column dict as bytes, sorted: a multiset of
    rows."""
    names = sorted(cols)
    n = len(cols[names[0]])
    flat = [np.ascontiguousarray(cols[k]).reshape(n, -1).view(np.uint8) for k in names]
    return sorted(b"".join(f[i].tobytes() for f in flat) for i in range(n))
