"""Dataset writer: encoded rows -> Parquet files + metadata, with pyarrow only.

Buffers codec-encoded rows, sizes row groups (explicitly, or to a target
of ``row_group_size_mb`` estimated from the first rows), writes numbered
Parquet files (optionally hive-partitioned), and finishes with the
``_common_metadata`` sidecar carrying the JSON Unischema and the
row-groups-per-file index. The stores it writes are the ones the JAX
package's writer produces.
"""
from __future__ import annotations

import posixpath
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, write_dataset_metadata
from petastorm_tpu_torch.unischema import Unischema, dict_to_encoded_row

_SIZE_ESTIMATE_ROWS = 10


class DatasetWriter:
    """Writes rows of ``schema`` to ``dataset_url`` as a Parquet store.

    :param row_group_size_mb: target (pre-compression) row-group size; rows
        per group are estimated from the first rows written
    :param rows_per_row_group: explicit rows per row group
    :param rows_per_file: rows per Parquet file (default: 16 row groups)
    :param partition_by: hive partition columns (scalar fields): each
        distinct combination of their values gets its own
        ``col=value/...`` directory; the columns stay in the files too
    :param compression: parquet codec ('snappy', 'zstd', 'gzip', 'none')
    :param filesystem: a filesystem to write through as it is
    :param storage_options: keyword arguments of the URL's fsspec filesystem
    """

    def __init__(self, dataset_url: str, schema: Unischema,
                 row_group_size_mb: int = 32,
                 rows_per_row_group: Optional[int] = None,
                 rows_per_file: Optional[int] = None,
                 partition_by: Optional[Sequence[str]] = None,
                 compression: str = "snappy",
                 filesystem=None, storage_options: Optional[dict] = None):
        self._schema = schema
        self._arrow_schema = schema.as_arrow_schema()
        self._ctx = DatasetContext(dataset_url, storage_options=storage_options,
                                   filesystem=filesystem)
        self._fs, self._root = self._ctx.filesystem, self._ctx.root_path
        self._row_group_bytes = row_group_size_mb * (1 << 20)
        self._rows_per_rg = rows_per_row_group
        self._rows_per_file = rows_per_file
        self._partition_by = list(partition_by or [])
        for col in self._partition_by:
            if col not in schema.fields or not schema.fields[col].is_scalar:
                raise ValueError(f"partition_by column {col!r} must be a scalar schema field")
        self._compression = compression
        # Rows waiting to be written, by partition key ((col, value), ...).
        self._buffers: Dict[tuple, List[dict]] = {}
        self._file_counter = 0
        self._closed = False
        self._fs.makedirs(self._root, exist_ok=True)

    def write_row(self, row: dict) -> None:
        encoded = dict_to_encoded_row(self._schema, row)
        pkey = tuple((c, encoded[c]) for c in self._partition_by)
        buf = self._buffers.setdefault(pkey, [])
        buf.append(encoded)
        if self._rows_per_rg is None and len(buf) >= _SIZE_ESTIMATE_ROWS:
            self._estimate_row_group_rows(buf)
        if self._rows_per_rg is not None:
            if len(buf) >= (self._rows_per_file or self._rows_per_rg * 16):
                self._flush(pkey)

    def write_rows(self, rows: Iterable[dict]) -> None:
        for row in rows:
            self.write_row(row)

    def _estimate_row_group_rows(self, sample: List[dict]) -> None:
        total = 0
        for row in sample:
            for v in row.values():
                total += len(v) if isinstance(v, (bytes, bytearray, str)) else 8
        avg = max(1, total // len(sample))
        self._rows_per_rg = max(1, self._row_group_bytes // avg)

    def _flush(self, pkey: tuple) -> None:
        rows = self._buffers.pop(pkey, [])
        if not rows:
            return
        if self._rows_per_rg is None:
            self._estimate_row_group_rows(rows)
        columns = [pa.array([r[f.name] for r in rows], type=f.type)
                   for f in self._arrow_schema]
        table = pa.Table.from_arrays(columns, schema=self._arrow_schema)
        part_dir = self._root
        for col, value in pkey:
            part_dir = posixpath.join(part_dir, f"{col}={value}")
        self._fs.makedirs(part_dir, exist_ok=True)
        path = posixpath.join(part_dir, f"part-{self._file_counter:05d}.parquet")
        self._file_counter += 1
        with self._fs.open(path, "wb") as sink:
            pq.write_table(table, sink, row_group_size=self._rows_per_rg,
                           compression=self._compression, use_dictionary=False)

    def close(self) -> None:
        if self._closed:
            return
        for pkey in list(self._buffers):
            self._flush(pkey)
        write_dataset_metadata(self._ctx, self._schema)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        return False


@contextmanager
def materialize_dataset_local(dataset_url: str, schema: Unischema, **writer_kwargs):
    """``with materialize_dataset_local(url, schema) as writer: writer.write_rows(...)``"""
    writer = DatasetWriter(dataset_url, schema, **writer_kwargs)
    yield writer
    writer.close()
