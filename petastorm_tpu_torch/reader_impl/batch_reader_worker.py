"""Columnar reader worker: one row group -> one pyarrow Table.

The worker of ``make_batch_reader``, for any Parquet store. It reads the
row group's columns as an Arrow table, shuffles its rows when asked (with
the same per-item generator as the row worker and the JAX package,
``np.random.default_rng((seed, epoch, position))``, applied by
``table.take``) and publishes the table. The consumer turns it into
``{column: ndarray}`` with :func:`arrow_table_to_numpy_dict`; on the
process pool that happens over the Arrow buffers in the shared-memory
ring, without a copy. With ``convert_early_to_numpy`` the worker converts
instead and publishes the dict.
"""
from __future__ import annotations

from decimal import Decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.reader_impl.row_reader_worker import _ParquetFileLRU, item_shuffle_rng
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class BatchReaderWorker(WorkerBase):
    """``args`` dict keys: ``dataset_url``, ``view_schema`` (the columns
    to read, as a Unischema), ``shuffle_rows``, ``seed`` and
    ``convert_early_to_numpy``."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._files = None
        self._rng = np.random.default_rng(
            None if args["seed"] is None else args["seed"] + worker_id)

    def process(self, rowgroup, shuffle_context=None):
        result = self._build_result(rowgroup, shuffle_context)
        if result is not None:
            self.publish_func(result)

    def _build_result(self, rowgroup, shuffle_context):
        view_schema = self.args["view_schema"]
        table = self._load_table(rowgroup, set(view_schema.fields),
                                 item_shuffle_rng(self.args["seed"], shuffle_context, self._rng))
        if table.num_rows == 0:
            return None
        table = table.select([n for n in table.column_names if n in view_schema.fields])
        if self.args.get("convert_early_to_numpy"):
            return arrow_table_to_numpy_dict(table, view_schema)
        return table

    def _read_table(self, rowgroup, columns) -> pa.Table:
        if self._files is None:
            from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext
            self._files = _ParquetFileLRU(DatasetContext(self.args["dataset_url"]).filesystem)
        pf = self._files.get(rowgroup.path)
        names = set(pf.schema_arrow.names)
        # Workers are the parallelism unit: arrow's own threads would only
        # oversubscribe the cores.
        table = pf.read_row_group(rowgroup.row_group,
                                  columns=[c for c in sorted(columns) if c in names],
                                  use_threads=False)
        # Hive partition keys are path components, not file columns.
        for key, value in rowgroup.partition_values:
            if key in columns and key not in table.column_names:
                table = table.append_column(key, pa.array([value] * table.num_rows))
        return table

    def _load_table(self, rowgroup, needed, rng) -> pa.Table:
        table = self._read_table(rowgroup, needed)
        if self.args["shuffle_rows"]:
            indices = np.arange(table.num_rows)
            if len(indices) > 1:
                indices = rng.permutation(indices)
            table = table.take(pa.array(indices))
        return table

    def shutdown(self):
        if self._files is not None:
            self._files.close_all()


def _numeric_dtype(field):
    """The field's numpy dtype, or None for a non-numeric declaration
    (str, bytes, Decimal). ``np.float32`` and the like are classes, so
    ``isinstance(x, type)`` cannot tell them from ``str``."""
    if field.numpy_dtype in (str, bytes, Decimal, np.str_, np.bytes_, np.object_):
        return None
    return np.dtype(field.numpy_dtype)


#: Arrow type -> "fsl", "list" or "plain": the ``pa.types.is_*`` walk costs
#: several calls per column per row group, and a stream sees a few types.
_ARROW_KIND_CACHE: dict = {}


def _arrow_column_kind(t) -> str:
    kind = _ARROW_KIND_CACHE.get(t)
    if kind is None:
        kind = ("fsl" if pa.types.is_fixed_size_list(t)
                else "list" if (pa.types.is_list(t) or pa.types.is_large_list(t))
                else "plain")
        _ARROW_KIND_CACHE[t] = kind
    return kind


def arrow_table_to_numpy_dict(table: pa.Table, schema, force_copy: bool = False) -> dict:
    """``{name: ndarray}`` of an Arrow table, list columns reassembled into
    fixed-shape blocks by the schema's declared shapes.

    * A ``FixedSizeList`` column without nulls becomes an ``(n, size)``
      view of its flat values (``(n, *shape)`` for a declared shape).
    * A list column with a fully declared shape is stacked row by row;
      null rows become NaN (float) or 0 (int) blocks.
    * Any other list column stays an object array of per-row arrays (the
      loaders decide, once per stream, whether it densifies).
    * Other columns go through ``to_numpy``: a view for null-free numeric
      columns.

    ``force_copy=True`` guarantees no output array views the table's
    buffers."""
    out = {}
    for name in table.column_names:
        col = table.column(name)
        field = schema.fields.get(name)
        combined = None
        if _arrow_column_kind(col.type) == "fsl":
            # chunk(0) when there is one: combine_chunks would copy a sliced
            # chunk to compact it; a sliced chunk takes the per-row path.
            combined = col.chunk(0) if col.num_chunks == 1 else col.combine_chunks()
        if combined is not None and combined.null_count == 0 \
                and combined.values.null_count == 0 and combined.offset == 0:
            size = col.type.list_size
            flat = combined.values.to_numpy(zero_copy_only=False)
            if field is not None and _numeric_dtype(field):
                flat = flat.astype(_numeric_dtype(field), copy=False)
            arr = flat.reshape(len(col), size)
            if field is not None and field.shape and all(d is not None for d in field.shape):
                arr = arr.reshape((len(col),) + tuple(field.shape))
            if force_copy and arr.base is not None:
                arr = arr.copy()
            out[name] = arr
        elif _arrow_column_kind(col.type) == "list" or combined is not None:
            # Variable lists, or fixed-size lists with nulls.
            rows = col.to_pylist()
            value_dtype = _numeric_dtype(field) if field is not None else None
            arrays = [None if r is None else np.asarray(r, dtype=value_dtype) for r in rows]
            if field is not None and field.shape and all(d is not None for d in field.shape):
                shape = tuple(field.shape)
                fill_dtype = value_dtype or (arrays and next(
                    (a.dtype for a in arrays if a is not None), np.float64)) or np.float64
                fill = np.full(shape, np.nan if np.dtype(fill_dtype).kind == "f" else 0,
                               dtype=fill_dtype)
                out[name] = (np.stack([fill if a is None else a.reshape(shape) for a in arrays])
                             if arrays else np.empty((0,) + shape, dtype=fill_dtype))
            else:
                obj = np.empty(len(arrays), dtype=object)
                for i, a in enumerate(arrays):
                    obj[i] = a
                out[name] = obj
        else:
            try:
                arr = col.to_numpy(zero_copy_only=False)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                arr = np.asarray(col.to_pylist(), dtype=object)
            if force_copy and arr.base is not None:
                arr = arr.copy()
            out[name] = arr
    return out
