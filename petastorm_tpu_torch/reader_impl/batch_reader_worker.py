"""Columnar reader worker: one row group -> one pyarrow Table.

The worker of ``make_batch_reader``, for any Parquet store. It reads the
row group's columns (and a predicate's) as an Arrow table and masks it by
the predicate (one ``do_include_batch`` call over the columns as numpy,
else ``do_include`` over pandas rows, as the JAX package does).
Then it takes the item's drop partition and shuffles its rows when asked
(with the same per-item generator as the row worker and the JAX package,
``np.random.default_rng((seed, epoch, position))``, applied by
``table.take``), runs the ``TransformSpec`` (over a pandas DataFrame, or
over ``{column: ndarray}`` when ``batched``), keeps the output schema's
columns and publishes the table. The consumer turns it into
``{column: ndarray}`` with :func:`arrow_table_to_numpy_dict`; on the
process pool that happens over the Arrow buffers in the shared-memory
ring, without a copy. With ``convert_early_to_numpy`` the worker converts
instead and publishes the dict, and so does an in-process worker under the
plan's ``decode_transport`` fusion (the same conversion of the same table,
so the consumer pops ready columns). Under the ``mask_decode_transform``
fusion one read covers the predicate's columns and the output's; unfused,
the predicate's columns are read first and the rest only when a row
passes, as in the JAX package. Retries, quarantine, fault sites, stage
deadlines, hedged reads and the readahead stage are the row worker's
(:func:`~petastorm_tpu_torch.reader_impl.row_reader_worker.init_resilience`).
With the reader's memory cache a group without a predicate is read once
and its Arrow table kept (:meth:`BatchReaderWorker._maybe_cached_table`);
the drop partition and the shuffle are taken from it each time.
"""
from __future__ import annotations

import hashlib
from decimal import Decimal
from typing import Optional

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.reader_impl.row_reader_worker import (apply_batched_transform,
                                                               deadline_checkpoint,
                                                               init_resilience,
                                                               item_shuffle_rng,
                                                               read_row_group_maybe_hedged,
                                                               run_guarded_item,
                                                               select_drop_partition)
from petastorm_tpu_torch.reader_impl.epoch_plan import OrderedUnit
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class BatchReaderWorker(WorkerBase):
    """``args`` dict keys: ``dataset_url`` (a URL or a list), ``view_schema`` (the columns
    to read, as a Unischema), ``output_schema`` (after the transform),
    ``predicate`` and ``transform_spec`` (or None), ``shuffle_rows``,
    ``seed``, ``convert_early_to_numpy``, ``sample_order`` (one
    :class:`~petastorm_tpu_torch.reader_impl.epoch_plan.OrderedUnit` an item
    with ``"deterministic"``, as the row worker publishes), and
    ``storage_options`` and ``filesystem`` (or None), how the store's files
    are reached, ``cache`` (the reader's memory cache, or None),
    ``plan_fusions`` (the plan's applied fusions: ``mask_decode_transform``,
    ``decode_transport``), and the row worker's resilience keys."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._files = self._fs = None
        self._rng = np.random.default_rng(
            None if args["seed"] is None else args["seed"] + worker_id)
        self._ordered = args.get("sample_order", "free") == "deterministic"
        self._fusions = frozenset(args.get("plan_fusions") or ())
        init_resilience(self, args)

    def process(self, rowgroup, shuffle_row_drop_partition=(0, 1), shuffle_context=None):
        # The whole load and transform is the retry unit; the publish stays
        # outside the guard, so a retried item never publishes twice.
        result = run_guarded_item(self, rowgroup, shuffle_context, lambda: self._build_result(
            rowgroup, shuffle_row_drop_partition, shuffle_context))
        if self._ordered and shuffle_context is not None:
            self.publish_func(OrderedUnit(shuffle_context,
                                          kind="data" if result is not None else "empty",
                                          payload=result))
        elif result is not None:
            self.publish_func(result)

    def _build_result(self, rowgroup, drop_part, shuffle_context):
        view_schema = self.args["view_schema"]
        spec = self.args.get("transform_spec")
        table = self._load_table(rowgroup, set(view_schema.fields), self.args.get("predicate"),
                                 drop_part,
                                 item_shuffle_rng(self.args["seed"], shuffle_context, self._rng))
        # Stage boundary (read done, transform ahead): a hard-overrun or
        # watchdog-cancelled attempt stops here.
        deadline_checkpoint(self)
        if table is None or table.num_rows == 0:
            return None
        if spec is not None and spec.func is not None:
            if spec.batched:
                cols = apply_batched_transform(spec, arrow_table_to_numpy_dict(table, view_schema))
                table = _table_from_columns(cols)
            else:
                table = _pandas_transform(spec.func, table)
        out_schema = self.args.get("output_schema", view_schema)
        table = table.select([n for n in table.column_names if n in out_schema.fields])
        if self.args.get("convert_early_to_numpy") or "decode_transport" in self._fusions:
            return arrow_table_to_numpy_dict(table, out_schema)
        return table

    def _maybe_cached_table(self, rowgroup, columns) -> pa.Table:
        """The group's table from the reader's cache (read and stored on a
        miss), or read when there is none."""
        cache = self.args.get("cache")
        if cache is None:
            return self._read_table(rowgroup, columns)
        url = self.args["dataset_url"]
        h = hashlib.md5((url if isinstance(url, str) else "|".join(url)).encode()).hexdigest()
        key = f"{h}:{rowgroup.path}:{rowgroup.row_group}:{','.join(sorted(columns))}"
        return cache.get(key, lambda: self._read_table(rowgroup, columns))

    def _read_table(self, rowgroup, columns) -> pa.Table:
        table = read_row_group_maybe_hedged(self, rowgroup, columns)
        # Hive partition keys are path components, not file columns.
        for key, value in rowgroup.partition_values:
            if key in columns and key not in table.column_names:
                table = table.append_column(key, pa.array([value] * table.num_rows))
        return table

    def _load_table(self, rowgroup, needed, predicate, drop_part, rng) -> Optional[pa.Table]:
        """The group's ``needed`` columns, masked by ``predicate`` (None
        when no row passes), then its drop partition, shuffled when asked."""
        if predicate is None:
            table = self._maybe_cached_table(rowgroup, needed)
        elif "mask_decode_transform" in self._fusions:
            # One read of every column, the mask over a selection of it.
            pred_fields = set(predicate.get_fields())
            table = self._read_table(rowgroup, needed | pred_fields)
            mask = _predicate_mask(
                table.select([n for n in table.column_names if n in pred_fields]), predicate)
            if not mask.any():
                return None
            table = table.select([n for n in table.column_names if n in needed]).filter(
                pa.array(mask))
        else:
            # The predicate's columns, then the rest once a row passes.
            pred_fields = set(predicate.get_fields())
            table = self._read_table(rowgroup, pred_fields)
            mask = _predicate_mask(table, predicate)
            if not mask.any():
                return None
            rest = needed - pred_fields
            if rest:
                rest_table = self._read_table(rowgroup, rest)
                for name in rest_table.column_names:
                    table = table.append_column(name, rest_table.column(name))
            table = table.select([n for n in table.column_names if n in needed]).filter(
                pa.array(mask))
        part_index, num_parts = drop_part
        if num_parts > 1 or self.args["shuffle_rows"]:
            indices = select_drop_partition(table.num_rows, part_index, num_parts,
                                            self.args["shuffle_rows"], rng)
            table = table.take(pa.array(indices))
        return table

    def shutdown(self):
        if self._files is not None:
            self._files.close_all()


def _predicate_mask(pred_table: pa.Table, predicate) -> np.ndarray:
    """The predicate's row mask over a group's predicate columns: one
    ``do_include_batch`` call over the columns as numpy where it answers,
    else ``do_include`` over the rows of a pandas DataFrame, whose cells
    are the values the JAX package's workers hand it."""
    if pred_table.num_rows == 0:
        return np.array([], dtype=bool)
    columns = {}
    for name in pred_table.column_names:
        try:
            columns[name] = pred_table.column(name).to_numpy(zero_copy_only=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            columns = None
            break
    if columns is not None:
        mask = predicate.do_include_batch(columns)
        if mask is not None:
            return np.asarray(mask, dtype=bool)
    df = pred_table.to_pandas()
    return df.apply(lambda r: predicate.do_include(r.to_dict()), axis=1).values.astype(bool)


def _pandas_transform(func, table: pa.Table) -> pa.Table:
    """``func`` over the group as a pandas DataFrame, back to Arrow. Arrow
    has no multi-dimensional cell type: such cells are raveled, and the
    output schema's shape brings the shape back."""
    df = func(table.to_pandas())
    for col in df.columns:
        vals = df[col].values
        probe = next((v for v in vals if isinstance(v, np.ndarray)), None)
        if probe is not None and probe.ndim > 1:
            df[col] = [v.ravel() if isinstance(v, np.ndarray) else v for v in vals]
    return pa.Table.from_pandas(df, preserve_index=False)


def _table_from_columns(cols: dict) -> pa.Table:
    """An Arrow table of a batched transform's columns: an ``(n, ...)``
    array of more than one dimension, or a column of multi-dimensional
    cells, becomes a list column of raveled rows."""
    arrays = {}
    for name, v in cols.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            if v.ndim > 1:
                # An explicit row width: reshape cannot infer -1 for 0 rows.
                width = int(np.prod(v.shape[1:], dtype=np.int64))
                arrays[name] = pa.array(list(v.reshape(len(v), width)))
            else:
                arrays[name] = pa.array(v)
            continue
        cells = list(v)
        if any(isinstance(c, np.ndarray) and c.ndim > 1 for c in cells):
            cells = [c.ravel() if isinstance(c, np.ndarray) else c for c in cells]
        arrays[name] = pa.array(cells)
    return pa.table(arrays)


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
