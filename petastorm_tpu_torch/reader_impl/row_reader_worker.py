"""Row reader worker: one row group -> a list of decoded row dicts, or of
NGram windows.

Reads only the columns the output schema (or the NGram) needs, shuffles
the row order inside the group when asked (with the same per-item
generator as the JAX package, ``np.random.default_rng((seed, epoch,
position))``), codec-decodes column by column and publishes the rows. An
NGram reader sorts the rows by timestamp and publishes windows instead:
column-major for a dense NGram over numeric columns, else row by row.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.workers_pool.worker_base import WorkerBase


class _ParquetFileLRU:
    """Tiny LRU of open ParquetFile handles keyed by path."""

    def __init__(self, filesystem, capacity: int = 8):
        self._fs = filesystem
        self._capacity = capacity
        self._files = {}

    def get(self, path: str) -> pq.ParquetFile:
        if path in self._files:
            self._files[path] = self._files.pop(path)  # refresh recency
            return self._files[path]
        if len(self._files) >= self._capacity:
            self._files.pop(next(iter(self._files))).close()
        f = pq.ParquetFile(self._fs.open(path, "rb"))
        self._files[path] = f
        return f

    def close_all(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def _column_values(col):
    """One pyarrow ChunkedArray as per-row values: null-free numeric columns
    as one numpy array, null-free binary columns as zero-copy memoryviews
    over the Arrow buffers (codecs copy on decode), anything else through
    ``to_pylist``."""
    t = col.type
    if col.null_count == 0:
        if pa.types.is_integer(t) or pa.types.is_floating(t) or pa.types.is_boolean(t):
            return col.to_numpy()
        if pa.types.is_binary(t) or pa.types.is_large_binary(t):
            off_dtype = np.int64 if pa.types.is_large_binary(t) else np.int32
            itemsize = np.dtype(off_dtype).itemsize
            out = []
            for chunk in col.chunks:
                n = len(chunk)
                if n == 0:
                    continue
                offs = np.frombuffer(chunk.buffers()[1], off_dtype,
                                     count=n + 1, offset=chunk.offset * itemsize)
                mv = memoryview(chunk.buffers()[2])
                out.extend(mv[offs[i]:offs[i + 1]] for i in range(n))
            return out
    return col.to_pylist()


def _decode_column(field, codec, src, indices):
    """Decode the selected rows of one column. A plain numeric scalar column
    is one vectorized cast (the same numpy scalars, cell for cell, as the
    per-cell decode); every other column decodes cell by cell."""
    if (type(codec) is ScalarCodec and field.shape == ()
            and isinstance(src, np.ndarray) and src.dtype.kind in "biuf"):
        try:
            npdt = np.dtype(field.numpy_dtype)
        except TypeError:  # str/bytes/Decimal declarations
            npdt = None
        if npdt is not None and npdt.kind in "biuf":
            sel = src[indices]
            return sel if sel.dtype == npdt else sel.astype(npdt)
    return [None if src[i] is None else codec.decode(field, src[i]) for i in indices]


def item_shuffle_rng(seed, shuffle_context, fallback_rng):
    """RNG for the row shuffle inside one row group: keyed by the item's
    ``(epoch, position)`` when seeded, so the shuffle is a function of the
    plan and not of worker scheduling."""
    if shuffle_context is not None and seed is not None:
        epoch, pos = shuffle_context
        return np.random.default_rng((seed, epoch, pos))
    return fallback_rng


def _scalar_fast_col(field, codec, col) -> bool:
    """A scalar numeric column whose decode is a dtype cast."""
    return (isinstance(col, np.ndarray) and col.dtype.kind in "biuf"
            and field.shape == () and type(codec) is ScalarCodec)


class RowReaderWorker(WorkerBase):
    """``args`` dict keys: ``dataset_url``, ``schema``
    (the stored Unischema), ``view_schema`` (the narrowed output),
    ``ngram`` (an NGram or None), ``shuffle_rows`` and ``seed``."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._files = None
        self._rng = np.random.default_rng(
            None if args["seed"] is None else args["seed"] + worker_id)
        schema = args["schema"]
        ngram = args.get("ngram")
        # An NGram needs every timestep's fields and the timestamp.
        self._needed = set(ngram.get_field_names_at_all_timesteps() if ngram is not None
                           else args["view_schema"].fields)
        self._decode_schema = schema.create_schema_view(
            [n for n in sorted(self._needed) if n in schema.fields])

    def process(self, rowgroup, shuffle_context=None):
        if self._files is None:
            from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext
            ctx = DatasetContext(self.args["dataset_url"])
            self._files = _ParquetFileLRU(ctx.filesystem)
        pf = self._files.get(rowgroup.path)
        names = set(pf.schema_arrow.names)
        # Workers are the parallelism unit: arrow's own threads would only
        # oversubscribe the cores.
        table = pf.read_row_group(rowgroup.row_group,
                                  columns=[c for c in sorted(self._needed) if c in names],
                                  use_threads=False)
        data = {name: _column_values(table.column(name)) for name in table.column_names}
        # Hive partition keys are path components, not file columns.
        for key, value in rowgroup.partition_values:
            if key in self._needed and key not in data:
                data[key] = [value] * table.num_rows

        indices = np.arange(table.num_rows)
        if self.args["shuffle_rows"] and len(indices) > 1:
            rng = item_shuffle_rng(self.args["seed"], shuffle_context, self._rng)
            indices = rng.permutation(indices)

        ngram = self.args.get("ngram")
        if ngram is not None and ngram.dense and self._dense_vectorizable(data, indices):
            result = self._dense_windows(ngram, data, indices)
        else:
            cols = {}
            for name, field, codec in self._decode_schema.decode_plan:
                if name in data:
                    cols[name] = _decode_column(field, codec, data[name], indices)
            result = [{n: c[j] for n, c in cols.items()} for j in range(len(indices))]
            if ngram is not None:
                ts = ngram.timestamp_field_name
                result.sort(key=lambda r: r[ts])   # stable, as the JAX package sorts
                result = ngram.form_ngram(result, self.args["view_schema"])
                if ngram.dense:
                    result = ngram.densify_windows(result)
        if result:
            self.publish_func(result)

    def _dense_vectorizable(self, data: dict, indices) -> bool:
        """True when every needed field can be assembled column-major:
        scalar numeric columns, or fixed-shape codec fields with no null
        cells. Anything else (strings, nulls, a non-numeric timestamp,
        hive partition values) takes the row path."""
        ts_name = self.args["ngram"].timestamp_field_name
        for name, field, codec in self._decode_schema.decode_plan:
            col = data.get(name)
            if col is None:
                return False
            if _scalar_fast_col(field, codec, col):
                continue
            if name == ts_name:
                return False
            if not field.shape or any(d is None for d in field.shape):
                return False
            if isinstance(col, np.ndarray) or any(col[i] is None for i in indices):
                return False
        return True

    def _dense_windows(self, ngram, data: dict, indices):
        """Column-major dense windows: one ``(n, *shape)`` array per field
        in ``indices`` order (a dtype cast for scalar numeric columns, a
        codec decode and one stack for the rest), then
        :meth:`NGram.form_ngram_dense` over a stable argsort of the
        timestamp column."""
        idx = np.asarray(indices, dtype=np.intp)
        cols = {}
        for name, field, codec in self._decode_schema.decode_plan:
            message = (f"Field {name!r}: codec produced non-uniform values; "
                       f"dense NGram requires fixed-shape decodes")
            try:
                arr = np.asarray(_decode_column(field, codec, data[name], idx))
            except ValueError as e:   # ragged decodes
                raise TypeError(message) from e
            if arr.dtype == object:
                raise TypeError(message)
            cols[name] = arr
        order = np.argsort(cols[ngram.timestamp_field_name], kind="stable")
        return ngram.form_ngram_dense(cols, order)

    def shutdown(self):
        if self._files is not None:
            self._files.close_all()
