"""Row reader worker: one row group -> a list of decoded row dicts, of
NGram windows, or (``row_materialization="lazy"``) one
:class:`~petastorm_tpu_torch.reader_impl.batch_plane.ColumnarBatch`.

Reads only the columns the output schema (or the NGram) needs, takes the
item's drop partition (``shuffle_row_drop_partitions``: one contiguous
slice of the rows), shuffles the row order inside it when asked (with the
same per-item generator as the JAX package, ``np.random.default_rng((seed,
epoch, position))``), codec-decodes column by column and publishes the
rows. With a predicate it reads and decodes the predicate's columns
first, masks the group (one ``do_include_batch`` call, or ``do_include``
row by row) and reads the other columns only when a row passes; the mask
is taken over the drop partition's indices after the shuffle, so the rows
come in the JAX package's order. A ``TransformSpec`` runs on each decoded
row, or once on the group's columns when ``batched``. An
image column goes through the native batch decoder in one call where the
field and the host allow it (``utils.decode.batch_decode_images``), else
cell by cell through its codec. An NGram reader sorts the rows by
timestamp and publishes windows instead: column-major for a dense NGram
over numeric columns, else row by row.

The worker builds every handle it needs (the filesystem, open files) from
the dataset URL inside its own thread or process.
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec, pin_decode_verdict
from petastorm_tpu_torch.reader_impl.batch_plane import ColumnarBatch
from petastorm_tpu_torch.reader_impl.epoch_plan import OrderedUnit
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


#: numpy dtypes of Arrow's fixed-width numeric types, by their Arrow names.
_FLOAT_NAMES = {"halffloat": "float16", "float": "float32", "double": "float64"}


def _numeric_values(col) -> np.ndarray:
    """A null-free integer or float ChunkedArray as one numpy array, read
    from the Arrow data buffers: ``to_numpy`` gives the same values but
    imports pandas on first use, half a second in every spawned worker."""
    dtype = np.dtype(_FLOAT_NAMES.get(str(col.type), str(col.type)))
    parts = [np.frombuffer(chunk.buffers()[1], dtype, count=len(chunk), offset=chunk.offset
                           * dtype.itemsize) for chunk in col.chunks if len(chunk)]
    if not parts:
        return np.empty(0, dtype)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _column_values(col):
    """One pyarrow ChunkedArray as per-row values: null-free numeric columns
    as one numpy array, null-free binary columns as zero-copy memoryviews
    over the Arrow buffers (codecs copy on decode), anything else through
    ``to_pylist``."""
    t = col.type
    if col.null_count == 0:
        if pa.types.is_integer(t) or pa.types.is_floating(t):
            return _numeric_values(col)
        if pa.types.is_boolean(t):
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
    """Decode the selected rows of one column, as the JAX package's worker
    does: a plain numeric scalar column in one vectorized cast
    (:func:`~petastorm_tpu_torch.utils.decode.batch_decode_scalars`), a
    homogeneous ``NdarrayCodec`` column into one array from one parsed
    header (:func:`~petastorm_tpu_torch.utils.decode.batch_decode_ndarrays`),
    every other column cell by cell; a user codec gets bytes, never the
    read path's memoryviews."""
    from petastorm_tpu_torch.utils.decode import (batch_decode_ndarrays, batch_decode_scalars,
                                                  is_memoryview_safe)
    batched = batch_decode_scalars(field, codec, src, indices)
    if batched is not None:
        return batched
    if is_memoryview_safe(codec):
        batched = batch_decode_ndarrays(field, codec, src, indices)
        if batched is not None:
            return batched
        return [None if src[i] is None else codec.decode(field, src[i]) for i in indices]
    return [None if (v := src[i]) is None
            else codec.decode(field, bytes(v) if isinstance(v, memoryview) else v)
            for i in indices]


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


def select_drop_partition(num_rows: int, partition_index: int, num_partitions: int,
                          shuffle: bool, rng) -> np.ndarray:
    """Row indices of the ``partition_index``-th of ``num_partitions``
    contiguous slices of a row group (``np.array_split``), permuted by
    ``rng`` when ``shuffle``."""
    indices = np.arange(num_rows)
    if num_partitions > 1:
        indices = np.array_split(indices, num_partitions)[partition_index]
    if shuffle and rng is not None and len(indices) > 1:
        indices = rng.permutation(indices)
    return indices


def apply_batched_transform(transform_spec, cols: dict) -> dict:
    """A ``TransformSpec(batched=True)`` func applied to one row group's
    columns: a dict of equal-length columns in and out (the row count may
    change: a batched transform may filter)."""
    out = transform_spec.func(dict(cols))
    if not isinstance(out, dict):
        raise TypeError(f"TransformSpec(batched=True) func must return a "
                        f"{{column: values}} dict, got {type(out).__name__}")
    lengths = {len(v) for v in out.values()}
    if len(lengths) > 1:
        raise ValueError(f"TransformSpec(batched=True) func returned ragged columns "
                         f"(lengths {sorted(lengths)}); every column must keep one "
                         f"entry per row")
    return out


class RowReaderWorker(WorkerBase):
    """``args`` dict keys: ``dataset_url``, ``schema``
    (the stored Unischema), ``view_schema`` (the narrowed output),
    ``ngram`` (an NGram or None), ``predicate`` and ``transform_spec``
    (or None), ``shuffle_rows``, ``seed`` and
    ``decode_threads`` (threads of each native image decode call),
    ``decode_verdict`` (the reader's :func:`~petastorm_tpu_torch.codecs.decode_verdict`,
    or None for a store without images), ``row_materialization`` (``"lazy"``:
    one ``ColumnarBatch`` an item, no row dicts) and ``sample_order``: with
    ``"deterministic"`` every item publishes one
    :class:`~petastorm_tpu_torch.reader_impl.epoch_plan.OrderedUnit`,
    ``empty`` when no row was kept; ``storage_options`` and ``filesystem``
    (or None), how the store's files are reached.

    Its counters (:meth:`take_counters`): ``images_native``, the image
    cells the native batch call decoded, and ``images_codec``, those that
    went through the codec one at a time."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        from petastorm_tpu_torch.utils.decode import NativeImageSkipMemo
        self._files = None
        self._native_img_skip = NativeImageSkipMemo()
        self._counters = {}
        self._rng = np.random.default_rng(
            None if args["seed"] is None else args["seed"] + worker_id)
        self._ordered = args.get("sample_order", "free") == "deterministic"
        # The reader checked that a lazy worker has no NGram and no per-row
        # transform.
        self._lazy = args.get("row_materialization", "eager") == "lazy"
        schema = args["schema"]
        ngram = args.get("ngram")
        # An NGram needs every timestep's fields and the timestamp.
        self._needed = set(ngram.get_field_names_at_all_timesteps() if ngram is not None
                           else args["view_schema"].fields)
        self._decode_schema = schema.create_schema_view(
            [n for n in sorted(self._needed) if n in schema.fields])
        if args.get("decode_verdict") is not None:
            # The reader's verdict on the image decode path; cv2 and the
            # native library load before the worker reports ready, not on
            # its first row group.
            pin_decode_verdict(args["decode_verdict"])
            if args["decode_verdict"][0]:
                from petastorm_tpu_torch.native import imgcodec
                imgcodec.imgcodec_available()
            try:
                import cv2  # noqa: F401
            except ImportError:   # the codec decodes with Pillow
                pass

    def process(self, rowgroup, shuffle_row_drop_partition=(0, 1), shuffle_context=None):
        result = self._build_result(rowgroup, shuffle_row_drop_partition, shuffle_context)
        if self._ordered and shuffle_context is not None:
            self.publish_func(OrderedUnit(shuffle_context, kind="data" if result else "empty",
                                          payload=result if result else None))
        elif result:
            self.publish_func(result)

    def _build_result(self, rowgroup, drop_part, shuffle_context):
        ngram = self.args.get("ngram")
        predicate = self.args.get("predicate")
        spec = self.args.get("transform_spec")
        func = spec.func if spec is not None else None
        rng = item_shuffle_rng(self.args["seed"], shuffle_context, self._rng)
        if predicate is not None:
            data, indices = self._load_columns_with_predicate(rowgroup, predicate, drop_part, rng)
        else:
            data, num_rows = self._read_columns(rowgroup, self._needed)
            indices = select_drop_partition(num_rows, *drop_part, self.args["shuffle_rows"], rng)

        batched = func is not None and spec.batched
        if ngram is None and (self._lazy or batched):
            # Columns stay columns through the decode and the batched
            # transform: a lazy reader gets them whole, an eager one as rows.
            cols = self._decode_columns(data, indices)
            if batched:
                cols = apply_batched_transform(spec, cols)
            n = len(next(iter(cols.values()))) if cols else 0
            if self._lazy:
                return ColumnarBatch(cols, n)
            return [{k: c[j] for k, c in cols.items()} for j in range(n)]
        if ngram is not None and ngram.dense and func is None \
                and self._dense_vectorizable(data, indices):
            return self._dense_windows(ngram, data, indices)
        cols = self._decode_columns(data, indices)
        rows = [{n: c[j] for n, c in cols.items()} for j in range(len(indices))]
        if func is not None:
            rows = [func(r) for r in rows]
        if ngram is not None:
            ts = ngram.timestamp_field_name
            rows.sort(key=lambda r: r[ts])   # stable, as the JAX package sorts
            rows = ngram.form_ngram(rows, self.args["view_schema"])
            if ngram.dense:
                rows = ngram.densify_windows(rows)
        return rows

    def _read_columns(self, rowgroup, columns):
        """``({column: per-row values}, rows)`` of the row group's
        ``columns``, hive partition keys included."""
        if self._files is None:
            from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext
            ctx = DatasetContext(self.args["dataset_url"],
                                 storage_options=self.args.get("storage_options"),
                                 filesystem=self.args.get("filesystem"))
            self._files = _ParquetFileLRU(ctx.filesystem)
        pf = self._files.get(rowgroup.path)
        names = set(pf.schema_arrow.names)
        # Workers are the parallelism unit: arrow's own threads would only
        # oversubscribe the cores.
        table = pf.read_row_group(rowgroup.row_group,
                                  columns=[c for c in sorted(columns) if c in names],
                                  use_threads=False)
        data = {name: _column_values(table.column(name)) for name in table.column_names}
        # Hive partition keys are path components, not file columns.
        for key, value in rowgroup.partition_values:
            if key in columns and key not in data:
                data[key] = [value] * table.num_rows
        return data, table.num_rows

    def _load_columns_with_predicate(self, rowgroup, predicate, drop_part, rng):
        """``(columns, surviving indices)``: the predicate's columns read and
        decoded whole, one mask, the drop partition's indices (shuffled)
        kept where the mask is set; the other columns are read only when
        a row passes."""
        from petastorm_tpu_torch.predicates import evaluate_predicate_mask
        schema = self.args["schema"]
        predicate_fields = set(predicate.get_fields())
        unknown = predicate_fields - set(schema.fields) - {k for k, _ in rowgroup.partition_values}
        if unknown:
            raise ValueError(f"Predicate references unknown fields: {sorted(unknown)}")
        pred_data, num_rows = self._read_columns(rowgroup, predicate_fields)
        # The predicate sees decoded values; partition keys pass through raw.
        pred_schema = schema.create_schema_view(
            [n for n in sorted(predicate_fields) if n in schema.fields])
        decoded = self._decode_columns(pred_data, np.arange(num_rows), pred_schema)
        passthrough = {k: pred_data[k] for k in predicate_fields
                       if k in pred_data and k not in pred_schema.fields}
        mask = evaluate_predicate_mask(predicate, {**passthrough, **decoded}, num_rows)
        if not mask.any():
            return pred_data, np.empty(0, np.intp)
        indices = select_drop_partition(num_rows, *drop_part, self.args["shuffle_rows"], rng)
        indices = indices[mask[indices]]
        other = self._needed - predicate_fields
        if other:
            other_data, _ = self._read_columns(rowgroup, other)
            return {**pred_data, **other_data}, indices
        return pred_data, indices

    def _decode_columns(self, data: dict, indices, schema=None) -> dict:
        """``{name: decoded values}`` of the selected rows of every column
        of ``schema`` (the needed fields by default) that ``data`` holds."""
        plan = (self._decode_schema if schema is None else schema).decode_plan
        return {name: self._decode(field, codec, data[name], indices)
                for name, field, codec in plan if name in data}

    def _decode(self, field, codec, src, indices):
        """Decode the selected rows of one column: an image column in one
        native call when :func:`~petastorm_tpu_torch.utils.decode.batch_decode_images`
        takes it, anything else by :func:`_decode_column`."""
        from petastorm_tpu_torch.utils.decode import batch_decode_images, native_image_eligible
        if not isinstance(codec, CompressedImageCodec):
            return _decode_column(field, codec, src, indices)
        if (not self._native_img_skip.should_skip(field.name)
                and native_image_eligible(field, codec)):
            batched = batch_decode_images(field, codec, [src[i] for i in indices],
                                          skip_memo=self._native_img_skip,
                                          n_threads=self.args.get("decode_threads"))
            if batched is not None:
                rows, n_native = batched
                self._count("images_native", n_native)
                self._count("images_codec", len(rows) - n_native)
                return rows
        decoded = _decode_column(field, codec, src, indices)
        self._count("images_codec", sum(v is not None for v in decoded))
        return decoded

    def _count(self, name: str, n: int) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def take_counters(self) -> dict:
        counters, self._counters = self._counters, {}
        return counters

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
                arr = np.asarray(self._decode(field, codec, data[name], idx))
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
