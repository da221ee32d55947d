"""Spark DataFrame -> cached Parquet store -> this package's loaders.

``make_spark_converter(df)`` materializes a DataFrame once into a Parquet
store under a parent cache directory and returns a
:class:`SparkDatasetConverter` over it. Converting a DataFrame of the same
analyzed plan again returns the same converter (the cache is keyed by a hash
of the plan); every store is deleted when the process exits, or by
:meth:`SparkDatasetConverter.delete`.

The converter's read side needs no Spark: :meth:`~SparkDatasetConverter.make_device_loader`
hands out a :class:`~petastorm_tpu_torch.loader.BatchedDataLoader` of batches
on the card, sharded over the ``torch.distributed`` ranks;
:meth:`~SparkDatasetConverter.make_torch_dataloader` and
:meth:`~SparkDatasetConverter.make_tf_dataset` are the reference's consumers.
pyspark and tensorflow are imported inside the functions that need them.
"""
from __future__ import annotations

import atexit
import hashlib
import logging
import os
import threading
import time
import uuid
import warnings
from typing import Optional

logger = logging.getLogger(__name__)

#: Spark conf key naming the parent cache directory.
PARENT_CACHE_DIR_URL_CONF = "petastorm.spark.converter.parentCacheDirUrl"

_cache_lock = threading.Lock()
_converter_cache = {}      # (plan hash, parent dir, compression) -> SparkDatasetConverter
_dirs_to_delete = set()


def _delete_cached_dirs():
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
    for url in list(_dirs_to_delete):
        try:
            fs, path = get_filesystem_and_path_or_paths(url)
            fs.rm(path, recursive=True)
        except Exception as e:  # noqa: BLE001 - exit-time cleanup is best effort
            logger.warning("Could not delete converter cache %s: %s", url, e)


atexit.register(_delete_cached_dirs)


class SparkDatasetConverter:
    """A handle on a materialized DataFrame's cached store.

    :param cache_dir_url: URL of the store
    :param dataset_size: rows of the materialized frame
    :param parent_cache_dir_url: the parent cache directory
    """

    def __init__(self, cache_dir_url: str, dataset_size: int,
                 parent_cache_dir_url: Optional[str] = None):
        self.cache_dir_url = cache_dir_url
        self.dataset_size = dataset_size
        self.parent_cache_dir_url = parent_cache_dir_url

    def __len__(self):
        return self.dataset_size

    def make_device_loader(self, batch_size: int, cur_shard="auto",
                           num_epochs: Optional[int] = None, steps_per_epoch="auto",
                           device="cuda", **reader_kwargs):
        """A :class:`~petastorm_tpu_torch.loader.BatchedDataLoader` of the
        store on ``device``, one shard a rank: ``cur_shard="auto"`` reads
        this rank's shard of the ``torch.distributed`` default group (the
        whole store without one). A rank's batch is its slice of the global
        batch, so no layout is taken.

        ``steps_per_epoch="auto"`` cuts every pass at
        :func:`~petastorm_tpu_torch.loader.aligned_steps_per_epoch` when the
        store is read in more than one shard, so ragged shards cannot make
        one rank step into a collective its peers skip; it stands down for
        a ``predicate``, ``rowgroup_selector`` or ``transform_spec``, which
        drop rows the bound counts. Pass an int to choose the count, or
        None for whole passes. The other keywords go to
        :func:`~petastorm_tpu_torch.reader.make_batch_reader`."""
        from petastorm_tpu_torch.loader import BatchedDataLoader, aligned_steps_per_epoch
        from petastorm_tpu_torch.reader import _resolve_shard, make_batch_reader
        if steps_per_epoch == "auto":
            steps_per_epoch = None
            filtered = any(reader_kwargs.get(k) is not None
                           for k in ("predicate", "rowgroup_selector", "transform_spec"))
            if cur_shard is not None and not filtered:
                _, count = _resolve_shard("auto", reader_kwargs.get("shard_count"))
                if count > 1:
                    steps_per_epoch = aligned_steps_per_epoch(
                        self.cache_dir_url, batch_size, shard_count=count,
                        shard_seed=reader_kwargs.get("shard_seed"),
                        filters=reader_kwargs.get("filters"),
                        storage_options=reader_kwargs.get("storage_options"),
                        filesystem=reader_kwargs.get("filesystem"))
        reader = make_batch_reader(self.cache_dir_url, cur_shard=cur_shard,
                                   num_epochs=num_epochs, **reader_kwargs)
        try:
            return BatchedDataLoader(reader, batch_size=batch_size, device=device,
                                     steps_per_epoch=steps_per_epoch)
        except BaseException:
            reader.stop()
            reader.join()
            raise

    def make_tf_dataset(self, batch_size: Optional[int] = None,
                        prefetch: Optional[int] = None,
                        num_epochs: Optional[int] = None,
                        workers_count: Optional[int] = None,
                        shuffling_queue_capacity: Optional[int] = None,
                        **reader_kwargs):
        """``with converter.make_tf_dataset() as dataset:`` a
        ``tf.data.Dataset`` of the store's rows in batches of ``batch_size``
        (32 when None), the unbatched row stream shuffled through
        ``shuffling_queue_capacity`` rows when given, prefetched
        ``prefetch`` batches ahead (tf's AUTOTUNE when None, none at 0).
        The reader is sharded by the launcher's environment ranks unless
        ``cur_shard``/``shard_count`` are given."""
        from petastorm_tpu_torch.reader import make_batch_reader
        from petastorm_tpu_torch.tf_utils import make_petastorm_dataset
        if workers_count is not None:
            reader_kwargs["workers_count"] = workers_count
        reader = make_batch_reader(self.cache_dir_url, num_epochs=num_epochs,
                                   **_apply_env_rank_defaults(reader_kwargs))
        dataset = make_petastorm_dataset(reader).unbatch()
        if shuffling_queue_capacity:
            dataset = dataset.shuffle(shuffling_queue_capacity)
        dataset = dataset.batch(batch_size if batch_size is not None else 32)
        if prefetch != 0:
            import tensorflow as tf
            dataset = dataset.prefetch(prefetch if prefetch is not None else tf.data.AUTOTUNE)
        return _ContextManagedAdapter(dataset, reader)

    def make_torch_dataloader(self, batch_size: int = 32,
                              num_epochs: Optional[int] = None,
                              workers_count: Optional[int] = None,
                              shuffling_queue_capacity: int = 0,
                              data_loader_fn=None, torch_device=None, **reader_kwargs):
        """``with converter.make_torch_dataloader() as loader:`` batches of
        the store from ``data_loader_fn(reader, batch_size=...,
        shuffling_queue_capacity=...)``, by default the torch adapter's
        :class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader` on
        ``torch_device`` (the card when None). ``shuffling_queue_capacity=0``
        does not shuffle. The reader is sharded by the launcher's
        environment ranks unless ``cur_shard``/``shard_count`` are given."""
        from petastorm_tpu_torch.pytorch import BatchedDataLoader
        from petastorm_tpu_torch.reader import make_batch_reader
        if workers_count is not None:
            reader_kwargs["workers_count"] = workers_count
        reader = make_batch_reader(self.cache_dir_url, num_epochs=num_epochs,
                                   **_apply_env_rank_defaults(reader_kwargs))
        if data_loader_fn is None:
            loader = BatchedDataLoader(reader, batch_size=batch_size, torch_device=torch_device,
                                       shuffling_queue_capacity=shuffling_queue_capacity)
        else:
            # The keyword always goes, even at 0: a reference data_loader_fn
            # may require it.
            loader = data_loader_fn(reader, batch_size=batch_size,
                                    shuffling_queue_capacity=shuffling_queue_capacity)
        return _ContextManagedAdapter(loader, reader)

    def delete(self):
        """Delete the cached store now, and forget this converter."""
        from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
        fs, path = get_filesystem_and_path_or_paths(self.cache_dir_url)
        fs.rm(path, recursive=True)
        _dirs_to_delete.discard(self.cache_dir_url)
        with _cache_lock:
            for k, v in list(_converter_cache.items()):
                if v is self:
                    del _converter_cache[k]


class _ContextManagedAdapter:
    """``with converter.make_tf_dataset() as dataset:``: stops and joins the
    reader on exit."""

    def __init__(self, inner, reader):
        self._inner = inner
        self._reader = reader

    def __enter__(self):
        return self._inner

    def __exit__(self, *exc):
        self._reader.stop()
        self._reader.join()
        return False

    def __iter__(self):
        return iter(self._inner)


def _spark_df_plan_hash(df) -> str:
    """A hash of the DataFrame's analyzed logical plan."""
    plan = df._jdf.queryExecution().analyzed().toString()
    return hashlib.sha256(plan.encode("utf-8")).hexdigest()[:24]


def _convert_precision_and_vectors(df, dtype: Optional[str]):
    """Spark ML vector columns -> arrays of ``dtype`` (float64 when None),
    then, when ``dtype`` is given, every double (``"float32"``) or float
    (``"float64"``) column and array element cast to it."""
    from pyspark.sql import functions as F
    from pyspark.sql import types as T
    if dtype is not None and dtype not in ("float32", "float64"):
        # Checked first: vector_to_array's own error for a bad dtype is an
        # opaque JVM one.
        raise ValueError(f"dtype {dtype!r} is not supported. Use 'float32' or 'float64'")
    converted = df
    for field in df.schema.fields:
        if field.dataType.typeName() == "vectorudt":
            from pyspark.ml.functions import vector_to_array
            converted = converted.withColumn(
                field.name, vector_to_array(F.col(field.name), dtype or "float64"))
    if dtype is None:
        return converted
    source_type, target_type = ((T.DoubleType, T.FloatType) if dtype == "float32"
                                else (T.FloatType, T.DoubleType))
    for field in converted.schema.fields:
        if isinstance(field.dataType, source_type):
            converted = converted.withColumn(field.name,
                                             F.col(field.name).cast(target_type()))
        elif (isinstance(field.dataType, T.ArrayType)
              and isinstance(field.dataType.elementType, source_type)):
            converted = converted.withColumn(
                field.name, F.col(field.name).cast(T.ArrayType(target_type())))
    return converted


def _env_rank_discovery():
    """(rank, size) from a launcher's environment (horovodrun, mpirun, a
    PMI launcher), or None."""
    for rank_key, size_key in (("HOROVOD_RANK", "HOROVOD_SIZE"),
                               ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
                               ("PMI_RANK", "PMI_SIZE")):
        rank, size = os.environ.get(rank_key), os.environ.get(size_key)
        if rank is not None and size is not None:
            return int(rank), int(size)
    return None


def _apply_env_rank_defaults(reader_kwargs: dict) -> dict:
    """``cur_shard``/``shard_count`` from the launcher's environment when the
    caller chose no sharding."""
    if "cur_shard" in reader_kwargs or "shard_count" in reader_kwargs:
        return reader_kwargs
    discovered = _env_rank_discovery()
    if discovered is not None and discovered[1] > 1:
        rank, size = discovered
        logger.info("Sharding reader %d/%d from launcher environment", rank, size)
        return dict(reader_kwargs, cur_shard=rank, shard_count=size)
    return reader_kwargs


def _wait_files_available(fs, paths, timeout_s: float = 30.0, poll_interval_s: float = 0.25):
    """Block until every path is visible on ``fs``: object stores whose
    listing lags their writes (S3) may not show fresh files at once."""
    deadline = time.time() + timeout_s
    remaining = list(paths)
    while remaining:
        remaining = [p for p in remaining if not fs.exists(p)]
        if not remaining:
            return
        if time.time() > deadline:
            raise RuntimeError(
                f"Timed out after {timeout_s}s waiting for materialized files to become "
                f"visible: {remaining[:3]}{'...' if len(remaining) > 3 else ''}")
        time.sleep(poll_interval_s)


def _check_parquet_file_sizes(sizes):
    """Warn when the median materialized file is under 50 MB."""
    if sizes and sorted(sizes)[len(sizes) // 2] < 50 * (1 << 20):
        warnings.warn("The median materialized Parquet file is smaller than 50 MB; "
                      "repartition the DataFrame to fewer partitions for better read "
                      "throughput.")


def make_spark_converter(df, parent_cache_dir_url: Optional[str] = None,
                         compression_codec: Optional[str] = None,
                         dtype: Optional[str] = "float32") -> SparkDatasetConverter:
    """Materialize ``df`` once into a cached Parquet store under
    ``parent_cache_dir_url`` (or the ``PARENT_CACHE_DIR_URL_CONF`` Spark
    conf) and return its converter; a DataFrame of the same plan returns
    the same converter. ``dtype`` unifies float precision
    (:func:`_convert_precision_and_vectors`). The row count comes from the
    store's footers, so the query does not run twice. Requires pyspark."""
    try:
        from pyspark.sql import SparkSession
    except ImportError as e:
        raise ImportError("make_spark_converter requires pyspark") from e

    spark = SparkSession.builder.getOrCreate()
    if parent_cache_dir_url is None:
        parent_cache_dir_url = spark.conf.get(PARENT_CACHE_DIR_URL_CONF, None)
    if not parent_cache_dir_url:
        raise ValueError(f"No cache directory: pass parent_cache_dir_url or set the "
                         f"{PARENT_CACHE_DIR_URL_CONF} Spark conf")

    df = _convert_precision_and_vectors(df, dtype)
    key = (_spark_df_plan_hash(df), parent_cache_dir_url, compression_codec)
    with _cache_lock:
        if key in _converter_cache:
            return _converter_cache[key]

    cache_dir_url = os.path.join(parent_cache_dir_url, uuid.uuid4().hex)
    writer = df.write
    if compression_codec:
        writer = writer.option("compression", compression_codec)
    writer.parquet(cache_dir_url)
    # Registered before any bookkeeping that could fail: the files must not
    # outlive the process.
    _dirs_to_delete.add(cache_dir_url)

    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
    if cache_dir_url.split("://", 1)[0] in ("s3", "s3a", "s3n", "gs"):
        fs, path = get_filesystem_and_path_or_paths(cache_dir_url)
        _wait_files_available(fs, [path.rstrip("/") + "/_SUCCESS"])

    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset_metadata
    try:
        stats = write_dataset_metadata(cache_dir_url, None)
        dataset_size = stats["total_rows"]
        _check_parquet_file_sizes(stats["file_sizes"])
    except Exception as e:  # noqa: BLE001 - the store stays readable through its footers
        logger.warning("Could not index the materialized store (%s); readers will scan "
                       "footers and dataset_size falls back to a Spark count", e)
        dataset_size = df.count()

    converter = SparkDatasetConverter(cache_dir_url, dataset_size, parent_cache_dir_url)
    with _cache_lock:
        _converter_cache[key] = converter
    return converter
