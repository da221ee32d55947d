"""Dataset metadata: schema storage/recovery and row-group enumeration.

Metadata lives in the key-value section of the dataset's
``_common_metadata`` Parquet sidecar, under the same keys the JAX package
writes:

* ``petastorm-tpu.unischema.v1`` — the Unischema as a JSON document;
* ``petastorm-tpu.num_row_groups_per_file.v1`` — JSON map of relative file
  path -> row-group count, so planning never scans footers.

Reference petastorm stores, whose schema is a pickle under
``dataset-toolkit.unischema.v1``, are not read by this package yet.
"""
from __future__ import annotations

import json
import logging
import os
import posixpath
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError, MetadataGenerationError
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.unischema import Unischema

logger = logging.getLogger(__name__)

UNISCHEMA_KEY = b"petastorm-tpu.unischema.v1"
ROW_GROUPS_PER_FILE_KEY = b"petastorm-tpu.num_row_groups_per_file.v1"
LEGACY_UNISCHEMA_KEY = b"dataset-toolkit.unischema.v1"

_METADATA_FILENAMES = ("_metadata", "_common_metadata")


@dataclass(frozen=True)
class RowGroupRef:
    """One unit of read work: a single row group of a single Parquet file."""
    path: str                      # filesystem path of the parquet file
    row_group: int                 # row-group ordinal within the file
    partition_values: tuple = ()   # hive-style ((key, value), ...) from the path

    @property
    def partition_dict(self) -> dict:
        return dict(self.partition_values)


def is_data_file(path: str) -> bool:
    """Hidden files and sidecars (``_metadata``, ``_common_metadata``,
    dotfiles) are never data; ``*.parquet``/``*.parq`` or extension-less
    files are."""
    base = posixpath.basename(path)
    if base.startswith(("_", ".")):
        return False
    return base.endswith((".parquet", ".parq")) or "." not in base


class DatasetContext:
    """Resolved handle on one dataset root: filesystem, root path, and
    lazily read metadata key-values. ``storage_options`` and ``filesystem``
    go to :class:`~petastorm_tpu_torch.fs_utils.FilesystemResolver`."""

    def __init__(self, dataset_url: str, storage_options: Optional[dict] = None,
                 filesystem=None):
        self.filesystem, self.root_path = get_filesystem_and_path_or_paths(
            dataset_url, storage_options=storage_options, filesystem=filesystem)
        self._file_paths: Optional[List[str]] = None
        self._kv_metadata: Optional[Dict[bytes, bytes]] = None
        self._arrow_schema = None

    def file_paths(self) -> List[str]:
        """Every data file under the root, sorted for deterministic plans."""
        if self._file_paths is None:
            self._file_paths = sorted(
                f for f in self.filesystem.find(self.root_path) if is_data_file(f))
        return self._file_paths

    def arrow_schema(self):
        """The store's Arrow schema: the ``_common_metadata`` or
        ``_metadata`` sidecar's, else the first data file's."""
        if self._arrow_schema is None:
            schema = (self._read_sidecar_schema("_common_metadata")
                      or self._read_sidecar_schema("_metadata"))
            if schema is None:
                files = self.file_paths()
                if not files:
                    raise MetadataError(f"No parquet files found under {self.root_path}")
                with self.filesystem.open(files[0], "rb") as f:
                    schema = pq.ParquetFile(f).schema_arrow
            self._arrow_schema = schema
        return self._arrow_schema

    def _read_sidecar_schema(self, name):
        p = posixpath.join(self.root_path, name)
        try:
            if not self.filesystem.exists(p):
                return None
            with self.filesystem.open(p, "rb") as f:
                return pq.read_schema(f)
        except (OSError, ValueError):
            # ValueError covers pyarrow's ArrowInvalid: a corrupt sidecar
            # is treated as absent.
            return None

    def key_value_metadata(self) -> Dict[bytes, bytes]:
        """Merged key-values of ``_metadata`` and ``_common_metadata`` (the
        latter wins ties)."""
        if self._kv_metadata is None:
            merged: Dict[bytes, bytes] = {}
            for name in _METADATA_FILENAMES:
                schema = self._read_sidecar_schema(name)
                if schema is not None and schema.metadata:
                    merged.update(schema.metadata)
            self._kv_metadata = merged
        return self._kv_metadata

    def partition_values_for(self, file_path: str) -> tuple:
        """Hive-style partition key/values from the file's directories."""
        rel = os.path.relpath(file_path, self.root_path)
        parts = []
        for comp in rel.split("/")[:-1]:
            if "=" in comp:
                k, _, v = comp.partition("=")
                parts.append((k, v))
        return tuple(parts)


def load_row_groups(ctx: DatasetContext) -> List[RowGroupRef]:
    """Every row group of the dataset, in deterministic order: from the
    metadata's row-groups-per-file index when it matches the files on disk,
    else from a footer scan of every data file."""
    kv = ctx.key_value_metadata()
    per_file: Optional[Dict[str, int]] = None
    if ROW_GROUPS_PER_FILE_KEY in kv:
        per_file = json.loads(kv[ROW_GROUPS_PER_FILE_KEY].decode("utf-8"))

    files = ctx.file_paths()
    by_rel = {os.path.relpath(f, ctx.root_path): f for f in files}
    if per_file is not None and set(per_file) == set(by_rel):
        counts = [(by_rel[rel], per_file[rel]) for rel in sorted(per_file)]
    else:
        if per_file is not None:
            logger.warning("Metadata row-group index does not match the files "
                           "on disk; scanning footers")

        def _count(path):
            with ctx.filesystem.open(path, "rb") as f:
                return path, pq.ParquetFile(f).metadata.num_row_groups

        with ThreadPoolExecutor(max_workers=10) as pool:
            counts = list(pool.map(_count, files))
    return [RowGroupRef(path, i, ctx.partition_values_for(path))
            for path, count in counts for i in range(count)]


def get_schema(ctx: DatasetContext) -> Unischema:
    """The Unischema stored in the dataset metadata."""
    kv = ctx.key_value_metadata()
    if UNISCHEMA_KEY in kv:
        return Unischema.from_dict(json.loads(kv[UNISCHEMA_KEY].decode("utf-8")))
    if LEGACY_UNISCHEMA_KEY in kv:
        raise MetadataError(
            f"{ctx.root_path} carries a pickled reference-petastorm schema, which "
            f"petastorm_tpu_torch cannot read yet")
    raise MetadataError(
        f"Could not find a Unischema in dataset metadata at {ctx.root_path}. "
        "Was the dataset written with materialize_dataset_local()?")


def infer_or_load_unischema(ctx: DatasetContext) -> Unischema:
    """The stored Unischema, or one inferred from the store's Arrow schema
    (:meth:`Unischema.from_arrow_schema`, unsupported columns left out) for
    a plain Parquet store."""
    try:
        return get_schema(ctx)
    except MetadataError:
        return Unischema.from_arrow_schema(ctx.arrow_schema(), omit_unsupported_fields=True)


def get_schema_from_dataset_url(dataset_url: str, storage_options: Optional[dict] = None,
                                filesystem=None) -> Unischema:
    """The Unischema stored in the metadata of the store at ``dataset_url``."""
    return get_schema(DatasetContext(dataset_url, storage_options=storage_options,
                                     filesystem=filesystem))


def _context(ctx_or_url) -> DatasetContext:
    return ctx_or_url if isinstance(ctx_or_url, DatasetContext) else DatasetContext(ctx_or_url)


def write_dataset_metadata(ctx_or_url, schema: Optional[Unischema],
                           extra_kv: Optional[Dict[bytes, bytes]] = None,
                           file_stats=None) -> dict:
    """(Re)write ``_common_metadata`` of a store (a :class:`DatasetContext`
    or a URL) with the row-groups-per-file map, built from a footer scan of
    every data file, the schema (kept as stored when None) and
    ``extra_kv``.

    Returns the statistics of the same footer pass, ``{"total_rows",
    "file_sizes", "num_files"}``, so a caller that needs them (the Spark
    converter's dataset size) reads no footer again. ``file_stats``
    (``[(path, num_row_groups, num_rows, size)]``, as
    :func:`write_summary_metadata` returns) replaces the footer pass."""
    ctx = _context(ctx_or_url)
    files = ctx.file_paths()
    if not files:
        raise MetadataGenerationError(f"No parquet data files under {ctx.root_path}")

    if file_stats is not None:
        stats = [(os.path.relpath(path, ctx.root_path), n_groups, n_rows, size)
                 for path, n_groups, n_rows, size in file_stats]
    else:
        def _count(path):
            size = ctx.filesystem.info(path)["size"]
            with ctx.filesystem.open(path, "rb") as f:
                md = pq.ParquetFile(f).metadata
            return os.path.relpath(path, ctx.root_path), md.num_row_groups, md.num_rows, size

        with ThreadPoolExecutor(max_workers=10) as pool:
            stats = list(pool.map(_count, files))
    per_file = {rel: n_groups for rel, n_groups, _, _ in stats}

    kv: Dict[bytes, bytes] = dict(ctx.key_value_metadata())
    kv[ROW_GROUPS_PER_FILE_KEY] = json.dumps(per_file, sort_keys=True).encode("utf-8")
    if schema is not None:
        kv[UNISCHEMA_KEY] = json.dumps(schema.to_dict()).encode("utf-8")
    if extra_kv:
        kv.update(extra_kv)
    with ctx.filesystem.open(files[0], "rb") as f:
        arrow_schema = pq.ParquetFile(f).schema_arrow
    with ctx.filesystem.open(posixpath.join(ctx.root_path, "_common_metadata"), "wb") as f:
        pq.write_metadata(arrow_schema.with_metadata(kv), f)
    ctx._kv_metadata = None
    return {"total_rows": sum(rows for _, _, rows, _ in stats),
            "file_sizes": [size for _, _, _, size in stats],
            "num_files": len(files)}


def write_summary_metadata(ctx_or_url) -> list:
    """Write a summary ``_metadata`` sidecar holding every data file's row
    groups (each tagged with its ``file_path``), so any Parquet planner can
    split the store without reading a footer. Schema keys that only the old
    ``_metadata`` held are moved into ``_common_metadata`` first. Returns
    ``[(path, num_row_groups, num_rows, size)]`` for
    :func:`write_dataset_metadata`'s ``file_stats``."""
    ctx = _context(ctx_or_url)
    files = ctx.file_paths()
    if not files:
        raise MetadataGenerationError(f"No parquet data files under {ctx.root_path}")
    sidecar_path = posixpath.join(ctx.root_path, "_metadata")
    common_path = posixpath.join(ctx.root_path, "_common_metadata")
    try:
        old_kv = {}
        if ctx.filesystem.exists(sidecar_path):
            with ctx.filesystem.open(sidecar_path, "rb") as f:
                old_kv = pq.read_schema(f).metadata or {}
        kept = {k: v for k, v in old_kv.items()
                if k in (UNISCHEMA_KEY, ROW_GROUPS_PER_FILE_KEY, LEGACY_UNISCHEMA_KEY)}
        if kept:
            if ctx.filesystem.exists(common_path):
                with ctx.filesystem.open(common_path, "rb") as f:
                    common_schema = pq.read_schema(f)
            else:
                with ctx.filesystem.open(files[0], "rb") as f:
                    common_schema = pq.ParquetFile(f).schema_arrow
            common_kv = dict(common_schema.metadata or {})
            rescued = {k: v for k, v in kept.items() if k not in common_kv}
            if rescued:
                with ctx.filesystem.open(common_path, "wb") as f:
                    pq.write_metadata(common_schema.with_metadata({**common_kv, **rescued}), f)
    except (OSError, ValueError):
        logger.warning("Could not read the old _metadata's key-values; summarizing anyway",
                       exc_info=True)

    def _read_md(path):
        size = ctx.filesystem.info(path)["size"]
        with ctx.filesystem.open(path, "rb") as f:
            md = pq.ParquetFile(f).metadata
        md.set_file_path(os.path.relpath(path, ctx.root_path))
        return path, md, size

    with ThreadPoolExecutor(max_workers=10) as pool:
        collected = list(pool.map(_read_md, files))
    # Counted before the merge: append_row_groups grows the first file's
    # metadata in place.
    stats = [(path, md.num_row_groups, md.num_rows, size) for path, md, size in collected]
    merged = collected[0][1]
    for _, md, _ in collected[1:]:
        merged.append_row_groups(md)
    with ctx.filesystem.open(sidecar_path, "wb") as f:
        merged.write_metadata_file(f)
    ctx._kv_metadata = None
    return stats


@contextmanager
def materialize_dataset(spark, dataset_url: str, schema: Unischema,
                        row_group_size_mb: Optional[int] = None,
                        use_summary_metadata: bool = False):
    """Context manager around a **Spark** Parquet write of ``dataset_url``
    (requires pyspark): sets the Parquet block size (and whether the
    committer writes summary metadata) in the session's Hadoop
    configuration before the caller's write job, stores the Unischema and
    the row-group index after it, and restores the configuration. With
    ``use_summary_metadata`` the summary ``_metadata`` is built from the
    footers (:func:`write_summary_metadata`), whatever the committer does.
    For a write without Spark use
    :func:`petastorm_tpu_torch.etl.writer.materialize_dataset_local`."""
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError("materialize_dataset requires pyspark. For a write without Spark "
                          "use petastorm_tpu_torch.etl.writer.materialize_dataset_local") from e
    hadoop_conf = spark.sparkContext._jsc.hadoopConfiguration()
    keys = ("parquet.block.size", "parquet.enable.summary-metadata")
    saved = {k: hadoop_conf.get(k) for k in keys}
    if row_group_size_mb is not None:
        hadoop_conf.setInt("parquet.block.size", row_group_size_mb * (1 << 20))
    hadoop_conf.setBoolean("parquet.enable.summary-metadata", bool(use_summary_metadata))
    try:
        yield
        ctx = DatasetContext(dataset_url)
        stats = write_summary_metadata(ctx) if use_summary_metadata else None
        write_dataset_metadata(ctx, schema, file_stats=stats)
    finally:
        for k, v in saved.items():
            if v is None:
                hadoop_conf.unset(k)
            else:
                hadoop_conf.set(k, v)
