"""Dataset metadata: schema storage/recovery and row-group enumeration.

Metadata lives in the key-value section of the dataset's
``_common_metadata`` Parquet sidecar, under the same keys the JAX package
writes:

* ``petastorm-tpu.unischema.v1`` — the Unischema as a JSON document;
* ``petastorm-tpu.num_row_groups_per_file.v1`` — JSON map of relative file
  path -> row-group count, so planning never scans footers.

Stores written by petastorm itself keep their schema as a pickle under
``dataset-toolkit.unischema.v1``, read through the restricted unpickler of
:mod:`petastorm_tpu_torch.etl.legacy`, and their row-groups-per-file map
under ``dataset-toolkit.num_row_groups_per_file.v1``.

A dataset is one root URL or a list of data-file URLs in one filesystem (a
multi-URL view, :attr:`DatasetContext.is_multi_path`), whose metadata cannot
be written. :func:`load_row_groups` plans from, in this order, the stored
row-groups-per-file map, the parent directory's map of a multi-URL view, the
summary ``_metadata`` sidecar's row groups, and a scan of the footers; the
first three read no data file.

:func:`load_row_group_stats` reads the footers' per-row-group column
statistics (:class:`ColumnStats`) for the reader's plan-time pruning: from
the summary ``_metadata`` sidecar when the store has one, else from the
footers of the files concerned.
"""
from __future__ import annotations

import json
import logging
import os
import posixpath
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError, MetadataGenerationError
from petastorm_tpu_torch.discovery.listing import list_data_files
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.predicates import _is_nan
from petastorm_tpu_torch.unischema import Unischema

logger = logging.getLogger(__name__)

UNISCHEMA_KEY = b"petastorm-tpu.unischema.v1"
ROW_GROUPS_PER_FILE_KEY = b"petastorm-tpu.num_row_groups_per_file.v1"
LEGACY_UNISCHEMA_KEY = b"dataset-toolkit.unischema.v1"
LEGACY_ROW_GROUPS_PER_FILE_KEY = b"dataset-toolkit.num_row_groups_per_file.v1"

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


@dataclass(frozen=True)
class ColumnStats:
    """One column's statistics in one row group, as the Parquet footer
    records them (pyarrow's logical values). ``has_min_max=False``: the
    bounds are absent or unusable (statistics off at write time, or a NaN
    bound), and the pruner lets the group through. A None count means not
    recorded, never zero."""
    min: object = None
    max: object = None
    null_count: Optional[int] = None
    num_rows: Optional[int] = None
    has_min_max: bool = False


def _column_stats_for_row_group(rg_meta, columns: set) -> Dict[str, ColumnStats]:
    """``{column: ColumnStats}`` of one footer row group, for the top-level
    ``columns`` (a nested path such as ``col.list.element`` bounds the
    elements, not the rows, and is skipped). A NaN bound drops the pair,
    by the predicates' own NaN rule."""
    out: Dict[str, ColumnStats] = {}
    num_rows = rg_meta.num_rows
    for j in range(rg_meta.num_columns):
        cc = rg_meta.column(j)
        name = cc.path_in_schema
        if "." in name or name not in columns or name in out:
            continue
        if not cc.is_stats_set or cc.statistics is None:
            out[name] = ColumnStats(num_rows=num_rows)
            continue
        st = cc.statistics
        has_min_max = bool(st.has_min_max) and not _is_nan(st.min) and not _is_nan(st.max)
        out[name] = ColumnStats(min=st.min if has_min_max else None,
                                max=st.max if has_min_max else None,
                                null_count=st.null_count if st.has_null_count else None,
                                num_rows=num_rows, has_min_max=has_min_max)
    return out


def _read_summary_metadata(ctx: "DatasetContext"):
    """The summary ``_metadata`` sidecar's ``pq.FileMetaData``, or None when
    it is absent, unreadable or holds no row group (a schema-only sidecar),
    or for a multi-URL view."""
    if ctx.is_multi_path:
        return None
    p = posixpath.join(ctx.root_path, "_metadata")
    try:
        if not ctx.filesystem.exists(p):
            return None
        with ctx.filesystem.open(p, "rb") as f:
            md = pq.read_metadata(f)
    except (OSError, ValueError):
        # ValueError covers pyarrow's ArrowInvalid: a corrupt summary falls
        # back to the footers.
        return None
    return md if md.num_row_groups else None


def load_row_group_stats(ctx: "DatasetContext", row_groups, columns, telemetry=None,
                         retry_policy=None) -> Dict[tuple, Dict[str, ColumnStats]]:
    """``{(path, ordinal): {column: ColumnStats}}`` of the given
    :class:`RowGroupRef` s, for ``columns``: from the summary ``_metadata``
    when the store has one (one read for every file), else from a threaded
    scan of the footers of the files the groups lie in.

    A footer that cannot be read gives no statistics (its groups are never
    pruned: planning does not fail on an optimization), after the retries
    of ``retry_policy`` (default the workers' read policy); each such file
    adds one to ``io.stats_footer_errors_total`` and logs a warning with the
    classifier's verdict."""
    columns = set(columns)
    wanted_paths = {rg.path for rg in row_groups}
    out: Dict[tuple, Dict[str, ColumnStats]] = {}

    md = _read_summary_metadata(ctx)
    if md is not None:
        seen_per_file: Dict[str, int] = {}
        for i in range(md.num_row_groups):
            rg = md.row_group(i)
            rel = rg.column(0).file_path
            if not rel:
                out.clear()
                break   # a malformed summary: the footers instead
            path = posixpath.join(ctx.root_path, rel)
            ordinal = seen_per_file.get(path, 0)
            seen_per_file[path] = ordinal + 1
            if path in wanted_paths:
                out[(path, ordinal)] = _column_stats_for_row_group(rg, columns)

    missing_paths = sorted({rg.path for rg in row_groups if (rg.path, rg.row_group) not in out})
    if missing_paths:
        from petastorm_tpu_torch.resilience import (DEFAULT_READ_POLICY, PERMANENT,
                                                    default_io_classifier)
        policy = retry_policy if retry_policy is not None else DEFAULT_READ_POLICY
        errors = (telemetry.counter("io.stats_footer_errors_total")
                  if telemetry is not None else None)

        def _read_footer(path):
            with ctx.filesystem.open(path, "rb") as f:
                return pq.ParquetFile(f).metadata

        def _scan(path):
            try:
                footer = policy.call(_read_footer, path)
            except (OSError, ValueError) as e:
                verdict = default_io_classifier(e)
                if errors is not None:
                    errors.add(1)
                logger.warning("statistics footer scan failed for %s (%s, %s%s); its row "
                               "groups will not be pruned", path, type(e).__name__, verdict,
                               "" if verdict == PERMANENT
                               else f" after {policy.max_attempts} attempt(s)")
                return path, None
            return path, [_column_stats_for_row_group(footer.row_group(i), columns)
                          for i in range(footer.num_row_groups)]

        with ThreadPoolExecutor(max_workers=10) as pool:
            for path, per_group in pool.map(_scan, missing_paths):
                for ordinal, stats in enumerate(per_group or ()):
                    out[(path, ordinal)] = stats
    return out


class DatasetContext:
    """Resolved handle on a dataset, one root or a multi-URL view:
    filesystem, path or paths, and lazily read metadata key-values.
    ``hadoop_configuration``, ``storage_options`` and ``filesystem`` go to
    :class:`~petastorm_tpu_torch.fs_utils.FilesystemResolver`."""

    def __init__(self, dataset_url_or_urls: Union[str, Sequence[str]],
                 storage_options: Optional[dict] = None, filesystem=None,
                 hadoop_configuration=None):
        self.filesystem, self.path_or_paths = get_filesystem_and_path_or_paths(
            dataset_url_or_urls, hadoop_configuration=hadoop_configuration,
            storage_options=storage_options, filesystem=filesystem)
        self._file_paths: Optional[List[str]] = None
        self._kv_metadata: Optional[Dict[bytes, bytes]] = None
        self._arrow_schema = None

    @property
    def is_multi_path(self) -> bool:
        """A list of URLs (a view of data files), not one root."""
        return isinstance(self.path_or_paths, list)

    @property
    def root_path(self) -> str:
        """The root, or a multi-URL view's first path."""
        return self.path_or_paths[0] if self.is_multi_path else self.path_or_paths

    def file_paths(self) -> List[str]:
        """Every data file under the root, sorted for deterministic plans,
        listed through the discovery plane's one listing path under its
        default retry policy (a plan-time context predates the reader's
        fault plan, registry and deadline; the watcher's polls carry them)."""
        if self._file_paths is None:
            self._file_paths = list_data_files(self.filesystem, self.path_or_paths)
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
                    raise MetadataError(f"No parquet files found under {self.path_or_paths}")
                with self.filesystem.open(files[0], "rb") as f:
                    schema = pq.ParquetFile(f).schema_arrow
            self._arrow_schema = schema
        return self._arrow_schema

    def _read_sidecar_schema(self, name):
        if self.is_multi_path:
            return None
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


def _expand_row_groups(ctx: DatasetContext, path_counts) -> List[RowGroupRef]:
    """``[(file path, row-group count)]``, in order, as one ref a group."""
    return [RowGroupRef(path, i, ctx.partition_values_for(path))
            for path, count in path_counts for i in range(count)]


def summary_row_group_row_counts(ctx: DatasetContext) -> Optional[Dict[str, List[int]]]:
    """``{file path: [rows of each group]}`` from the summary ``_metadata``
    sidecar, in its order, or None without a usable summary: one read in
    place of every footer."""
    md = _read_summary_metadata(ctx)
    if md is None:
        return None
    out: Dict[str, List[int]] = {}
    for i in range(md.num_row_groups):
        rg = md.row_group(i)
        rel = rg.column(0).file_path
        if not rel:
            return None   # a malformed summary: a group without its file
        out.setdefault(posixpath.join(ctx.root_path, rel), []).append(rg.num_rows)
    return out


def _row_groups_from_summary_metadata(ctx: DatasetContext,
                                      files: List[str]) -> Optional[List[RowGroupRef]]:
    """The row groups the summary ``_metadata`` sidecar lists, with no
    footer read; None without a usable summary (absent, schema-only,
    malformed, or stale: its files are not those on disk)."""
    md = _read_summary_metadata(ctx)
    if md is None:
        return None
    per_file: Dict[str, int] = {}
    for i in range(md.num_row_groups):
        file_path = md.row_group(i).column(0).file_path
        if not file_path:
            return None
        per_file[file_path] = per_file.get(file_path, 0) + 1
    by_rel = {os.path.relpath(f, ctx.root_path): f for f in files}
    if set(per_file) != set(by_rel):
        logger.warning("Summary _metadata is stale (%d summarized files, %d on disk); "
                       "falling back", len(per_file), len(by_rel))
        return None
    return _expand_row_groups(ctx, [(by_rel[rel], per_file[rel]) for rel in sorted(per_file)])


def _multi_path_parent_index(ctx: DatasetContext, files: List[str]) -> Optional[Dict[str, int]]:
    """``{file: row groups}`` of a multi-URL view whose files share one
    directory, from that directory's ``_common_metadata`` map (this
    package's key, else petastorm's); None when they do not, or when a file
    is not in the map."""
    parents = {posixpath.dirname(f) for f in files}
    if len(parents) != 1:
        return None
    sidecar = posixpath.join(parents.pop(), "_common_metadata")
    try:
        if not ctx.filesystem.exists(sidecar):
            return None
        with ctx.filesystem.open(sidecar, "rb") as f:
            kv = pq.read_schema(f).metadata or {}
    except (OSError, ValueError):
        return None
    for key in (ROW_GROUPS_PER_FILE_KEY, LEGACY_ROW_GROUPS_PER_FILE_KEY):
        if key in kv:
            index = json.loads(kv[key].decode("utf-8"))
            break
    else:
        return None
    per_file = {}
    for f in files:
        rel = posixpath.basename(f)
        if rel not in index:
            return None   # a listed file the map lacks: the footers instead
        per_file[f] = index[rel]
    return per_file


def load_row_groups(ctx: DatasetContext) -> List[RowGroupRef]:
    """Every row group of the dataset, in deterministic order, from the
    first of:

    1. the metadata's row-groups-per-file map (this package's key, then
       petastorm's), when it names exactly the files on disk;
    2. for a multi-URL view, its files' parent directory's map;
    3. the summary ``_metadata`` sidecar's row groups;
    4. a threaded scan of every data file's footer.
    """
    kv = ctx.key_value_metadata()
    per_file: Optional[Dict[str, int]] = None
    for key in (ROW_GROUPS_PER_FILE_KEY, LEGACY_ROW_GROUPS_PER_FILE_KEY):
        if key in kv:
            per_file = json.loads(kv[key].decode("utf-8"))
            break

    files = ctx.file_paths()
    if per_file is not None and not ctx.is_multi_path:
        by_rel = {os.path.relpath(f, ctx.root_path): f for f in files}
        missing = [rel for rel in per_file if rel not in by_rel]
        unindexed = [rel for rel in by_rel if rel not in per_file]
        if not (missing or unindexed):
            return _expand_row_groups(ctx, [(by_rel[rel], per_file[rel])
                                            for rel in sorted(per_file)])
        logger.warning("Metadata row-group index is stale (%d indexed files absent on disk, "
                       "%d on-disk files not indexed: appended without regenerating "
                       "metadata?); falling back to footer scan", len(missing), len(unindexed))

    if ctx.is_multi_path:
        by_file = _multi_path_parent_index(ctx, files)
        if by_file is not None:
            return _expand_row_groups(ctx, [(f, by_file[f]) for f in files])

    summary = _row_groups_from_summary_metadata(ctx, files)
    if summary is not None:
        return summary

    def _count(path):
        with ctx.filesystem.open(path, "rb") as f:
            return path, pq.ParquetFile(f).metadata.num_row_groups

    with ThreadPoolExecutor(max_workers=10) as pool:
        counts = dict(pool.map(_count, files))
    return _expand_row_groups(ctx, [(f, counts[f]) for f in files])


def get_schema(ctx: DatasetContext) -> Unischema:
    """The Unischema stored in the dataset metadata: this package's JSON
    document, else petastorm's pickle through the restricted unpickler."""
    kv = ctx.key_value_metadata()
    if UNISCHEMA_KEY in kv:
        return Unischema.from_dict(json.loads(kv[UNISCHEMA_KEY].decode("utf-8")))
    if LEGACY_UNISCHEMA_KEY in kv:
        from petastorm_tpu_torch.etl.legacy import depickle_legacy_unischema
        return depickle_legacy_unischema(kv[LEGACY_UNISCHEMA_KEY])
    raise MetadataError(
        f"Could not find a Unischema in dataset metadata at {ctx.path_or_paths}. "
        "Was the dataset written with materialize_dataset_local()?")


def infer_or_load_unischema(ctx: DatasetContext) -> Unischema:
    """The stored Unischema, or one inferred from the store's Arrow schema
    (:meth:`Unischema.from_arrow_schema`, unsupported columns left out) for
    a plain Parquet store."""
    try:
        return get_schema(ctx)
    except MetadataError:
        return Unischema.from_arrow_schema(ctx.arrow_schema(), omit_unsupported_fields=True)


def get_schema_from_dataset_url(dataset_url_or_urls, storage_options: Optional[dict] = None,
                                filesystem=None) -> Unischema:
    """The Unischema stored in the metadata of the store at
    ``dataset_url_or_urls`` (one URL or a list)."""
    return get_schema(DatasetContext(dataset_url_or_urls, storage_options=storage_options,
                                     filesystem=filesystem))


def _context(ctx_or_url) -> DatasetContext:
    return ctx_or_url if isinstance(ctx_or_url, DatasetContext) else DatasetContext(ctx_or_url)


def write_dataset_metadata(ctx_or_url, schema: Optional[Unischema],
                           extra_kv: Optional[Dict[bytes, bytes]] = None,
                           file_stats=None) -> dict:
    """(Re)write ``_common_metadata`` of a store (a :class:`DatasetContext`
    or a URL) with the row-groups-per-file map, built from a footer scan of
    every data file, the schema (kept as stored when None) and
    ``extra_kv``. A multi-URL view has no root to write it to:
    ``MetadataGenerationError``.

    Returns the statistics of the same footer pass, ``{"total_rows",
    "file_sizes", "num_files"}``, so a caller that needs them (the Spark
    converter's dataset size) reads no footer again. ``file_stats``
    (``[(path, num_row_groups, num_rows, size)]``, as
    :func:`write_summary_metadata` returns) replaces the footer pass."""
    ctx = _context(ctx_or_url)
    if ctx.is_multi_path:
        raise MetadataGenerationError("Cannot write metadata for a multi-URL dataset view")
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
    if ctx.is_multi_path:
        raise MetadataGenerationError("Cannot write summary metadata for a multi-URL view")
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
                if k in (UNISCHEMA_KEY, ROW_GROUPS_PER_FILE_KEY, LEGACY_UNISCHEMA_KEY,
                         LEGACY_ROW_GROUPS_PER_FILE_KEY)}
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
                        use_summary_metadata: bool = False, filesystem_factory=None):
    """Context manager around a **Spark** Parquet write of ``dataset_url``
    (requires pyspark): sets the Parquet block size (and whether the
    committer writes summary metadata) in the session's Hadoop
    configuration before the caller's write job, stores the Unischema and
    the row-group index after it, and restores the configuration. With
    ``use_summary_metadata`` the summary ``_metadata`` is built from the
    footers (:func:`write_summary_metadata`), whatever the committer does.
    ``filesystem_factory()``, when given, makes the filesystem the metadata
    is written through.
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
        ctx = DatasetContext(dataset_url,
                             filesystem=filesystem_factory() if filesystem_factory else None)
        stats = write_summary_metadata(ctx) if use_summary_metadata else None
        write_dataset_metadata(ctx, schema, file_stats=stats)
    finally:
        for k, v in saved.items():
            if v is None:
                hadoop_conf.unset(k)
            else:
                hadoop_conf.set(k, v)
