"""Build and extend the field -> row-group index (the JAX package's
``petastorm_tpu.index`` build functions, in the same module there).

:func:`build_field_index` enumerates the row groups the way the reader
plans them (:func:`~petastorm_tpu_torch.etl.dataset_metadata.load_row_groups`)
and a thread pool reads only the key columns of each group, recording each
value's exact ``(file, row_group, row_offset)``. :func:`extend_field_index`
appends files not yet indexed, bumps the generation and saves; existing
entries are never rewritten.

:func:`index_from_legacy_indexers` bridges the
:mod:`petastorm_tpu_torch.etl.rowgroup_indexers` surface: a legacy indexer
knows only which row groups hold a value, so its entries are
group-granular (:data:`~petastorm_tpu_torch.index.sidecar.GROUP_GRANULAR`)
and a lookup decodes the group and filters it by value.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, load_row_groups
from petastorm_tpu_torch.index.sidecar import GROUP_GRANULAR, FieldIndex

logger = logging.getLogger(__name__)

__all__ = ["build_field_index", "extend_field_index", "index_from_legacy_indexers",
           "scan_files_into_index"]


def _as_ctx(dataset_url_or_ctx) -> DatasetContext:
    return (dataset_url_or_ctx if isinstance(dataset_url_or_ctx, DatasetContext)
            else DatasetContext(dataset_url_or_ctx))


def _index_cell(index: FieldIndex, field: str, value, fidx: int, rg: int, off: int) -> None:
    """One cell's entries: an array-valued key field indexes each element
    (the legacy ``SingleFieldIndexer``'s rule), all at the same row."""
    if value is None:
        return
    if isinstance(value, (list, tuple)) or (hasattr(value, "__len__")
                                            and not isinstance(value, (str, bytes))):
        for v in value:
            if v is not None:
                index.add_entry(field, v, fidx, rg, off)
        return
    index.add_entry(field, value, fidx, rg, off)


def _scan_file(ctx: DatasetContext, path: str, num_row_groups: Optional[int],
               fields: Sequence[str]):
    """``[(num_rows, {field: per-row values}), ...]`` a row group of one
    file: one ``read_row_group(columns=key fields)`` a group."""
    with ctx.filesystem.open(path, "rb") as f:
        pf = pq.ParquetFile(f)
        names = set(pf.schema_arrow.names)
        missing = [c for c in fields if c not in names]
        if missing:
            raise MetadataError(f"key field(s) {missing} not present in {path!r} "
                                f"(available: {sorted(names)})")
        n = num_row_groups if num_row_groups is not None else pf.metadata.num_row_groups
        out = []
        for rg in range(n):
            table = pf.read_row_group(rg, columns=list(fields), use_threads=False)
            out.append((table.num_rows, {c: table.column(c).to_pylist() for c in fields}))
    return out


def scan_files_into_index(ctx: DatasetContext, index: FieldIndex, fields: Sequence[str],
                          files: Sequence[Tuple[str, Optional[int]]],
                          num_workers: int = 10) -> int:
    """Scan ``[(abs_path, num_row_groups or None), ...]`` and append their
    entries to ``index`` in memory (the caller saves). Files the index
    already holds are skipped. Returns how many files were indexed."""
    todo = [(path, n) for path, n in files
            if not index.has_file(os.path.relpath(path, ctx.root_path))]
    if not todo:
        return 0
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        scans = list(pool.map(lambda job: _scan_file(ctx, job[0], job[1], fields), todo))
    # One thread folds, in ``todo`` order: the file ordinals are deterministic.
    for (path, _n), per_group in zip(todo, scans):
        fidx = index.add_file(os.path.relpath(path, ctx.root_path),
                              [rows for rows, _ in per_group])
        for rg, (num_rows, cols) in enumerate(per_group):
            for field in fields:
                values = cols[field]
                for off in range(num_rows):
                    _index_cell(index, field, values[off], fidx, rg, off)
    return len(todo)


def build_field_index(dataset_url_or_ctx, fields: Sequence[str], num_workers: int = 10,
                      save: bool = True) -> FieldIndex:
    """Build (or rebuild) the store's field index over ``fields`` and save
    the sidecar; returns the :class:`FieldIndex`."""
    ctx = _as_ctx(dataset_url_or_ctx)
    fields = list(fields)
    if not fields:
        raise ValueError("build_field_index needs at least one key field")
    per_file: dict = {}
    for rg in load_row_groups(ctx):   # the planning order: sorted paths
        per_file[rg.path] = max(per_file.get(rg.path, 0), rg.row_group + 1)
    index = FieldIndex()
    scan_files_into_index(ctx, index, fields, list(per_file.items()), num_workers=num_workers)
    index.generation = 1
    if save:
        index.save(ctx)
    logger.info("field index built over %s: %d file(s), %d row(s)", fields,
                len(index.files), index.num_rows)
    return index


def extend_field_index(dataset_url_or_ctx, new_files: Optional[Sequence[str]] = None,
                       fields: Optional[Sequence[str]] = None,
                       num_workers: int = 10) -> FieldIndex:
    """Extend the saved sidecar with files not yet indexed (``new_files``,
    absolute paths, or every such file of the store), bump the generation
    and save. Existing files and entries are untouched."""
    ctx = _as_ctx(dataset_url_or_ctx)
    index = FieldIndex.load(ctx)
    fields = list(fields) if fields is not None else index.fields_indexed
    if new_files is None:
        new_files = [p for p in ctx.file_paths()
                     if not index.has_file(os.path.relpath(p, ctx.root_path))]
    added = scan_files_into_index(ctx, index, fields, [(p, None) for p in new_files],
                                  num_workers=num_workers)
    if added:
        index.generation += 1
        index.save(ctx)
    return index


def index_from_legacy_indexers(ctx: DatasetContext, indexers,
                               num_workers: int = 10) -> FieldIndex:
    """A group-granular :class:`FieldIndex` of populated legacy indexers
    (value -> set of global row-group ordinals, in
    :func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index`'s
    enumeration). An indexer without a single key column (e.g.
    ``FieldNotNullIndexer``) does not map onto a keyed index and is skipped
    with a warning."""
    row_groups = load_row_groups(ctx)
    paths = []
    for rg in row_groups:
        if rg.path not in paths:
            paths.append(rg.path)

    def _counts(path):
        with ctx.filesystem.open(path, "rb") as f:
            md = pq.ParquetFile(f).metadata
        return path, [md.row_group(i).num_rows for i in range(md.num_row_groups)]

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        counts = dict(pool.map(_counts, paths))
    index = FieldIndex()
    ordinals = {path: index.add_file(os.path.relpath(path, ctx.root_path), counts[path])
                for path in paths}
    for ix in indexers:
        cols = list(ix.column_names)
        values = ix.indexed_values
        if len(cols) != 1 or (values and not _keyed_values(values)):
            logger.warning("legacy indexer %r does not map onto a keyed field index "
                           "(columns=%s); skipped: query it through "
                           "get_row_group_indexes()", ix.index_name, cols)
            continue
        for value in values:
            for ordinal in ix.get_row_group_indexes(value):
                rg = row_groups[ordinal]
                index.add_entry(cols[0], value, ordinals[rg.path], rg.row_group,
                                GROUP_GRANULAR)
    index.generation = 1
    return index


def _keyed_values(values) -> bool:
    """False for an indexer whose values are markers (``FieldNotNullIndexer``'s
    ``__not_null__``), not keys."""
    return not any(isinstance(v, str) and v.startswith("__") for v in values)
