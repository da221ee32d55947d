"""Keyed point reads over the field index (the JAX package's
``petastorm_tpu/index/lookup.py``).

The plane resolves keys through the saved :class:`FieldIndex`, groups the
keys that share a ``(file, row_group)`` and serves each touched group with
one read through the epoch path's own decode: a
:class:`~petastorm_tpu_torch.reader_impl.row_reader_worker.RowReaderWorker`
with the same cache keys. So a lookup hands out the cells an epoch read of
the same rows hands out, and a lookup and the epoch stream warm each
other's cache. Three cache branches, as in the JAX package: none (read and
decode), the decoded memory cache (shared entries), the raw disk cache
(decoded on every retrieval, as the epoch path does).

Each group's fetch runs under the worker's
:class:`~petastorm_tpu_torch.resilience.RowGroupGuard`: transient errors
are retried per the read policy; in ``degraded_mode`` a give-up is
recorded on the reader's quarantine and its keys are skipped; without it
the error goes to the caller.

Telemetry on the owning registry: the ``index.lookup_s`` histogram and the
``index.lookups_total``, ``keys_requested_total``, ``keys_missing_total``,
``keys_skipped_total``, ``rowgroups_touched_total``, ``rows_served_total``,
``cache_hits_total``, ``cache_misses_total`` and ``growth_files_total``
counters (:func:`~petastorm_tpu_torch.index.gather_rows` adds
``index.gather_rows_total``).

Imports without torch.
"""
from __future__ import annotations

import logging
import posixpath
import time
from typing import Dict, List, Optional, Sequence, Tuple

from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, RowGroupRef
from petastorm_tpu_torch.index.sidecar import GROUP_GRANULAR, FieldIndex, encode_key
from petastorm_tpu_torch.resilience.quarantine import RowGroupSkipped

logger = logging.getLogger(__name__)

__all__ = ["IndexLookupPlane", "matching_offsets"]


class IndexLookupPlane:
    """Keyed point reads over one store: one a reader (made on the first
    :meth:`Reader.lookup <petastorm_tpu_torch.reader.Reader.lookup>`), or
    standalone through :meth:`for_dataset`.

    ``decode_verdict`` and ``decode_threads`` are the reader's image decode
    settings, handed to the plane's workers as to the epoch workers."""

    def __init__(self, ctx: DatasetContext, index: FieldIndex, schema, *, dataset_url=None,
                 storage_options=None, filesystem=None, cache=None, retry_policy=None,
                 degraded_mode: bool = False, fault_plan=None, hedge_policy=None,
                 telemetry=None, quarantine=None,
                 default_columns: Optional[Sequence[str]] = None,
                 decode_verdict=None, decode_threads: Optional[int] = None):
        self._ctx = ctx
        self._index = index
        self._schema = schema
        self._worker_args = {
            "dataset_url": dataset_url if dataset_url is not None else ctx.root_path,
            "storage_options": storage_options, "filesystem": filesystem,
            "schema": schema, "cache": cache, "retry_policy": retry_policy,
            "degraded_mode": degraded_mode, "fault_plan": fault_plan,
            "hedge_policy": hedge_policy, "resilience_telemetry": telemetry,
            "decode_verdict": decode_verdict, "decode_threads": decode_threads,
            "seed": None, "shuffle_rows": False}
        self._cache = cache
        self.quarantine = quarantine
        self._default_columns = (list(default_columns) if default_columns is not None
                                 else sorted(schema.fields.keys()))
        #: One decode worker a needed column set (the set fixes a worker's
        #: decode plan and its cache keys).
        self._workers: Dict[frozenset, object] = {}
        self._telemetry = telemetry
        if telemetry is not None:
            self._h_lookup = telemetry.histogram("index.lookup_s")
            self._c_lookups = telemetry.counter("index.lookups_total")
            self._c_keys = telemetry.counter("index.keys_requested_total")
            self._c_missing = telemetry.counter("index.keys_missing_total")
            self._c_skipped = telemetry.counter("index.keys_skipped_total")
            self._c_groups = telemetry.counter("index.rowgroups_touched_total")
            self._c_rows = telemetry.counter("index.rows_served_total")
            self._c_hits = telemetry.counter("index.cache_hits_total")
            self._c_misses = telemetry.counter("index.cache_misses_total")
            self._c_growth = telemetry.counter("index.growth_files_total")

    @classmethod
    def for_dataset(cls, dataset_url, *, cache=None, telemetry=None, storage_options=None,
                    filesystem=None, **kwargs) -> "IndexLookupPlane":
        """A plane over a store URL, from its saved sidecar and its stored
        (or inferred) Unischema. ``Reader.lookup()`` shares a live reader's
        cache and registry instead."""
        from petastorm_tpu_torch.etl.dataset_metadata import infer_or_load_unischema
        ctx = DatasetContext(dataset_url, storage_options=storage_options,
                             filesystem=filesystem)
        return cls(ctx, FieldIndex.load(ctx), infer_or_load_unischema(ctx),
                   dataset_url=dataset_url, storage_options=storage_options,
                   filesystem=filesystem, cache=cache, telemetry=telemetry, **kwargs)

    @property
    def index(self) -> FieldIndex:
        return self._index

    def lookup(self, keys, field: Optional[str] = None,
               columns: Optional[Sequence[str]] = None,
               on_missing: str = "error") -> List[dict]:
        """The rows holding each key value of ``field``: one row dict a
        matching row, in key order (a key in several rows gives all of
        them, in store order). ``columns`` narrows the fields returned (by
        default the owning reader's view); the key field is always read, so
        a group-granular entry can filter. ``on_missing="error"`` raises
        :class:`KeyError` naming the absent keys; ``"skip"`` counts them on
        ``index.keys_missing_total`` and leaves them out. The keys of a
        group quarantined during the lookup (degraded mode) are skipped
        and recorded."""
        t0 = time.perf_counter()
        field = self._resolve_field(field)
        out_columns, needed = self._column_sets(columns, field)
        keys = list(keys)
        missing = []
        by_group: Dict[Tuple[str, int], list] = {}
        order: List[list] = []   # a slot a key, filled group by group, flattened
        for pos, key in enumerate(keys):
            entries = self._index.entries_for(field, key)
            order.append([])
            if not entries:
                missing.append(key)
                continue
            for rel, rg, off in entries:
                by_group.setdefault((rel, rg), []).append((pos, key, off))
        if missing:
            if on_missing == "error":
                raise KeyError(f"{len(missing)} key(s) not in the {field!r} index (first: "
                               f"{missing[:5]!r}); pass on_missing='skip' to drop absent keys")
            if self._telemetry is not None:
                self._c_missing.add(len(missing))
        skipped_keys = 0
        worker = self._worker(needed)
        for (rel, rg), wants in sorted(by_group.items()):
            data = self._decoded_group(rel, rg, needed)
            if data is None:   # quarantined: skipped and recorded
                skipped_keys += len(wants)
                continue
            key_col = data.get(field)
            for pos, key, off in wants:
                offs = matching_offsets(key_col, key) if off == GROUP_GRANULAR else (off,)
                for o in offs:
                    order[pos].append({c: worker._copy_cell(data[c][o])
                                       for c in out_columns if c in data})
        rows = [row for slot in order for row in slot]
        if self._telemetry is not None:
            self._c_lookups.add(1)
            self._c_keys.add(len(keys))
            self._c_rows.add(len(rows))
            if skipped_keys:
                self._c_skipped.add(skipped_keys)
            self._h_lookup.observe(time.perf_counter() - t0)
        return rows

    def fetch_rows(self, locations: Sequence[Tuple[str, int, int]],
                   columns: Optional[Sequence[str]] = None) -> List[Optional[dict]]:
        """Point reads by exact ``(rel_path, row_group, row_offset)``, the
        :class:`~petastorm_tpu_torch.index.DatasetView` primitive: grouped,
        cached and guarded as :meth:`lookup`; a quarantined group's rows come
        back as ``None`` (the caller addressed positions)."""
        t0 = time.perf_counter()
        out_columns, needed = self._column_sets(columns, None)
        by_group: Dict[Tuple[str, int], list] = {}
        for pos, (rel, rg, off) in enumerate(locations):
            by_group.setdefault((rel, rg), []).append((pos, off))
        out: List[Optional[dict]] = [None] * len(locations)
        skipped = 0
        worker = self._worker(needed)
        for (rel, rg), wants in sorted(by_group.items()):
            data = self._decoded_group(rel, rg, needed)
            if data is None:
                skipped += len(wants)
                continue
            for pos, off in wants:
                out[pos] = {c: worker._copy_cell(data[c][off]) for c in out_columns if c in data}
        if self._telemetry is not None:
            self._c_lookups.add(1)
            self._c_rows.add(len(locations) - skipped)
            if skipped:
                self._c_skipped.add(skipped)
            self._h_lookup.observe(time.perf_counter() - t0)
        return out

    def gather(self, keys, field: Optional[str] = None, columns: Optional[Sequence[str]] = None,
               on_missing: str = "error", device="cuda") -> dict:
        """:meth:`lookup`, then :func:`~petastorm_tpu_torch.index.gather_rows`
        onto ``device``: one tensor a field."""
        from petastorm_tpu_torch.index.gather import gather_rows
        rows = self.lookup(keys, field=field, columns=columns, on_missing=on_missing)
        return gather_rows(rows, fields=columns, telemetry=self._telemetry, device=device)

    def extend_files(self, files: Sequence[Tuple[str, int]]) -> int:
        """Index the key columns of ``(abs_path, num_row_groups)`` files not
        yet in the in-memory index (the saved sidecar is untouched:
        :func:`~petastorm_tpu_torch.index.extend_field_index` owns it).
        Returns how many files were indexed."""
        fields = self._index.fields_indexed
        if not fields:
            return 0
        from petastorm_tpu_torch.index.build import scan_files_into_index
        added = scan_files_into_index(self._ctx, self._index, fields, list(files))
        if added:
            self._index.generation += 1
            if self._telemetry is not None:
                self._c_growth.add(added)
        return added

    def close(self) -> None:
        for worker in self._workers.values():
            worker.shutdown()
        self._workers.clear()

    def _resolve_field(self, field: Optional[str]) -> str:
        if field is not None:
            return field
        indexed = self._index.fields_indexed
        if len(indexed) == 1:
            return indexed[0]
        raise ValueError(f"lookup(field=...) is required when {len(indexed)} fields are "
                         f"indexed ({indexed})")

    def _column_sets(self, columns: Optional[Sequence[str]], field: Optional[str]):
        """``(output columns, the set read)``. The default is the owning
        reader's view, so the cache keys are the epoch path's."""
        out = list(columns) if columns is not None else self._default_columns
        unknown = [c for c in out if c not in self._schema.fields]
        if unknown:
            raise ValueError(f"unknown column(s) {unknown} (schema fields: "
                             f"{sorted(self._schema.fields)})")
        needed = set(out)
        if field is not None and field in self._schema.fields:
            needed.add(field)
        return out, frozenset(needed)

    def _worker(self, needed: frozenset):
        worker = self._workers.get(needed)
        if worker is None:
            from petastorm_tpu_torch.reader_impl.row_reader_worker import (RowReaderWorker,
                                                                           open_files)
            args = dict(self._worker_args,
                        view_schema=self._schema.create_schema_view(sorted(needed)))
            worker = RowReaderWorker(0, lambda *_: None, args)
            open_files(worker)
            self._workers[needed] = worker
        return worker

    def _decoded_group(self, rel_path: str, row_group: int,
                       needed: frozenset) -> Optional[dict]:
        """One touched group's decoded columns, whole: read once on a miss, a
        cache read on a hit. None when the group was quarantined."""
        path = posixpath.join(self._ctx.root_path, rel_path)
        rowgroup = RowGroupRef(path, row_group, self._ctx.partition_values_for(path))
        worker = self._worker(needed)
        filled = []

        def fill_decoded():
            filled.append(1)
            return worker._decode_all_columns(rowgroup, needed)

        def fetch():
            cache = self._cache
            if cache is None:
                return fill_decoded()
            if getattr(cache, "caches_decoded", False):
                # The epoch workers' key: the two warm each other.
                return cache.get(worker._cache_key(rowgroup, needed) + ":decoded",
                                 fill_decoded)

            # The disk cache keeps raw columns: decoded on every retrieval,
            # as the epoch path does.
            def fill_raw():
                filled.append(1)
                return worker._read_columns(rowgroup, needed, zero_copy=False)[0]
            data = cache.get(worker._cache_key(rowgroup, needed), fill_raw)
            n = len(next(iter(data.values()))) if data else 0
            return worker._decode_columns(data, range(n))

        try:
            data = worker._guard.run(fetch, rowgroup,
                                     on_retry=lambda *_: worker._files.evict(rowgroup.path))
        except RowGroupSkipped as skip:
            if self.quarantine is not None:
                self.quarantine.add(skip.record)
            logger.warning("lookup skipped quarantined row group %s", skip.record.piece)
            if self._telemetry is not None:
                self._c_groups.add(1)
                self._c_misses.add(1)
            return None
        if self._telemetry is not None:
            self._c_groups.add(1)
            (self._c_misses if filled else self._c_hits).add(1)
        return data


def matching_offsets(key_col, key) -> List[int]:
    """The row offsets whose cell matches ``key``: the group-granular
    filter. Scalar cells compare through the index's typed encoding, array
    cells by membership."""
    if key_col is None:
        return []
    want = encode_key(key)
    offs = []
    for i, cell in enumerate(key_col):
        if cell is None:
            continue
        if isinstance(cell, (list, tuple)) or (
                hasattr(cell, "__len__") and not isinstance(cell, (str, bytes, memoryview))):
            if any(v is not None and encode_key(v) == want for v in cell):
                offs.append(i)
        elif encode_key(cell) == want:
            offs.append(i)
    return offs
