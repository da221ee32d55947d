"""``make_reader``: decoded rows of a petastorm store, one namedtuple at a
time; ``make_batch_reader``: the columns of any Parquet store, one row
group at a time.

The reader plans the store's row groups, in the JAX package's order of
steps: hive partition ``filters``, a ``predicate`` over partition keys
alone, a ``rowgroup_selector`` over the stored indexes, the shard
``index % shard_count == cur_shard`` (after a ``random.Random(shard_seed)``
shuffle when given) and an explicit ``rowgroup_subset``. It ventilates each
planned group ``shuffle_row_drop_partitions`` times to a worker pool (each
copy reads its own slice of the rows), in a per-epoch order seeded exactly
as the JAX package seeds it, and yields what the workers publish, after
their ``predicate`` and ``transform_spec``. Given the same store, seed and
settings, it yields the same rows as the JAX package's reader, in the same
order on the thread and dummy pools (the process pool delivers in the
order its workers finish). With
``sample_order="deterministic"`` the order is the plan's on every pool
(:mod:`.reader_impl.epoch_plan`), optionally shuffled inside windows of
``shuffle_window`` row groups. With ``schema_fields=NGram(...)`` a row
reader yields the NGram's windows instead of rows. With
``row_materialization="lazy"`` the workers publish one
:class:`~petastorm_tpu_torch.reader_impl.batch_plane.ColumnarBatch` a row
group: rows are views of its columns, and ``next_batch()`` hands out whole
batches (the same rows, the same multiset an epoch, as the eager reader).

:meth:`Reader.state_dict` is the read position (``epoch``, ``offset``,
``items``, ``seed``, the JAX package's free-mode cursor): passed back as
``resume_state=`` to a reader of the same store and settings, it continues
the stream with no row lost. A row group counts as read once its last row
(or its batch) has been handed out; one read in part is read again whole.
The JAX package's reader waits for the worker's confirmation, which it
reads on the next pull, so where a pull ends exactly on a row group its
cursor still points at that group and the port's is one past it. In
deterministic mode the cursor is the JAX package's deterministic one, the
same in both packages, and cursors cross between them either way.

Every reader owns a telemetry registry (``reader.telemetry``,
:mod:`petastorm_tpu_torch.telemetry`) that its pool, its workers and a
loader over it share: ``reader.rows``, ``reader.pool_wait_s``, the
ventilator and results-queue gauges, the workers' decode and, on
processes, the transport. :attr:`Reader.diagnostics` is the pool's counters
with a snapshot of it. ``PETASTORM_TPU_TELEMETRY_EXPORT=<path>`` makes every
reader write snapshots there until it stops (``.prom``: Prometheus text).

The JAX package's resilience arguments (:mod:`petastorm_tpu_torch.resilience`)
apply on every pool: ``retry_policy`` and ``degraded_mode`` (retry a failed
row group, then quarantine it: :meth:`Reader.quarantine_report`),
``fault_plan``, ``stage_deadline_s`` and ``hedge_policy`` (latency
budgets and hedged reads in the workers), ``hang_timeout_s`` (a
:class:`~petastorm_tpu_torch.resilience.PipelineWatchdog`:
:meth:`Reader.watchdog_report`) and, on processes, ``worker_crash_budget``
(a dead worker's row groups go to the survivors).

The IO and tuning plane (the JAX package's arguments): ``readahead_depth``
starts a :class:`~petastorm_tpu_torch.reader_impl.readahead.ReadaheadFetcher`
that reads row groups ahead of the decode workers (in-process pools:
:meth:`Reader.readahead_report`); ``memory_cache_size_bytes`` keeps decoded
row groups in an :class:`~petastorm_tpu_torch.autotune.InMemoryRowGroupCache`,
so later epochs skip the read and the decode (``cache_type="local-disk"``
keeps raw ones on the disk instead: :mod:`.local_disk_cache`); ``autotune`` starts an
:class:`~petastorm_tpu_torch.autotune.AutotuneController` over the pool's
concurrency, the ventilation and readahead depths and a loader's prefetch
depth and shuffle target (:meth:`Reader.autotune_report`).

The planning plane (the JAX package's ``plan/``): the entry points lower
their kwargs into a :class:`~petastorm_tpu_torch.plan.PipelinePlan` (one
validation pass, the workers' fusions, the persisted placement of a warm
start; :meth:`Reader.plan_report`). With a predicate that declares
``intervals()``, the planned row groups that the footers' statistics prove
empty are dropped after sharding (``rowgroup_pruning``, on by default:
:meth:`Reader.pruning_report`); ``rowgroup_coalescing=N`` reads up to N
same-file groups in one work item. With ``autotune_config.placement`` the
controller may migrate the decode stage between the thread and the process
pool mid-epoch (:meth:`Reader._perform_pool_migration`: no row lost or
repeated), and a resolved trial persists for the next reader of the store.

The random-access plane (:mod:`petastorm_tpu_torch.index`):
:meth:`Reader.lookup` and :meth:`Reader.dataset_view` read rows by key or
by ordinal through the store's field index, sharing the reader's cache.

Live data (:mod:`petastorm_tpu_torch.discovery`): with
``refresh_interval_s`` a watcher admits the files a producer appends and
the reader folds them into its plan from the first epoch not planned yet
(:meth:`Reader.refresh_dataset`, :meth:`Reader.dataset_growth_report`); the
cursor then carries a file manifest, and ``reset()`` rebases the plan.
"""
from __future__ import annotations

import dataclasses
import io
import logging
import os
import pickle
import random
import sys
import threading
import time
import types
import warnings
from collections import deque
from functools import partial
from typing import Optional, Sequence

from petastorm_tpu_torch.codecs import CompressedImageCodec, decode_verdict
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (ColumnStats, DatasetContext, RowGroupRef,
                                                      get_schema, infer_or_load_unischema,
                                                      load_row_group_stats, load_row_groups)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.batch_plane import ColumnarBatch
from petastorm_tpu_torch.reader_impl.batch_reader_worker import (BatchReaderWorker,
                                                                 arrow_table_to_numpy_dict)
from petastorm_tpu_torch.reader_impl.epoch_plan import EpochPlan, OrderedDeliveryGate, mint_seed
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
from petastorm_tpu_torch.telemetry import (SLO_WATCH_ENV, TELEMETRY_EXPORT_ENV, AnomalyMonitor,
                                           BlackBox, MetricsTimeline, PeriodicExporter,
                                           SloWatcher, TelemetryPublisher, TimelineSampler,
                                           blackbox_dir_from_env, make_registry, parse_rules,
                                           publish_addr_from_env, timeline_interval_from_env)
from petastorm_tpu_torch.telemetry.accounting import ACCOUNTING_SCHEMA_VERSION, accounting_totals
from petastorm_tpu_torch.telemetry.slo import default_rules
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers_pool import (EmptyResultError, ITEM_CONTEXT_KWARG,
                                              TimeoutWaitingForResultError, add_counters)
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

logger = logging.getLogger(__name__)

#: In-flight row groups per worker beyond the one it is decoding.
_VENTILATE_EXTRA_ROWGROUPS = 3

#: Seconds a placement migration waits for the old pool to drain before it
#: gives up and stays on it (a migratable reader has no watchdog: this
#: bound keeps a wedged worker from hanging the swap).
_MIGRATION_DRAIN_TIMEOUT_S = 120.0

#: Handed-out items remembered before those the ventilator has confirmed
#: are dropped from the reader's record.
_DELIVERED_PRUNE_AT = 256

#: Per-worker shm ring bytes of the process pool, the least it shrinks to
#: where ``/dev/shm`` is small, and the most an autotune budget sizes it to
#: (reference petastorm_tpu/reader.py:251-265).
DEFAULT_RING_CAPACITY = 128 << 20
MIN_RING_CAPACITY = 16 << 20
MAX_RING_CAPACITY = 512 << 20
SHM_DIR = "/dev/shm"

#: Bytes of fetched tables the readahead stage may hold without a shared
#: budget.
DEFAULT_READAHEAD_BYTES = 256 << 20


def shm_free_bytes(path: str = SHM_DIR) -> int:
    """Bytes free in the shared-memory filesystem."""
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def ring_capacity_for(workers_count: int, free_bytes: Optional[int] = None,
                      want: int = DEFAULT_RING_CAPACITY) -> int:
    """Each process worker's ring: ``want`` bytes
    (:data:`DEFAULT_RING_CAPACITY`), or the even share of the free
    ``/dev/shm`` when that is smaller, but no less than
    :data:`MIN_RING_CAPACITY`. Raises ``RuntimeError`` when the rings do not
    fit even so: the reader never turns to threads by itself."""
    free = shm_free_bytes() if free_bytes is None else free_bytes
    capacity = max(MIN_RING_CAPACITY, min(want, free // max(1, workers_count)))
    if capacity * workers_count > free:
        raise RuntimeError(
            f"reader_pool_type='process' needs {workers_count} shared-memory rings of at "
            f"least {MIN_RING_CAPACITY >> 20} MiB, but {SHM_DIR} has {free} bytes free: "
            f"enlarge {SHM_DIR}, use fewer workers or reader_pool_type='thread'")
    return capacity


def _ring_capacity_from_budget(autotune_config, workers_count: int) -> Optional[int]:
    """The ring bytes an autotune ``memory_budget_bytes`` asks for: its even
    share a worker, within [:data:`MIN_RING_CAPACITY`,
    :data:`MAX_RING_CAPACITY`]; None without a budget (the default)."""
    budget = getattr(autotune_config, "memory_budget_bytes", None)
    if not budget:
        return None
    return max(MIN_RING_CAPACITY, min(MAX_RING_CAPACITY, int(budget) // max(1, workers_count)))


def _warn_predicate_bypasses_cache(predicate, memory_cache_size_bytes) -> None:
    """Both workers read a predicate's groups fresh and never consult the
    cache on that path (a cached group cannot be masked without freezing
    its rows), so say that the cache will see no hits."""
    if predicate is not None and memory_cache_size_bytes:
        warnings.warn(
            "predicate= bypasses row-group caching: every epoch re-reads and re-decodes the "
            f"predicate's row groups, and the {memory_cache_size_bytes}-byte memory cache will "
            "record no hits. Drop the predicate (filter after read) to cache, or drop "
            "memory_cache_size_bytes to silence this.")


def _make_cache(cache_type=None, cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None, cache_extra_settings=None, retry_policy=None,
                fault_plan=None, memory_cache_size_bytes=None):
    """The reader's row-group cache, or None: the decoded cache of
    ``memory_cache_size_bytes``, else a ``"local-disk"``
    :class:`~petastorm_tpu_torch.local_disk_cache.LocalDiskCache` at
    ``cache_location`` (the JAX package's factory; the plan's validation
    refuses both at once)."""
    if memory_cache_size_bytes:
        from petastorm_tpu_torch.autotune import InMemoryRowGroupCache
        return InMemoryRowGroupCache(memory_cache_size_bytes, fault_plan=fault_plan)
    if cache_type in (None, "null"):
        return None
    if cache_type == "local-disk":
        from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
        return LocalDiskCache(cache_location, cache_size_limit, cache_row_size_estimate or 0,
                              retry_policy=retry_policy, fault_plan=fault_plan,
                              **(cache_extra_settings or {}))
    raise ValueError(f"Unknown cache_type {cache_type!r}")


def decode_threads_for(workers_count: int) -> int:
    """Threads of each native image decode call: the cores left to each
    worker, at most ``imgcodec.default_threads()`` and at least 1, so the
    workers' decodes do not oversubscribe the host."""
    from petastorm_tpu_torch.native.imgcodec import default_threads
    return max(1, min(default_threads(), (os.cpu_count() or 1) // max(1, workers_count)))


_FILTER_OPS = ("=", "==", "!=", "<", "<=", ">", ">=", "in", "not in")


def _filter_value_eq(val, ref) -> bool:
    """Hive partition values are path strings: equal by their string
    forms, or as numbers, so ``("year", "=", 2024.0)`` matches ``year=2024``."""
    if str(val) == str(ref):
        return True
    try:
        return float(val) == float(ref)
    except (TypeError, ValueError):
        return False


def _filter_compare(val, op: str, ref) -> bool:
    if op in ("=", "=="):
        return _filter_value_eq(val, ref)
    if op == "!=":
        return not _filter_value_eq(val, ref)
    if op == "in":
        return any(_filter_value_eq(val, r) for r in ref)
    if op == "not in":
        return not any(_filter_value_eq(val, r) for r in ref)
    # Orderings compare as numbers where both sides convert, else as strings.
    try:
        a, b = float(val), float(ref)
    except (TypeError, ValueError):
        a, b = str(val), str(ref)
    return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[op]


def _normalize_filters(filters):
    """The filters as a list of AND-groups, ORed: ``[(col, op, val), ...]``
    is one group, ``[[(col, op, val), ...], ...]`` several. Every clause
    is checked here, before any matching."""
    if not filters:
        return []
    if all(isinstance(f, tuple) for f in filters):
        groups = [list(filters)]
    elif all(isinstance(f, (list, tuple)) for f in filters):
        groups = [list(g) for g in filters]
    else:
        raise ValueError("filters must be a list of (col, op, val) tuples "
                         "or a list of such lists")
    for g in groups:
        if not g:
            raise ValueError("empty filter conjunction [] matches nothing "
                             "meaningfully; remove it or add clauses")
        for clause in g:
            if not (isinstance(clause, tuple) and len(clause) == 3):
                raise ValueError(f"bad filter clause {clause!r}; expected "
                                 f"(column, op, value)")
            col, op, ref = clause
            if op not in _FILTER_OPS:
                raise ValueError(f"unsupported filter op {op!r} "
                                 f"(supported: {' '.join(_FILTER_OPS)})")
            if op in ("in", "not in") and isinstance(ref, (str, bytes)):
                raise ValueError(
                    f"filter ({col!r}, {op!r}, {ref!r}): the reference "
                    f"must be a list/tuple/set of values, not a string")
    return groups


def _row_group_matches_filters(partition_dict: dict, groups) -> bool:
    # A group without a referenced key does not match the clause.
    def clause_ok(col, op, ref):
        return col in partition_dict and _filter_compare(partition_dict[col], op, ref)

    return any(all(clause_ok(*clause) for clause in g) for g in groups)


def _partition_keys(row_groups) -> set:
    return {k for rg in row_groups for k, _ in rg.partition_values}


def _apply_filters(row_groups, filters):
    """The groups whose hive partition values pass ``filters``. A column
    that is not a partition key raises: nothing later could evaluate it."""
    groups = _normalize_filters(filters)
    if not groups:
        return row_groups
    partition_keys = _partition_keys(row_groups)
    unknown = {col for g in groups for col, _, _ in g} - partition_keys
    if unknown:
        raise ValueError(
            f"filters reference non-partition column(s) {sorted(unknown)}; this dataset's "
            f"partition keys are {sorted(partition_keys) or '(none - unpartitioned store)'}. "
            f"Use predicate=... for row-level filtering")
    return [rg for rg in row_groups if _row_group_matches_filters(rg.partition_dict, groups)]


def _apply_partition_predicate(row_groups, predicate):
    """Where every predicate field is a hive partition key, the groups the
    predicate rejects on their partition values; groups without one of
    the keys stay for the workers to decide."""
    fields = predicate.get_fields()
    if not row_groups or not fields or not fields.issubset(_partition_keys(row_groups)):
        return row_groups
    return [rg for rg in row_groups
            if not fields.issubset(set(rg.partition_dict))
            or predicate.do_include(rg.partition_dict)]


def _apply_selector(ctx, all_row_groups, row_groups, selector, report=None):
    """The groups ``selector`` selects through the store's indexes; its
    ordinals index the unfiltered order. ``report`` (the pruning report)
    gets the selector and the groups it dropped."""
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
    indexes = get_row_group_indexes(ctx)
    for name in selector.get_index_names():
        if name not in indexes:
            raise ValueError(f"Index {name!r} not found in dataset metadata "
                             f"(available: {sorted(indexes)})")
    selected = {id(all_row_groups[i]) for i in selector.select_row_groups(indexes)
                if i < len(all_row_groups)}
    kept = [rg for rg in row_groups if id(rg) in selected]
    if report is not None:
        report["selector"] = (selector.describe() if hasattr(selector, "describe")
                              else type(selector).__name__)
        report["selector_pruned"] = len(row_groups) - len(kept)
    return kept


def _shard_row_groups(row_groups, cur_shard, shard_count, shard_seed):
    """``index % shard_count == cur_shard``, after a ``random.Random(shard_seed)``
    shuffle when a seed is given."""
    if shard_seed is not None:
        row_groups = list(row_groups)
        random.Random(shard_seed).shuffle(row_groups)
    shard = [rg for i, rg in enumerate(row_groups) if i % shard_count == cur_shard]
    if not shard:
        raise NoDataAvailableError(
            f"Shard {cur_shard}/{shard_count} received zero row groups "
            f"({len(row_groups)} total). Use fewer shards or larger datasets.")
    return shard


def _apply_rowgroup_subset(all_row_groups, row_groups, rowgroup_subset):
    """The subset's ordinals (into the unfiltered order) that the earlier
    steps kept, in the subset's order. An out-of-range or repeated
    ordinal raises."""
    seen = set()
    for ordinal in rowgroup_subset:
        if not 0 <= ordinal < len(all_row_groups):
            raise ValueError(f"rowgroup_subset ordinal {ordinal} out of range "
                             f"[0, {len(all_row_groups)}) for this dataset")
        if ordinal in seen:
            raise ValueError(f"rowgroup_subset contains duplicate ordinal {ordinal}")
        seen.add(ordinal)
    kept = {id(rg) for rg in row_groups}
    return [all_row_groups[i] for i in rowgroup_subset if id(all_row_groups[i]) in kept]


def _plan_row_groups(ctx, all_row_groups, filters, predicate, rowgroup_selector,
                     cur_shard, shard_count, shard_seed, rowgroup_subset, report=None,
                     stream=None):
    """The JAX reader's planning steps, in its order (statistics pruning
    and coalescing come after, in the reader). ``stream`` (a dict) gets
    ``"shard_index"``: the groups the shard walk went over, where a live
    dataset's growth continues it."""
    planned = list(all_row_groups)
    if filters:
        planned = _apply_filters(planned, filters)
    if predicate is not None:
        planned = _apply_partition_predicate(planned, predicate)
    if rowgroup_selector is not None:
        planned = _apply_selector(ctx, all_row_groups, planned, rowgroup_selector, report)
    if stream is not None:
        stream["shard_index"] = len(planned)
    if cur_shard is not None:
        planned = _shard_row_groups(planned, cur_shard, shard_count, shard_seed)
    if rowgroup_subset is not None:
        planned = _apply_rowgroup_subset(all_row_groups, planned, rowgroup_subset)
    return planned


def _prune_with_stats(row_groups, constraints, stats):
    """``(kept, pruned_per_file)``: the groups whose statistics admit every
    constraint (``[(field, FieldDomain)]``), given ``{(path, ordinal):
    {column: ColumnStats}}``. A hive partition key is a ``min == max``
    statistic; a field without statistics admits anything."""
    fields = {f for f, _ in constraints}
    kept, pruned_per_file = [], {}
    for rg in row_groups:
        group_stats = dict(stats.get((rg.path, rg.row_group), {}))
        for key, value in rg.partition_values:
            if key in fields and key not in group_stats:
                group_stats[key] = ColumnStats(min=value, max=value, null_count=0,
                                               has_min_max=True)
        if all(domain.admits_stats(group_stats[field])
               for field, domain in constraints if field in group_stats):
            kept.append(rg)
        else:
            pruned_per_file[rg.path] = pruned_per_file.get(rg.path, 0) + 1
    return kept, pruned_per_file


def _fold_plan_column_stats(agg: dict, per_group_stats) -> None:
    """Fold per-group ``{column: ColumnStats}`` dicts into ``agg``'s
    per-column min of mins, max of maxes (numeric bounds only), summed null
    and row counts and group count."""
    for group in per_group_stats:
        for name, st in group.items():
            rec = agg.get(name)
            if rec is None:
                rec = agg[name] = {"min": None, "max": None, "null_count": 0,
                                   "num_rows": 0, "groups": 0}
            rec["groups"] += 1
            if st.num_rows is not None:
                rec["num_rows"] += int(st.num_rows)
            if st.null_count is not None:
                rec["null_count"] += int(st.null_count)
            if st.has_min_max:
                try:
                    lo, hi = float(st.min), float(st.max)
                except (TypeError, ValueError):
                    continue
                rec["min"] = lo if rec["min"] is None else min(rec["min"], lo)
                rec["max"] = hi if rec["max"] is None else max(rec["max"], hi)


def _coalesce_row_groups(refs, max_per_item: int):
    """Runs of up to ``max_per_item`` same-file groups (after sharding and
    pruning, before the shuffle) as one work item each, whose ``row_group``
    is the tuple of their ordinals: the workers read it in one
    ``read_row_groups`` call. Partition values are per file, so a run
    shares them."""
    out, run = [], []

    def flush():
        if run:
            out.append(run[0] if len(run) == 1 else dataclasses.replace(
                run[0], row_group=tuple(r.row_group for r in run)))
            run.clear()

    for ref in refs:
        if run and (ref.path != run[0].path or len(run) >= max_per_item):
            flush()
        run.append(ref)
    flush()
    return out


def _warn_compat_kwargs(hdfs_driver, pyarrow_serialize) -> None:
    """petastorm's arguments that mean nothing here are accepted, so its
    call sites run unchanged, and warned about."""
    if hdfs_driver is not None:
        warnings.warn("hdfs_driver is ignored: hdfs access goes through fsspec/pyarrow (HA "
                      "failover via petastorm_tpu_torch.hdfs)", stacklevel=3)
    if pyarrow_serialize:
        warnings.warn("pyarrow_serialize was deprecated in petastorm and is a no-op here",
                      DeprecationWarning, stacklevel=3)


#: The one-time warnings already given in this process.
_ONE_SHOT_WARNED: set = set()


def _warn_once(key: str, message: str) -> None:
    """``message`` at most once a process for ``key``: the caveat depends
    on the configuration only, so the first reader speaks for the rest."""
    if key not in _ONE_SHOT_WARNED:
        _ONE_SHOT_WARNED.add(key)
        warnings.warn(message, stacklevel=3)


def _check_refresh(refresh_interval_s, ctx) -> None:
    """The JAX reader's checks of ``refresh_interval_s`` (its conflicts
    with ``rowgroup_subset`` and ``shard_seed`` are validation rules)."""
    if refresh_interval_s is None:
        return
    if refresh_interval_s < 0:
        raise ValueError(f"refresh_interval_s must be >= 0, got {refresh_interval_s}")
    if ctx.is_multi_path:
        raise ValueError("refresh_interval_s needs a single dataset root to watch; multi-URL "
                         "views enumerate a fixed file list")


def _fingerprint_fields(schema, schema_fields) -> list:
    """The plan cache's field ingredient: the output view's names (two
    readers of different columns are different workloads), the whole
    schema's for an NGram or a view that does not resolve."""
    if schema_fields is not None and not isinstance(schema_fields, NGram):
        try:
            return sorted(schema.create_schema_view(schema_fields).fields)
        except Exception:  # noqa: BLE001 - the reader raises the real error later
            pass
    return sorted(schema.fields)


class _SpawnPickler(pickle.Pickler):
    """Refuses functions and classes of ``__main__``: a spawned worker runs
    another main module and could not load them."""

    def persistent_id(self, obj):
        if isinstance(obj, (type, types.FunctionType)) and obj.__module__ == "__main__":
            raise pickle.PicklingError(f"{obj.__qualname__} is defined in __main__")
        return None


def _spawnable(obj) -> bool:
    """True when ``obj`` can be sent to a spawned worker (None can)."""
    try:
        _SpawnPickler(io.BytesIO()).dump(obj)
        return True
    except Exception:  # noqa: BLE001 - any pickling failure reads alike
        return False


def _check_spawnable(what: str, obj) -> None:
    """Raise ``ValueError`` unless ``obj`` can be sent to a spawned worker."""
    if obj is None:
        return
    try:
        _SpawnPickler(io.BytesIO()).dump(obj)
    except Exception as e:  # noqa: BLE001 - any pickling failure is reported alike
        raise ValueError(
            f"reader_pool_type='process' sends {what} {obj!r} to spawned workers, but it does "
            f"not pickle ({type(e).__name__}: {e}). Use a function defined at module level in "
            f"an importable module (not a lambda, a closure or a function of __main__), or "
            f"reader_pool_type='thread'") from e


def _resolve_shard(cur_shard, shard_count):
    """``cur_shard="auto"``: this rank's ``(rank, shard_count or world
    size)`` in an initialised ``torch.distributed`` default group, else
    ``(0, shard_count or 1)``; anything else as given."""
    if cur_shard != "auto":
        return cur_shard, shard_count
    # A group exists only once torch.distributed was imported: a process
    # that never imported it reads as one rank without importing torch.
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), shard_count or dist.get_world_size()
    return 0, shard_count or 1


def make_reader(dataset_url,
                schema_fields=None,
                reader_pool_type: str = "thread",
                workers_count: int = 4,
                results_queue_size: int = 50,
                shuffle_row_groups: bool = True,
                shuffle_rows: bool = False,
                seed: Optional[int] = None,
                num_epochs: Optional[int] = 1,
                cur_shard=None,
                shard_count: Optional[int] = None,
                resume_state: Optional[dict] = None,
                shuffle_row_drop_partitions: int = 1,
                predicate=None,
                rowgroup_selector=None,
                filters=None,
                shard_seed: Optional[int] = None,
                transform_spec=None,
                rowgroup_subset: Optional[Sequence[int]] = None,
                sample_order: str = "free",
                shuffle_window: int = 0,
                refresh_interval_s: Optional[float] = None,
                row_materialization: str = "eager",
                storage_options: Optional[dict] = None,
                filesystem=None,
                pool_profiling_enabled: bool = False,
                retry_policy=None,
                degraded_mode: bool = False,
                fault_plan=None,
                worker_crash_budget: int = 0,
                stage_deadline_s=None,
                hedge_policy=None,
                hang_timeout_s: Optional[float] = None,
                autotune: bool = False,
                autotune_config=None,
                cache_type: str = "null",
                cache_location: Optional[str] = None,
                cache_size_limit: Optional[int] = None,
                cache_row_size_estimate: Optional[int] = None,
                cache_extra_settings: Optional[dict] = None,
                memory_cache_size_bytes: Optional[int] = None,
                readahead_depth: Optional[int] = None,
                readahead_max_bytes: Optional[int] = None,
                rowgroup_pruning: bool = True,
                rowgroup_coalescing: int = 1,
                timeline_interval_s: Optional[float] = None,
                timeline_anomaly: bool = True,
                telemetry_publish: Optional[str] = None,
                tenant: Optional[str] = None,
                hdfs_driver: Optional[str] = None,
                pyarrow_serialize: bool = False,
                convert_early_to_numpy: Optional[bool] = None) -> "Reader":
    """Reader over a store written by ``materialize_dataset_local`` (either
    package's) or by petastorm itself (its pickled schema is read through
    :mod:`petastorm_tpu_torch.etl.legacy`'s restricted unpickler).

    :param dataset_url: the store's URL (``file://``, ``hdfs://``, any
        fsspec scheme), or a list of data-file URLs in one filesystem

    :param schema_fields: UnischemaFields or name regexes narrowing the output,
        or an :class:`~petastorm_tpu_torch.ngram.NGram`: the reader then
        yields its windows (``{offset: namedtuple}``, or ``{name: array}``
        when ``dense``), assembled inside each row group
    :param reader_pool_type: ``'thread'``, ``'process'`` (spawned decode
        processes that return rows through shared-memory rings, each
        :func:`ring_capacity_for` bytes; rows arrive in the order the
        workers finish) or ``'dummy'`` (inline, one thread)
    :param workers_count: decode threads or processes
    :param results_queue_size: bound of each worker's result queue
    :param shuffle_row_groups: shuffle row-group order each epoch
        (``random.Random(seed + epoch)``)
    :param shuffle_rows: shuffle rows inside each row group
        (``np.random.default_rng((seed, epoch, position))``)
    :param seed: master seed of both shuffles; with shuffling on and no seed
        one is drawn at random
    :param num_epochs: passes over the dataset; ``None`` = forever
    :param cur_shard/shard_count: read only row groups with
        ``index % shard_count == cur_shard`` (of the groups the filters,
        the predicate and the selector kept); ``cur_shard="auto"`` is this
        rank's index in the initialised ``torch.distributed`` default group,
        with ``shard_count`` defaulting to its size (``(0, shard_count or
        1)`` without a group)
    :param resume_state: a :meth:`Reader.state_dict` (of this package's
        reader or the JAX package's, free mode) to continue from; its
        recorded seed is used when ``seed`` is None. The store, selection,
        sharding and shuffle settings must be the saved reader's
    :param shuffle_row_drop_partitions: ventilate each row group N times,
        each copy reading its own contiguous 1/N of the rows (fewer rows
        of one group in flight together; not with a non-overlapping NGram)
    :param predicate: a :class:`~petastorm_tpu_torch.predicates.PredicateBase`;
        the workers read its fields first and deliver only the rows it
        includes. Over partition keys alone it skips whole row groups at
        planning time
    :param rowgroup_selector: a selector (:mod:`petastorm_tpu_torch.selectors`)
        over the indexes stored by ``build_rowgroup_index``
    :param filters: pyarrow-style partition filters, ``[(col, op, val),
        ...]`` (ANDed) or a list of such lists (ORed), ops ``= == != < <= >
        >= in "not in"``, over hive partition keys only
    :param shard_seed: shuffle the planned row groups with
        ``random.Random(shard_seed)`` before sharding
    :param transform_spec: a :class:`~petastorm_tpu_torch.transform.TransformSpec`
        applied to each row (or, ``batched``, to each group's columns) in
        the workers; ``reader.schema`` is the transformed schema
    :param rowgroup_subset: ordinals into the store's unfiltered row-group
        order; the reader plans those (that the other steps kept) in the
        subset's order. Not with ``cur_shard`` or ``shuffle_row_groups``
    :param sample_order: ``'free'`` (the default: the order depends on the
        pool and its timing) or ``'deterministic'``: the delivered stream is
        a function of ``(seed, epoch, planned row groups)`` alone, the same
        on the thread, process and dummy pools at any worker count and
        across a cut and a resume. A reorder stage in the reader
        (:class:`~petastorm_tpu_torch.reader_impl.epoch_plan.OrderedDeliveryGate`)
        puts the workers' results back in plan order. With no ``seed`` one
        is minted and recorded in :meth:`Reader.state_dict`
    :param shuffle_window: with ``sample_order='deterministic'``, shuffle
        the ordered stream inside consecutive windows of this many work
        items by a seeded permutation indexed by plan position (not by
        arrival), so it resumes exactly and a row group is delivered within
        ``shuffle_window`` plan positions of its slot. ``0``: plan order
    :param refresh_interval_s: read a live, appending dataset: a
        :class:`~petastorm_tpu_torch.discovery.DatasetWatcher` lists the
        store every ``refresh_interval_s`` seconds on a background thread
        (``0``: only at :meth:`Reader.refresh_dataset` and
        :meth:`Reader.reset`), checks each new file (a torn footer waits
        ``pending_retry`` in :meth:`Reader.quarantine_report`; a file that
        changed a planned column's type is refused with a warning, and the
        reader serves on) and folds the admitted files into the plan at the
        consumer's next pull, from the first epoch the ventilator has not
        planned: an epoch planned before the growth is delivered as it would
        have been without it. ``state_dict()`` then carries a file manifest,
        so a resumed reader rebuilds the grown plan. Not with
        ``rowgroup_subset``, ``shard_seed`` or several URLs; a
        ``rowgroup_selector`` admits the growth unpruned (with a warning).
        :meth:`Reader.dataset_growth_report` reads the admissions
    :param row_materialization: ``'eager'`` (the default: the workers build
        one dict a row) or ``'lazy'``: the workers publish one
        :class:`~petastorm_tpu_torch.reader_impl.batch_plane.ColumnarBatch`
        a row group, ``next()`` yields namedtuples whose cells are views of
        the batch's columns (a kept row pins its batch; writing a cell
        writes the batch) and :meth:`Reader.next_batch` hands out whole
        batches, which the loaders collate by slicing columns. The same
        rows, the same multiset an epoch. An NGram or a per-row
        ``TransformSpec`` func falls back to eager with a warning
        (``TransformSpec(batched=True)`` stays lazy)
    :param storage_options: keyword arguments of the URL's fsspec filesystem
        (credentials, endpoints), for the reader and its workers
    :param filesystem: a filesystem to read through as it is; spawned
        process workers cannot share it and resolve the URL themselves
        (with ``storage_options``)
    :param pool_profiling_enabled: cProfile the thread pool and print the
        statistics when it is joined (ignored, with a warning, on the other
        pools)
    :param retry_policy: a :class:`~petastorm_tpu_torch.resilience.RetryPolicy`
        for each row group's load and decode in the workers; default
        :data:`~petastorm_tpu_torch.resilience.DEFAULT_READ_POLICY`
    :param degraded_mode: a row group that still fails after the retries is
        quarantined (skipped, with its provenance in
        :meth:`Reader.quarantine_report`) instead of failing the reader
    :param fault_plan: a :class:`~petastorm_tpu_torch.resilience.FaultPlan`
        of seeded injected faults (tests and benchmarks)
    :param worker_crash_budget: on processes, the worker deaths tolerated:
        a dead worker's row groups go to the surviving workers (0: a death
        raises ``RuntimeError``, more than N raise
        :class:`~petastorm_tpu_torch.resilience.CrashBudgetExceededError`)
    :param stage_deadline_s: each load-and-decode attempt's latency budget:
        a number ``h`` is a hard deadline ``h`` with a soft one at ``h/2``,
        or a :class:`~petastorm_tpu_torch.resilience.StageDeadline`. Soft
        overruns are counted (``resilience.straggler`` events); hard ones
        cancel the attempt into the retries and the quarantine
    :param hedge_policy: a :class:`~petastorm_tpu_torch.resilience.HedgePolicy`:
        a row-group read that straggles past a tracked delay races a
        duplicate read; the first wins, the same bytes either way
    :param hang_timeout_s: start a
        :class:`~petastorm_tpu_torch.resilience.PipelineWatchdog`: when the
        consumer waits this long with no progress anywhere in the pipeline,
        the thread stacks go to the registry's events and the watchdog
        escalates nudge -> cancel (kill the stuck workers, on processes
        with a crash budget) -> ``PipelineHungError``
    :param autotune: start an
        :class:`~petastorm_tpu_torch.autotune.AutotuneController` that
        samples this pipeline's telemetry and moves, within clamped ranges
        and with hysteresis, the thread pool's decode concurrency, the
        ventilation and readahead depths, and a loader's prefetch depth and
        shuffle target (:meth:`Reader.autotune_report`)
    :param autotune_config: an :class:`~petastorm_tpu_torch.autotune.AutotuneConfig`
        (interval, hysteresis, cooldown, watermarks, ``memory_budget_bytes``:
        one ledger the cache and the readahead stage charge, which also
        sizes the process pool's rings)
    :param cache_type: ``"null"`` (no cache) or ``"local-disk"``: a
        :class:`~petastorm_tpu_torch.local_disk_cache.LocalDiskCache` of raw
        row groups in ``cache_location``, up to ``cache_size_limit`` bytes
        (``cache_row_size_estimate`` feeds its capacity check,
        ``cache_extra_settings`` its other arguments, e.g. ``cleanup``); the
        threads share it and spawned workers reopen its directory; the row
        worker decodes on every retrieval, the batch worker keeps the Arrow
        table. Exclusive with ``memory_cache_size_bytes``
    :param memory_cache_size_bytes: keep up to this many bytes of decoded
        row groups in memory (least recently used out first, cost-aware
        admission), so later epochs skip the read and the decode; hits copy
        the cells they hand out. A ``predicate``'s groups bypass it (a
        warning says so); on processes each worker keeps a private cache of
        this size (a warning says so)
    :param readahead_depth: read up to this many row groups ahead of the
        decode workers on fetcher threads, every needed column in one read
        (:meth:`Reader.readahead_report`); a failed fetch is discarded and
        read again inline under the retry policy; a hedge policy hedges the
        fetches. In-process pools only: ignored with a warning on processes
    :param readahead_max_bytes: the bytes of fetched tables the stage may
        hold (default 256 MiB); the autotune budget when it has one
    :param rowgroup_pruning: with a ``predicate`` that declares
        ``intervals()`` (the built-in equality, set and range predicates
        do), drop at plan time, after sharding, the row groups whose footer
        statistics (min, max, null count; hive keys as constants) prove that
        no row can match: they are never read (``io.rowgroups_pruned``,
        :meth:`Reader.pruning_report`). A plan that pruning empties is an
        empty epoch. Any unusable statistic keeps the group
    :param rowgroup_coalescing: read up to N same-file row groups as one
        work item, in one read: shuffling, sharding granularity and resume
        go by the coalesced item, and NGram windows may span the groups of
        one item
    :param timeline_interval_s: the ops plane: sample this pipeline's
        registry into a rolling
        :class:`~petastorm_tpu_torch.telemetry.MetricsTimeline` every
        ``timeline_interval_s`` seconds on a background thread (windowed
        rows/s, bytes/s, stall fraction, pool utilization, rolling
        quantiles), exported under ``snapshot()["timeline"]`` and
        :meth:`Reader.timeline_report`. ``None`` defers to
        ``PETASTORM_TPU_TIMELINE``; unset is off
    :param timeline_anomaly: run the default anomaly-detector bank over
        every timeline window (``anomaly.*`` events and counters,
        :meth:`Reader.anomaly_report`), writing a postmortem bundle on a
        detection's entry edge when ``PETASTORM_TPU_BLACKBOX`` names a
        directory. ``False`` keeps the ring without the detectors
    :param telemetry_publish: stream this registry's delta-encoded metric
        windows and accounting totals to a
        :class:`~petastorm_tpu_torch.telemetry.TelemetryAggregator` at this
        ``tcp://host:port`` or ``ipc:///path``; ``None`` defers to
        ``PETASTORM_TPU_TELEMETRY_PUBLISH``. A missing aggregator costs
        dropped windows (``fabric.send_errors``), never a stall
    :param tenant: the label that every published window and
        :meth:`Reader.accounting_report` carry

    ``PETASTORM_TPU_SLO_WATCH`` (``1`` for the default rules, or a
    ``parse_rules`` spec) starts an SLO watcher on the registry
    (:meth:`Reader.slo_report`), and ``PETASTORM_TPU_BLACKBOX=/dir`` arms
    the postmortem black box: a fatal escaping the reader, a watchdog
    abort, an SLO violation or an anomaly writes one bundle a reason
    (``python -m petastorm_tpu_torch.telemetry postmortem BUNDLE``).

    ``hdfs_driver``, ``pyarrow_serialize`` and ``convert_early_to_numpy``
    are petastorm's, accepted and ignored (the first two with a warning):
    hdfs goes through fsspec and pyarrow, and the row workers always decode
    to numpy.

    On ``reader_pool_type="process"`` the predicate, the transform and the
    retry policy must pickle into a spawned worker: a ``ValueError`` says so
    at construction. With ``autotune_config.placement`` a thread reader
    whose predicate, transform or retry policy does not pickle warns and
    does not tune its placement.
    """
    _warn_compat_kwargs(hdfs_driver, pyarrow_serialize)
    del convert_early_to_numpy   # the row workers always decode early
    seed = _resolve_seed(seed, resume_state, shuffle_row_groups, shuffle_rows, sample_order)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count)
    ctx = DatasetContext(dataset_url, storage_options=storage_options, filesystem=filesystem)
    _check_refresh(refresh_interval_s, ctx)
    try:
        stored_schema = get_schema(ctx)
    except MetadataError as e:
        raise MetadataError(f"Dataset at {dataset_url} is missing petastorm metadata "
                            f"(underlying error: {e}). If this is a plain Parquet store, use "
                            f"make_batch_reader() instead.") from e
    from petastorm_tpu_torch.plan import lower_reader_kwargs
    plan = lower_reader_kwargs(
        "row", _lowering_kwargs(locals()),
        schema_field_names=_fingerprint_fields(stored_schema, schema_fields),
        ngram=isinstance(schema_fields, NGram))
    _warn_predicate_bypasses_cache(predicate, memory_cache_size_bytes)
    # One construction path: the first pool and any pool a placement
    # migration builds later.
    pool_factory = partial(_make_pool, workers_count=workers_count,
                           results_queue_size=results_queue_size, shuffle_rows=shuffle_rows,
                           seed=seed, serializer=PickleSerializer(),
                           pool_profiling_enabled=pool_profiling_enabled,
                           ring_bytes=_ring_capacity_from_budget(autotune_config, workers_count))
    return Reader(dataset_url, pool_factory(plan.pool_type), ctx=ctx,
                  stored_schema=stored_schema, plan=plan, pool_factory=pool_factory,
                  rowgroup_pruning=rowgroup_pruning, rowgroup_coalescing=rowgroup_coalescing,
                  schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, resume_state=resume_state,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  rowgroup_selector=rowgroup_selector, filters=filters, shard_seed=shard_seed,
                  transform_spec=transform_spec, rowgroup_subset=rowgroup_subset,
                  sample_order=sample_order, shuffle_window=shuffle_window,
                  refresh_interval_s=refresh_interval_s,
                  row_materialization=row_materialization, storage_options=storage_options,
                  filesystem=filesystem, retry_policy=retry_policy, degraded_mode=degraded_mode,
                  fault_plan=fault_plan, worker_crash_budget=worker_crash_budget,
                  stage_deadline_s=stage_deadline_s, hedge_policy=hedge_policy,
                  hang_timeout_s=hang_timeout_s, autotune=autotune,
                  autotune_config=autotune_config,
                  cache_type=cache_type, cache_location=cache_location,
                  cache_size_limit=cache_size_limit,
                  cache_row_size_estimate=cache_row_size_estimate,
                  cache_extra_settings=cache_extra_settings,
                  memory_cache_size_bytes=memory_cache_size_bytes,
                  readahead_depth=readahead_depth, readahead_max_bytes=readahead_max_bytes,
                  timeline_interval_s=timeline_interval_s, timeline_anomaly=timeline_anomaly,
                  telemetry_publish=telemetry_publish, tenant=tenant)


def make_batch_reader(dataset_url_or_urls,
                      schema_fields=None,
                      reader_pool_type: str = "thread",
                      workers_count: int = 4,
                      results_queue_size: int = 50,
                      shuffle_row_groups: bool = True,
                      shuffle_rows: bool = False,
                      seed: Optional[int] = None,
                      num_epochs: Optional[int] = 1,
                      cur_shard=None,
                      shard_count: Optional[int] = None,
                      convert_early_to_numpy: bool = False,
                      resume_state: Optional[dict] = None,
                      shuffle_row_drop_partitions: int = 1,
                      predicate=None,
                      rowgroup_selector=None,
                      filters=None,
                      shard_seed: Optional[int] = None,
                      transform_spec=None,
                      rowgroup_subset: Optional[Sequence[int]] = None,
                      sample_order: str = "free",
                      shuffle_window: int = 0,
                      refresh_interval_s: Optional[float] = None,
                      storage_options: Optional[dict] = None,
                      filesystem=None,
                      pool_profiling_enabled: bool = False,
                      retry_policy=None,
                      degraded_mode: bool = False,
                      fault_plan=None,
                      worker_crash_budget: int = 0,
                      stage_deadline_s=None,
                      hedge_policy=None,
                      hang_timeout_s: Optional[float] = None,
                      autotune: bool = False,
                      autotune_config=None,
                      cache_type: str = "null",
                      cache_location: Optional[str] = None,
                      cache_size_limit: Optional[int] = None,
                      cache_row_size_estimate: Optional[int] = None,
                      cache_extra_settings: Optional[dict] = None,
                      memory_cache_size_bytes: Optional[int] = None,
                      readahead_depth: Optional[int] = None,
                      readahead_max_bytes: Optional[int] = None,
                      rowgroup_pruning: bool = True,
                      rowgroup_coalescing: int = 1,
                      timeline_interval_s: Optional[float] = None,
                      timeline_anomaly: bool = True,
                      telemetry_publish: Optional[str] = None,
                      tenant: Optional[str] = None,
                      hdfs_driver: Optional[str] = None,
                      serializer=None) -> "Reader":
    """Columnar reader of any Parquet store (several files, with or without
    petastorm metadata; a store without it gets a schema inferred from its
    Arrow schema): one batch of ``{column: ndarray}`` per row group,
    through :meth:`Reader.next_batch`, or a namedtuple of those columns
    per ``next()``.

    :param dataset_url_or_urls: the store's URL, or a list of data-file URLs
        in one filesystem (a multi-URL view: planned from the files' parent
        directory's row-group map when they share one, else their footers;
        no live refresh)

    Fixed-size list columns come as ``(rows, size)`` blocks, lists with a
    declared shape as ``(rows, *shape)`` blocks (null rows NaN or 0), other
    lists as object arrays of per-row arrays.

    :param schema_fields: column names or name regexes (``re.fullmatch``)
    :param reader_pool_type: ``'thread'``, ``'process'`` or ``'dummy'``, as
        :func:`make_reader`. On processes the workers publish Arrow tables
        through the shared-memory rings, and the columns the consumer gets
        view the ring (no copy): a batch pins its ring record until its
        last array (or a tensor made from one) is dropped, and the worker
        waits while its ring is full of pinned records (when every busy
        worker waits, ``next_batch`` raises after 60 s). The columns are
        read-only on every pool: a tensor made from one must not be
        written into (``.clone()`` it first).
    :param convert_early_to_numpy: convert to numpy in the workers instead
        (on processes the dicts cross the rings pickled)
    :param predicate: evaluated over each group's Arrow columns (one mask
        per group where the predicate has ``do_include_batch``, else row by
        row over pandas rows, as in the JAX package)
    :param transform_spec: ``func`` takes each group's pandas DataFrame
        (tensor cells come back raveled and are reshaped by the
        transformed schema), or with ``batched`` its ``{column: ndarray}``.
        A transformed group is new Arrow memory; it crosses the process
        rings like any other
    :param sample_order/shuffle_window: as :func:`make_reader`: with
        ``'deterministic'`` the batch stream is a function of ``(seed,
        epoch, planned row groups)``, and on processes the columns still
        view the rings (the unit's ordinal rides as Arrow schema metadata)
    :param refresh_interval_s: a live, appending dataset, as
        :func:`make_reader`
    :param serializer: what a process worker publishes through its ring:
        an :class:`~petastorm_tpu_torch.reader_impl.arrow_table_serializer.ArrowTableSerializer`
        (the default; the columns view the ring) or a
        :class:`~petastorm_tpu_torch.reader_impl.pickle_serializer.PickleSerializer`
        (the default with ``convert_early_to_numpy``, which needs it)
    :param hdfs_driver: petastorm's, accepted, warned about and ignored

    The other arguments are :func:`make_reader`'s; its memory cache keeps
    each group's Arrow table (the read, not a decode, is what it saves).
    On an in-process pool the workers convert each group to numpy (the
    plan's ``decode_transport`` fusion; ``PETASTORM_TPU_PLAN_FUSION=0``
    leaves it to the consumer).
    """
    _warn_compat_kwargs(hdfs_driver, False)
    seed = _resolve_seed(seed, resume_state, shuffle_row_groups, shuffle_rows, sample_order)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count)
    if isinstance(schema_fields, NGram):
        raise ValueError("NGram is not supported by make_batch_reader; use make_reader")
    ctx = DatasetContext(dataset_url_or_urls, storage_options=storage_options,
                         filesystem=filesystem)
    _check_refresh(refresh_interval_s, ctx)
    stored_schema = infer_or_load_unischema(ctx)
    from petastorm_tpu_torch.plan import lower_reader_kwargs
    plan = lower_reader_kwargs("batch", _lowering_kwargs(locals()),
                               schema_field_names=_fingerprint_fields(stored_schema,
                                                                      schema_fields))
    _warn_predicate_bypasses_cache(predicate, memory_cache_size_bytes)
    if serializer is None:
        # Numpy dicts cannot travel as Arrow IPC.
        serializer = PickleSerializer() if convert_early_to_numpy else ArrowTableSerializer()
    elif convert_early_to_numpy and not isinstance(serializer, PickleSerializer):
        raise ValueError("convert_early_to_numpy publishes numpy dicts, which only the "
                         "PickleSerializer can carry; drop serializer= or "
                         "convert_early_to_numpy")
    pool_factory = partial(_make_pool, workers_count=workers_count,
                           results_queue_size=results_queue_size, shuffle_rows=shuffle_rows,
                           seed=seed, serializer=serializer,
                           pool_profiling_enabled=pool_profiling_enabled,
                           ring_bytes=_ring_capacity_from_budget(autotune_config, workers_count))
    return Reader(dataset_url_or_urls, pool_factory(plan.pool_type), ctx=ctx,
                  stored_schema=stored_schema, plan=plan, pool_factory=pool_factory,
                  rowgroup_pruning=rowgroup_pruning, rowgroup_coalescing=rowgroup_coalescing,
                  schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, is_batched_reader=True,
                  convert_early_to_numpy=convert_early_to_numpy, resume_state=resume_state,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  rowgroup_selector=rowgroup_selector, filters=filters, shard_seed=shard_seed,
                  transform_spec=transform_spec, rowgroup_subset=rowgroup_subset,
                  sample_order=sample_order, shuffle_window=shuffle_window,
                  refresh_interval_s=refresh_interval_s,
                  storage_options=storage_options, filesystem=filesystem,
                  retry_policy=retry_policy, degraded_mode=degraded_mode, fault_plan=fault_plan,
                  worker_crash_budget=worker_crash_budget, stage_deadline_s=stage_deadline_s,
                  hedge_policy=hedge_policy, hang_timeout_s=hang_timeout_s, autotune=autotune,
                  autotune_config=autotune_config,
                  cache_type=cache_type, cache_location=cache_location,
                  cache_size_limit=cache_size_limit,
                  cache_row_size_estimate=cache_row_size_estimate,
                  cache_extra_settings=cache_extra_settings,
                  memory_cache_size_bytes=memory_cache_size_bytes,
                  readahead_depth=readahead_depth, readahead_max_bytes=readahead_max_bytes,
                  timeline_interval_s=timeline_interval_s, timeline_anomaly=timeline_anomaly,
                  telemetry_publish=telemetry_publish, tenant=tenant)


#: The entry points' kwargs that lowering reads (the JAX package's set,
#: less the kwargs the port does not take yet).
_LOWERED_KWARGS = (
    "dataset_url", "dataset_url_or_urls", "reader_pool_type", "workers_count", "results_queue_size",
    "shuffle_row_groups", "shuffle_rows", "shuffle_row_drop_partitions", "predicate",
    "transform_spec", "num_epochs", "cur_shard", "shard_seed", "seed",
    "cache_type", "cache_location", "cache_size_limit", "memory_cache_size_bytes",
    "rowgroup_coalescing", "readahead_depth", "readahead_max_bytes",
    "rowgroup_subset", "row_materialization", "convert_early_to_numpy", "sample_order",
    "shuffle_window", "refresh_interval_s", "autotune", "autotune_config", "serializer")


def _lowering_kwargs(entry_locals: dict) -> dict:
    """The lowering dict of an entry point's ``locals()``."""
    return {k: entry_locals[k] for k in _LOWERED_KWARGS if k in entry_locals}


def _resolve_materialization(row_materialization: str, ngram, transform_spec) -> str:
    """The JAX package's fallback of ``row_materialization`` (its values
    are checked by :func:`~petastorm_tpu_torch.plan.validate_reader_config`):
    an NGram or a per-row transform func falls back to eager with a
    warning."""
    if row_materialization == "eager":
        return "eager"
    if ngram is not None:
        warnings.warn("row_materialization='lazy' does not apply to NGram readers (windows "
                      "are assembled per sample); falling back to eager")
        return "eager"
    if transform_spec is not None and transform_spec.func is not None \
            and not transform_spec.batched:
        warnings.warn("row_materialization='lazy' needs a batch-native TransformSpec "
                      "(batched=True, columns in and out); a per-row func forces per-row "
                      "materialization; falling back to eager")
        return "eager"
    return "lazy"


def _resolve_seed(seed, resume_state, shuffle_row_groups: bool, shuffle_rows: bool,
                  sample_order: str = "free"):
    """The explicit seed; else a resume state's recorded one (its offsets
    index that seed's order; a state without one stays None, so the resume
    check can refuse it); else, when anything is shuffled or the order is
    deterministic, a minted one, so the reader's ``state_dict`` can be
    resumed."""
    if seed is not None:
        return seed
    if resume_state is not None:
        saved = resume_state.get("seed")
        return None if saved is None else int(saved)
    if shuffle_row_groups or shuffle_rows or sample_order != "free":
        return mint_seed()
    return None


def _resume_position(resume_state: dict, seed, shuffle_row_groups: bool, shuffle_rows: bool,
                     num_items: int, sample_order: str = "free", shuffle_window: int = 0):
    """``(start_epoch, start_offset, window_delivered, skipped_ordinals)``
    of a resume state, after the JAX package's checks
    (``reader.py:1536-1604``). ``num_items`` counts a live-data cursor's
    growth too (its manifest was replayed into the plan)."""
    plan = resume_state.get("plan") or {}
    if shuffle_row_groups and seed is None:
        raise ValueError("Exact resume requires a seed when shuffle_row_groups is on (the "
                         "epoch permutation must be reproducible); this resume_state records "
                         "none. States saved by state_dict() carry their minted seed.")
    saved_seed = resume_state.get("seed")
    if saved_seed is not None and seed is not None and int(saved_seed) != int(seed) \
            and (shuffle_row_groups or shuffle_rows or sample_order == "deterministic"):
        raise ValueError(f"resume_state was saved under seed {saved_seed} but this reader "
                         f"shuffles with seed {seed}: the offset would point into a different "
                         f"permutation")
    saved_order = resume_state.get("sample_order")
    if saved_order is not None and saved_order != sample_order:
        raise ValueError(f"resume_state was saved with sample_order={saved_order!r} but this "
                         f"reader runs {sample_order!r}; the cursors do not transfer")
    saved_window = resume_state.get("window")
    if saved_window is not None and int(saved_window) != shuffle_window:
        raise ValueError(f"resume_state was saved with shuffle_window={saved_window} but this "
                         f"reader uses {shuffle_window}; the in-window position would index a "
                         f"different block permutation")
    if plan and bool(plan.get("shuffled")) != bool(shuffle_row_groups):
        raise ValueError(f"resume_state was saved with shuffle_row_groups="
                         f"{bool(plan.get('shuffled'))} but this reader uses "
                         f"{bool(shuffle_row_groups)}: the offset would index a different "
                         f"permutation")
    saved_items = resume_state.get("items")
    if saved_items is not None and int(saved_items) != num_items:
        raise ValueError(f"resume_state was saved over {saved_items} work items but this reader "
                         f"plans {num_items}: the offset would point at different data. Resume "
                         f"with the same dataset, filters, sharding, "
                         f"shuffle_row_drop_partitions and rowgroup_coalescing as the saved "
                         f"run.")
    epoch = int(resume_state.get("epoch", 0))
    offset = int(resume_state.get("offset", 0))
    if not 0 <= offset < num_items:
        raise ValueError(f"resume offset {offset} >= {num_items} work items (did the dataset "
                         f"or its filtering change?)")
    if shuffle_window > 1 and offset % shuffle_window:
        # A windowed cursor records block starts; the gate would wait for
        # plan positions before the ventilation restart, forever.
        raise ValueError(f"resume offset {offset} is not aligned to shuffle_window="
                         f"{shuffle_window}: windowed cursors record window-block starts; this "
                         f"state was not saved by a shuffle_window={shuffle_window} reader")
    return (epoch, offset, int(resume_state.get("window_delivered", 0)),
            tuple(resume_state.get("skipped_ordinals", ())))


def _make_pool(reader_pool_type, workers_count, results_queue_size, shuffle_rows, seed,
               serializer, pool_profiling_enabled=False, ring_bytes=None):
    """The reader's pool of ``reader_pool_type``; the entry points bind the
    other arguments into the reader's pool factory."""
    if reader_pool_type == "thread":
        return ThreadPool(workers_count, results_queue_size, shuffle_rows=shuffle_rows, seed=seed,
                          profiling_enabled=pool_profiling_enabled)
    if pool_profiling_enabled and reader_pool_type in ("process", "dummy"):
        # cProfile sees this process's threads: process workers run
        # elsewhere, and the dummy pool has no worker threads.
        warnings.warn(f"pool_profiling_enabled only applies to reader_pool_type='thread'; "
                      f"ignored for {reader_pool_type!r}")
    if reader_pool_type == "process":
        ring_capacity = (ring_capacity_for(workers_count) if ring_bytes is None
                         else ring_capacity_for(workers_count, want=ring_bytes))
        return ProcessPool(workers_count, ring_capacity=ring_capacity, serializer=serializer)
    if reader_pool_type == "dummy":
        return DummyPool()
    raise ValueError(f"Unknown reader_pool_type {reader_pool_type!r} "
                     f"(expected 'thread', 'process' or 'dummy')")


class Reader:
    """Iterator of row namedtuples (fields of ``reader.schema``), of NGram
    windows when ``reader.ngram`` is set, or, for a batched reader
    (``make_batch_reader``), of one namedtuple of columns per row group.

    Use as a context manager, or call ``stop()`` then ``join()``. After a
    pass is fully consumed, ``reset()`` starts another one.

    ``sample_order`` is ``'free'`` or ``'deterministic'`` (the reader then
    delivers through its :class:`OrderedDeliveryGate`, and its cursor is the
    gate's). ``row_materialization`` is ``'lazy'`` when the workers publish
    :class:`ColumnarBatch` es (always ``'eager'`` for a batched reader).
    ``telemetry`` is the pipeline's registry (see the module docstring).
    ``quarantine`` is the :class:`~petastorm_tpu_torch.resilience.RowGroupQuarantine`
    of the row groups given up on, ``watchdog`` the
    :class:`~petastorm_tpu_torch.resilience.PipelineWatchdog` or None.
    """

    def __init__(self, dataset_url, pool, schema_fields, shuffle_row_groups,
                 shuffle_rows, seed, num_epochs, cur_shard, shard_count,
                 is_batched_reader=False, convert_early_to_numpy=False, resume_state=None,
                 shuffle_row_drop_partitions=1, predicate=None, rowgroup_selector=None,
                 filters=None, shard_seed=None, transform_spec=None, rowgroup_subset=None,
                 sample_order="free", shuffle_window=0, row_materialization="eager",
                 storage_options=None, filesystem=None, retry_policy=None, degraded_mode=False,
                 fault_plan=None, worker_crash_budget=0, stage_deadline_s=None,
                 hedge_policy=None, hang_timeout_s=None, autotune=False, autotune_config=None,
                 cache_type="null", cache_location=None, cache_size_limit=None,
                 cache_row_size_estimate=None, cache_extra_settings=None,
                 memory_cache_size_bytes=None, readahead_depth=None, readahead_max_bytes=None,
                 rowgroup_pruning=True, rowgroup_coalescing=1, plan=None, pool_factory=None,
                 ctx=None, stored_schema=None, timeline_interval_s=None, timeline_anomaly=True,
                 telemetry_publish=None, tenant=None, refresh_interval_s=None):
        # The plan-time validation pass: the entry points ran it while
        # lowering; a direct Reader(...) gets the same rules and messages.
        from petastorm_tpu_torch.plan import validate_reader_config
        validation_cfg = {"rowgroup_subset": rowgroup_subset, "cur_shard": cur_shard,
                          "shuffle_row_groups": shuffle_row_groups, "shard_seed": shard_seed,
                          "sample_order": sample_order, "shuffle_window": shuffle_window,
                          "memory_cache_size_bytes": memory_cache_size_bytes,
                          "cache_type": cache_type, "refresh_interval_s": refresh_interval_s}
        if not is_batched_reader:
            validation_cfg["row_materialization"] = row_materialization
        validate_reader_config(validation_cfg)
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not (isinstance(cur_shard, int)
                                          and 0 <= cur_shard < shard_count):
            raise ValueError(f"cur_shard must be an int in [0, {shard_count}), "
                             f"got {cur_shard!r}")
        if shuffle_row_drop_partitions < 1:
            raise ValueError(f"shuffle_row_drop_partitions must be >= 1, "
                             f"got {shuffle_row_drop_partitions}")
        if readahead_depth is not None and readahead_depth < 0:
            raise ValueError(f"readahead_depth must be >= 1, got {readahead_depth}")
        shuffle_window = int(shuffle_window or 0)
        #: ``'free'`` or ``'deterministic'``: the reader's order contract.
        self.sample_order = sample_order
        self._shuffle_window = shuffle_window
        #: The lowered plan this reader runs (None for a direct Reader(...)).
        self._plan = plan
        # Placement migration: the factory builds a pool of either flavor
        # with this reader's construction arguments; the placement actuator
        # sets the pending target from any thread, and the swap happens at
        # the next safe point on the consumer's thread.
        self._pool_factory = pool_factory
        self._worker_crash_budget = worker_crash_budget
        self._convert_early_to_numpy = convert_early_to_numpy
        self._pending_pool_target = None
        self._placement_actuator = None
        # A failure mid-migration poisons the reader: every later pull
        # raises it, never a stopped pool's end of data.
        self._migration_error = None
        # Results drained from a pool being migrated away from, with their
        # contexts: delivered first, in drain order.
        self._pending = deque()
        self._result_context = None
        # The retired pools' item tallies and counters, added to the live
        # pool's, so diagnostics and counters stay monotonic.
        self._pool_items_base = {"items_ventilated": 0, "items_processed": 0}
        self._pool_counters_base = {}
        self._diag_lock = threading.Lock()
        #: The pipeline's telemetry registry; a loader over this reader
        #: adopts it.
        self.telemetry = make_registry()
        self._telemetry_exporter = None
        self._rows_counter = self.telemetry.counter("reader.rows")
        self._pool_wait_hist = self.telemetry.histogram("reader.pool_wait_s")
        self._rows_per_op = None   # batch.rows_per_op, made on the first batch
        if ctx is None:
            ctx = DatasetContext(dataset_url, storage_options=storage_options,
                                 filesystem=filesystem)
        _check_refresh(refresh_interval_s, ctx)
        self._ctx = ctx
        self._batched = is_batched_reader
        if stored_schema is None:
            stored_schema = infer_or_load_unischema(ctx) if is_batched_reader else get_schema(ctx)
        self._stored_schema = stored_schema
        #: The NGram windows are formed by, or None for a row reader.
        self.ngram: Optional[NGram] = None
        if isinstance(schema_fields, NGram):
            if is_batched_reader:
                raise ValueError("NGram is not supported by make_batch_reader; use make_reader")
            self.ngram = schema_fields
            self.ngram.resolve_regex_field_names(stored_schema)
            view_schema = stored_schema
        elif schema_fields is not None:
            view_schema = stored_schema.create_schema_view(schema_fields)
        else:
            view_schema = stored_schema
        if self.ngram is not None and not self.ngram.timestamp_overlap \
                and shuffle_row_drop_partitions > 1:
            raise NotImplementedError("shuffle_row_drop_partitions with "
                                      "non-overlapping ngrams is not supported")
        #: ``'lazy'`` when the workers publish ColumnarBatches and rows are
        #: views of them; always ``'eager'`` for a batched reader, whose
        #: payload is already a row group's columns.
        self.row_materialization = ("eager" if is_batched_reader else _resolve_materialization(
            row_materialization, self.ngram, transform_spec))
        #: The rows' schema: the view, transformed by ``transform_spec``.
        self.schema = (view_schema if transform_spec is None
                       else transform_schema(view_schema, transform_spec))
        if isinstance(pool, ProcessPool):
            _check_spawnable("predicate", predicate)
            _check_spawnable("transform_spec", transform_spec)
            # A policy's classifier crosses too: a module-level function.
            _check_spawnable("retry_policy", retry_policy)

        # Live data: the watcher (made after the resilience wiring, whose
        # quarantine it shares), the applied growth batches, and the base
        # files' manifest, which a cursor carries.
        self._refresh_interval_s = refresh_interval_s
        self._discovery = None
        # One fold at a time: a loader's thread pulls (a safe point) while
        # the caller may run refresh_dataset().
        self._growth_lock = threading.Lock()
        self._growth_batches: list = []
        self._base_manifest = None
        self._live_plan = None
        resume_manifest = (resume_state.get("manifest")
                           if isinstance(resume_state, dict) else None)
        if resume_manifest:
            # A live-data cursor: its manifest, not the sorted listing (an
            # appended file may sort into the middle), gives the base
            # ordinals; the growth batches are replayed below at their
            # epochs, so the plan is the one the cursor indexed.
            if shard_seed is not None:
                raise ValueError("a live-data manifest cursor cannot resume with shard_seed "
                                 "(the shard stream must extend monotonically; "
                                 "docs/live_data.md)")
            from petastorm_tpu_torch.discovery import DatasetSnapshot
            base_snapshot = DatasetSnapshot.from_manifest(resume_manifest["base"],
                                                          ctx.root_path)
            all_row_groups = base_snapshot.row_group_refs(ctx)
        else:
            base_snapshot = None
            all_row_groups = load_row_groups(ctx)
        #: What the plan-time pruning did (:meth:`pruning_report`).
        self._pruning_report = {"enabled": False}
        #: Per column, the footer statistics the pruning scan read, folded.
        self._plan_column_stats: dict = {}
        stream = {}
        row_groups = _plan_row_groups(ctx, all_row_groups, filters, predicate,
                                      rowgroup_selector, cur_shard, shard_count, shard_seed,
                                      rowgroup_subset, report=self._pruning_report,
                                      stream=stream)
        #: Where a growth batch's groups continue the shard walk.
        self._shard_stream_index = stream["shard_index"]
        if not row_groups:
            raise NoDataAvailableError(
                f"No row groups left after predicate/selector/shard filtering "
                f"(dataset has {len(all_row_groups)}; cur_shard={cur_shard}, "
                f"shard_count={shard_count})")
        # Lineage ordinals of trace mode: the group's position in the plan,
        # or its ordinal in the store for an explicit subset (a coalesced
        # item, keyed by a tuple, falls back to its epoch position).
        self._ordinal_of = ({(rg.path, rg.row_group): i for i, rg in enumerate(all_row_groups)}
                            if rowgroup_subset is not None else
                            {(rg.path, rg.row_group): i for i, rg in enumerate(row_groups)})
        #: The lineage ordinal a growth batch's first group takes.
        self._next_ordinal = len(row_groups)
        # Statistics pruning after sharding, so shard membership is the same
        # with pruning on or off. A plan it empties is an empty epoch (the
        # predicate provably matches nothing), not a configuration error.
        self._pruning_report.update({"row_groups_planned": len(row_groups),
                                     "row_groups_pruned": 0,
                                     "row_groups_kept": len(row_groups)})
        if rowgroup_pruning and predicate is not None:
            row_groups = self._prune_row_groups_with_statistics(row_groups, predicate)
        if rowgroup_coalescing > 1:
            row_groups = _coalesce_row_groups(row_groups, rowgroup_coalescing)
        items = [{"rowgroup": rg,
                  "shuffle_row_drop_partition": (part, shuffle_row_drop_partitions)}
                 for rg in row_groups for part in range(shuffle_row_drop_partitions)]

        # The live growth plan: a growth batch goes through the filters,
        # the shard walk (continued), the pruning and the coalescing the
        # base went through.
        base_items_count = len(items)
        growth_segments = None
        if refresh_interval_s is not None or resume_manifest:
            from petastorm_tpu_torch.discovery import DatasetSnapshot
            if base_snapshot is None:
                base_snapshot = DatasetSnapshot.from_row_groups(all_row_groups)
            self._base_snapshot = base_snapshot
            self._base_manifest = base_snapshot.manifest(ctx.root_path)
            self._live_plan = {"filters": filters, "predicate": predicate,
                               "cur_shard": cur_shard, "shard_count": shard_count,
                               "pruning": rowgroup_pruning, "coalescing": rowgroup_coalescing,
                               "drop_partitions": shuffle_row_drop_partitions}
            if rowgroup_selector is not None:
                _warn_once("refresh_selector",
                           "rowgroup_selector indexes are stored at write time and cannot "
                           "cover appended files; discovery admits new files WITHOUT selector "
                           "pruning")
            if resume_manifest and resume_manifest.get("growth"):
                segments = [(0, base_items_count)]
                for batch in resume_manifest["growth"]:
                    files = [(os.path.join(ctx.root_path, rel), int(n), None)
                             for rel, n in batch["files"]]
                    new_items, info = self._plan_growth_batch(files)
                    if len(new_items) != int(batch["items"]):
                        raise ValueError(
                            f"live-data resume planned {len(new_items)} work item(s) for the "
                            f"growth batch at epoch {batch['epoch']} but the cursor recorded "
                            f"{batch['items']} — the appended files (or predicate/filters) "
                            f"changed since the checkpoint")
                    items.extend(new_items)
                    epoch_from = int(batch["epoch"])
                    if segments[-1][0] == epoch_from:
                        segments[-1] = (epoch_from, len(items))
                    else:
                        segments.append((epoch_from, len(items)))
                    self._growth_batches.append(
                        {"epoch": epoch_from, "files": [[r, int(n)] for r, n in batch["files"]],
                         "items": len(new_items), **info})
                if len(segments) > 1:
                    growth_segments = segments

        start_epoch, start_offset, window_delivered, skipped = (
            (0, 0, 0, ()) if resume_state is None else _resume_position(
                resume_state, seed, shuffle_row_groups, shuffle_rows, len(items), sample_order,
                shuffle_window))
        self._num_items = len(items)
        self._seed = seed
        self._pool = pool
        #: The canonical plan and the reorder gate (deterministic mode only):
        #: the gate sits between ``pool.get_results()`` and the consumer, and
        #: its cursor, not the ventilator's watermark, is the checkpoint.
        self._epoch_plan = self._gate = None
        if sample_order == "deterministic":
            self._epoch_plan = EpochPlan(seed=seed, num_items=base_items_count,
                                         shuffled=shuffle_row_groups, window=shuffle_window,
                                         growth=growth_segments[1:] if growth_segments else ())
            self._gate = OrderedDeliveryGate(self._epoch_plan, start_epoch=start_epoch,
                                             start_offset=start_offset,
                                             window_delivered=window_delivered, skipped=skipped)
        resilience_args = self._attach_resilience(pool, worker_crash_budget, stage_deadline_s,
                                                  hedge_policy, hang_timeout_s)
        self._stage_deadline = resilience_args["stage_deadline"]
        if refresh_interval_s is not None:
            self._discovery = self._make_watcher(ctx, refresh_interval_s, predicate,
                                                 rowgroup_pruning, retry_policy, fault_plan)
        self._cache = self._attach_cache(
            pool, fault_plan, cache_type=cache_type, cache_location=cache_location,
            cache_size_limit=cache_size_limit, cache_row_size_estimate=cache_row_size_estimate,
            cache_extra_settings=cache_extra_settings, retry_policy=retry_policy,
            memory_cache_size_bytes=memory_cache_size_bytes)
        #: The random-access plane (:meth:`lookup`), made on first use.
        self._lookup_plane = None
        #: The :class:`~petastorm_tpu_torch.reader_impl.readahead.ReadaheadFetcher`
        #: when ``readahead_depth`` is set on an in-process pool, else None
        #: (made before the ventilator, whose wrapper announces items to it).
        self.readahead = self._make_readahead(
            pool, ctx, view_schema, predicate, readahead_depth, readahead_max_bytes, fault_plan,
            hedge_policy)
        self._ventilator = ConcurrentVentilator(
            self._make_ventilate_fn(pool), items,
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count * (1 + _VENTILATE_EXTRA_ROWGROUPS),
            item_context_key=ITEM_CONTEXT_KWARG,
            start_epoch=start_epoch, start_offset=start_offset, growth_segments=growth_segments)
        self._buffer = deque()
        # The lazy cursor: the batch being served, its columns in the
        # namedtuple's field order (None where the batch lacks a field) and
        # the next row.
        self._batch: Optional[ColumnarBatch] = None
        self._batch_cols = None
        self._batch_pos = 0
        # The context of the item the buffered rows come from, and those of
        # items handed out in full whose confirmation may still be to come.
        self._buffer_context = None
        self._delivered = set()
        self.last_row_consumed = False
        self.telemetry.gauge("ventilator.backlog", lambda: self._ventilator.inflight)
        self.telemetry.gauge("ventilator.max_inflight", lambda: self._ventilator.max_inflight)
        self._sync_pool_gauges(pool)
        # Built for an in-process pool; _worker_args_for derives the spawned
        # workers' copy, so a migration can stand up either flavor.
        self._worker_args_inproc = {
            "dataset_url": dataset_url, "view_schema": view_schema,
            "output_schema": self.schema, "predicate": predicate,
            "transform_spec": transform_spec, "shuffle_rows": shuffle_rows, "seed": seed,
            "sample_order": sample_order, "storage_options": storage_options,
            "filesystem": filesystem, "retry_policy": retry_policy,
            "degraded_mode": degraded_mode, "fault_plan": fault_plan, **resilience_args,
            "resilience_telemetry": self.telemetry,
            # A spawned worker unpickles an empty private cache.
            "cache": self._cache, "readahead": self.readahead,
            "plan_fusions": plan.fusion_names() if plan is not None else frozenset()}
        if is_batched_reader:
            self._worker_class = BatchReaderWorker
            self._worker_args_inproc["convert_early_to_numpy"] = convert_early_to_numpy
        else:
            self._worker_class = RowReaderWorker
            # The image decode path is settled here, once (the native build
            # and the JPEG parity check), and the workers adopt the verdict.
            verdict = (decode_verdict() if any(isinstance(f.codec, CompressedImageCodec)
                                               for f in stored_schema.fields.values()) else None)
            self._worker_args_inproc.update({
                "schema": stored_schema, "ngram": self.ngram,
                "decode_threads": decode_threads_for(pool.workers_count),
                "decode_verdict": verdict, "row_materialization": self.row_materialization})
        self._prepare_pool(pool)
        #: The :class:`~petastorm_tpu_torch.autotune.AutotuneController` when
        #: ``autotune``, else None; a loader over this reader registers its
        #: own knobs on it.
        self.autotune = (self._make_autotune(pool, autotune_config, hang_timeout_s)
                         if autotune else None)
        if self.autotune is not None:
            self.autotune.start()
        if self.readahead is not None:
            self.readahead.start()
        pool.start(self._worker_class, self._worker_args_for(pool), ventilator=self._ventilator)
        #: The pipeline watchdog when ``hang_timeout_s`` is set, else None;
        #: the pool wait reports the consumer's starvation to it.
        self.watchdog = None
        if hang_timeout_s is not None:
            from petastorm_tpu_torch.resilience import PipelineWatchdog
            self.watchdog = PipelineWatchdog(
                pool, ventilator=self._ventilator, telemetry=self.telemetry,
                hang_timeout_s=hang_timeout_s, recovery=getattr(pool, "recovery", None),
                cancel_token=resilience_args["cancel_token"]).start()
        export_path = os.environ.get(TELEMETRY_EXPORT_ENV)
        if export_path:
            self._telemetry_exporter = PeriodicExporter(
                self.telemetry, export_path,
                fmt="prometheus" if export_path.endswith(".prom") else "json").start()
        self._start_ops_plane(timeline_interval_s, timeline_anomaly, telemetry_publish, tenant)

    def _start_ops_plane(self, timeline_interval_s, timeline_anomaly, telemetry_publish,
                         tenant) -> None:
        """The ops plane, built in the JAX reader's order: the black box
        (``PETASTORM_TPU_BLACKBOX``) with every report surface as a
        collector, the SLO watcher (``PETASTORM_TPU_SLO_WATCH``), the
        rolling timeline and its sampler with the anomaly bank on every
        window, and the fabric publisher. Each is None when off."""
        self.blackbox = None
        bb_dir = blackbox_dir_from_env()
        if bb_dir:
            self.blackbox = BlackBox(bb_dir, self.telemetry, label="reader",
                                     config=self._config_summary())
            for name, fn in (("cursor", self.state_dict), ("plan", self.plan_report),
                             ("quarantine", self.quarantine_report),
                             ("pruning", self.pruning_report),
                             ("readahead", self.readahead_report),
                             ("autotune", self.autotune_report),
                             ("growth", self.dataset_growth_report), ("slo", self.slo_report),
                             ("anomaly", self.anomaly_report),
                             ("watchdog", self.watchdog_report)):
                self.blackbox.add_collector(name, fn)
            if self.watchdog is not None:
                self.watchdog.on_abort = (
                    lambda err: self.blackbox.write_bundle("watchdog_abort", exc=err))
        #: The :class:`~petastorm_tpu_torch.telemetry.SloWatcher` when
        #: ``PETASTORM_TPU_SLO_WATCH`` is set (``1``: the default rules),
        #: violations recorded as ``slo.violation`` events.
        self.slo_watcher = None
        slo_spec = os.environ.get(SLO_WATCH_ENV, "").strip()
        if slo_spec:
            rules = default_rules() if slo_spec in ("1", "default") else parse_rules(slo_spec)
            self.slo_watcher = SloWatcher(self.telemetry, rules,
                                          on_violation=self._on_slo_violation).start()
        self._timeline = None
        self._timeline_sampler = None
        #: The anomaly bank over the timeline's windows, or None.
        self.anomaly_monitor = None
        interval = (timeline_interval_s if timeline_interval_s is not None
                    else timeline_interval_from_env())
        if interval:
            self._timeline = MetricsTimeline(interval_s=interval)
            self.telemetry.timeline = self._timeline
            if timeline_anomaly:
                self.anomaly_monitor = AnomalyMonitor(self.telemetry,
                                                      on_detection=self._on_anomaly)
                self._timeline.add_listener(self.anomaly_monitor.observe_window)
            self._timeline_sampler = TimelineSampler(self.telemetry, self._timeline,
                                                     interval).start()
        self._telemetry_publisher = None
        self._tenant = tenant
        publish_addr = (telemetry_publish if telemetry_publish is not None
                        else publish_addr_from_env())
        if publish_addr:
            self._telemetry_publisher = TelemetryPublisher(self.telemetry, publish_addr,
                                                           tenant=tenant).start()

    def _config_summary(self) -> dict:
        """JSON-safe construction summary for the black box's
        ``config.json`` (the JAX reader's keys)."""
        return {
            "dataset_url": str(self._ctx.root_path),
            "pool_type": ("process" if isinstance(self._pool, ProcessPool)
                          else "dummy" if isinstance(self._pool, DummyPool) else "thread"),
            "workers_count": getattr(self._pool, "workers_count", None),
            "is_batched_reader": self._batched,
            "row_materialization": self.row_materialization,
            "sample_order": self.sample_order,
            "shuffle_window": self._shuffle_window,
            "seed": self._seed,
            "num_items": getattr(self, "_num_items", None),
            "plan_source": self._plan.source if self._plan is not None else None,
        }

    def _record_fatal(self, exc: BaseException) -> None:
        """Black-box trigger for any fatal escaping the consumer API; the
        exception class names the bundle, so distinct failure modes latch
        distinct bundles."""
        if self.blackbox is not None:
            self.blackbox.write_bundle(type(exc).__name__, exc=exc)

    def _on_slo_violation(self, violation: dict) -> None:
        if self.blackbox is not None:
            self.blackbox.write_bundle(f"slo_{violation.get('rule', '?')}")

    def _on_anomaly(self, detection: dict) -> None:
        if self.blackbox is not None:
            self.blackbox.write_bundle(f"anomaly_{detection.get('rule', '?')}")

    def _prune_row_groups_with_statistics(self, row_groups, predicate):
        """The groups the predicate's ``intervals()`` do not prove empty
        against the footers' statistics (the JAX reader's
        ``_prune_row_groups_with_statistics``). Any unusable signal (no
        ``intervals()``, missing statistics, NaN bounds, types that do not
        compare) keeps a group, and the workers decide as before. Fills
        the pruning report and ``io.rowgroups_pruned``/``planned``."""
        report = self._pruning_report
        constraints = predicate.intervals()
        if not constraints:
            report["reason"] = "predicate declares no intervals()"
            return row_groups
        report["enabled"] = True
        fields = sorted({f for f, _ in constraints})
        report["fields"] = fields
        stats = load_row_group_stats(self._ctx, row_groups, fields, telemetry=self.telemetry)
        _fold_plan_column_stats(self._plan_column_stats, stats.values())
        report["column_stats"] = dict(self._plan_column_stats)
        kept, pruned_per_file = _prune_with_stats(row_groups, constraints, stats)
        pruned = len(row_groups) - len(kept)
        report.update({"row_groups_pruned": pruned, "row_groups_kept": len(kept),
                       "pruned_per_file": pruned_per_file})
        self.telemetry.counter("io.rowgroups_pruned").add(pruned)
        self.telemetry.counter("io.rowgroups_planned").add(len(kept))
        if pruned:
            logger.debug("Statistics pruning dropped %d/%d row groups (fields: %s)", pruned,
                         len(row_groups), fields)
        return kept

    def _make_watcher(self, ctx, refresh_interval_s, predicate, rowgroup_pruning, retry_policy,
                      fault_plan):
        """The live data's :class:`~petastorm_tpu_torch.discovery.DatasetWatcher`
        (the JAX reader's wiring, ``reader.py:1418-1467``): its snapshot
        covers the plan (the base and the growth a manifest replayed), new
        files are classified against the store's Arrow schema, footers
        harvest the pruner's columns, torn files go to this reader's
        quarantine, listings run under the stage deadline (or the listing's
        default). Started here when ``refresh_interval_s > 0``."""
        from petastorm_tpu_torch.discovery import DatasetWatcher
        from petastorm_tpu_torch.discovery.listing import DEFAULT_LIST_DEADLINE
        snapshot = self._base_snapshot
        for batch in self._growth_batches:
            snapshot = snapshot.extended([(os.path.join(ctx.root_path, rel), n, 0.0, -1)
                                          for rel, n in batch["files"]])
        try:
            reference_schema = ctx.arrow_schema()
        except Exception as e:  # noqa: BLE001 - the drift check is best effort
            reference_schema = None
            warnings.warn(f"live discovery could not resolve the dataset's Arrow schema "
                          f"({e!r}); appended files will be admitted without schema-drift "
                          f"classification")
        stats_cols = set()
        if rowgroup_pruning and predicate is not None and hasattr(predicate, "intervals"):
            stats_cols = {f for f, _ in predicate.intervals() or ()}
        watcher = DatasetWatcher(
            ctx, base_snapshot=snapshot, reference_schema=reference_schema,
            poll_interval_s=refresh_interval_s if refresh_interval_s > 0 else None,
            retry_policy=retry_policy,
            deadline=(self._stage_deadline if self._stage_deadline is not None
                      else DEFAULT_LIST_DEADLINE),
            fault_plan=fault_plan, telemetry=self.telemetry, quarantine=self.quarantine,
            stats_columns=sorted(stats_cols))
        if refresh_interval_s > 0:
            watcher.start()
        return watcher

    def _attach_resilience(self, pool, worker_crash_budget, stage_deadline_s, hedge_policy,
                           hang_timeout_s) -> dict:
        """The JAX reader's resilience wiring (``reader.py:1339-1386``): the
        quarantine (which :meth:`_prepare_pool` attaches to every pool, with
        crash recovery on processes), the checks of the latency arguments,
        and the workers' ``stage_deadline``, ``hedge_policy`` and
        ``cancel_token``. One cancel token serves the in-process workers
        (their checkpoints read it, the watchdog requests it); spawned
        workers get none, there being no flag to share across processes:
        the watchdog kills them instead."""
        from petastorm_tpu_torch.resilience import (CancellationToken, HedgePolicy,
                                                    RowGroupQuarantine, StageDeadline)
        self.quarantine = RowGroupQuarantine(telemetry=self.telemetry)
        if worker_crash_budget and not isinstance(pool, ProcessPool):
            # In-process workers cannot die apart from the trainer.
            warnings.warn("worker_crash_budget only applies to "
                          "reader_pool_type='process'; ignored")
        stage_deadline = StageDeadline.from_arg(stage_deadline_s)
        if hedge_policy is not None and not isinstance(hedge_policy, HedgePolicy):
            raise TypeError(f"hedge_policy must be a petastorm_tpu_torch.resilience.HedgePolicy "
                            f"(or None), got {type(hedge_policy).__name__}")
        if hang_timeout_s is not None and hang_timeout_s <= 0:
            raise ValueError(f"hang_timeout_s must be positive, got {hang_timeout_s}")
        cancel_token = (CancellationToken()
                        if (stage_deadline is not None or hang_timeout_s is not None)
                        and not isinstance(pool, ProcessPool) else None)
        return {"stage_deadline": stage_deadline, "hedge_policy": hedge_policy,
                "cancel_token": cancel_token}

    def _attach_cache(self, pool, fault_plan, memory_cache_size_bytes=None, **disk):
        """The row-group cache (or None). The decoded cache counts into
        this reader's registry on an in-process pool, whose workers share
        it, and warns on processes, where each worker keeps a private one;
        the disk cache is one directory that every worker opens."""
        cache = _make_cache(fault_plan=fault_plan,
                            memory_cache_size_bytes=memory_cache_size_bytes, **disk)
        if cache is None or not getattr(cache, "caches_decoded", False):
            return cache
        if isinstance(pool, ProcessPool):
            warnings.warn(
                f"memory_cache_size_bytes with reader_pool_type='process' keeps a PRIVATE cache "
                f"of that size in every spawned worker: up to {pool.workers_count}x the "
                f"configured bytes host-wide. Size accordingly, or use the thread pool to share "
                f"one cache.")
        else:
            cache.attach_telemetry(self.telemetry)
        return cache

    def _make_readahead(self, pool, ctx, view_schema, predicate, depth, max_bytes, fault_plan,
                        hedge_policy):
        """The readahead stage of ``depth`` groups over every column a
        worker reads (the view's, every NGram timestep's, the predicate's),
        charged to a private budget of ``max_bytes``; None without a depth,
        and on processes (with a warning: a spawned worker cannot pop from
        this process)."""
        if not depth:
            return None
        if isinstance(pool, ProcessPool):
            warnings.warn("readahead_depth only applies to in-process pools "
                          "(reader_pool_type='thread'/'dummy'); ignored for the process pool")
            return None
        from petastorm_tpu_torch.autotune import MemoryBudget
        from petastorm_tpu_torch.reader_impl.readahead import ReadaheadFetcher
        columns = set(self.ngram.get_field_names_at_all_timesteps() if self.ngram is not None
                      else view_schema.fields)
        if predicate is not None:
            columns |= set(predicate.get_fields())
        # The submissions' cap is sized for the ventilator's autotuned
        # ceiling: a consumer that stops popping (epochs served by the
        # cache) cannot pile them up.
        return ReadaheadFetcher(ctx.filesystem, columns, depth=int(depth),
                                budget=MemoryBudget(max_bytes or DEFAULT_READAHEAD_BYTES),
                                fault_plan=fault_plan, hedge_policy=hedge_policy,
                                telemetry=self.telemetry,
                                max_queue=4 * pool.workers_count * (1 + _VENTILATE_EXTRA_ROWGROUPS))

    def _prepare_pool(self, pool) -> None:
        """What a pool takes from the reader before ``start()``, for the
        first pool and a migrated one alike: the registry, the quarantine,
        crash recovery (processes, under ``worker_crash_budget``), the stage
        deadline (in-process pools hold whole items to its soft budget) and,
        for a batch reader on processes, the conversion of each table to
        numpy views over the ring."""
        pool.telemetry = self.telemetry
        pool.quarantine = self.quarantine
        if isinstance(pool, ProcessPool) and self._worker_crash_budget:
            from petastorm_tpu_torch.resilience import WorkerCrashRecovery
            pool.recovery = WorkerCrashRecovery(self._worker_crash_budget,
                                                telemetry=self.telemetry)
        if hasattr(pool, "stage_deadline"):
            pool.stage_deadline = self._stage_deadline
        if self._batched and isinstance(pool, ProcessPool) and not self._convert_early_to_numpy:
            pool.result_transform = partial(arrow_table_to_numpy_dict, schema=self.schema)

    def _worker_args_for(self, pool) -> dict:
        """The workers' args for ``pool``: a spawned worker gets no live
        handle (it resolves the URL itself, counts locally, reads inline and
        has no cross-process cancel flag), and no ``decode_transport``
        fusion (the rings' Arrow stream is the transport)."""
        if not isinstance(pool, ProcessPool):
            return self._worker_args_inproc
        from petastorm_tpu_torch.plan import FUSION_DECODE_TRANSPORT
        return {**self._worker_args_inproc, "filesystem": None, "resilience_telemetry": None,
                "cancel_token": None, "readahead": None,
                "plan_fusions": frozenset(self._worker_args_inproc["plan_fusions"])
                - {FUSION_DECODE_TRANSPORT}}

    def _sync_pool_gauges(self, pool) -> None:
        """Point the pool-derived gauges at ``pool`` (at construction and at
        a migration): ``pool.backend`` 0 for threads and the dummy pool, 1
        for processes, as in the JAX package; the results queue's depth and
        bound (0 on processes, whose queued results lie in the rings)."""
        depth_gauge = self.telemetry.gauge("pool.results_queue_depth")
        capacity_gauge = self.telemetry.gauge("pool.results_queue_capacity")
        is_process = isinstance(pool, ProcessPool)
        self.telemetry.gauge("pool.backend").set(1.0 if is_process else 0.0)
        if is_process:
            depth_gauge.set_function(None)
            depth_gauge.set(0)
            capacity_gauge.set(0)
        else:
            depth_gauge.set_function(pool.results_qsize)
            # results_qsize() sums every worker's queue: so does the bound.
            capacity_gauge.set(pool.diagnostics["results_queue_capacity"]
                               * max(1, pool.workers_count))

    def _make_autotune(self, pool, autotune_config, hang_timeout_s):
        """The controller over this pipeline's knobs: the thread pool's
        gate, the ventilator's cap and the readahead depth. With
        ``memory_budget_bytes`` the cache and the readahead stage charge one
        shared ledger, which the controller watches; the cache's own budget
        is never the pressure signal (a full cache is a healthy one).

        With ``placement``, a placement actuator whose trial migrates the
        pool, where a migration can run: a thread or process pool, no
        readahead stage and no watchdog (both bound to the pool they started
        with), and a predicate, transform and retry policy that pickle into
        a spawned worker; else a warning. A warm start from a persisted plan
        pins the knob instead and seeds the actuators with the persisted
        values."""
        from petastorm_tpu_torch.autotune import (AutotuneController, MemoryBudget,
                                                  ReadaheadDepthActuator,
                                                  VentilatorDepthActuator,
                                                  WorkerConcurrencyActuator)
        budget = None
        budget_bytes = getattr(autotune_config, "memory_budget_bytes", None)
        if budget_bytes:
            budget = MemoryBudget(budget_bytes, telemetry=self.telemetry)
            if getattr(self._cache, "caches_decoded", False):
                self._cache.budget = budget
            if self.readahead is not None:
                self.readahead.budget = budget
        controller = AutotuneController(self.telemetry, autotune_config, budget=budget)
        gate = getattr(pool, "concurrency_gate", None)
        if gate is not None:
            controller.register(WorkerConcurrencyActuator(gate, pool.workers_count))
        controller.register(VentilatorDepthActuator(self._ventilator))
        if self.readahead is not None:
            controller.register(ReadaheadDepthActuator(self.readahead))
        persisted = self._plan is not None and self._plan.source == "persisted"
        if getattr(autotune_config, "placement", False) and not persisted:
            args = self._worker_args_inproc
            if (self._pool_factory is not None and isinstance(pool, (ThreadPool, ProcessPool))
                    and self.readahead is None and hang_timeout_s is None
                    and all(_spawnable(args[k]) for k in ("predicate", "transform_spec",
                                                          "retry_policy"))):
                from petastorm_tpu_torch.autotune import PlacementActuator
                self._placement_actuator = controller.register(PlacementActuator(
                    self._request_pool_migration,
                    "process" if isinstance(pool, ProcessPool) else "thread"))
                # A resolved trial persists, so the next reader skips it.
                controller.on_placement_resolved = self._on_placement_resolved
            else:
                warnings.warn(
                    "autotune_config.placement=True ignored: placement migration needs a "
                    "thread/process pool without readahead_depth or hang_timeout_s, and a "
                    "predicate, transform_spec and retry_policy that pickle into a spawned "
                    "worker")
        elif persisted:
            # The pool was built on the persisted winner: no trial, and the
            # actuators start at the persisted run's values (clamped).
            controller.pin_placement({"verdict": "persisted", "backend": self._plan.pool_type,
                                      "trial": self._plan.trial})
            for name, value in (self._plan.capacity_seeds.get("actuators") or {}).items():
                seeded = controller.actuator(name)
                if seeded is not None:
                    seeded.set(value)
        return controller

    def _make_ventilate_fn(self, pool):
        """``pool.ventilate``, adding in trace mode the item's lineage id
        (``e{epoch}:g{ordinal}``, the kwarg ``trace_context`` the pools pop)
        and a ``petastorm_tpu.ventilate`` event, and announcing the item to
        the readahead stage (not on processes: a spawned worker reads
        inline). The first pool and a migrated one both go through here."""
        recorder = self.telemetry.recorder
        pool_ventilate = pool.ventilate
        readahead = None if isinstance(pool, ProcessPool) else self.readahead
        ordinal_of = self._ordinal_of

        def ventilate_fn(**kwargs):
            trace = None
            if recorder.trace_enabled:
                ctx = kwargs.get(ITEM_CONTEXT_KWARG)
                if ctx is not None:
                    epoch, pos = ctx
                    rg = kwargs["rowgroup"]
                    trace = f"e{epoch}:g{ordinal_of.get((rg.path, rg.row_group), pos)}"
                    kwargs["trace_context"] = trace
                    recorder.record_event("petastorm_tpu.ventilate", trace=trace,
                                          stage="ventilate", track="ventilator")
            if readahead is not None:
                readahead.submit(kwargs["rowgroup"], trace=trace)
            pool_ventilate(**kwargs)
        return ventilate_fn

    def _request_pool_migration(self, backend: str) -> None:
        """The placement actuator's endpoint (any thread): migrate the decode
        stage to ``backend`` at the next safe point of the consumer."""
        self._pending_pool_target = backend

    def _perform_pool_migration(self) -> None:
        """Swap the decode stage between threads and processes on the
        consumer's thread (the JAX reader's ``_perform_pool_migration``):
        park the ventilator before its next item, drain the old pool (its
        results and their contexts go to the pending queue, delivered
        first), stop it, stand up the new pool through the factory, point
        the ventilator at it and let it go on. Every item ventilated into
        the old pool is consumed from it, and the ventilator resumes into
        the new one: no row is lost or repeated. A delivered batch that
        views the old pool's ring keeps its record (``join()`` keeps a
        viewed ring's mapping)."""
        target, self._pending_pool_target = self._pending_pool_target, None
        current = "process" if isinstance(self._pool, ProcessPool) else "thread"
        if target == current or self._pool_factory is None:
            if self._placement_actuator is not None:
                self._placement_actuator.mark_applied()
            return
        logger.info("Migrating the decode stage: %s pool -> %s pool", current, target)
        t0 = time.perf_counter()
        old_pool = self._pool
        if not self._ventilator.pause():
            warnings.warn("placement migration skipped: ventilator did not quiesce in time")
            self._ventilator.resume()
            if self._placement_actuator is not None:
                self._placement_actuator.mark_failed(current)
            return
        buffered = []
        migrated = aborted = False
        try:
            drain_deadline = time.monotonic() + _MIGRATION_DRAIN_TIMEOUT_S
            while True:
                d = old_pool.diagnostics
                if d["items_inprocess"] <= 0 and d["output_queue_size"] <= 0:
                    break
                if time.monotonic() > drain_deadline:
                    warnings.warn(
                        f"placement migration aborted: the {current} pool did not drain within "
                        f"{_MIGRATION_DRAIN_TIMEOUT_S:.0f}s ({d['items_inprocess']} item(s) "
                        f"still in flight); staying on the {current} pool")
                    aborted = True
                    return
                try:
                    # Bounded waits: processed markers are consumed inside
                    # get_results without a result, so the counts are read
                    # again between attempts.
                    result = old_pool.get_results(timeout=0.25)
                except TimeoutWaitingForResultError:
                    continue
                except EmptyResultError:
                    break
                buffered.append((result, old_pool.result_context))
            # Detached before the stop, which would stop ventilation for good.
            old_pool._ventilator = None
            final = old_pool.diagnostics
            old_pool.stop()
            old_pool.join()

            new_pool = self._pool_factory(target)
            self._prepare_pool(new_pool)
            new_pool.start(self._worker_class, self._worker_args_for(new_pool), ventilator=None)
            # The running ventilator is the new pool's now: its processed
            # credits flow there, and the parked thread ventilates into it.
            new_pool._ventilator = self._ventilator
            self._ventilator.set_ventilate_fn(self._make_ventilate_fn(new_pool))
            self._sync_pool_gauges(new_pool)
            if self.autotune is not None:
                self.autotune.unregister("worker_concurrency")
                gate = getattr(new_pool, "concurrency_gate", None)
                if gate is not None:
                    from petastorm_tpu_torch.autotune import WorkerConcurrencyActuator
                    self.autotune.register(WorkerConcurrencyActuator(gate,
                                                                     new_pool.workers_count))
            # The old pool's tallies retire into the base as the live pool
            # swaps, in one step under the lock diagnostics reads.
            with self._diag_lock:
                self._pool_items_base["items_ventilated"] += final["items_ventilated"]
                self._pool_items_base["items_processed"] += final["items_processed"]
                add_counters(self._pool_counters_base, old_pool.counters)
                self._pool = new_pool
            self._pending.extend(buffered)
            buffered = []
            migrated = True
        except BaseException as exc:
            # The old pool may be stopped already: the pipeline is broken,
            # and every later pull raises this, after the drained results.
            self._migration_error = exc
            raise
        finally:
            if buffered:
                self._pending.extend(buffered)
            if self._placement_actuator is not None:
                if migrated:
                    self._placement_actuator.mark_applied()
                else:
                    self._placement_actuator.mark_failed(current)
            if migrated or aborted:
                # After a hard failure the ventilator stays parked: it would
                # feed a stopped pool.
                self._ventilator.resume()
        self.telemetry.counter("autotune.placement_migrations").add(1)
        logger.info("Decode stage on the %s pool (the migration took %.2f s)", target,
                    time.perf_counter() - t0)

    def _safe_point(self) -> None:
        """Before each pull: a failed migration raises once the results it
        drained are delivered, a requested migration runs, then admitted
        growth folds into the plan (it changes only epochs not planned yet,
        so the epoch being read does not see it)."""
        if self._migration_error is not None and not self._has_buffered():
            raise self._migration_error
        if self._pending_pool_target is not None:
            self._perform_pool_migration()
        if self._discovery is not None and self._discovery.has_growth:
            self._apply_dataset_growth()

    # ------------------------------------------------------------ live data
    def _plan_growth_batch(self, files):
        """One admitted growth batch through the base plan's steps (the JAX
        reader's ``_plan_growth_batch``): filters, partition predicate, the
        shard walk continued, statistics pruning, coalescing; lineage
        ordinals continue after the plan's. ``files``: ``[(path,
        num_row_groups, per_group_stats or None)]`` in admission order; the
        statistics come from the watcher's footer reads, or (a manifest
        resume records names only) from a footer scan of those files.
        Returns ``(new_items, {"row_groups", "pruned"})``."""
        plan = self._live_plan
        refs, stats_by_key, have_stats = [], {}, True
        for path, n_groups, stats in files:
            pv = self._ctx.partition_values_for(path)
            for i in range(n_groups):
                refs.append(RowGroupRef(path, i, pv))
                if stats is not None and i < len(stats):
                    stats_by_key[(path, i)] = stats[i]
            if stats is None:
                have_stats = False
        kept = refs
        if plan["filters"]:
            kept = _apply_filters(kept, plan["filters"])
        if plan["predicate"] is not None:
            kept = _apply_partition_predicate(kept, plan["predicate"])
        if plan["cur_shard"] is not None:
            start = self._shard_stream_index
            self._shard_stream_index = start + len(kept)
            kept = [rg for i, rg in enumerate(kept, start=start)
                    if i % plan["shard_count"] == plan["cur_shard"]]
        for rg in kept:
            self._ordinal_of[(rg.path, rg.row_group)] = self._next_ordinal
            self._next_ordinal += 1
        pruned = 0
        predicate = plan["predicate"]
        constraints = (predicate.intervals() if plan["pruning"] and predicate is not None
                       and hasattr(predicate, "intervals") else None)
        if constraints:
            fields = sorted({f for f, _ in constraints})
            stats = (stats_by_key if have_stats
                     else load_row_group_stats(self._ctx, kept, fields, telemetry=self.telemetry))
            _fold_plan_column_stats(self._plan_column_stats, stats.values())
            report = self._pruning_report
            if report.get("enabled"):
                report["column_stats"] = dict(self._plan_column_stats)
            kept2, _ = _prune_with_stats(kept, constraints, stats)
            pruned = len(kept) - len(kept2)
            kept = kept2
            if report.get("enabled"):
                report["row_groups_pruned"] = report.get("row_groups_pruned", 0) + pruned
                report["row_groups_kept"] = report.get("row_groups_kept", 0) + len(kept)
            self.telemetry.counter("io.rowgroups_pruned").add(pruned)
            self.telemetry.counter("io.rowgroups_planned").add(len(kept))
        if plan["coalescing"] > 1:
            kept = _coalesce_row_groups(kept, plan["coalescing"])
        parts = plan["drop_partitions"]
        new_items = [{"rowgroup": rg, "shuffle_row_drop_partition": (part, parts)}
                     for rg in kept for part in range(parts)]
        return new_items, {"row_groups": len(refs), "pruned": pruned}

    def _apply_dataset_growth(self) -> None:
        """Fold the watcher's staged files into the plan, on the consumer's
        thread (the JAX reader's ``_apply_dataset_growth``): the new items
        follow the existing ones from the first epoch the ventilator has not
        planned, so a planned epoch (the one being read too) is delivered as
        without the growth, cursors stay valid, and the next epoch is a
        function of ``(seed, epoch, grown plan)``. The lookup plane, when
        made, indexes the new files too."""
        with self._growth_lock:
            self._fold_staged_growth()

    def _fold_staged_growth(self) -> None:
        staged = self._discovery.drain_staged()
        if not staged:
            return
        new_items, info = self._plan_growth_batch(
            [(a.path, a.num_row_groups, a.stats) for a in staged])
        effective = self._ventilator.extend_items(new_items)
        if self._epoch_plan is not None and new_items:
            self._epoch_plan.extend(effective, self._num_items + len(new_items))
        self._num_items += len(new_items)
        batch = {"epoch": effective,
                 "files": [[os.path.relpath(a.path, self._ctx.root_path), a.num_row_groups]
                           for a in staged],
                 "items": len(new_items), **info}
        self._growth_batches.append(batch)
        if self._lookup_plane is not None:
            # Best effort: a failed index extension must not stop the
            # stream the growth is for.
            try:
                self._lookup_plane.extend_files([(a.path, a.num_row_groups) for a in staged])
            except Exception:  # noqa: BLE001
                logger.exception("field-index growth extension failed; lookups will not see "
                                 "the appended files")
        self.telemetry.counter("discovery.items_extended").add(len(new_items))
        self.telemetry.record_event("discovery.growth_applied",
                                    {"epoch": effective, "files": len(staged),
                                     "row_groups": info["row_groups"], "items": len(new_items),
                                     "pruned": info["pruned"]})
        logger.info("live growth applied: %d file(s), %d row group(s) -> %d work item(s) "
                    "(%d pruned), effective from epoch %d", len(staged), info["row_groups"],
                    len(new_items), info["pruned"], effective)

    def refresh_dataset(self) -> dict:
        """Poll the store once, fold the admitted growth into the plan and
        return :meth:`dataset_growth_report`: the explicit poll beside the
        background one (with ``refresh_interval_s=0``, this and
        :meth:`reset` are the only polls)."""
        if self._discovery is None:
            raise RuntimeError("refresh_dataset() needs make_reader(refresh_interval_s=...)")
        self._discovery.poll_once()
        self._apply_dataset_growth()
        return self.dataset_growth_report()

    def dataset_growth_report(self) -> dict:
        """The live data (the JAX reader's keys): ``enabled``,
        ``refresh_interval_s``, ``items`` (work items planned now),
        ``applied`` (each growth batch: its effective ``epoch``, ``files``,
        ``items``, ``row_groups``, ``pruned``) and ``discovery`` (the
        watcher's :meth:`~petastorm_tpu_torch.discovery.DatasetWatcher.report`).
        ``{"enabled": False}`` without ``refresh_interval_s`` or growth."""
        if self._discovery is None and not self._growth_batches:
            return {"enabled": False}
        report = {"enabled": self._discovery is not None,
                  "refresh_interval_s": self._refresh_interval_s,
                  "items": self._num_items,
                  "applied": [dict(b) for b in self._growth_batches]}
        if self._discovery is not None:
            report["discovery"] = self._discovery.report()
        return report

    def _current_manifest(self) -> dict:
        """The cursor's manifest: the base files and the growth batches, in
        admission order."""
        return {"base": [list(entry) for entry in self._base_manifest],
                "growth": [{"epoch": b["epoch"], "files": [list(f) for f in b["files"]],
                            "items": b["items"]} for b in self._growth_batches]}

    def _has_buffered(self) -> bool:
        """Undelivered results that need no live pool."""
        return bool(self._pending) or self._has_partial_unit()

    @property
    def diagnostics(self) -> dict:
        """The pool's counters (the same keys on every pool:
        ``output_queue_size``, ``items_ventilated``, ``items_processed``,
        ``items_inprocess``, ``workers_count``, ``results_queue_capacity``),
        ``pool_type``, ``ventilator_backlog`` and a ``telemetry`` snapshot:
        the JAX reader's keys. That reader's snapshot may also carry the
        ``timeline``, ``explain`` and ``quality`` payloads of planes this
        package does not have. ``items_ventilated`` and ``items_processed``
        include the pools a placement migration retired, and ``pool_type``
        names the live pool."""
        with self._diag_lock:
            pool = self._pool
            d = dict(pool.diagnostics)
            d["items_ventilated"] += self._pool_items_base["items_ventilated"]
            d["items_processed"] += self._pool_items_base["items_processed"]
        d["pool_type"] = ("process" if isinstance(pool, ProcessPool)
                          else "dummy" if isinstance(pool, DummyPool) else "thread")
        d["ventilator_backlog"] = self._ventilator.inflight
        d["telemetry"] = self.telemetry.snapshot()
        return d

    @property
    def pool(self):
        """The live worker pool (``ThreadPool``, ``ProcessPool`` or
        ``DummyPool``)."""
        return self._pool

    @property
    def counters(self) -> dict:
        """The pool's counters summed over the items consumed so far:
        ``images_native`` and ``images_codec``, the image cells decoded by
        the native batch call and by the codec one at a time, and on a
        batched process reader ``zero_copy_batches`` and
        ``zero_copy_bytes``, the batches whose columns view the ring and
        those columns' bytes; in deterministic mode also the gate's
        ``units_reordered``, ``skips_recorded``, ``duplicates_dropped`` and
        ``buffer_depth``. Pools a placement migration retired count too."""
        with self._diag_lock:
            counters = dict(self._pool_counters_base)
            add_counters(counters, self._pool.counters)
        if self._gate is not None:
            counters.update(self._gate.counters())
        return counters

    @property
    def batched_output(self) -> bool:
        """True for a ``make_batch_reader`` reader."""
        return self._batched

    def next_batch(self):
        """The next whole unit as columns. A batched reader: the next row
        group's ``{column: ndarray}``, the arrays ``next()`` wraps in a
        namedtuple. A lazy row reader: the workers'
        :class:`~petastorm_tpu_torch.reader_impl.batch_plane.ColumnarBatch`,
        or the rest of one that ``next()`` served in part, so that mixing
        the two never repeats a row. An eager row reader raises
        ``TypeError``: it has no batch to hand out. Each batch's rows go to
        the ``batch.rows_per_op`` histogram. A fatal escaping it writes the
        black box's bundle before it unwinds."""
        if not self._batched and getattr(self, "row_materialization", "eager") != "lazy":
            raise TypeError("next_batch() needs make_reader(row_materialization='lazy') or "
                            "a make_batch_reader reader; this reader's workers publish rows")
        try:
            return self._next_batch()
        except StopIteration:
            raise
        except Exception as e:
            self._record_fatal(e)
            raise

    def _next_batch(self):
        if not self._batched:
            self._safe_point()
            while self._batch is None:
                if not self._pull():
                    raise StopIteration
            return self._batch_remainder()
        self._safe_point()
        result = self._next_columns()
        if result:
            self._observe_rows_per_op(len(next(iter(result.values()))))
        return result

    def _observe_rows_per_op(self, rows: int) -> None:
        if self._rows_per_op is None:
            self._rows_per_op = self.telemetry.histogram("batch.rows_per_op")
        self._rows_per_op.observe(rows)

    def _next_columns(self) -> dict:
        """A batched reader's next row group as ``{column: ndarray}``."""
        try:
            result = self._get_results()
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration from None
        if self._gate is None:
            self._mark_delivered(self._result_context)
        if not isinstance(result, dict):
            # An Arrow table from a thread or dummy pool worker.
            result = arrow_table_to_numpy_dict(result, self.schema)
        if result:
            self._rows_counter.add(len(next(iter(result.values()))))
        return result

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self._next_row()
        except StopIteration:
            raise
        except Exception as e:
            # A fatal escaping the pipeline (a hang, a pool abort, the crash
            # budget, a worker's exception): the black box writes its bundle
            # before the consumer unwinds, while the registry still
            # describes the death.
            self._record_fatal(e)
            raise

    def _next_row(self):
        self._safe_point()
        if self._batched:
            return self.schema.make_namedtuple_from_dict(self._next_columns())
        while self._batch is None and not self._buffer:
            if not self._pull():
                raise StopIteration
        if self._batch is not None:
            i = self._batch_pos
            row = self.schema.namedtuple(*[None if c is None else c[i]
                                           for c in self._batch_cols])
            self._batch_pos = i + 1
            if self._batch_pos >= self._batch.num_rows:
                self._batch = self._batch_cols = None
            return row
        item = self._buffer.popleft()
        if self.ngram is not None:
            return item   # already a window
        return self.schema.make_namedtuple_from_dict(item)

    def next(self):
        """``next(reader)``."""
        return self.__next__()

    def _pull(self) -> bool:
        """Take the next work item's result into the row buffer or the lazy
        cursor, once the last one was handed out in full; False at the end
        of the stream."""
        self._mark_delivered(self._buffer_context)
        self._buffer_context = None
        try:
            result = self._get_results()
        except EmptyResultError:
            self.last_row_consumed = True
            return False
        if self._gate is None:
            self._buffer_context = self._result_context
        if isinstance(result, ColumnarBatch):
            if result.num_rows:
                self._batch = result
                self._batch_cols = [result.columns.get(n) for n in self.schema.namedtuple._fields]
                self._batch_pos = 0
                self._rows_counter.add(result.num_rows)
                self._observe_rows_per_op(result.num_rows)
        else:
            self._buffer.extend(result)
            self._rows_counter.add(len(result))
        return True

    def _batch_remainder(self) -> ColumnarBatch:
        """The lazy cursor's unserved rows as a batch (views of its columns
        when ``next()`` served some), and the cursor cleared."""
        batch, pos = self._batch, self._batch_pos
        self._batch = self._batch_cols = None
        if pos == 0:
            return batch
        return ColumnarBatch({name: col[pos:] for name, col in batch.columns.items()},
                             batch.num_rows - pos)

    def _has_partial_unit(self) -> bool:
        """Rows of the last unit pulled are still to be handed out."""
        return bool(self._buffer) or self._batch is not None

    def _get_results(self):
        """The next work item's result: through the gate, in plan order, in
        deterministic mode; else as the pool delivers."""
        if self._gate is not None:
            return self._gate.pull(self._fetch_once)
        return self._fetch_once()

    def _fetch_once(self):
        """A result drained from a migrated-away pool, else the live pool's;
        its item's context goes to ``_result_context``."""
        if self._pending:
            result, self._result_context = self._pending.popleft()
            return result
        result = self._timed_get_results()
        self._result_context = self._pool.result_context
        return result

    def _timed_get_results(self):
        """``pool.get_results()``, its wait in ``reader.pool_wait_s`` (and a
        ``petastorm_tpu.pool_wait`` span): the dummy pool's inline decode is
        taken out, so the pool wait and ``worker.decode_s`` stay apart."""
        pool = self._pool
        inline0 = getattr(pool, "inline_decode_s", 0.0)
        watchdog = self.watchdog
        t0 = time.perf_counter()
        with self.telemetry.span("petastorm_tpu.pool_wait", stage="deliver", track="consumer"):
            if watchdog is None:
                result = pool.get_results()
            else:
                watchdog.enter_wait()
                try:
                    result = pool.get_results()
                finally:
                    watchdog.exit_wait()
        wait = time.perf_counter() - t0 - (getattr(pool, "inline_decode_s", 0.0) - inline0)
        self._pool_wait_hist.observe(max(0.0, wait))
        return result

    def _mark_delivered(self, context):
        """Record that every row of the item at ``context`` was handed out."""
        if context is None:
            return
        self._delivered.add(context)
        if len(self._delivered) > _DELIVERED_PRUNE_AT:
            confirmed = self._ventilator.watermark()
            self._delivered = {c for c in self._delivered if c >= confirmed}

    def state_dict(self) -> dict:
        """The read position, ``{"epoch", "offset", "items", "seed"}``: the
        first row group, in the epoch's seeded order, not yet handed out in
        full. Pass it as ``resume_state=`` to continue the stream; groups
        after it that were handed out already (a pool finishes groups out of
        order) are read again: bounded duplication, never loss. ``seed`` is
        the shuffle seed, minted when none was given. Call it from the
        thread that reads; under a loader, which reads ahead, use the
        loader's ``state_dict()``.

        Deterministic mode: the JAX package's cursor, the delivery position
        ``{"epoch", "offset", "window_delivered", "skipped_ordinals",
        "items", "seed", "sample_order", "window", "plan"}``; the resumed
        stream is the rest of the uninterrupted one. A row group handed out
        in part backs the cursor up one unit: it is read again whole.

        Live data (``refresh_interval_s``, or a resumed live cursor): also
        ``"manifest"``, the base files and the growth batches in admission
        order, from which a resumed reader rebuilds the grown plan."""
        if self._gate is not None:
            cur = self._gate.cursor(back_up=self._has_partial_unit())
            cur.update({"items": self._num_items, "seed": self._seed,
                        "sample_order": "deterministic", "window": self._shuffle_window,
                        "plan": self._epoch_plan.describe()})
        else:
            delivered = set(self._delivered)
            if not self._has_partial_unit() and self._buffer_context is not None:
                delivered.add(self._buffer_context)
            epoch, offset = self._ventilator.watermark(delivered)
            cur = {"epoch": epoch, "offset": offset, "items": self._num_items,
                   "seed": self._seed}
        if self._base_manifest is not None:
            # The admission-ordered files pin the ordinals: the sorted
            # listing would put appended files in the middle.
            cur["manifest"] = self._current_manifest()
        return cur

    def quarantine_report(self) -> dict:
        """The row groups given up on so far in degraded mode: their count,
        tallies by error type and state, and each piece's provenance (path,
        row group, exception, attempts, worker). The JAX package's schema."""
        return self.quarantine.report()

    def _ensure_lookup_plane(self):
        """The random-access plane, made on first use from the store's
        field-index sidecar: it shares this reader's cache (a lookup and
        the epoch stream warm each other and hand out the same cells), its
        quarantine, its retry and degraded settings and its registry. It is
        reconciled with every file of this reader's plan: growth applied
        before it was made, and base files newer than the saved sidecar (a
        fresh reader over a grown store plans appended files as its base);
        ``extend_files`` indexes each file once."""
        if self._lookup_plane is None:
            from petastorm_tpu_torch.index import FieldIndex, IndexLookupPlane
            args = self._worker_args_inproc
            self._lookup_plane = IndexLookupPlane(
                self._ctx, FieldIndex.load(self._ctx), self._stored_schema,
                dataset_url=args["dataset_url"], storage_options=args.get("storage_options"),
                filesystem=args.get("filesystem"), cache=self._cache,
                retry_policy=args.get("retry_policy"),
                degraded_mode=args.get("degraded_mode", False),
                fault_plan=args.get("fault_plan"), hedge_policy=args.get("hedge_policy"),
                telemetry=self.telemetry, quarantine=self.quarantine,
                default_columns=sorted(n for n in self.schema.fields
                                       if n in self._stored_schema.fields),
                decode_verdict=args.get("decode_verdict"),
                decode_threads=args.get("decode_threads"))
            root = self._ctx.root_path
            newer = [(os.path.join(root, rel), n) for rel, n in (self._base_manifest or [])]
            newer += [(os.path.join(root, rel), n)
                      for b in self._growth_batches for rel, n in b["files"]]
            newer = [(path, n) for path, n in newer
                     if not self._lookup_plane.index.has_file(os.path.relpath(path, root))]
            if newer:
                self._lookup_plane.extend_files(newer)
        return self._lookup_plane

    def lookup(self, keys, field=None, columns=None, on_missing="error"):
        """Keyed point reads: the decoded rows holding each value of
        ``field``, in key order, co-resident keys served by one row-group
        read and warm groups from the decoded cache. The cells equal an
        epoch read's of the same rows. Needs the store's field index
        (:func:`petastorm_tpu_torch.index.build_field_index`); predicates,
        transforms and shuffles do not apply."""
        return self._ensure_lookup_plane().lookup(keys, field=field, columns=columns,
                                                  on_missing=on_missing)

    def dataset_view(self, columns=None):
        """A :class:`~petastorm_tpu_torch.index.DatasetView` over this
        reader's lookup plane: rows by global ordinal (the index's file
        order, then group, then row), stable across a resume."""
        from petastorm_tpu_torch.index import DatasetView
        return DatasetView(self._ensure_lookup_plane(), columns=columns)

    def cleanup_cache(self):
        """Remove this reader's cache contents (a disk cache made with
        ``cache_extra_settings={"cleanup": True}`` deletes its directory);
        a no-op without a cache."""
        if self._cache is None:
            return
        try:
            self._cache.cleanup()
        except OSError as e:
            logger.warning("Error cleaning cache: %s", e)

    def watchdog_report(self) -> dict:
        """The watchdog's state: hangs detected and recovered, the ladder's
        stage, whether it aborted, the latest stack dump. Empty without
        ``hang_timeout_s``."""
        return {} if self.watchdog is None else self.watchdog.report()

    def readahead_report(self) -> dict:
        """The fetch stage: depth, fetchers, tables ahead, bytes held, and
        its hits, misses, fetch errors, fetches and dropped submissions.
        Empty without ``readahead_depth``."""
        return {} if self.readahead is None else self.readahead.stats()

    def autotune_report(self) -> dict:
        """The controller: ticks, each actuator's value and range, and
        every move (tick, actuator, old, new, verdict). Empty without
        ``autotune``."""
        return {} if self.autotune is None else self.autotune.report()

    def pruning_report(self) -> dict:
        """The plan-time pruning, the same for every epoch (the JAX
        package's schema): whether statistics pruning engaged (or the
        ``reason`` it did not), the constrained ``fields``, the groups
        planned, pruned and kept, ``pruned_per_file``, the folded footer
        ``column_stats``, and a selector's ``selector_pruned``."""
        return dict(self._pruning_report)

    def plan_report(self) -> dict:
        """The executed plan's decisions (the JAX package's
        ``PipelinePlan.describe()``): the placement and its ``source``
        (``default``, ``persisted`` or ``trial``), the trial's verdict, the
        fusions applied or declined, the plan-cache consult, the capacity
        seeds. Empty for a direct ``Reader(...)``."""
        return {} if self._plan is None else self._plan.describe()

    def slo_report(self) -> dict:
        """The SLO watcher's rules, violation totals and active violations;
        empty when ``PETASTORM_TPU_SLO_WATCH`` is unset."""
        return {} if self.slo_watcher is None else self.slo_watcher.report()

    def timeline_report(self) -> dict:
        """The rolling timeline ring (``MetricsTimeline.as_dict()``); empty
        when ``timeline_interval_s``/``PETASTORM_TPU_TIMELINE`` is off."""
        return {} if self._timeline is None else self._timeline.as_dict()

    def anomaly_report(self) -> dict:
        """The anomaly bank's rules, detections so far and what is active;
        empty when the timeline or ``timeline_anomaly`` is off."""
        return {} if self.anomaly_monitor is None else self.anomaly_monitor.report()

    def accounting_report(self) -> dict:
        """This pipeline's resource-accounting totals, stamped with its
        pipeline id and ``tenant=``: the record a running publisher streams
        to the aggregator's ledger."""
        return {"schema_version": ACCOUNTING_SCHEMA_VERSION,
                "pipeline_id": self.telemetry.pipeline_id,
                "tenant": self._tenant,
                "totals": accounting_totals(self.telemetry.metrics_view())}

    def _on_placement_resolved(self, outcome: dict) -> None:
        """The controller's callback when the placement trial resolves:
        the verdict goes on the plan and, when measured, into the plan
        cache with the tuned actuator values, so the next reader of this
        store starts on the winner. The port has no operator profile yet:
        the record's ``profile`` is None. A failure costs only the warm
        start."""
        if self._plan is None:
            return
        if outcome.get("verdict") not in ("kept", "reverted"):
            self._plan.trial = dict(outcome)
            return
        try:
            from petastorm_tpu_torch.plan import record_trial_outcome
            record_trial_outcome(self._plan, outcome,
                                 actuators=(self.autotune.actuator_values()
                                            if self.autotune is not None else {}),
                                 profile=None)
        except Exception:  # noqa: BLE001 - persistence never stops the reader
            logger.exception("plan-cache persist failed; the trial's verdict still applies "
                             "to this run")

    def reset(self):
        """Start another pass; only legal once the current one is consumed.

        With live data the reset rebases the plan: the store is polled
        (with ``refresh_interval_s=0``), staged growth folds in, and the new
        pass plans every admitted item from its epoch 0 (also on a reader
        resumed from a live cursor without discovery)."""
        if not self.last_row_consumed:
            raise RuntimeError(
                "reset() is only supported after the previous pass was fully consumed")
        if self._discovery is not None:
            if not self._refresh_interval_s:
                self._discovery.poll_once()
            if self._discovery.has_growth:
                self._apply_dataset_growth()
        if self._growth_batches:
            self._ventilator.rebase_growth()
            if self._epoch_plan is not None:
                self._epoch_plan.rebase()
            for batch in self._growth_batches:
                self._base_manifest.extend([list(f) for f in batch["files"]])
            self._growth_batches = []
        self._ventilator.reset()
        if self._gate is not None:
            self._gate.reset()   # another pass replays the same order
        self._buffer_context = None
        self._delivered = set()
        self.last_row_consumed = False

    def stop(self):
        if self._plan is not None and self._plan.source == "trial" \
                and (self._plan.trial or {}).get("verdict") in ("kept", "reverted"):
            # The record refreshed with the run's final knob values.
            try:
                from petastorm_tpu_torch.plan import record_trial_outcome
                record_trial_outcome(self._plan, self._plan.trial,
                                     actuators=(self.autotune.actuator_values()
                                                if self.autotune is not None else {}),
                                     profile=None)
            except Exception:  # noqa: BLE001 - persistence never stops the reader
                logger.exception("plan-cache refresh at close failed")
        if self.slo_watcher is not None:
            self.slo_watcher.stop()
        if self._timeline_sampler is not None:
            # Before the exporter's and the publisher's final flushes: the
            # sampler's stop takes the terminal window.
            self._timeline_sampler.stop()
        if self.autotune is not None:
            self.autotune.stop()
        if self._telemetry_publisher is not None:
            # The final (``bye``) window ships the terminal state.
            self._telemetry_publisher.stop()
            self._telemetry_publisher = None
        if self._telemetry_exporter is not None:
            self._telemetry_exporter.stop()
            self._telemetry_exporter = None
        if self._discovery is not None:
            self._discovery.stop()
        if self._lookup_plane is not None:
            self._lookup_plane.close()
        self._pool.stop()
        if self.readahead is not None:
            # After the pool: a worker waiting in a pop sees the stop and
            # reads inline; the held tables and their charge go.
            self.readahead.close()

    def join(self):
        if self.watchdog is not None:
            self.watchdog.stop()
        self._pool.join()
        if self._cache is not None:
            self._cache.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
        return False
