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
order its workers finish; the JAX reader's statistics pruning, which the
port leaves out, reorders a shuffled epoch under some predicates). With
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
"""
from __future__ import annotations

import io
import os
import pickle
import random
import sys
import time
import types
import warnings
from collections import deque
from functools import partial
from typing import Optional, Sequence

from petastorm_tpu_torch.codecs import CompressedImageCodec, decode_verdict
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, get_schema,
                                                      infer_or_load_unischema, load_row_groups)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.batch_plane import ColumnarBatch
from petastorm_tpu_torch.reader_impl.batch_reader_worker import (BatchReaderWorker,
                                                                 arrow_table_to_numpy_dict)
from petastorm_tpu_torch.reader_impl.epoch_plan import EpochPlan, OrderedDeliveryGate, mint_seed
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
from petastorm_tpu_torch.telemetry import PeriodicExporter, TELEMETRY_EXPORT_ENV, make_registry
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers_pool import EmptyResultError, ITEM_CONTEXT_KWARG
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

#: In-flight row groups per worker beyond the one it is decoding.
_VENTILATE_EXTRA_ROWGROUPS = 3

#: Handed-out items remembered before those the ventilator has confirmed
#: are dropped from the reader's record.
_DELIVERED_PRUNE_AT = 256

#: Per-worker shm ring bytes of the process pool, and the least it shrinks
#: to where ``/dev/shm`` is small (reference petastorm_tpu/reader.py:251-265).
DEFAULT_RING_CAPACITY = 128 << 20
MIN_RING_CAPACITY = 16 << 20
SHM_DIR = "/dev/shm"


def shm_free_bytes(path: str = SHM_DIR) -> int:
    """Bytes free in the shared-memory filesystem."""
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


def ring_capacity_for(workers_count: int, free_bytes: Optional[int] = None) -> int:
    """Each process worker's ring: :data:`DEFAULT_RING_CAPACITY`, or the
    even share of the free ``/dev/shm`` when that is smaller, but no less
    than :data:`MIN_RING_CAPACITY`. Raises ``RuntimeError`` when the rings
    do not fit even so: the reader never turns to threads by itself."""
    free = shm_free_bytes() if free_bytes is None else free_bytes
    capacity = max(MIN_RING_CAPACITY, min(DEFAULT_RING_CAPACITY, free // max(1, workers_count)))
    if capacity * workers_count > free:
        raise RuntimeError(
            f"reader_pool_type='process' needs {workers_count} shared-memory rings of at "
            f"least {MIN_RING_CAPACITY >> 20} MiB, but {SHM_DIR} has {free} bytes free: "
            f"enlarge {SHM_DIR}, use fewer workers or reader_pool_type='thread'")
    return capacity


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


def _apply_selector(ctx, all_row_groups, row_groups, selector):
    """The groups ``selector`` selects through the store's indexes; its
    ordinals index the unfiltered order."""
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
    indexes = get_row_group_indexes(ctx)
    for name in selector.get_index_names():
        if name not in indexes:
            raise ValueError(f"Index {name!r} not found in dataset metadata "
                             f"(available: {sorted(indexes)})")
    selected = {id(all_row_groups[i]) for i in selector.select_row_groups(indexes)
                if i < len(all_row_groups)}
    return [rg for rg in row_groups if id(rg) in selected]


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
                     cur_shard, shard_count, shard_seed, rowgroup_subset):
    """The JAX reader's planning steps, in its order."""
    planned = list(all_row_groups)
    if filters:
        planned = _apply_filters(planned, filters)
    if predicate is not None:
        planned = _apply_partition_predicate(planned, predicate)
    if rowgroup_selector is not None:
        planned = _apply_selector(ctx, all_row_groups, planned, rowgroup_selector)
    if cur_shard is not None:
        planned = _shard_row_groups(planned, cur_shard, shard_count, shard_seed)
    if rowgroup_subset is not None:
        planned = _apply_rowgroup_subset(all_row_groups, planned, rowgroup_subset)
    return planned


class _SpawnPickler(pickle.Pickler):
    """Refuses functions and classes of ``__main__``: a spawned worker runs
    another main module and could not load them."""

    def persistent_id(self, obj):
        if isinstance(obj, (type, types.FunctionType)) and obj.__module__ == "__main__":
            raise pickle.PicklingError(f"{obj.__qualname__} is defined in __main__")
        return None


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


def make_reader(dataset_url: str,
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
                row_materialization: str = "eager",
                storage_options: Optional[dict] = None,
                filesystem=None,
                pool_profiling_enabled: bool = False) -> "Reader":
    """Reader over a store written by ``materialize_dataset_local`` (either
    package's).

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

    On ``reader_pool_type="process"`` the predicate and the transform must
    pickle into a spawned worker: a ``ValueError`` says so at construction.
    """
    seed = _resolve_seed(seed, resume_state, shuffle_row_groups, shuffle_rows, sample_order)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, shuffle_rows, seed,
                      PickleSerializer(), pool_profiling_enabled)
    return Reader(dataset_url, pool, schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, resume_state=resume_state,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  rowgroup_selector=rowgroup_selector, filters=filters, shard_seed=shard_seed,
                  transform_spec=transform_spec, rowgroup_subset=rowgroup_subset,
                  sample_order=sample_order, shuffle_window=shuffle_window,
                  row_materialization=row_materialization, storage_options=storage_options,
                  filesystem=filesystem)


def make_batch_reader(dataset_url: str,
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
                      storage_options: Optional[dict] = None,
                      filesystem=None,
                      pool_profiling_enabled: bool = False) -> "Reader":
    """Columnar reader of any Parquet store (several files, with or without
    petastorm metadata; a store without it gets a schema inferred from its
    Arrow schema): one batch of ``{column: ndarray}`` per row group,
    through :meth:`Reader.next_batch`, or a namedtuple of those columns
    per ``next()``.

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

    The other arguments are :func:`make_reader`'s.
    """
    seed = _resolve_seed(seed, resume_state, shuffle_row_groups, shuffle_rows, sample_order)
    cur_shard, shard_count = _resolve_shard(cur_shard, shard_count)
    serializer = PickleSerializer() if convert_early_to_numpy else ArrowTableSerializer()
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, shuffle_rows, seed,
                      serializer, pool_profiling_enabled)
    return Reader(dataset_url, pool, schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, is_batched_reader=True,
                  convert_early_to_numpy=convert_early_to_numpy, resume_state=resume_state,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions, predicate=predicate,
                  rowgroup_selector=rowgroup_selector, filters=filters, shard_seed=shard_seed,
                  transform_spec=transform_spec, rowgroup_subset=rowgroup_subset,
                  sample_order=sample_order, shuffle_window=shuffle_window,
                  storage_options=storage_options, filesystem=filesystem)


def _check_sample_order(sample_order: str, shuffle_window: int) -> None:
    """The JAX package's plan-time checks of the two arguments."""
    if sample_order not in ("free", "deterministic"):
        raise ValueError(f"sample_order must be 'free' or 'deterministic', got {sample_order!r}")
    if shuffle_window is not None and int(shuffle_window) < 0:
        raise ValueError(f"shuffle_window must be >= 0, got {shuffle_window}")
    if shuffle_window and sample_order != "deterministic":
        raise ValueError("shuffle_window is the deterministic plane's window-shuffle mode; "
                         "pass sample_order='deterministic' with it")


def _resolve_materialization(row_materialization: str, ngram, transform_spec) -> str:
    """The JAX package's checks of ``row_materialization``: any value but
    ``'eager'`` or ``'lazy'`` raises; an NGram or a per-row transform func
    falls back to eager with a warning."""
    if row_materialization not in ("eager", "lazy"):
        raise ValueError(f"row_materialization must be 'eager' or 'lazy', "
                         f"got {row_materialization!r}")
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
    (``reader.py:1536-1604``). A live-data cursor is refused."""
    plan = resume_state.get("plan") or {}
    if "manifest" in resume_state or "growth" in plan:
        raise ValueError("resume_state is a live-data cursor (it records a file manifest or a "
                         "grown plan); this package does not read live data")
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
                         f"with the same dataset, filters, sharding and "
                         f"shuffle_row_drop_partitions as the saved run.")
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
               serializer, pool_profiling_enabled=False):
    if reader_pool_type == "thread":
        return ThreadPool(workers_count, results_queue_size, shuffle_rows=shuffle_rows, seed=seed,
                          profiling_enabled=pool_profiling_enabled)
    if pool_profiling_enabled and reader_pool_type in ("process", "dummy"):
        # cProfile sees this process's threads: process workers run
        # elsewhere, and the dummy pool has no worker threads.
        warnings.warn(f"pool_profiling_enabled only applies to reader_pool_type='thread'; "
                      f"ignored for {reader_pool_type!r}")
    if reader_pool_type == "process":
        return ProcessPool(workers_count, ring_capacity=ring_capacity_for(workers_count),
                           serializer=serializer)
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
    """

    def __init__(self, dataset_url, pool, schema_fields, shuffle_row_groups,
                 shuffle_rows, seed, num_epochs, cur_shard, shard_count,
                 is_batched_reader=False, convert_early_to_numpy=False, resume_state=None,
                 shuffle_row_drop_partitions=1, predicate=None, rowgroup_selector=None,
                 filters=None, shard_seed=None, transform_spec=None, rowgroup_subset=None,
                 sample_order="free", shuffle_window=0, row_materialization="eager",
                 storage_options=None, filesystem=None):
        if rowgroup_subset is not None and cur_shard is not None:
            raise ValueError("rowgroup_subset and cur_shard/shard_count are mutually exclusive: "
                             "an explicit ordinal subset is a shard assignment")
        if rowgroup_subset is not None and shuffle_row_groups:
            raise ValueError("rowgroup_subset delivers row groups in exactly the given order; "
                             "pass shuffle_row_groups=False and shuffle the ordinal list itself")
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not (isinstance(cur_shard, int)
                                          and 0 <= cur_shard < shard_count):
            raise ValueError(f"cur_shard must be an int in [0, {shard_count}), "
                             f"got {cur_shard!r}")
        if shuffle_row_drop_partitions < 1:
            raise ValueError(f"shuffle_row_drop_partitions must be >= 1, "
                             f"got {shuffle_row_drop_partitions}")
        _check_sample_order(sample_order, shuffle_window)
        shuffle_window = int(shuffle_window or 0)
        #: ``'free'`` or ``'deterministic'``: the reader's order contract.
        self.sample_order = sample_order
        self._shuffle_window = shuffle_window
        #: The pipeline's telemetry registry; a loader over this reader
        #: adopts it.
        self.telemetry = make_registry()
        self._telemetry_exporter = None
        self._rows_counter = self.telemetry.counter("reader.rows")
        self._pool_wait_hist = self.telemetry.histogram("reader.pool_wait_s")
        self._rows_per_op = None   # batch.rows_per_op, made on the first batch
        ctx = DatasetContext(dataset_url, storage_options=storage_options, filesystem=filesystem)
        self._batched = is_batched_reader
        stored_schema = infer_or_load_unischema(ctx) if is_batched_reader else get_schema(ctx)
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

        all_row_groups = load_row_groups(ctx)
        row_groups = _plan_row_groups(ctx, all_row_groups, filters, predicate,
                                      rowgroup_selector, cur_shard, shard_count, shard_seed,
                                      rowgroup_subset)
        if not row_groups:
            raise NoDataAvailableError(
                f"No row groups left after predicate/selector/shard filtering "
                f"(dataset has {len(all_row_groups)}; cur_shard={cur_shard}, "
                f"shard_count={shard_count})")
        items = [{"rowgroup": rg,
                  "shuffle_row_drop_partition": (part, shuffle_row_drop_partitions)}
                 for rg in row_groups for part in range(shuffle_row_drop_partitions)]

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
            self._epoch_plan = EpochPlan(seed=seed, num_items=len(items),
                                         shuffled=shuffle_row_groups, window=shuffle_window)
            self._gate = OrderedDeliveryGate(self._epoch_plan, start_epoch=start_epoch,
                                             start_offset=start_offset,
                                             window_delivered=window_delivered, skipped=skipped)
        # Lineage ordinals of trace mode: the group's position in the plan,
        # or its ordinal in the store for an explicit subset.
        ordinal_of = ({(rg.path, rg.row_group): i for i, rg in enumerate(all_row_groups)}
                      if rowgroup_subset is not None else
                      {(rg.path, rg.row_group): i for i, rg in enumerate(row_groups)})
        self._ventilator = ConcurrentVentilator(
            self._make_ventilate_fn(pool, ordinal_of), items,
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count * (1 + _VENTILATE_EXTRA_ROWGROUPS),
            item_context_key=ITEM_CONTEXT_KWARG,
            start_epoch=start_epoch, start_offset=start_offset)
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
        depth_gauge = self.telemetry.gauge("pool.results_queue_depth")
        capacity_gauge = self.telemetry.gauge("pool.results_queue_capacity")
        # 0 for threads and the dummy pool, 1 for processes, as in the JAX package.
        self.telemetry.gauge("pool.backend").set(1.0 if isinstance(pool, ProcessPool) else 0.0)
        if isinstance(pool, ProcessPool):
            # Queued results lie in the rings, which the consumer does not count.
            depth_gauge.set(0)
            capacity_gauge.set(0)
        else:
            depth_gauge.set_function(pool.results_qsize)
            # results_qsize() sums every worker's queue: so does the bound.
            capacity_gauge.set(pool.diagnostics["results_queue_capacity"]
                               * max(1, pool.workers_count))
        # Before start(): the workers time their items into it.
        pool.telemetry = self.telemetry
        worker_args = {"dataset_url": dataset_url, "view_schema": view_schema,
                       "output_schema": self.schema, "predicate": predicate,
                       "transform_spec": transform_spec, "shuffle_rows": shuffle_rows,
                       "seed": seed, "sample_order": sample_order,
                       "storage_options": storage_options,
                       # A spawned worker resolves the URL itself.
                       "filesystem": None if isinstance(pool, ProcessPool) else filesystem}
        if is_batched_reader:
            if isinstance(pool, ProcessPool) and not convert_early_to_numpy:
                # Columns as views over the Arrow buffers in the ring.
                pool.result_transform = partial(arrow_table_to_numpy_dict, schema=self.schema)
            pool.start(BatchReaderWorker,
                       {**worker_args, "convert_early_to_numpy": convert_early_to_numpy},
                       ventilator=self._ventilator)
        else:
            # The image decode path is settled here, once (the native build
            # and the JPEG parity check), and the workers adopt the verdict.
            verdict = (decode_verdict() if any(isinstance(f.codec, CompressedImageCodec)
                                               for f in stored_schema.fields.values()) else None)
            pool.start(RowReaderWorker,
                       {**worker_args, "schema": stored_schema, "ngram": self.ngram,
                        "decode_threads": decode_threads_for(pool.workers_count),
                        "decode_verdict": verdict,
                        "row_materialization": self.row_materialization},
                       ventilator=self._ventilator)
        export_path = os.environ.get(TELEMETRY_EXPORT_ENV)
        if export_path:
            self._telemetry_exporter = PeriodicExporter(
                self.telemetry, export_path,
                fmt="prometheus" if export_path.endswith(".prom") else "json").start()

    def _make_ventilate_fn(self, pool, ordinal_of):
        """``pool.ventilate``, adding in trace mode the item's lineage id
        (``e{epoch}:g{ordinal}``, the kwarg ``trace_context`` the pools pop)
        and a ``petastorm_tpu.ventilate`` event."""
        recorder = self.telemetry.recorder
        pool_ventilate = pool.ventilate

        def ventilate_fn(**kwargs):
            if recorder.trace_enabled:
                ctx = kwargs.get(ITEM_CONTEXT_KWARG)
                if ctx is not None:
                    epoch, pos = ctx
                    rg = kwargs["rowgroup"]
                    trace = f"e{epoch}:g{ordinal_of.get((rg.path, rg.row_group), pos)}"
                    kwargs["trace_context"] = trace
                    recorder.record_event("petastorm_tpu.ventilate", trace=trace,
                                          stage="ventilate", track="ventilator")
            pool_ventilate(**kwargs)
        return ventilate_fn

    @property
    def diagnostics(self) -> dict:
        """The pool's counters (the same keys on every pool:
        ``output_queue_size``, ``items_ventilated``, ``items_processed``,
        ``items_inprocess``, ``workers_count``, ``results_queue_capacity``),
        ``pool_type``, ``ventilator_backlog`` and a ``telemetry`` snapshot:
        the JAX reader's keys. That reader's snapshot may also carry the
        ``timeline``, ``explain`` and ``quality`` payloads of planes this
        package does not have."""
        d = dict(self._pool.diagnostics)
        d["pool_type"] = ("process" if isinstance(self._pool, ProcessPool)
                          else "dummy" if isinstance(self._pool, DummyPool) else "thread")
        d["ventilator_backlog"] = self._ventilator.inflight
        d["telemetry"] = self.telemetry.snapshot()
        return d

    @property
    def pool(self):
        """The worker pool (``ThreadPool``, ``ProcessPool`` or ``DummyPool``)."""
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
        ``buffer_depth``."""
        counters = dict(self._pool.counters)
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
        the ``batch.rows_per_op`` histogram."""
        if not self._batched:
            if getattr(self, "row_materialization", "eager") != "lazy":
                raise TypeError("next_batch() needs make_reader(row_materialization='lazy') or "
                                "a make_batch_reader reader; this reader's workers publish rows")
            while self._batch is None:
                if not self._pull():
                    raise StopIteration
            return self._batch_remainder()
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
            self._mark_delivered(self._pool.result_context)
        if not isinstance(result, dict):
            # An Arrow table from a thread or dummy pool worker.
            result = arrow_table_to_numpy_dict(result, self.schema)
        if result:
            self._rows_counter.add(len(next(iter(result.values()))))
        return result

    def __iter__(self):
        return self

    def __next__(self):
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
            self._buffer_context = self._pool.result_context
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
            return self._gate.pull(self._timed_get_results)
        return self._timed_get_results()

    def _timed_get_results(self):
        """``pool.get_results()``, its wait in ``reader.pool_wait_s`` (and a
        ``petastorm_tpu.pool_wait`` span): the dummy pool's inline decode is
        taken out, so the pool wait and ``worker.decode_s`` stay apart."""
        pool = self._pool
        inline0 = getattr(pool, "inline_decode_s", 0.0)
        t0 = time.perf_counter()
        with self.telemetry.span("petastorm_tpu.pool_wait", stage="deliver", track="consumer"):
            result = pool.get_results()
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
        in part backs the cursor up one unit: it is read again whole."""
        if self._gate is not None:
            cur = self._gate.cursor(back_up=self._has_partial_unit())
            cur.update({"items": self._num_items, "seed": self._seed,
                        "sample_order": "deterministic", "window": self._shuffle_window,
                        "plan": self._epoch_plan.describe()})
            return cur
        delivered = set(self._delivered)
        if not self._has_partial_unit() and self._buffer_context is not None:
            delivered.add(self._buffer_context)
        epoch, offset = self._ventilator.watermark(delivered)
        return {"epoch": epoch, "offset": offset, "items": self._num_items, "seed": self._seed}

    def reset(self):
        """Start another pass; only legal once the current one is consumed."""
        if not self.last_row_consumed:
            raise RuntimeError(
                "reset() is only supported after the previous pass was fully consumed")
        self._ventilator.reset()
        if self._gate is not None:
            self._gate.reset()   # another pass replays the same order
        self._buffer_context = None
        self._delivered = set()
        self.last_row_consumed = False

    def stop(self):
        if self._telemetry_exporter is not None:
            self._telemetry_exporter.stop()
            self._telemetry_exporter = None
        self._pool.stop()

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
        return False
