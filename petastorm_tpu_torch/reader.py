"""``make_reader``: decoded rows of a petastorm store, one namedtuple at a
time; ``make_batch_reader``: the columns of any Parquet store, one row
group at a time.

The reader plans the store's row groups (optionally sharded
``index % shard_count == cur_shard``), ventilates them to a worker pool —
in a per-epoch order seeded exactly as the JAX package seeds it — and
yields what the workers publish. Given the same store, seed and settings,
it yields the same rows as the JAX package's reader, in the same order on
the thread and dummy pools (the process pool delivers in the order its
workers finish). With ``schema_fields=NGram(...)`` a row reader yields the
NGram's windows instead of rows.

:meth:`Reader.state_dict` is the read position (``epoch``, ``offset``,
``items``, ``seed``, the JAX package's free-mode cursor): passed back as
``resume_state=`` to a reader of the same store and settings, it continues
the stream with no row lost. A row group counts as read once its last row
(or its batch) has been handed out; one read in part is read again whole.
The JAX package's reader waits for the worker's confirmation, which it
reads on the next pull, so where a pull ends exactly on a row group its
cursor still points at that group and the port's is one past it.
"""
from __future__ import annotations

import os
from collections import deque
from functools import partial
from typing import Optional

from petastorm_tpu_torch.codecs import CompressedImageCodec, decode_verdict
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, get_schema,
                                                      infer_or_load_unischema, load_row_groups)
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import ArrowTableSerializer
from petastorm_tpu_torch.reader_impl.batch_reader_worker import (BatchReaderWorker,
                                                                 arrow_table_to_numpy_dict)
from petastorm_tpu_torch.reader_impl.pickle_serializer import PickleSerializer
from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
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


def make_reader(dataset_url: str,
                schema_fields=None,
                reader_pool_type: str = "thread",
                workers_count: int = 4,
                results_queue_size: int = 50,
                shuffle_row_groups: bool = True,
                shuffle_rows: bool = False,
                seed: Optional[int] = None,
                num_epochs: Optional[int] = 1,
                cur_shard: Optional[int] = None,
                shard_count: Optional[int] = None,
                resume_state: Optional[dict] = None) -> "Reader":
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
        ``index % shard_count == cur_shard``
    :param resume_state: a :meth:`Reader.state_dict` (of this package's
        reader or the JAX package's, free mode) to continue from; its
        recorded seed is used when ``seed`` is None. The store, sharding
        and shuffle settings must be the saved reader's
    """
    seed = _resolve_seed(seed, resume_state, shuffle_row_groups, shuffle_rows)
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, shuffle_rows, seed,
                      PickleSerializer())
    return Reader(dataset_url, pool, schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, resume_state=resume_state)


def make_batch_reader(dataset_url: str,
                      schema_fields=None,
                      reader_pool_type: str = "thread",
                      workers_count: int = 4,
                      results_queue_size: int = 50,
                      shuffle_row_groups: bool = True,
                      shuffle_rows: bool = False,
                      seed: Optional[int] = None,
                      num_epochs: Optional[int] = 1,
                      cur_shard: Optional[int] = None,
                      shard_count: Optional[int] = None,
                      convert_early_to_numpy: bool = False,
                      resume_state: Optional[dict] = None) -> "Reader":
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

    The other arguments are :func:`make_reader`'s.
    """
    seed = _resolve_seed(seed, resume_state, shuffle_row_groups, shuffle_rows)
    serializer = PickleSerializer() if convert_early_to_numpy else ArrowTableSerializer()
    pool = _make_pool(reader_pool_type, workers_count, results_queue_size, shuffle_rows, seed,
                      serializer)
    return Reader(dataset_url, pool, schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, is_batched_reader=True,
                  convert_early_to_numpy=convert_early_to_numpy, resume_state=resume_state)


def mint_seed() -> int:
    """A fresh 32-bit seed (the JAX package's ``epoch_plan.mint_seed``)."""
    return int.from_bytes(os.urandom(4), "little")


def _resolve_seed(seed, resume_state, shuffle_row_groups: bool, shuffle_rows: bool):
    """The explicit seed; else a resume state's recorded one (its offsets
    index that seed's order; a state without one stays None, so the resume
    check can refuse it); else, when anything is shuffled, a minted one, so
    the reader's ``state_dict`` can be resumed."""
    if seed is not None:
        return seed
    if resume_state is not None:
        saved = resume_state.get("seed")
        return None if saved is None else int(saved)
    if shuffle_row_groups or shuffle_rows:
        return mint_seed()
    return None


def _resume_position(resume_state: dict, seed, shuffle_row_groups: bool, shuffle_rows: bool,
                     num_items: int):
    """``(start_epoch, start_offset)`` of a free-mode resume state, after
    the JAX package's checks (``reader.py:1536-1591``)."""
    if resume_state.get("sample_order", "free") != "free" or "manifest" in resume_state:
        raise ValueError("resume_state is a deterministic-mode or live-data cursor; this "
                         "package resumes free-mode cursors only")
    if shuffle_row_groups and seed is None:
        raise ValueError("Exact resume requires a seed when shuffle_row_groups is on (the "
                         "epoch permutation must be reproducible); this resume_state records "
                         "none. States saved by state_dict() carry their minted seed.")
    saved_seed = resume_state.get("seed")
    if saved_seed is not None and seed is not None and int(saved_seed) != int(seed) \
            and (shuffle_row_groups or shuffle_rows):
        raise ValueError(f"resume_state was saved under seed {saved_seed} but this reader "
                         f"shuffles with seed {seed}: the offset would point into a different "
                         f"permutation")
    saved_items = resume_state.get("items")
    if saved_items is not None and int(saved_items) != num_items:
        raise ValueError(f"resume_state was saved over {saved_items} work items but this reader "
                         f"plans {num_items}: the offset would point at different data. Resume "
                         f"with the same dataset and sharding as the saved run.")
    epoch = int(resume_state.get("epoch", 0))
    offset = int(resume_state.get("offset", 0))
    if not 0 <= offset < num_items:
        raise ValueError(f"resume offset {offset} >= {num_items} work items (did the dataset "
                         f"or its sharding change?)")
    return epoch, offset


def _make_pool(reader_pool_type, workers_count, results_queue_size, shuffle_rows, seed,
               serializer):
    if reader_pool_type == "thread":
        return ThreadPool(workers_count, results_queue_size, shuffle_rows=shuffle_rows, seed=seed)
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
    """

    def __init__(self, dataset_url, pool, schema_fields, shuffle_row_groups,
                 shuffle_rows, seed, num_epochs, cur_shard, shard_count,
                 is_batched_reader=False, convert_early_to_numpy=False, resume_state=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not (isinstance(cur_shard, int)
                                          and 0 <= cur_shard < shard_count):
            raise ValueError(f"cur_shard must be an int in [0, {shard_count}), "
                             f"got {cur_shard!r}")
        ctx = DatasetContext(dataset_url)
        self._batched = is_batched_reader
        stored_schema = infer_or_load_unischema(ctx) if is_batched_reader else get_schema(ctx)
        #: The NGram windows are formed by, or None for a row reader.
        self.ngram: Optional[NGram] = None
        if isinstance(schema_fields, NGram):
            if is_batched_reader:
                raise ValueError("NGram is not supported by make_batch_reader; use make_reader")
            self.ngram = schema_fields
            self.ngram.resolve_regex_field_names(stored_schema)
            self.schema = stored_schema
        elif schema_fields is not None:
            self.schema = stored_schema.create_schema_view(schema_fields)
        else:
            self.schema = stored_schema

        all_row_groups = load_row_groups(ctx)
        row_groups = all_row_groups
        if cur_shard is not None:
            row_groups = [rg for i, rg in enumerate(all_row_groups)
                          if i % shard_count == cur_shard]
        if not row_groups:
            raise NoDataAvailableError(
                f"No row groups to read (dataset has {len(all_row_groups)}; "
                f"cur_shard={cur_shard}, shard_count={shard_count})")

        start_epoch, start_offset = (0, 0) if resume_state is None else _resume_position(
            resume_state, seed, shuffle_row_groups, shuffle_rows, len(row_groups))
        self._num_items = len(row_groups)
        self._seed = seed
        self._pool = pool
        self._ventilator = ConcurrentVentilator(
            pool.ventilate, [{"rowgroup": rg} for rg in row_groups],
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count * (1 + _VENTILATE_EXTRA_ROWGROUPS),
            item_context_key=ITEM_CONTEXT_KWARG,
            start_epoch=start_epoch, start_offset=start_offset)
        self._buffer = deque()
        # The context of the item the buffered rows come from, and those of
        # items handed out in full whose confirmation may still be to come.
        self._buffer_context = None
        self._delivered = set()
        self.last_row_consumed = False
        if is_batched_reader:
            if isinstance(pool, ProcessPool) and not convert_early_to_numpy:
                # Columns as views over the Arrow buffers in the ring.
                pool.result_transform = partial(arrow_table_to_numpy_dict, schema=self.schema)
            pool.start(BatchReaderWorker,
                       {"dataset_url": dataset_url, "view_schema": self.schema,
                        "shuffle_rows": shuffle_rows, "seed": seed,
                        "convert_early_to_numpy": convert_early_to_numpy},
                       ventilator=self._ventilator)
            return
        # The image decode path is settled here, once (the native build and
        # the JPEG parity check), and the workers adopt the verdict.
        verdict = (decode_verdict() if any(isinstance(f.codec, CompressedImageCodec)
                                           for f in stored_schema.fields.values()) else None)
        pool.start(RowReaderWorker,
                   {"dataset_url": dataset_url, "schema": stored_schema, "view_schema": self.schema,
                    "ngram": self.ngram, "shuffle_rows": shuffle_rows, "seed": seed,
                    "decode_threads": decode_threads_for(pool.workers_count),
                    "decode_verdict": verdict},
                   ventilator=self._ventilator)

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
        those columns' bytes."""
        return dict(self._pool.counters)

    @property
    def batched_output(self) -> bool:
        """True for a ``make_batch_reader`` reader."""
        return self._batched

    def next_batch(self) -> dict:
        """The next row group's ``{column: ndarray}`` (a batched reader
        only): the arrays ``next()`` wraps in a namedtuple."""
        if not self._batched:
            raise TypeError("next_batch() needs a make_batch_reader reader; this reader's "
                            "workers publish rows")
        try:
            result = self._pool.get_results()
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration from None
        self._mark_delivered(self._pool.result_context)
        if not isinstance(result, dict):
            # An Arrow table from a thread or dummy pool worker.
            result = arrow_table_to_numpy_dict(result, self.schema)
        return result

    def __iter__(self):
        return self

    def __next__(self):
        if self._batched:
            return self.schema.make_namedtuple_from_dict(self.next_batch())
        while not self._buffer:
            self._mark_delivered(self._buffer_context)
            self._buffer_context = None
            try:
                self._buffer.extend(self._pool.get_results())
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration from None
            self._buffer_context = self._pool.result_context
        item = self._buffer.popleft()
        if self.ngram is not None:
            return item   # already a window
        return self.schema.make_namedtuple_from_dict(item)

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
        loader's ``state_dict()``."""
        delivered = set(self._delivered)
        if not self._buffer and self._buffer_context is not None:
            delivered.add(self._buffer_context)
        epoch, offset = self._ventilator.watermark(delivered)
        return {"epoch": epoch, "offset": offset, "items": self._num_items, "seed": self._seed}

    def reset(self):
        """Start another pass; only legal once the current one is consumed."""
        if not self.last_row_consumed:
            raise RuntimeError(
                "reset() is only supported after the previous pass was fully consumed")
        self._ventilator.reset()
        self._buffer_context = None
        self._delivered = set()
        self.last_row_consumed = False

    def stop(self):
        self._pool.stop()

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.join()
        return False
