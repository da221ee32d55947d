"""``make_reader``: decoded rows of a petastorm store, one namedtuple at a time.

The reader plans the store's row groups (optionally sharded
``index % shard_count == cur_shard``), ventilates them to a worker pool —
in a per-epoch order seeded exactly as the JAX package seeds it — and
yields the rows the workers decode. Given the same store, seed and
settings, it yields the same rows in the same order as the JAX package's
``make_reader``.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Optional

from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, get_schema,
                                                      load_row_groups)
from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
from petastorm_tpu_torch.workers_pool import EmptyResultError, ITEM_CONTEXT_KWARG
from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

#: In-flight row groups per worker beyond the one it is decoding.
_VENTILATE_EXTRA_ROWGROUPS = 3


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
                shard_count: Optional[int] = None) -> "Reader":
    """Reader over a store written by ``materialize_dataset_local`` (either
    package's).

    :param schema_fields: UnischemaFields or name regexes narrowing the output
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (inline, one thread)
    :param workers_count: decode threads of the thread pool
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
    """
    if seed is None and (shuffle_row_groups or shuffle_rows):
        # A drawn seed still keys the row shuffle by plan position, as in
        # the JAX package.
        seed = int.from_bytes(os.urandom(4), "little")
    if reader_pool_type == "thread":
        pool = ThreadPool(workers_count, results_queue_size,
                          shuffle_rows=shuffle_rows, seed=seed)
    elif reader_pool_type == "dummy":
        pool = DummyPool()
    else:
        raise ValueError(f"Unknown reader_pool_type {reader_pool_type!r} "
                         f"(expected 'thread' or 'dummy')")
    return Reader(dataset_url, pool, schema_fields=schema_fields,
                  shuffle_row_groups=shuffle_row_groups, shuffle_rows=shuffle_rows,
                  seed=seed, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count)


class Reader:
    """Iterator of row namedtuples (fields of ``reader.schema``).

    Use as a context manager, or call ``stop()`` then ``join()``. After a
    pass is fully consumed, ``reset()`` starts another one.
    """

    def __init__(self, dataset_url, pool, schema_fields, shuffle_row_groups,
                 shuffle_rows, seed, num_epochs, cur_shard, shard_count):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError("cur_shard and shard_count must be used together")
        if cur_shard is not None and not (isinstance(cur_shard, int)
                                          and 0 <= cur_shard < shard_count):
            raise ValueError(f"cur_shard must be an int in [0, {shard_count}), "
                             f"got {cur_shard!r}")
        ctx = DatasetContext(dataset_url)
        stored_schema = get_schema(ctx)
        self.schema = (stored_schema.create_schema_view(schema_fields)
                       if schema_fields is not None else stored_schema)

        all_row_groups = load_row_groups(ctx)
        row_groups = all_row_groups
        if cur_shard is not None:
            row_groups = [rg for i, rg in enumerate(all_row_groups)
                          if i % shard_count == cur_shard]
        if not row_groups:
            raise NoDataAvailableError(
                f"No row groups to read (dataset has {len(all_row_groups)}; "
                f"cur_shard={cur_shard}, shard_count={shard_count})")

        self._pool = pool
        self._ventilator = ConcurrentVentilator(
            pool.ventilate, [{"rowgroup": rg} for rg in row_groups],
            iterations=num_epochs,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            max_ventilation_queue_size=pool.workers_count * (1 + _VENTILATE_EXTRA_ROWGROUPS),
            item_context_key=ITEM_CONTEXT_KWARG)
        self._buffer = deque()
        self.last_row_consumed = False
        pool.start(RowReaderWorker,
                   {"dataset_url": dataset_url, "schema": stored_schema, "view_schema": self.schema,
                    "shuffle_rows": shuffle_rows, "seed": seed},
                   ventilator=self._ventilator)

    def __iter__(self):
        return self

    def __next__(self):
        while not self._buffer:
            try:
                self._buffer.extend(self._pool.get_results())
            except EmptyResultError:
                self.last_row_consumed = True
                raise StopIteration from None
        return self.schema.make_namedtuple_from_dict(self._buffer.popleft())

    def reset(self):
        """Start another pass; only legal once the current one is consumed."""
        if not self.last_row_consumed:
            raise RuntimeError(
                "reset() is only supported after the previous pass was fully consumed")
        self._ventilator.reset()
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
