"""Client-side row shuffling buffers.

Row groups arrive in group order; a shuffling buffer decorrelates rows
across groups before batching. ``RandomShufflingBuffer`` keeps up to
``shuffling_buffer_capacity`` rows and pops uniformly at random with the
swap-with-last trick. Its index draws are the JAX package's: 63-bit words
drawn in blocks of 1024 from ``np.random.default_rng(seed)``, each reduced
modulo the live buffer size, or with ``batched_rng=False`` one bounded
``rng.integers`` draw a pop, so a seed gives the same stream in both
packages either way. ``BatchShufflingBuffer`` is the lazy row plane's: it holds whole
column batches and permutes each refill's pool at once, with the JAX
package's ``default_rng(seed).permutation`` draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_RNG_BLOCK_SIZE = 1024


class RandomShufflingBuffer:
    """:param shuffling_buffer_capacity: max rows held
    :param min_after_retrieve: keep at least this many rows buffered before
        allowing retrieval (until ``finish``), bounding shuffle quality
    :param extra_capacity: allowance above capacity for one bulk
        ``add_many`` (a whole row group may arrive at once)
    :param seed: RNG seed for reproducible shuffles
    :param batched_rng: draw the indices in blocks of ``_RNG_BLOCK_SIZE``
        63-bit words, each reduced modulo the live size (the default); else
        one bounded draw a pop, another seeded stream
    """

    def __init__(self, shuffling_buffer_capacity: int,
                 min_after_retrieve: int = 0,
                 extra_capacity: int = 1000,
                 seed: Optional[int] = None,
                 batched_rng: bool = True):
        if min_after_retrieve >= shuffling_buffer_capacity:
            raise ValueError("min_after_retrieve must be smaller than "
                             "shuffling_buffer_capacity")
        self._configured_capacity = shuffling_buffer_capacity
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._rng = np.random.default_rng(seed)
        self._batched_rng = bool(batched_rng)
        self._rand_block = None
        self._rand_pos = 0
        self._items = []
        self._done_adding = False

    def add_many(self, items):
        if self._done_adding:
            raise RuntimeError("Cannot add to a finished shuffling buffer")
        items = list(items)
        # Held to the configured capacity, not the live target: the
        # controller may shrink the target between a can_add and this add.
        if len(self._items) + len(items) > self._configured_capacity + self._extra_capacity:
            raise RuntimeError(
                f"Attempt to overfill shuffling buffer: {len(self._items)} buffered + "
                f"{len(items)} new > {self._configured_capacity} + {self._extra_capacity} "
                f"slack. Check can_add before adding.")
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve:
            raise RuntimeError("Cannot retrieve: buffer below min_after_retrieve "
                               "and not finished, or empty")
        if self._batched_rng:
            idx = self._next_batched_index(len(self._items))
        else:
            idx = int(self._rng.integers(0, len(self._items)))
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

    def _next_batched_index(self, n: int) -> int:
        """One index off the block of raw 63-bit words (drawn without a
        bound, so one block serves every live size), modulo ``n``."""
        if self._rand_block is None or self._rand_pos >= len(self._rand_block):
            self._rand_block = self._rng.integers(0, 1 << 63, size=_RNG_BLOCK_SIZE,
                                                  dtype=np.uint64)
            self._rand_pos = 0
        v = int(self._rand_block[self._rand_pos])
        self._rand_pos += 1
        return v % n

    def finish(self):
        self._done_adding = True

    @property
    def can_add(self):
        return len(self._items) < self._capacity and not self._done_adding

    @property
    def can_retrieve(self):
        if self._done_adding:
            return len(self._items) > 0
        return len(self._items) > self._min_after_retrieve

    @property
    def size(self):
        return len(self._items)

    @property
    def capacity(self):
        return self._capacity

    @property
    def min_target(self) -> int:
        """The least target :meth:`set_target_capacity` takes: the mixing
        floor plus one retrievable row."""
        return self._min_after_retrieve + 1

    def set_target_capacity(self, n: int) -> None:
        """The target resident rows as a live knob (the autotune
        controller's ``shuffle_target``; ``tools/check_knobs.py`` checks
        that only :mod:`petastorm_tpu_torch.autotune` calls it), clamped to
        [``min_target``, the configured capacity]. A shrink below the fill
        pauses adds until retrieval drains the excess; no row is dropped."""
        self._capacity = max(self.min_target, min(int(n), self._configured_capacity))


class BatchShufflingBuffer:
    """Whole column batches in, shuffled column slices out.

    ``add_many`` appends one batch; a refill concatenates every pending
    batch into one pool and permutes it with one
    ``rng.permutation`` (one fancy index a column); ``retrieve_batch``
    then slices the pool (views, no copy) until it is drained.

    Mixing radius: a refill permutes exactly the rows buffered at that
    moment, so two rows mix if and only if they share a refill. Retrieval,
    and with it the next refill, waits until more than
    ``min_after_retrieve`` rows are buffered (until ``finish``). The same
    seed and the same order of adds give the same stream, the JAX
    package's bit for bit.

    :param shuffling_buffer_capacity: target resident rows (adds pause at
        or above it; one whole batch may land past it)
    :param min_after_retrieve: rows a refill must mix, until ``finish``
    :param seed: RNG seed of the permutations
    """

    def __init__(self, shuffling_buffer_capacity: int, min_after_retrieve: int = 0,
                 seed: Optional[int] = None):
        if min_after_retrieve >= shuffling_buffer_capacity:
            raise ValueError("min_after_retrieve must be smaller than "
                             "shuffling_buffer_capacity")
        self._configured_capacity = int(shuffling_buffer_capacity)
        self._capacity = int(shuffling_buffer_capacity)
        self._min_after = int(min_after_retrieve)
        self._rng = np.random.default_rng(seed)
        self._pending: list = []          # whole batches awaiting a refill
        self._pending_rows = 0
        self._pool: Optional[dict] = None  # the permuted columns being served
        self._pool_pos = 0
        self._pool_rows = 0
        self._done_adding = False

    def add_many(self, batch) -> None:
        """Append one batch: a ``{column: ndarray}`` dict or a
        :class:`~petastorm_tpu_torch.reader_impl.batch_plane.ColumnarBatch`."""
        if self._done_adding:
            raise RuntimeError("Cannot add to a finished shuffling buffer")
        columns = getattr(batch, "columns", batch)
        n = len(next(iter(columns.values()))) if columns else 0
        if n == 0:
            return
        self._pending.append(columns)
        self._pending_rows += n

    def retrieve_batch(self, max_rows: int) -> dict:
        """Up to ``max_rows`` shuffled rows as column slices (views of the
        permuted pool), refilling when the pool is drained."""
        if not self.can_retrieve:
            raise RuntimeError("Cannot retrieve: buffer below min_after_retrieve "
                               "and not finished, or empty")
        if self._pool_pos >= self._pool_rows:
            self._refill()
        take = min(int(max_rows), self._pool_rows - self._pool_pos)
        lo, hi = self._pool_pos, self._pool_pos + take
        self._pool_pos = hi
        out = {name: col[lo:hi] for name, col in self._pool.items()}
        if self._pool_pos >= self._pool_rows:
            # Served in full: the pool's memory goes with the last slice.
            self._pool = None
            self._pool_rows = self._pool_pos = 0
        return out

    def retrieve(self):
        """One row, as a 1-row slice dict."""
        return self.retrieve_batch(1)

    def _refill(self) -> None:
        """Merge the pending batches into one pool and permute it once."""
        if not self._pending:
            raise RuntimeError("refill with no pending batches")
        first = self._pending[0]
        if len(self._pending) == 1:
            merged = first
        else:
            merged = {name: np.concatenate([p[name] for p in self._pending]) for name in first}
        n = len(next(iter(merged.values())))
        self._pending = []
        self._pending_rows = 0
        perm = self._rng.permutation(n)
        self._pool = {name: np.asarray(col)[perm] for name, col in merged.items()}
        self._pool_rows = n
        self._pool_pos = 0

    def finish(self) -> None:
        self._done_adding = True

    @property
    def can_add(self) -> bool:
        return self.size < self._capacity and not self._done_adding

    @property
    def can_retrieve(self) -> bool:
        if self._done_adding:
            return self.size > 0
        return self.size > self._min_after

    @property
    def size(self) -> int:
        return self._pending_rows + (self._pool_rows - self._pool_pos)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def min_target(self) -> int:
        """The least target :meth:`set_target_capacity` takes: the mixing
        floor plus one retrievable row."""
        return self._min_after + 1

    def set_target_capacity(self, n: int) -> None:
        """The target resident rows as a live knob (the autotune
        controller's ``shuffle_target``), clamped to [``min_target``, the
        configured capacity]. A shrink below the fill pauses adds until
        retrieval drains the excess; no buffered row is dropped."""
        self._capacity = max(self.min_target, min(int(n), self._configured_capacity))
