"""Client-side row shuffling buffer.

Row groups arrive in group order; a shuffling buffer decorrelates rows
across groups before batching. ``RandomShufflingBuffer`` keeps up to
``shuffling_buffer_capacity`` rows and pops uniformly at random with the
swap-with-last trick. Its index draws are the JAX package's: 63-bit words
drawn in blocks of 1024 from ``np.random.default_rng(seed)``, each reduced
modulo the live buffer size, so a seed gives the same stream in both
packages.
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
    """

    def __init__(self, shuffling_buffer_capacity: int,
                 min_after_retrieve: int = 0,
                 extra_capacity: int = 1000,
                 seed: Optional[int] = None):
        if min_after_retrieve >= shuffling_buffer_capacity:
            raise ValueError("min_after_retrieve must be smaller than "
                             "shuffling_buffer_capacity")
        self._capacity = shuffling_buffer_capacity
        self._min_after_retrieve = min_after_retrieve
        self._extra_capacity = extra_capacity
        self._rng = np.random.default_rng(seed)
        self._rand_block = None
        self._rand_pos = 0
        self._items = []
        self._done_adding = False

    def add_many(self, items):
        if self._done_adding:
            raise RuntimeError("Cannot add to a finished shuffling buffer")
        items = list(items)
        if len(self._items) + len(items) > self._capacity + self._extra_capacity:
            raise RuntimeError(
                f"Attempt to overfill shuffling buffer: {len(self._items)} buffered + "
                f"{len(items)} new > {self._capacity} + {self._extra_capacity} slack. "
                f"Check can_add before adding.")
        self._items.extend(items)

    def retrieve(self):
        if not self.can_retrieve:
            raise RuntimeError("Cannot retrieve: buffer below min_after_retrieve "
                               "and not finished, or empty")
        if self._rand_block is None or self._rand_pos >= len(self._rand_block):
            self._rand_block = self._rng.integers(0, 1 << 63, size=_RNG_BLOCK_SIZE,
                                                  dtype=np.uint64)
            self._rand_pos = 0
        idx = int(self._rand_block[self._rand_pos]) % len(self._items)
        self._rand_pos += 1
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

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
