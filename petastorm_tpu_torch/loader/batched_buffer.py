"""Shuffling buffers over whole column arrays, for the batched loaders.

Instead of shuffling rows one object at a time
(``reader_impl.shuffling_buffer``), these hold one numpy array per column
and move rows with vectorized slices and permutations. Given the same
groups in the same order and the same seed, they give the JAX package's
batches bit for bit (the same algorithm, the same ``default_rng(seed)``
draws).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np


class BatchedNoopShufflingBuffer:
    """FIFO of column-dict groups, re-chunked to ``batch_size`` rows.

    A batch inside one group is a slice (a view) of it; one that spans two
    groups is a copy. ``can_add`` turns false once two batches are
    buffered, so the producer streams instead of loading the dataset."""

    def __init__(self, batch_size: int):
        self._batch_size = batch_size
        self._chunks = deque()
        self._head_off = 0   # rows of chunks[0] already served
        self._size = 0
        self._done = False

    def add_many(self, batch: Dict[str, np.ndarray]):
        self._chunks.append(batch)
        self._size += len(next(iter(batch.values())))

    def retrieve(self) -> Dict[str, np.ndarray]:
        if not self.can_retrieve:
            raise RuntimeError("Nothing to retrieve")
        need = min(self._batch_size, self._size)
        parts = []
        got = 0
        while got < need:
            chunk = self._chunks[0]
            off = self._head_off
            n = len(next(iter(chunk.values()))) - off
            take = min(n, need - got)
            if take == n:
                parts.append(chunk if off == 0 else {k: v[off:] for k, v in chunk.items()})
                self._chunks.popleft()
                self._head_off = 0
            else:
                parts.append({k: v[off:off + take] for k, v in chunk.items()})
                self._head_off = off + take
            got += take
        self._size -= need
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def finish(self):
        self._done = True

    @property
    def can_add(self) -> bool:
        return not self._done and self._size < 2 * self._batch_size

    @property
    def can_retrieve(self) -> bool:
        if self._done:
            return self._size > 0
        return self._size >= self._batch_size

    @property
    def size(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return 2 * self._batch_size


class BatchedRandomShufflingBuffer:
    """Uniform random batches drawn from a column store.

    :param shuffling_queue_capacity: rows buffered before adding stops
    :param min_after_retrieve: rows that must stay buffered after a
        retrieval until ``finish`` (the shuffle's quality floor)
    :param batch_size: rows per batch
    :param extra_capacity: rows the store holds beyond the capacity (a group
        is added whole)
    :param seed: seed of ``np.random.default_rng``

    ``add_many`` copies each group into the store, so the buffer keeps no
    view of its input."""

    def __init__(self, shuffling_queue_capacity: int, min_after_retrieve: int,
                 batch_size: int, extra_capacity: int = 250000,
                 seed: Optional[int] = None):
        if min_after_retrieve >= shuffling_queue_capacity:
            raise ValueError("min_after_retrieve must be < shuffling_queue_capacity")
        self._configured_capacity = shuffling_queue_capacity
        self._capacity = shuffling_queue_capacity
        self._min_after = min_after_retrieve
        self._extra = extra_capacity
        self._batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._done = False

    def add_many(self, batch: Dict[str, np.ndarray]):
        if self._done:
            raise RuntimeError("Cannot add to a finished buffer")
        n = len(next(iter(batch.values())))
        if self._size + n > self._configured_capacity + self._extra:
            raise RuntimeError("Buffer overfill: check can_add before adding")
        if self._store is None:
            # Sized by the configured capacity, not the live target: a target
            # shrunk before the first add may grow back later.
            self._store = {k: np.empty((self._configured_capacity + self._extra,) + v.shape[1:],
                                       dtype=v.dtype)
                           for k, v in batch.items()}
        for k, v in batch.items():
            self._store[k][self._size:self._size + n] = v
        self._size += n

    def retrieve(self) -> Dict[str, np.ndarray]:
        if not self.can_retrieve:
            raise RuntimeError("Below min_after_retrieve (and not finished) or empty")
        take = min(self._batch_size, self._size)
        picked = self._rng.choice(self._size, size=take, replace=False)
        out = {k: v[picked] for k, v in self._store.items()}   # fancy indexing copies
        # Fill the holes below the new size from the tail's survivors.
        keep_tail = np.setdiff1d(np.arange(self._size - take, self._size), picked,
                                 assume_unique=True)
        holes = picked[picked < self._size - take]
        for v in self._store.values():
            v[holes] = v[keep_tail[:len(holes)]]
        self._size -= take
        return out

    def finish(self):
        self._done = True

    @property
    def can_add(self) -> bool:
        return self._size < self._capacity and not self._done

    @property
    def can_retrieve(self) -> bool:
        if self._done:
            return self._size > 0
        return self._size >= max(self._min_after + self._batch_size, self._batch_size)

    @property
    def size(self) -> int:
        return self._size

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def min_target(self) -> int:
        """The least target :meth:`set_target_capacity` takes: the mixing
        floor plus one retrievable batch."""
        return self._min_after + self._batch_size

    def set_target_capacity(self, n: int) -> None:
        """The target buffered rows as a live knob (the autotune
        controller's ``shuffle_target``; ``tools/check_knobs.py`` checks
        that only :mod:`petastorm_tpu_torch.autotune` calls it), clamped to
        [``min_target``, the configured capacity]. The store holds the
        configured capacity plus the slack, so the configured bound wins
        where the floor would pass it. A shrink below the fill pauses adds
        until retrieval drains the excess."""
        floor = min(self.min_target, self._configured_capacity)
        self._capacity = max(floor, min(int(n), self._configured_capacity))
