"""GrowthSchedule: the step function of the epoch that a live appending
dataset grows plans by (the JAX package's ``utils/growth.py``).

Growth is recorded as ``(first_epoch, size)`` segments; segment i covers
epochs ``[first_epoch_i, first_epoch_{i+1})``. The epoch plan, the
ventilator's per-epoch item slices and the mesh loader's per-epoch ordinal
ranges all walk the same table through this class:

* sizes never shrink (a live dataset only appends);
* segment epochs strictly increase;
* :meth:`GrowthSchedule.extend` never rewrites a planned epoch: an
  effective epoch earlier than the last step is pulled forward to it (two
  admissions racing into the same future epoch collapse into one), or,
  with ``strict``, raises (the epoch plan, whose caller passes the
  ventilator's already-normalised epoch).

The module imports no torch: the workers load it.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

__all__ = ["GrowthSchedule"]


class GrowthSchedule:
    """``epoch -> size``, a step function whose past steps never change.
    Not thread-safe: callers hold their own lock around a mutation."""

    __slots__ = ("_segments",)

    def __init__(self, segments: Iterable[Tuple[int, int]]):
        segs = [(int(e), int(n)) for e, n in segments]
        if not segs:
            raise ValueError("GrowthSchedule needs at least one segment")
        for (e0, n0), (e1, n1) in zip(segs, segs[1:]):
            if e1 <= e0:
                raise ValueError(f"growth segments must be strictly epoch-increasing, "
                                 f"got {segs}")
            if n1 < n0:
                raise ValueError(f"growth is monotonic (sizes never shrink), got {segs}")
        self._segments = segs

    @classmethod
    def base(cls, size: int, first_epoch: int = 0) -> "GrowthSchedule":
        return cls([(first_epoch, size)])

    @property
    def segments(self) -> List[Tuple[int, int]]:
        return list(self._segments)

    @property
    def final_size(self) -> int:
        return self._segments[-1][1]

    @property
    def last_epoch(self) -> int:
        return self._segments[-1][0]

    @property
    def grown(self) -> bool:
        return len(self._segments) > 1

    def size_at(self, epoch: int) -> int:
        """The size of ``epoch``."""
        n = self._segments[0][1]
        for first_epoch, size in self._segments:
            if first_epoch > epoch:
                break
            n = size
        return n

    def cum_items(self, epoch: int) -> int:
        """Items in epochs ``[first segment's epoch, epoch)``: the linear
        ordinal of ``epoch``'s first position."""
        total = 0
        segs = self._segments
        for i, (start, n) in enumerate(segs):
            end = segs[i + 1][0] if i + 1 < len(segs) else None
            hi = epoch if end is None else min(end, epoch)
            if hi > start:
                total += (hi - start) * n
            if end is None or end >= epoch:
                break
        return total

    def slot(self, linear: int) -> Tuple[int, int]:
        """``(epoch, position in the epoch)`` of linear slot ``linear``."""
        rem = linear
        segs = self._segments
        for i, (start, n) in enumerate(segs):
            end = segs[i + 1][0] if i + 1 < len(segs) else None
            span = None if end is None else (end - start) * n
            if span is None or rem < span:
                return start + rem // max(1, n), rem % max(1, n)
            rem -= span
        raise AssertionError("unreachable: the last segment is unbounded")

    def extend(self, first_epoch: int, size: int, strict: bool = False) -> int:
        """Grow to ``size`` from ``first_epoch`` on; returns the epoch the
        step landed at. An epoch before the last step is pulled forward to
        it (that step is not planned yet), or raises when ``strict``."""
        last_epoch, last_size = self._segments[-1]
        if size < last_size:
            raise ValueError(f"growth is monotonic: {size} < current {last_size} (a live "
                             f"dataset only ever appends)")
        if first_epoch < last_epoch:
            if strict:
                raise ValueError(f"growth effective epoch {first_epoch} precedes the last "
                                 f"segment's epoch {last_epoch}: already-planned epochs are "
                                 f"immutable")
            first_epoch = last_epoch
        if size == last_size:
            return max(first_epoch, last_epoch)
        if first_epoch == last_epoch:
            self._segments[-1] = (last_epoch, int(size))
            return last_epoch
        self._segments.append((int(first_epoch), int(size)))
        return int(first_epoch)

    def rebase(self) -> None:
        """One epoch-0 segment over the final size (the reader's ``reset()``
        rebase)."""
        self._segments = [(0, self.final_size)]

    def __repr__(self):
        return f"GrowthSchedule({self._segments})"
