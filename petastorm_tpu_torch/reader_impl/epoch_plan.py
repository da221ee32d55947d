"""The deterministic epoch plane: the canonical sample order and the gate
that delivers in it (the JAX package's ``reader_impl/epoch_plan.py``).

With ``make_reader(sample_order="deterministic")`` the delivered stream is
a function of ``(seed, epoch, planned work items)`` alone: the same on the
thread, process and dummy pools, at any worker count, and across a cut
and a resume. Three pieces:

* :class:`EpochPlan`, the canonical order: per epoch the ventilator's
  ``random.Random(seed + epoch)`` permutation of the work items (the
  workers key their row shuffle by ``(seed, epoch, position)``, so the
  order inside a group is part of the same function). With ``window > 1``
  it adds a seeded block permutation over consecutive windows of plan
  positions, indexed by position, so the window shuffle resumes exactly
  and a unit is delivered within ``window`` positions of its slot.
* :class:`OrderedUnit`, the envelope the workers publish in deterministic
  mode: one per ventilated item, with the ventilator's ``(epoch,
  position)`` and a kind, ``data``, ``empty`` (no row kept) or ``skip``
  (an item given up; no producer in this package yet).
* :class:`OrderedDeliveryGate`, the reorder stage between the pool's
  results and the consumer: a buffer keyed by linear ordinal and a
  watermark. Units that arrive out of order wait, duplicates are dropped,
  skips advance the watermark and are recorded in the cursor.

A live appending dataset grows the plan monotonically
(:meth:`EpochPlan.extend`): the item count becomes a step function of the
epoch, and an epoch planned before the growth keeps its order. The module
imports no torch: the workers load it.
"""
from __future__ import annotations

import logging
import os
import random
from typing import Iterable, List, Tuple

from petastorm_tpu_torch.workers_pool import EmptyResultError

logger = logging.getLogger(__name__)

#: numpy's SeedSequence takes non-negative 32-bit words.
_SEED_MASK = 0xFFFFFFFF

#: A plan position whose item completed with no rows: the watermark passes
#: it, nothing is delivered and nothing is recorded in the cursor.
_EMPTY = object()


def mint_seed() -> int:
    """A fresh 32-bit seed, minted once at plan time and recorded in the
    reader's ``state_dict``, so an unseeded run can still be resumed."""
    return int.from_bytes(os.urandom(4), "little")


class OrderedUnit:
    """One work item's envelope in deterministic mode: ``context`` is the
    ventilator's ``(epoch, position)``, ``kind`` ``'data'`` (``payload`` is
    the worker's result), ``'empty'`` or ``'skip'``. It pickles across the
    process pool; the Arrow serializer carries it as schema metadata
    instead, so the zero-copy transport stays zero-copy."""

    __slots__ = ("context", "kind", "payload")

    def __init__(self, context: Tuple[int, int], kind: str = "data", payload=None):
        self.context = (int(context[0]), int(context[1]))
        self.kind = kind
        self.payload = payload

    def __repr__(self):
        return f"OrderedUnit(e{self.context[0]}:p{self.context[1]}, {self.kind})"


class EpochPlan:
    """The canonical order over ``num_items`` work items at epoch 0.
    ``shuffled``: the ventilator permutes each epoch; ``window``: the block
    size of the window shuffle (``<= 1``: plan order).

    Growth (live data): :meth:`extend` makes the item count a step function
    of the epoch, ``(first_epoch, num_items)`` segments (``growth``: the
    segments after the first). New items take positions after the existing
    ones from an epoch not planned yet, so an epoch planned before the
    growth keeps its permutation. Positions are linearized as
    ``cum_items(epoch) + position``, so one integer orders the whole
    multi-epoch stream (``epoch * num_items + position`` without growth)."""

    def __init__(self, seed: int, num_items: int, shuffled: bool = False, window: int = 0,
                 growth: Iterable[Tuple[int, int]] = ()):
        if seed is None:
            raise ValueError("EpochPlan needs a concrete seed (deterministic mode mints one "
                             "at plan time)")
        self.seed = int(seed)
        self.num_items = int(num_items)
        self.shuffled = bool(shuffled)
        self.window = int(window)
        from petastorm_tpu_torch.utils.growth import GrowthSchedule
        self._schedule = GrowthSchedule.base(int(num_items))
        self._block_cache = {}
        for first_epoch, n in sorted(growth):
            self.extend(int(first_epoch), int(n))

    def describe(self) -> dict:
        """The plan's JSON record for ``state_dict`` (the JAX package's):
        ``growth``, only when the plan grew, lists the ``[first_epoch,
        num_items]`` segments a resumed plan replays."""
        d = {"version": 1, "seed": self.seed, "items": self.num_items,
             "shuffled": self.shuffled, "window": self.window}
        if self._schedule.grown:
            d["growth"] = [[e, n] for e, n in self._schedule.segments[1:]]
        return d

    def extend(self, first_epoch: int, num_items: int) -> None:
        """Epochs from ``first_epoch`` on plan over ``num_items`` items, the
        new positions after the existing ones. ``first_epoch`` must not
        precede the last segment (the reader passes the ventilator's
        normalised effective epoch): a minted permutation never changes."""
        if num_items == self._schedule.final_size:
            return
        self._schedule.extend(first_epoch, num_items, strict=True)
        # A tail block's length depends on its epoch's item count.
        self._block_cache.clear()

    @property
    def growth_segments(self) -> List[Tuple[int, int]]:
        """The whole segment table ``[(0, base), (e1, n1), ...]``."""
        return self._schedule.segments

    def rebase(self) -> None:
        """One epoch-0 segment over the whole item count: the reader's
        ``reset()`` rebase (with a gate and ventilator reset: the cursor's
        origin moves)."""
        self._schedule.rebase()
        self.num_items = self._schedule.final_size
        self._block_cache.clear()

    def num_items_at(self, epoch: int) -> int:
        """The item count of ``epoch``."""
        return self._schedule.size_at(epoch)

    def cum_items(self, epoch: int) -> int:
        """Items in epochs ``[0, epoch)``: the linear ordinal of ``epoch``'s
        first position."""
        return self._schedule.cum_items(epoch)

    def slot_epoch(self, consumed: int) -> Tuple[int, int]:
        """``(epoch, position)`` of consumption slot ``consumed``."""
        return self._schedule.slot(consumed)

    def permutation(self, epoch: int) -> list:
        """Item order of ``epoch``: position ``p`` holds item
        ``permutation(epoch)[p]``, the ventilator's
        ``random.Random(seed + epoch).shuffle`` over the items live at
        ``epoch`` (identity unshuffled)."""
        order = list(range(self.num_items_at(epoch)))
        if self.shuffled:
            random.Random(self.seed + epoch).shuffle(order)
        return order

    def block_permutation(self, epoch: int, block_start: int) -> Tuple[int, ...]:
        """The window shuffle of the block that starts at plan position
        ``block_start`` of ``epoch``: a function of ``(seed, epoch,
        block_start)``, never of arrival timing."""
        import numpy as np
        key = (epoch, block_start)
        perm = self._block_cache.get(key)
        if perm is None:
            length = min(self.window, self.num_items_at(epoch) - block_start)
            rng = np.random.default_rng([self.seed & _SEED_MASK, epoch & _SEED_MASK,
                                         block_start & _SEED_MASK, 0x0EDE])
            perm = tuple(int(i) for i in rng.permutation(length))
            if len(self._block_cache) > 8:
                self._block_cache.clear()
            self._block_cache[key] = perm
        return perm

    # ------------------------------------------------- cursor arithmetic
    def needed_linear(self, consumed: int) -> int:
        """Linear ordinal of the unit delivered at consumption slot
        ``consumed`` (units consumed since epoch 0)."""
        if self.window <= 1:
            return consumed
        epoch, r = self.slot_epoch(consumed)
        block_start = (r // self.window) * self.window
        perm = self.block_permutation(epoch, block_start)
        return self.cum_items(epoch) + block_start + perm[r - block_start]

    def cursor_fields(self, consumed: int) -> Tuple[int, int, int]:
        """``(epoch, offset, window_delivered)`` of slot ``consumed``:
        ``offset`` is where ventilation restarts (the watermark, or the
        current block's start), ``window_delivered`` how many of that
        block's units were delivered already."""
        epoch, r = self.slot_epoch(consumed)
        if self.window <= 1:
            return epoch, r, 0
        block_start = (r // self.window) * self.window
        return epoch, block_start, r - block_start

    def consumed_from_cursor(self, epoch: int, offset: int, window_delivered: int) -> int:
        return self.cum_items(epoch) + offset + window_delivered


class OrderedDeliveryGate:
    """The reorder stage between ``pool.get_results()`` and the consumer.

    ``pull(fetch)`` returns the next payload in plan order, calling
    ``fetch()`` (the pool's results, in any order) until the unit at the
    watermark has arrived. ``skip`` units advance the watermark and are
    recorded for the cursor, ``empty`` ones advance it silently, and a unit
    seen twice is dropped by its ordinal.

    :meth:`cursor` advances on delivery to the consumer, not on completion
    in the pool, so a checkpoint never passes buffered units;
    ``back_up=True`` gives the cursor before the last data delivery (the
    caller holds a unit in part: a resume reads it again whole).

    Counters (plain ints): ``units_reordered`` (units that arrived ahead of
    the watermark), ``skips_recorded``, ``duplicates_dropped``, and
    :attr:`buffered_count`.
    """

    def __init__(self, plan: EpochPlan, start_epoch: int = 0, start_offset: int = 0,
                 window_delivered: int = 0, skipped: Iterable[int] = ()):
        self._plan = plan
        self._c = plan.consumed_from_cursor(start_epoch, start_offset, window_delivered)
        #: Consumption slot at the entry of the pull that made the last data
        #: delivery: the ``back_up`` cursor.
        self._c_entry = self._c
        self._buffered = {}
        #: Skip ordinals reported and not yet passed by the watermark.
        self._skips = {int(s) for s in skipped}
        #: Every skip ordinal reported (a resumed run drops them even where
        #: the fault does not fire again).
        self._skip_log = set(self._skips)
        #: Ordinals consumed within the current window block (duplicate
        #: detection; on a resume, the block's prefix delivered before it).
        self._consumed_in_block = set()
        if plan.window > 1 and window_delivered:
            perm = plan.block_permutation(start_epoch, start_offset)
            base = plan.cum_items(start_epoch) + start_offset
            self._consumed_in_block = {base + perm[j] for j in range(window_delivered)}
        self.units_reordered = 0
        self.skips_recorded = 0
        self.duplicates_dropped = 0

    @property
    def buffered_count(self) -> int:
        return len(self._buffered)

    def counters(self) -> dict:
        return {"units_reordered": self.units_reordered, "skips_recorded": self.skips_recorded,
                "duplicates_dropped": self.duplicates_dropped,
                "buffer_depth": self.buffered_count}

    def pull(self, fetch):
        """The next payload in plan order. Raises what ``fetch`` raises
        (``EmptyResultError`` at the end of the stream, worker failures)."""
        c_entry = self._c
        while True:
            needed = self._plan.needed_linear(self._c)
            if needed in self._skips:
                self._skips.discard(needed)
                self._advance(needed)
                continue
            unit = self._buffered.pop(needed, None)
            if unit is _EMPTY:
                self._advance(needed)
                continue
            if unit is not None:
                self._advance(needed)
                self._c_entry = c_entry
                return unit
            try:
                result = fetch()
            except EmptyResultError:
                if self._buffered:
                    # A stop() mid-epoch: the pool ended its stream with
                    # units still waiting here. End of data, as in free order.
                    logger.debug("ordered gate: stream ended with %d buffered unit(s)",
                                 len(self._buffered))
                raise
            self._feed(result)

    def cursor(self, back_up: bool = False) -> dict:
        """``{"epoch", "offset", "window_delivered", "skipped_ordinals"}``:
        ``skipped_ordinals`` lists every known skip at or after the
        ventilation restart point."""
        c = self._c_entry if back_up else self._c
        epoch, offset, k = self._plan.cursor_fields(c)
        base = self._plan.cum_items(epoch) + offset
        pending = sorted(s for s in (self._skip_log | self._skips) if s >= base)
        return {"epoch": int(epoch), "offset": int(offset), "window_delivered": int(k),
                "skipped_ordinals": [int(s) for s in pending]}

    def reset(self) -> None:
        """Back to the stream's origin: another pass replays the same order."""
        self._c = 0
        self._c_entry = 0
        self._buffered.clear()
        self._skips.clear()
        self._skip_log.clear()
        self._consumed_in_block.clear()

    # ---------------------------------------------------------- internals
    def _advance(self, consumed_linear: int) -> None:
        plan = self._plan
        if plan.window > 1:
            self._consumed_in_block.add(consumed_linear)
        self._c += 1
        if plan.window > 1:
            _epoch, r = plan.slot_epoch(self._c)
            if r % plan.window == 0 or r == 0:
                # A block (or an epoch, whose size may not be a multiple of
                # the window) is finished: the watermark covers it.
                self._consumed_in_block.clear()

    def _already_consumed(self, linear: int) -> bool:
        plan = self._plan
        if plan.window <= 1:
            return linear < self._c
        epoch, offset, _k = plan.cursor_fields(self._c)
        block_base = plan.cum_items(epoch) + offset
        return linear < block_base or linear in self._consumed_in_block

    def _feed(self, result) -> None:
        if not isinstance(result, OrderedUnit):
            raise TypeError(f"deterministic mode expected OrderedUnit payloads from the pool, "
                            f"got {type(result).__name__} (a worker without sample_order?)")
        epoch, pos = result.context
        linear = self._plan.cum_items(epoch) + pos
        if result.kind == "skip":
            if linear not in self._skip_log and not self._already_consumed(linear):
                self._skips.add(linear)
                self._skip_log.add(linear)
                self.skips_recorded += 1
            return
        if self._already_consumed(linear) or linear in self._buffered \
                or linear in self._skip_log:
            # A duplicate: a resume reading a window's delivered members again.
            self.duplicates_dropped += 1
            return
        if result.kind == "empty" or result.payload is None:
            self._buffered[linear] = _EMPTY
            return
        if linear != self._plan.needed_linear(self._c):
            self.units_reordered += 1
        self._buffered[linear] = result.payload
