"""The deterministic epoch plane of petastorm_tpu_torch against the JAX
package's (``reader_impl/epoch_plan.py``).

* ``EpochPlan``: the epoch permutations, the window blocks' permutations
  and the cursor arithmetic equal the JAX plan's over a grid of (seed,
  items, window, epoch).
* ``OrderedDeliveryGate``: fed the same arrival sequence, the two gates
  release the same payloads and give the same cursors at every step: out
  of order, duplicates, skips, empty units, ``back_up``, windowed delivery
  and a resume inside a window.
* ``OrderedUnit`` round-trips through the port's Arrow serializer, and its
  stream is the JAX serializer's after the port's lead bytes.
"""
import random

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.reader_impl import epoch_plan as jax_plane
from petastorm_tpu.reader_impl.arrow_table_serializer import \
    ArrowTableSerializer as JaxArrowTableSerializer
from petastorm_tpu.workers_pool import EmptyResultError as JaxEmptyResultError
from petastorm_tpu_torch.reader_impl import epoch_plan as plane
from petastorm_tpu_torch.reader_impl.arrow_table_serializer import LEAD, ArrowTableSerializer
from petastorm_tpu_torch.workers_pool import EmptyResultError

GRID = [(seed, items, window) for seed in (0, 7, 2 ** 32 - 1, 123456789)
        for items in (1, 5, 16, 37) for window in (0, 1, 3, 4, 16)]


def _plans(seed, items, window, shuffled=True):
    return (plane.EpochPlan(seed, items, shuffled=shuffled, window=window),
            jax_plane.EpochPlan(seed, items, shuffled=shuffled, window=window))


@pytest.mark.parametrize("seed,items,window", GRID)
def test_plan_orders_and_cursor_arithmetic_match_jax(seed, items, window):
    port, ref = _plans(seed, items, window)
    assert port.describe() == ref.describe()
    for epoch in range(3):
        assert port.permutation(epoch) == ref.permutation(epoch)
        assert port.cum_items(epoch) == ref.cum_items(epoch)
        if window > 1:
            for start in range(0, items, window):
                assert port.block_permutation(epoch, start) == ref.block_permutation(epoch, start)
    for consumed in range(3 * items + 2):
        assert port.slot_epoch(consumed) == ref.slot_epoch(consumed)
        assert port.needed_linear(consumed) == ref.needed_linear(consumed)
        fields = port.cursor_fields(consumed)
        assert fields == ref.cursor_fields(consumed)
        assert port.consumed_from_cursor(*fields) == consumed


@pytest.mark.parametrize("seed,items", [(3, 10), (11, 7)])
def test_permutation_is_the_ventilators_order(seed, items):
    order = list(range(items))
    random.Random(seed + 2).shuffle(order)
    assert plane.EpochPlan(seed, items, shuffled=True).permutation(2) == order
    assert plane.EpochPlan(seed, items).permutation(2) == list(range(items))


@pytest.mark.parametrize("items,window", [(16, 4), (37, 16), (10, 3)])
def test_needed_linear_covers_every_slot_once(items, window):
    plan = plane.EpochPlan(5, items, shuffled=True, window=window)
    got = [plan.needed_linear(c) for c in range(2 * items)]
    assert sorted(got) == list(range(2 * items))
    assert got != list(range(2 * items))
    # the mixing radius: a unit lands within its block
    assert all(abs(g - c) < window for c, g in enumerate(got))


def test_plan_needs_a_seed_and_mint_seed_is_32_bit():
    with pytest.raises(ValueError, match="seed"):
        plane.EpochPlan(None, 4)
    seeds = {plane.mint_seed() for _ in range(16)}
    assert all(0 <= s < 2 ** 32 for s in seeds) and len(seeds) > 1


# ----------------------------------------------------------------------- gate
def _run_gates(plan_args, arrivals, pulls, gate_kwargs=None, back_up_at=()):
    """Feed both packages' gates ``arrivals`` (``(epoch, pos, kind)``
    triples, payload ``f"e{epoch}p{pos}"``) and pull ``pulls`` times; returns
    each gate's releases and cursors (after every pull, and backed up where
    asked)."""
    out = []
    for mod, empty in ((plane, EmptyResultError), (jax_plane, JaxEmptyResultError)):
        plan = mod.EpochPlan(*plan_args[:2], **plan_args[2])
        gate = mod.OrderedDeliveryGate(plan, **(gate_kwargs or {}))
        it = iter([mod.OrderedUnit((e, p), kind=k, payload=None if k != "data"
                                   else f"e{e}p{p}") for e, p, k in arrivals])

        def fetch(it=it, empty=empty):
            try:
                return next(it)
            except StopIteration:
                raise empty() from None
        released, cursors = [], [gate.cursor()]
        for i in range(pulls):
            try:
                released.append(gate.pull(fetch))
            except empty:
                released.append("END")
            cursors.append(gate.cursor())
            if i in back_up_at:
                cursors.append(gate.cursor(back_up=True))
        out.append((released, cursors))
    return out


def _data(*positions, epoch=0):
    return [(epoch, p, "data") for p in positions]


GATE_CASES = {
    "out of order": ((0, 4, {}), _data(2, 0, 3, 1), 5, None, ()),
    "duplicates": ((0, 3, {}), _data(0, 0, 1, 1, 2, 0), 4, None, ()),
    "skips": ((0, 3, {}), [(0, 1, "skip"), (0, 0, "data"), (0, 1, "data"), (0, 2, "data")],
              3, None, ()),
    "empty units": ((0, 4, {}), [(0, 0, "empty"), (0, 2, "data"), (0, 1, "empty"),
                                 (0, 3, "data")], 3, None, ()),
    "back up": ((0, 3, {}), _data(0, 1, 2), 3, None, (0, 1, 2)),
    "two epochs shuffled": ((9, 4, {"shuffled": True}), _data(3, 1, 0, 2) +
                            _data(2, 0, 1, 3, epoch=1), 9, None, (4,)),
    "windowed": ((4, 8, {"window": 4}), _data(*range(8)), 9, None, (2, 5)),
    "windowed out of order": ((4, 10, {"window": 4, "shuffled": True}),
                              _data(9, 8, 3, 2, 1, 0, 7, 6, 5, 4), 10, None, (1,)),
    "resumed with skips": ((0, 3, {}), _data(1, 2), 2,
                           {"start_offset": 1, "skipped": [1]}, ()),
    "resumed inside a window": ((4, 8, {"window": 4}), _data(*range(8)), 5,
                                {"start_offset": 0, "window_delivered": 3}, (0,)),
    "resumed windowed, second epoch": ((2, 6, {"window": 4, "shuffled": True}),
                                       _data(4, 5, epoch=0) + _data(*range(6), epoch=1), 7,
                                       {"start_offset": 4, "window_delivered": 1}, ()),
}


@pytest.mark.parametrize("case", GATE_CASES.values(), ids=GATE_CASES.keys())
def test_gate_releases_and_cursors_match_jax(case):
    plan_args, arrivals, pulls, gate_kwargs, back_up_at = case
    port, ref = _run_gates(plan_args, arrivals, pulls, gate_kwargs, back_up_at)
    assert port == ref


def test_gate_windowed_resume_gives_the_uninterrupted_tail():
    plan = plane.EpochPlan(4, 8, window=4)

    def fetch_of(units):
        it = iter(units)
        return lambda: next(it)
    units = [plane.OrderedUnit((0, p), payload=p) for p in range(8)]
    gate = plane.OrderedDeliveryGate(plan)
    fetch = fetch_of(units)
    full = [gate.pull(fetch) for _ in range(8)]
    assert sorted(full) == list(range(8)) and full != list(range(8))
    for cut in range(1, 8):
        cursor = plane.OrderedDeliveryGate(plan)
        fetch = fetch_of(units)
        head = [cursor.pull(fetch) for _ in range(cut)]
        state = cursor.cursor()
        resumed = plane.OrderedDeliveryGate(plan, start_epoch=state["epoch"],
                                            start_offset=state["offset"],
                                            window_delivered=state["window_delivered"])
        # The ventilator restarts at the block's start: members delivered
        # before the cut arrive again and are dropped.
        fetch = fetch_of(units[state["offset"]:])
        assert head + [resumed.pull(fetch) for _ in range(8 - cut)] == full
        assert resumed.duplicates_dropped <= state["window_delivered"]


def test_gate_counters_and_refusal_of_bare_payloads():
    plan = plane.EpochPlan(0, 3)
    gate = plane.OrderedDeliveryGate(plan)
    units = iter([plane.OrderedUnit((0, 2), payload="c"), plane.OrderedUnit((0, 1), kind="skip"),
                  plane.OrderedUnit((0, 0), payload="a"), plane.OrderedUnit((0, 0), payload="a")])
    assert gate.pull(lambda: next(units)) == "a"
    assert gate.counters() == {"units_reordered": 1, "skips_recorded": 1,
                               "duplicates_dropped": 0, "buffer_depth": 1}
    assert gate.pull(lambda: next(units)) == "c"
    with pytest.raises(TypeError, match="OrderedUnit"):
        plane.OrderedDeliveryGate(plan).pull(lambda: "bare")


def test_gate_reset_replays_from_the_origin():
    plan = plane.EpochPlan(0, 2)
    gate = plane.OrderedDeliveryGate(plan)
    for _ in range(2):
        units = iter([plane.OrderedUnit((0, 1), payload="b"),
                      plane.OrderedUnit((0, 0), payload="a")])
        assert [gate.pull(lambda: next(units)) for _ in range(2)] == ["a", "b"]
        gate.reset()
        assert gate.cursor()["offset"] == 0


# ----------------------------------------------------------------- serializer
@pytest.mark.parametrize("kind", ["data", "empty", "skip"])
def test_ordered_unit_round_trips_through_the_arrow_serializer(kind):
    s = ArrowTableSerializer()
    table = pa.table({"x": np.arange(5, dtype=np.int64), "y": np.linspace(0, 1, 5)})
    unit = plane.OrderedUnit((2, 5), kind=kind, payload=table if kind == "data" else None)
    buf = s.serialize(unit)
    got = s.deserialize(buf)
    assert isinstance(got, plane.OrderedUnit)
    assert got.context == (2, 5) and got.kind == kind
    if kind == "data":
        assert got.payload.select(["x", "y"]).equals(table)
    else:
        assert got.payload is None
    # The same stream as the JAX serializer's, after the lead bytes.
    ref = JaxArrowTableSerializer().deserialize(memoryview(buf)[LEAD:])
    assert ref.context == got.context and ref.kind == kind
    # A plain table stays a plain table.
    assert s.deserialize(s.serialize(table)).equals(table)
