"""Resume in petastorm_tpu_torch against the JAX package's (free mode).

* The ventilators: the same item orders, from the start and resumed, and
  the same ``state`` after the same confirmations, in order and out of
  order.
* The reader cursor (``Reader.state_dict`` / ``resume_state=``): the same
  keys, and at the same delivery points the same values, but for one
  documented difference. The port counts a row group as read once its last
  row is handed out; the JAX reader once the worker's confirmation, which
  it reads on the next pull, has come. So after ``n`` rows of 10-row groups
  the port's position is ``n // 10`` and the JAX reader's ``ceil(n / 10) -
  1``: equal unless the pull ends exactly on a group. Cursors resume across
  the packages in both directions, and with one worker a resumed stream is
  the uninterrupted remainder.
* The loaders' delivery-accurate ``state_dict``: at every delivered batch
  for ``DataLoader`` (the same relation) and ``BatchedDataLoader`` (equal);
  the shuffling-buffer loaders raise; and the random-interrupt no-loss
  property of ``tests/test_resume.py:555`` on the thread and process pools.
"""
import collections
import random
import time
import warnings

import numpy as np
import pytest

from petastorm_tpu.jax import BatchedDataLoader as JaxBatchedDataLoader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.workers_pool.ventilator import ConcurrentVentilator as JaxVentilator
from petastorm_tpu_torch.loader import BatchedDataLoader, DataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.workers_pool import ITEM_CONTEXT_KWARG
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

GROUP = 10    # rows per row group of both session stores (100 rows, 10 groups)


# ----------------------------------------------------------------- ventilator
def _ventilated(cls, **kwargs):
    got = []
    v = cls(lambda **kw: got.append((kw["i"], kw[ITEM_CONTEXT_KWARG])),
            [{"i": i} for i in range(10)], max_ventilation_queue_size=1000,
            item_context_key=ITEM_CONTEXT_KWARG, **kwargs)
    v.start()
    deadline = time.monotonic() + 30
    while not v.completed() and time.monotonic() < deadline:
        time.sleep(0.005)
    v.stop()
    assert v.completed()
    return got


@pytest.mark.parametrize("kwargs", [
    dict(iterations=2),
    dict(iterations=3, randomize_item_order=True, random_seed=3),
    dict(iterations=3, randomize_item_order=True, random_seed=3, start_epoch=1, start_offset=4),
    dict(iterations=2, start_epoch=0, start_offset=9),
    dict(iterations=2, randomize_item_order=True, random_seed=5, start_epoch=2),
], ids=["plain", "seeded", "resumed", "last offset", "past the end"])
def test_ventilators_ventilate_the_same_orders(kwargs):
    assert _ventilated(ConcurrentVentilator, **kwargs) == _ventilated(JaxVentilator, **kwargs)


def test_resumed_order_is_the_uninterrupted_remainder():
    full = _ventilated(ConcurrentVentilator, iterations=2, randomize_item_order=True,
                       random_seed=3)
    rest = _ventilated(ConcurrentVentilator, iterations=2, randomize_item_order=True,
                       random_seed=3, start_epoch=0, start_offset=4)
    assert rest == full[4:]


def _states_after(cls, completions, **kwargs):
    v = cls(lambda **kw: None, [{"i": i} for i in range(8)], iterations=3,
            max_ventilation_queue_size=1000, **kwargs)
    out = [v.state]
    for ctx in completions:
        v.processed_item(ctx)
        out.append(v.state)
    return out


@pytest.mark.parametrize("completions", [
    [(0, p) for p in range(8)] + [(1, 0), (1, 1)],
    [(0, 1), (0, 3), (0, 0), (0, 2)] + [(0, p) for p in (7, 6, 5, 4)] + [(1, 1), (1, 0)],
    [None] * 11,
], ids=["in order", "out of order", "no contexts"])
def test_ventilators_report_the_same_state_after_the_same_confirmations(completions):
    got = _states_after(ConcurrentVentilator, completions)
    assert got == _states_after(JaxVentilator, completions)
    if completions[1] == (0, 3):
        assert [s["offset"] for s in got[:5]] == [0, 0, 0, 2, 4]


def test_ventilator_state_of_a_resumed_run_and_its_seed():
    kw = dict(randomize_item_order=True, random_seed=9, start_epoch=1, start_offset=6)
    got = _states_after(ConcurrentVentilator, [(1, 6), (1, 7)], **kw)
    assert got == _states_after(JaxVentilator, [(1, 6), (1, 7)], **kw)
    assert got[-1] == {"epoch": 2, "offset": 0, "seed": 9, "randomized": True}


def test_ventilators_refuse_an_offset_out_of_range():
    for cls in (ConcurrentVentilator, JaxVentilator):
        with pytest.raises(ValueError, match="start_offset"):
            cls(lambda **kw: None, [{"i": 0}], start_offset=1)


def test_watermark_counts_delivered_positions_without_consuming_them():
    v = ConcurrentVentilator(lambda **kw: None, [{"i": i} for i in range(4)], iterations=2)
    v.processed_item((0, 1))
    assert v.watermark() == (0, 0)
    assert v.watermark({(0, 0)}) == (0, 2)
    assert v.watermark({(0, 0), (0, 2), (0, 3)}) == (1, 0)
    assert v.watermark() == (0, 0)


# --------------------------------------------------------------------- reader
def _cursor(linear: int, items: int = 10) -> tuple:
    return linear // items, linear % items


def _port_position(rows: int) -> tuple:
    """The port's cursor after ``rows`` rows: the first group not fully
    handed out."""
    return _cursor(rows // GROUP)


def _jax_position(rows: int) -> tuple:
    """The JAX reader's: the group of the last row pulled (0 before any)."""
    return _cursor(max(0, -(-rows // GROUP) - 1))


def _pull(factory, url, n, **kwargs):
    with factory(url, **kwargs) as reader:
        it = iter(reader)
        ids = [int(next(it).id) for _ in range(n)]
        return ids, reader.state_dict()


def _rest(factory, url, **kwargs):
    with factory(url, **kwargs) as reader:
        return [int(row.id) for row in reader]


READER_KW = {"file order": dict(shuffle_row_groups=False),
             "seeded shuffle": dict(shuffle_row_groups=True, seed=11),
             "rows shuffled": dict(shuffle_row_groups=True, shuffle_rows=True, seed=7)}


@pytest.mark.parametrize("kw", READER_KW.values(), ids=READER_KW.keys())
@pytest.mark.parametrize("n", [0, 1, 9, 10, 37, 40, 99, 100, 101, 150])
def test_reader_cursor_key_for_key_at_the_same_delivery_points(synthetic_dataset, kw, n):
    kwargs = dict(schema_fields=["id"], reader_pool_type="dummy", num_epochs=2, **kw)
    ids, port = _pull(make_reader, synthetic_dataset.url, n, **kwargs)
    jax_ids, jax = _pull(jax_make_reader, synthetic_dataset.url, n, **kwargs)
    assert ids == jax_ids
    assert set(port) == set(jax) == {"epoch", "offset", "items", "seed"}
    assert port["items"] == jax["items"] == 10 and port["seed"] == jax["seed"]
    assert (port["epoch"], port["offset"]) == _port_position(n)
    assert (jax["epoch"], jax["offset"]) == _jax_position(n)
    if n % GROUP:
        assert port == jax


@pytest.mark.parametrize("n", [10, 37, 100, 133])
def test_cursors_resume_across_the_packages(synthetic_dataset, n):
    """A port cursor read by the JAX reader, and a JAX cursor by the port's,
    give the stream the saving package's own reader gives from it."""
    kwargs = dict(schema_fields=["id"], reader_pool_type="dummy", num_epochs=2,
                  shuffle_row_groups=True, shuffle_rows=True, seed=5)
    _, port = _pull(make_reader, synthetic_dataset.url, n, **kwargs)
    _, jax = _pull(jax_make_reader, synthetic_dataset.url, n, **kwargs)
    for state in (port, jax):
        mine = _rest(make_reader, synthetic_dataset.url, resume_state=state, **kwargs)
        theirs = _rest(jax_make_reader, synthetic_dataset.url, resume_state=state, **kwargs)
        assert mine == theirs and len(mine) == 200 - GROUP * (state["epoch"] * 10
                                                             + state["offset"])


@pytest.mark.parametrize("pool", ["thread", "dummy"])
@pytest.mark.parametrize("n", [20, 30, 55, 100, 130])
def test_one_worker_resumes_the_uninterrupted_remainder(synthetic_dataset, pool, n):
    """At a group boundary the resumed stream is the remainder itself; inside
    a group it is that group's rows already read, then the remainder."""
    kwargs = dict(schema_fields=["id"], reader_pool_type=pool, workers_count=1, num_epochs=2,
                  shuffle_row_groups=True, shuffle_rows=True, seed=3)
    full = _rest(make_reader, synthetic_dataset.url, **kwargs)
    part, state = _pull(make_reader, synthetic_dataset.url, n, **kwargs)
    rest = _rest(make_reader, synthetic_dataset.url, resume_state=state, **kwargs)
    assert part == full[:n]
    assert rest == full[n - n % GROUP:]


def test_batch_reader_cursor_and_resume(scalar_dataset):
    kwargs = dict(reader_pool_type="dummy", shuffle_row_groups=True, seed=2, num_epochs=1)
    with make_batch_reader(scalar_dataset.url, **kwargs) as r, \
            jax_make_batch_reader(scalar_dataset.url, **kwargs) as j:
        for _ in range(3):
            got, want = r.next_batch(), j.next_batch()
            np.testing.assert_array_equal(got["id"], want["id"])
        port, jax = r.state_dict(), j.state_dict()
    # A batch is handed out whole: after three the port points at the fourth.
    assert port == {**jax, "offset": 3} and jax["offset"] == 2
    with make_batch_reader(scalar_dataset.url, resume_state=port, **kwargs) as r, \
            jax_make_batch_reader(scalar_dataset.url, resume_state=port, **kwargs) as j:
        mine, theirs = [], []
        for reader, out in ((r, mine), (j, theirs)):
            try:
                while True:
                    out.extend(int(i) for i in reader.next_batch()["id"])
            except StopIteration:
                pass
    assert mine == theirs and len(mine) == 70


def test_minted_seed_is_recorded_and_resumes(synthetic_dataset):
    kwargs = dict(schema_fields=["id"], reader_pool_type="dummy", shuffle_row_groups=True,
                  num_epochs=1)
    first, state = _pull(make_reader, synthetic_dataset.url, 30, **kwargs)
    assert state["seed"] is not None
    rest = _rest(make_reader, synthetic_dataset.url, resume_state=state, **kwargs)
    assert sorted(first + rest) == list(range(100))


@pytest.mark.parametrize("resume_state,kwargs,match", [
    ({"epoch": 0, "offset": 1}, dict(shuffle_row_groups=True), "seed"),
    ({"epoch": 0, "offset": 1, "seed": 4}, dict(shuffle_row_groups=True, seed=5), "seed"),
    ({"epoch": 0, "offset": 1, "items": 10}, dict(shuffle_row_groups=False, cur_shard=0,
                                                  shard_count=2), "work items"),
    ({"epoch": 0, "offset": 999}, dict(shuffle_row_groups=False), "offset"),
    ({"epoch": 0, "offset": 1, "sample_order": "deterministic"},
     dict(shuffle_row_groups=False), "sample_order"),
], ids=["no seed", "other seed", "changed item count", "offset out of range",
        "deterministic cursor"])
def test_resume_checks_refuse_like_the_jax_reader(synthetic_dataset, resume_state, kwargs,
                                                  match):
    with pytest.raises(ValueError, match=match):
        make_reader(synthetic_dataset.url, reader_pool_type="dummy", resume_state=resume_state,
                    **kwargs)
    with pytest.raises(ValueError, match=match):
        jax_make_reader(synthetic_dataset.url, reader_pool_type="dummy",
                        resume_state=resume_state, **kwargs)


# -------------------------------------------------------------------- loaders
def _port_loader_states(loader_cls, factory, url, reader_kw, loader_kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with factory(url, reader_pool_type="dummy", **reader_kw) as reader:
            loader = loader_cls(reader, device="cpu", **loader_kw)
            out = []
            for batch in loader:
                out.append((len(batch["id"]), loader.state_dict()))
            return out


def _jax_loader_states(loader_cls, factory, url, reader_kw, loader_kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with factory(url, reader_pool_type="dummy", **reader_kw) as reader:
            loader = loader_cls(reader, **loader_kw)
            out = []
            for batch in loader:
                out.append((len(batch["id"]), loader.state_dict()))
            return out


@pytest.mark.parametrize("batch_size", [7, 10, 20, 30])
@pytest.mark.parametrize("reader_kw", [dict(shuffle_row_groups=False),
                                       dict(shuffle_row_groups=True, seed=4)],
                         ids=["file order", "seeded shuffle"])
def test_data_loader_state_at_every_delivered_batch(synthetic_dataset, batch_size, reader_kw):
    reader_kw = dict(schema_fields=["id"], num_epochs=1, **reader_kw)
    loader_kw = dict(batch_size=batch_size, drop_last=False, prefetch=3)
    port = _port_loader_states(DataLoader, make_reader, synthetic_dataset.url, reader_kw,
                               loader_kw)
    jax = _jax_loader_states(JaxDataLoader, jax_make_reader, synthetic_dataset.url, reader_kw,
                             loader_kw)
    assert [n for n, _ in port] == [n for n, _ in jax]
    rows = 0
    for (n, p), (_, j) in zip(port, jax):
        rows += n
        assert (p["epoch"], p["offset"]) == _port_position(rows)
        # A short last batch is assembled after the reader's end, which has
        # confirmed every group.
        ended = rows == 100 and n < batch_size
        assert (j["epoch"], j["offset"]) == (_port_position(rows) if ended
                                             else _jax_position(rows))
        if rows % GROUP or ended:
            assert p == j


@pytest.mark.parametrize("batch_size", [7, 10, 25])
def test_batched_loader_state_equals_jax_at_every_delivered_batch(scalar_dataset, batch_size):
    reader_kw = dict(shuffle_row_groups=True, seed=6, num_epochs=1)
    loader_kw = dict(batch_size=batch_size, drop_last=False, prefetch=3)
    port = _port_loader_states(BatchedDataLoader, make_batch_reader, scalar_dataset.url,
                               reader_kw, loader_kw)
    jax = _jax_loader_states(JaxBatchedDataLoader, jax_make_batch_reader, scalar_dataset.url,
                             reader_kw, loader_kw)
    assert port == jax


def test_state_before_the_first_batch_is_the_readers(synthetic_dataset):
    with make_reader(synthetic_dataset.url, schema_fields=["id"], reader_pool_type="dummy",
                     shuffle_row_groups=False, num_epochs=1,
                     resume_state={"epoch": 0, "offset": 3}) as reader:
        loader = DataLoader(reader, batch_size=5, device="cpu")
        assert loader.state_dict() is None
        it = iter(loader)
        next(it)
        it.close()
    assert loader.state_dict()["offset"] == 3


@pytest.mark.parametrize("loader_cls,factory,store", [
    (DataLoader, make_reader, "synthetic_dataset"),
    (BatchedDataLoader, make_batch_reader, "scalar_dataset")])
def test_shuffling_buffer_loaders_refuse_state_dict(request, loader_cls, factory, store):
    url = request.getfixturevalue(store).url
    with factory(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        loader = loader_cls(reader, batch_size=5, shuffling_queue_capacity=20, device="cpu")
        with pytest.raises(ValueError, match="shuffling_queue_capacity"):
            loader.state_dict()


def test_prefetched_batches_are_read_again_not_skipped(synthetic_dataset):
    """The reader's own cursor runs ahead by the staged batches; the
    loader's stays at the last delivered one."""
    kw = dict(schema_fields=["id"], reader_pool_type="thread", workers_count=1,
              shuffle_row_groups=False, num_epochs=1)
    with make_reader(synthetic_dataset.url, **kw) as reader:
        loader = DataLoader(reader, batch_size=10, prefetch=3, device="cpu")
        it = iter(loader)
        part1 = [int(v) for _ in range(2) for v in next(it)["id"]]
        deadline = time.monotonic() + 10
        while reader.state_dict()["offset"] < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        state, raw = loader.state_dict(), reader.state_dict()
        it.close()
    assert state["offset"] == 2 and raw["offset"] >= 4
    rest = _rest(make_reader, synthetic_dataset.url, resume_state=state, **kw)
    assert part1 + rest == list(range(100))


def _read_all(url, pool, seed, batch, resume_state=None, stop_after=None):
    with make_reader(url, schema_fields=["id"], reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=True, seed=seed, num_epochs=1,
                     resume_state=resume_state) as reader:
        loader = DataLoader(reader, batch_size=batch, drop_last=False, device="cpu")
        out, state = [], None
        for i, b in enumerate(loader):
            out.extend(int(v) for v in b["id"])
            if stop_after is not None and i + 1 == stop_after:
                state = loader.state_dict()
                break
        return out, state


@pytest.mark.parametrize("pool,seed", [("thread", 0), ("thread", 7), ("process", 0)])
def test_resume_no_loss_property_random_interrupt_points(synthetic_dataset, pool, seed):
    """Random interrupt points: no row is lost (every row the first part did
    not deliver comes back), duplicates are bounded by the groups in flight
    (the ventilator's cap of 8 for 2 workers), and on the seeded thread pool
    the streams are the uninterrupted one's, as in the JAX package's test."""
    batch = 10
    full, _ = _read_all(synthetic_dataset.url, pool, seed, batch)
    assert sorted(full) == list(range(100))
    rng = random.Random(1234 + seed)
    for k in sorted(rng.sample(range(1, len(full) // batch), 3)):
        part1, state = _read_all(synthetic_dataset.url, pool, seed, batch, stop_after=k)
        part2, _ = _read_all(synthetic_dataset.url, pool, seed, batch, resume_state=state)
        missing = collections.Counter(full) - collections.Counter(part1)
        assert not missing - collections.Counter(part2), (pool, seed, k)
        assert len(part1) + len(part2) - len(full) <= 8 * GROUP
        if pool == "thread":
            rest = full[k * batch:]
            assert part1 == full[:k * batch]
            assert part2[-len(rest):] == rest
