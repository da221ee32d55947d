"""``sample_order="deterministic"`` and ``shuffle_window`` in
petastorm_tpu_torch against the JAX package's readers.

* The port's stream from ``make_reader`` and ``make_batch_reader`` equals
  the JAX reader's (statistics pruning off, as the port has none) on the
  dummy, thread and process pools, with and without a window, and its
  cursors are the JAX reader's at the same points.
* A resume at random interrupt points (hypothesis) gives the rest of the
  uninterrupted stream; a row group handed out in part is read again whole.
* A JAX cursor resumes in the port and a port cursor in the JAX reader,
  with the same tail.
* The port refuses where the JAX reader refuses: a mode or a window that
  differs from the saved one, a flipped shuffle flag, a windowed offset off
  its block, and ``shuffle_window`` without deterministic order.
* Several epochs and ``reset()`` replay; the loaders' ``state_dict`` under
  a windowed deterministic reader resumes to the same batches.
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.loader import BatchedDataLoader, DataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

GROUP = 10     # rows per row group of both session stores (100 rows)


def _kw(window=0, seed=11, epochs=2, shuffle=True, **extra):
    return dict(schema_fields=["id"], shuffle_row_groups=shuffle, seed=seed, num_epochs=epochs,
                sample_order="deterministic", shuffle_window=window, **extra)


def _rows(factory, url, **kw):
    with factory(url, **kw) as r:
        return [int(row.id) for row in r]


def _batch_rows(factory, url, **kw):
    with factory(url, **kw) as r:
        return [int(v) for batch in r for v in batch.id]


def _jax(kw, **more):
    return {**kw, **more}


# ------------------------------------------------------------------- streams
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_row_stream_equals_jax(synthetic_dataset, pool, window):
    want = _rows(jax_make_reader, synthetic_dataset.url,
                 **_jax(_kw(window), reader_pool_type="dummy"))
    got = _rows(make_reader, synthetic_dataset.url,
                **_kw(window, reader_pool_type=pool, workers_count=3))
    assert got == want
    assert sorted(got) == sorted(list(range(100)) * 2)
    if window:
        assert want != _rows(jax_make_reader, synthetic_dataset.url,
                             **_jax(_kw(0), reader_pool_type="dummy"))


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("pool", ["dummy", "thread", "process"])
def test_batch_stream_equals_jax(scalar_dataset, pool, window):
    want = _batch_rows(jax_make_batch_reader, scalar_dataset.url,
                       **_jax(_kw(window, seed=5), reader_pool_type="dummy"))
    with make_batch_reader(scalar_dataset.url, reader_pool_type=pool, workers_count=3,
                           **_kw(window, seed=5)) as r:
        got = [int(v) for batch in r for v in batch.id]
        counters = r.counters
    assert got == want
    assert counters["buffer_depth"] == 0
    if pool == "process":
        # The envelope rides as schema metadata: every group still views the ring.
        assert counters["zero_copy_batches"] == 20


def test_unshuffled_deterministic_stream_is_plan_order(synthetic_dataset):
    got = _rows(make_reader, synthetic_dataset.url,
                **_kw(shuffle=False, epochs=1, reader_pool_type="thread", workers_count=4))
    assert got == _rows(make_reader, synthetic_dataset.url, schema_fields=["id"],
                        shuffle_row_groups=False, reader_pool_type="dummy")


@pytest.mark.parametrize("window", [0, 4])
def test_cursors_equal_jax_at_every_unit(synthetic_dataset, window):
    """At every cut point, in the middle of a group and at its end, the
    port's cursor is the JAX reader's (keys and values)."""
    for k in (1, 9, 10, 11, 35, 40, 99, 100, 101):
        states = []
        for factory, kw in ((make_reader, _kw(window)), (jax_make_reader, _jax(_kw(window)))):
            with factory(synthetic_dataset.url, reader_pool_type="dummy", **kw) as r:
                it = iter(r)
                for _ in range(k):
                    next(it)
                states.append(r.state_dict())
        assert states[0] == states[1], k
        assert states[0]["sample_order"] == "deterministic" and states[0]["window"] == window


# -------------------------------------------------------------------- resume
def _tail_after(k: int, full: list) -> list:
    """The stream a resume at row ``k`` gives: a group handed out in part
    is read again whole."""
    return full[(k // GROUP) * GROUP:]


@settings(max_examples=15, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(k=st.integers(min_value=0, max_value=199), window=st.sampled_from([0, 3, 4]))
def test_resume_at_random_points_gives_the_uninterrupted_tail(synthetic_dataset, k, window):
    kw = _kw(window, reader_pool_type="thread", workers_count=3)
    full = _rows(make_reader, synthetic_dataset.url, **kw)
    with make_reader(synthetic_dataset.url, **kw) as r:
        it = iter(r)
        first = [int(next(it).id) for _ in range(k)]
        state = r.state_dict()
    rest = _rows(make_reader, synthetic_dataset.url, **{**kw, "seed": None, "resume_state": state})
    assert first == full[:k]
    assert rest == _tail_after(k, full)


def test_batch_reader_resume_gives_the_uninterrupted_tail(scalar_dataset):
    kw = _kw(4, seed=3, reader_pool_type="thread", workers_count=2)
    full = _batch_rows(make_batch_reader, scalar_dataset.url, **kw)
    for k in (1, 4, 7, 13):
        with make_batch_reader(scalar_dataset.url, **kw) as r:
            first = [int(v) for _ in range(k) for v in r.next_batch()["id"]]
            state = r.state_dict()
        rest = _batch_rows(make_batch_reader, scalar_dataset.url, **{**kw, "resume_state": state})
        assert first + rest == full, k


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_cursors_cross_between_the_packages(synthetic_dataset, direction, window):
    save, load = ((jax_make_reader, make_reader) if direction == "jax to port"
                  else (make_reader, jax_make_reader))
    kw = _kw(window, reader_pool_type="dummy")

    def opts(factory, **more):
        return {**(_jax(kw) if factory is jax_make_reader else kw), **more}
    full = _rows(save, synthetic_dataset.url, **opts(save))
    for k in (7, 30, 123):
        with save(synthetic_dataset.url, **opts(save)) as r:
            it = iter(r)
            for _ in range(k):
                next(it)
            state = r.state_dict()
        rest = _rows(load, synthetic_dataset.url, **opts(load, seed=None, resume_state=state))
        same_package = _rows(save, synthetic_dataset.url,
                             **opts(save, seed=None, resume_state=state))
        assert rest == same_package == _tail_after(k, full), k


# ---------------------------------------------------------------- refusals
def _saved_state(url, **kw):
    with make_reader(url, reader_pool_type="dummy", **kw) as r:
        next(r)
        return r.state_dict()


REFUSALS = {
    "mode": (dict(sample_order="deterministic", seed=3), dict(), "sample_order"),
    "window": (dict(sample_order="deterministic", seed=3),
               dict(sample_order="deterministic", shuffle_window=4), "shuffle_window"),
    "shuffle flag": (dict(sample_order="deterministic", shuffle_row_groups=True, seed=3),
                     dict(sample_order="deterministic", shuffle_row_groups=False),
                     "shuffle_row_groups"),
    "misaligned offset": ({"epoch": 0, "offset": 3, "seed": 3},
                          dict(sample_order="deterministic", shuffle_window=4, seed=3),
                          "aligned"),
}


@pytest.mark.parametrize("case", REFUSALS.values(), ids=REFUSALS.keys())
def test_port_refuses_where_jax_refuses(synthetic_dataset, case):
    saved, resume_kw, match = case
    state = saved if "offset" in saved else _saved_state(synthetic_dataset.url, **saved)
    for factory, extra in ((make_reader, {}), (jax_make_reader, {})):
        with pytest.raises(ValueError, match=match):
            factory(synthetic_dataset.url, reader_pool_type="dummy", resume_state=state,
                    **resume_kw, **extra)


@pytest.mark.parametrize("kw,match", [
    (dict(sample_order="chaotic"), "sample_order"),
    (dict(shuffle_window=8), "shuffle_window"),
    (dict(sample_order="deterministic", shuffle_window=-1), "shuffle_window"),
], ids=["unknown order", "window in free order", "negative window"])
def test_arguments_are_checked_as_jax_checks_them(synthetic_dataset, kw, match):
    for factory in (make_reader, make_batch_reader, jax_make_reader):
        with pytest.raises(ValueError, match=match):
            factory(synthetic_dataset.url, reader_pool_type="dummy", **kw)


def test_live_data_cursors_are_refused(synthetic_dataset):
    """Live-data cursors, refused before the port read live data, now
    resume as in the JAX reader: a JAX cursor with a file manifest, and one
    whose plan grew by the store's last file from epoch 1, give the port
    the JAX reader's rows."""
    url = synthetic_dataset.url
    kw = _kw(seed=3, reader_pool_type="dummy", refresh_interval_s=0)
    with jax_make_reader(url, **kw) as r:
        it = iter(r)
        for _ in range(25):
            next(it)
        state = r.state_dict()
    files = state["manifest"]["base"]
    assert state["manifest"]["growth"] == [] and len(files) > 1
    last = int(files[-1][1])
    grown = {**state, "epoch": 0, "offset": 0, "window_delivered": 0, "skipped_ordinals": [],
             "manifest": {"base": files[:-1],
                          "growth": [{"epoch": 1, "files": files[-1:], "items": last}]},
             "plan": {**state["plan"], "items": state["items"] - last,
                      "growth": [[1, state["items"]]]}}
    for cursor, rows in ((state, 200 - 20), (grown, 200 - GROUP * last)):
        want = _rows(jax_make_reader, url, resume_state=cursor, **kw)
        got = _rows(make_reader, url, resume_state=cursor, **kw)
        assert got == want and len(got) == rows


def test_state_dict_records_the_plan_and_a_minted_seed(synthetic_dataset):
    state = _saved_state(synthetic_dataset.url, sample_order="deterministic")
    assert set(state) == {"epoch", "offset", "window_delivered", "skipped_ordinals", "items",
                          "seed", "sample_order", "window", "plan"}
    assert state["seed"] is not None and state["plan"]["seed"] == state["seed"]
    assert state["plan"] == {"version": 1, "seed": state["seed"], "items": 10,
                             "shuffled": True, "window": 0}


# ------------------------------------------------------- epochs and reset
def test_multi_epoch_stream_and_reset_replay(synthetic_dataset):
    kw = _kw(0, seed=3, reader_pool_type="thread", workers_count=2)
    two = _rows(make_reader, synthetic_dataset.url, **kw)
    assert len(two) == 200 and two[:100] != two[100:]
    assert two == _rows(jax_make_reader, synthetic_dataset.url, **_jax(kw))
    with make_reader(synthetic_dataset.url, **{**kw, "num_epochs": 1,
                                               "shuffle_window": 4}) as r:
        first_pass = [int(s.id) for s in r]
        r.reset()
        assert r.state_dict()["offset"] == 0
        second_pass = [int(s.id) for s in r]
    assert second_pass == first_pass
    assert first_pass == _rows(make_reader, synthetic_dataset.url,
                               **{**kw, "num_epochs": 2, "shuffle_window": 4})[:100]


# ------------------------------------------------------------------ loaders
def _loader_batches(loader, n=None):
    out = []
    for i, batch in enumerate(loader):
        out.append(batch["id"].tolist())
        if n is not None and i + 1 == n:
            break
    return out


@pytest.mark.parametrize("cut", [1, 5, 13])
def test_loader_state_under_a_windowed_reader_resumes_to_the_same_batches(synthetic_dataset,
                                                                          cut):
    kw = _kw(4, seed=7, reader_pool_type="thread", workers_count=3)
    with make_reader(synthetic_dataset.url, **kw) as r:
        full = _loader_batches(DataLoader(r, batch_size=GROUP, device="cpu"))
    with make_reader(synthetic_dataset.url, **kw) as r:
        loader = DataLoader(r, batch_size=GROUP, device="cpu", prefetch=3)
        head = _loader_batches(loader, cut)
        state = loader.state_dict()
    assert state["sample_order"] == "deterministic" and state["window"] == 4
    with make_reader(synthetic_dataset.url, **{**kw, "resume_state": state}) as r:
        rest = _loader_batches(DataLoader(r, batch_size=GROUP, device="cpu"))
    assert len(full) == 20 and head + rest == full


def test_batched_loader_state_under_a_windowed_reader_resumes(scalar_dataset):
    """The plain batched buffer holds up to two batches, so its cursor stays
    at the last point where it was empty (as in the JAX package): the
    resume reads the rest of the stream from there, a suffix of it."""
    kw = _kw(4, seed=2, reader_pool_type="thread", workers_count=2)
    with make_batch_reader(scalar_dataset.url, **kw) as r:
        full = _loader_batches(BatchedDataLoader(r, batch_size=5, device="cpu"))
    with make_batch_reader(scalar_dataset.url, **kw) as r:
        loader = BatchedDataLoader(r, batch_size=5, device="cpu")
        head = _loader_batches(loader, 6)
        state = loader.state_dict()
    with make_batch_reader(scalar_dataset.url, **{**kw, "resume_state": state}) as r:
        rest = _loader_batches(BatchedDataLoader(r, batch_size=5, device="cpu"))
    assert head == full[:6]
    assert rest == full[len(full) - len(rest):] and len(rest) >= len(full) - 6
    assert state["window"] == 4 and state["offset"] % 4 == 0


def test_loader_with_a_shuffling_buffer_names_shuffle_window(synthetic_dataset):
    with make_reader(synthetic_dataset.url, **_kw(0, reader_pool_type="dummy")) as r:
        loader = DataLoader(r, batch_size=4, shuffling_queue_capacity=16, device="cpu")
        with pytest.raises(ValueError, match="shuffle_window"):
            loader.state_dict()


def test_loader_cut_inside_a_group_loses_no_row(synthetic_dataset):
    kw = _kw(4, seed=7, epochs=1, reader_pool_type="thread", workers_count=2)
    with make_reader(synthetic_dataset.url, **kw) as r:
        full = [i for b in _loader_batches(DataLoader(r, batch_size=4, device="cpu",
                                                      drop_last=False)) for i in b]
    with make_reader(synthetic_dataset.url, **kw) as r:
        loader = DataLoader(r, batch_size=4, device="cpu", drop_last=False)
        head = [i for b in _loader_batches(loader, 3) for i in b]
        state = loader.state_dict()
    with make_reader(synthetic_dataset.url, **{**kw, "resume_state": state}) as r:
        rest = [i for b in _loader_batches(DataLoader(r, batch_size=4, device="cpu",
                                                      drop_last=False)) for i in b]
    assert head == full[:12]
    # 12 rows read: the second group was read in part and is read again whole.
    assert rest == full[GROUP:]
    assert np.array_equal(np.sort(np.unique(head + rest)), np.sort(full))
