"""Placement migration of petastorm_tpu_torch against the JAX package: the
decode stage moved thread -> process -> thread mid-epoch on the row and
batch readers, free and deterministic, with every id delivered once, the
JAX reader's multiset under the same migrations, and in deterministic mode
the unmigrated order; the gauges and ``diagnostics()`` across the swap, a
drain that times out, a failed start, the picklability condition, and the
warm start from a persisted plan."""
import warnings

import numpy as np
import pytest

import petastorm_tpu.predicates as jp
import petastorm_tpu_torch.predicates as tp
import petastorm_tpu_torch.reader as reader_module
from petastorm_tpu.autotune import AutotuneConfig as JaxAutotuneConfig
from petastorm_tpu.plan import PlanCache as JaxPlanCache
from petastorm_tpu.plan import PlanKey as JaxPlanKey
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.autotune import AutotuneConfig
from petastorm_tpu_torch.plan import PlanCache, record_trial_outcome
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool

pytestmark = pytest.mark.zerocopy


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    d = str(tmp_path / "plans")
    monkeypatch.setenv("PETASTORM_TPU_PLAN_CACHE", d)
    return d


def _ids_of(item, batched):
    return [int(i) for i in np.atleast_1d(item.id)] if batched else [int(item.id)]


def _migrating_epoch(factory, url, batched, migrate_at=(2, 5), **kw):
    """Every id of one epoch, pulling with a thread -> process migration
    after unit ``migrate_at[0]`` and back after ``migrate_at[1]``; and
    each unit's pool class and ``diagnostics()`` tallies."""
    ids, trail = [], []
    with factory(url, **kw) as r:
        for n, item in enumerate(r, start=1):
            ids += _ids_of(item, batched)
            d = r.diagnostics
            trail.append((type(r._pool).__name__, d["items_ventilated"], d["items_processed"],
                          d["pool_type"], r.telemetry.snapshot()["gauges"].get("pool.backend")))
            if n == migrate_at[0]:
                r._request_pool_migration("process")
            elif n == migrate_at[1]:
                r._request_pool_migration("thread")
        migrations = r.telemetry.snapshot()["counters"].get("autotune.placement_migrations")
    return ids, trail, migrations


CASES = {
    "row free": (False, dict(shuffle_row_groups=True, seed=3, schema_fields=["id", "id2"]),
                 (30, 70)),
    "row deterministic": (False, dict(shuffle_row_groups=True, seed=3, schema_fields=["id"],
                                      sample_order="deterministic"), (30, 70)),
    "batch free": (True, dict(shuffle_row_groups=True, seed=4), (2, 6)),
    "batch deterministic": (True, dict(shuffle_row_groups=True, seed=4,
                                       sample_order="deterministic", shuffle_window=2), (2, 6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_migration_delivers_every_id_once_as_the_jax_reader(synthetic_dataset, scalar_dataset,
                                                             case):
    batched, kw, at = CASES[case]
    url = scalar_dataset.url if batched else synthetic_dataset.url
    kw = dict(reader_pool_type="thread", workers_count=2, **kw)
    port_factory = make_batch_reader if batched else make_reader
    jax_factory = jax_make_batch_reader if batched else jax_make_reader
    ids, trail, migrations = _migrating_epoch(port_factory, url, batched, at, **kw)
    jax_ids, _, jax_migrations = _migrating_epoch(jax_factory, url, batched, at, **kw)
    assert sorted(ids) == list(range(100)) and migrations == jax_migrations == 2
    assert sorted(ids) == sorted(jax_ids)
    # The live pool, its gauge and diagnostics' pool_type move together, and
    # the tallies never go back.
    pools = [t[0] for t in trail]
    assert pools[at[0]] == "ProcessPool" and pools[at[1]] == "ThreadPool"
    assert pools[0] == "ThreadPool" and "ProcessPool" in pools
    for name, _, _, pool_type, backend in trail:
        assert pool_type == ("process" if name == "ProcessPool" else "thread")
        assert backend == (1.0 if name == "ProcessPool" else 0.0)
    for a, b in zip(trail, trail[1:]):
        assert b[1] >= a[1] and b[2] >= a[2]
    if kw.get("sample_order") == "deterministic":
        with port_factory(url, **kw) as r:
            plain = [i for item in r for i in _ids_of(item, batched)]
        assert ids == plain == jax_ids


def test_a_drain_that_times_out_leaves_the_old_pool_live(synthetic_dataset, monkeypatch):
    monkeypatch.setattr(reader_module, "_MIGRATION_DRAIN_TIMEOUT_S", -1.0)
    ids = []
    with make_reader(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                     schema_fields=["id"], seed=1) as r:
        with pytest.warns(UserWarning, match="did not drain"):
            for n, row in enumerate(r):
                ids.append(int(row.id))
                if n == 15:
                    r._request_pool_migration("process")
        assert isinstance(r.pool, ThreadPool)
        assert r.telemetry.snapshot()["counters"].get("autotune.placement_migrations") is None
    assert sorted(ids) == list(range(100))


def test_a_failed_start_raises_at_every_later_pull(synthetic_dataset):
    ids = []
    with make_reader(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                     schema_fields=["id"], shuffle_row_groups=False) as r:
        def broken(target):
            raise OSError(f"cannot start a {target} pool")
        r._pool_factory = broken
        for _ in range(15):
            ids.append(int(next(r).id))
        r._request_pool_migration("process")
        with pytest.raises(OSError, match="cannot start"):
            next(r)
        # The results drained from the stopped pool are still delivered,
        # then every pull raises the error (never a clean end of data).
        with pytest.raises(OSError, match="cannot start"):
            while True:
                ids.append(int(next(r).id))
        for _ in range(2):
            with pytest.raises(OSError, match="cannot start"):
                next(r)
    assert ids == sorted(ids) and 15 < len(ids) < 100


def test_placement_needs_what_a_spawned_worker_can_unpickle(synthetic_dataset):
    """A thread reader whose predicate does not pickle warns and tunes no
    placement (the port pickles where the JAX package has dill)."""
    cfg = AutotuneConfig(placement=True, interval_s=60)
    with pytest.warns(UserWarning, match="placement=True ignored"):
        r = make_reader(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                        autotune=True, autotune_config=cfg,
                        predicate=tp.in_lambda(["id"], lambda v: v["id"] % 2 == 0))
    with r:
        assert r.autotune.actuator("placement") is None
        assert sorted(int(x.id) for x in r) == list(range(0, 100, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with make_reader(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                         autotune=True, autotune_config=cfg,
                         predicate=tp.in_range("id", 0, 50)) as r:
            assert r.autotune.actuator("placement") is not None
            assert sorted(int(x.id) for x in r) == list(range(50))


def test_the_placement_actuator_migrates_as_in_jax(synthetic_dataset):
    """The actuator's request runs the migration at the next pull and is
    marked applied, in both packages."""
    out = []
    for factory, config in ((make_reader, AutotuneConfig), (jax_make_reader, JaxAutotuneConfig)):
        with factory(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                     autotune=True, autotune_config=config(placement=True, interval_s=60),
                     schema_fields=["id"], seed=2) as r:
            act = r.autotune.actuator("placement")
            ids = [int(next(r).id) for _ in range(20)]
            act.set(1)
            assert not act.applied
            ids += [int(x.id) for x in r]
            out.append((sorted(ids), act.applied, act.backend, r.diagnostics["pool_type"],
                        r.plan_report()["cache"]))
    assert out[0] == out[1] == (list(range(100)), True, "process", "process", "miss")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_warm_start_builds_the_persisted_backend(synthetic_dataset, _plan_cache, writer):
    """A verdict persisted by either package: the port's reader starts on
    the recorded backend, pins the placement knob, seeds the actuators and
    reports ``source="persisted"``."""
    cfg = AutotuneConfig(placement=True, interval_s=60)
    kw = dict(reader_pool_type="thread", workers_count=2, schema_fields=["id"], seed=3,
              autotune=True, autotune_config=cfg)
    with make_reader(synthetic_dataset.url, **kw) as r:
        plan = r._plan
        assert plan.cache == "miss" and plan.source == "default"
        sum(1 for _ in r)
    outcome = {"verdict": "kept", "backend": "process", "baseline": 10.0, "trial": 12.0}
    if writer == "port":
        assert record_trial_outcome(plan, outcome, actuators={"ventilate_ahead": 5})
    else:
        key = JaxPlanKey(**plan.key.to_dict())
        assert JaxPlanCache(_plan_cache).store(key, {"backend": "process", "trial": outcome,
                                                     "actuators": {"ventilate_ahead": 5},
                                                     "profile": None})
    with make_reader(synthetic_dataset.url, **kw) as r:
        report = r.plan_report()
        assert isinstance(r.pool, ProcessPool)
        assert report["source"] == "persisted" and report["cache"] == "hit"
        assert report["placement"] == {"decode": "process"} and report["trial"] == outcome
        assert r.autotune.actuator("placement") is None
        assert r.autotune.placement_outcome["verdict"] == "persisted"
        assert r.autotune.actuator("ventilate_ahead").value == 5
        assert sorted(int(x.id) for x in r) == list(range(100))
    assert PlanCache(_plan_cache).load(plan.key)["backend"] == "process"


def test_a_resolved_trial_persists_for_the_next_reader(synthetic_dataset, _plan_cache):
    cfg = AutotuneConfig(placement=True, interval_s=60)
    with make_reader(synthetic_dataset.url, reader_pool_type="thread", workers_count=2,
                     autotune=True, autotune_config=cfg) as r:
        r._on_placement_resolved({"verdict": "failed", "backend": "thread"})
        assert r.plan_report()["trial"]["verdict"] == "failed"
        assert PlanCache(_plan_cache).load(r._plan.key) is None
        r._on_placement_resolved({"verdict": "reverted", "backend": "thread"})
        sum(1 for _ in r)
    record = PlanCache(_plan_cache).load(r._plan.key)
    assert record["backend"] == "thread" and record["profile"] is None
    assert r.plan_report()["source"] == "trial"
    with make_reader(synthetic_dataset.url, reader_pool_type="process", workers_count=2,
                     autotune=True, autotune_config=cfg) as warm:
        assert isinstance(warm.pool, ThreadPool)
        assert warm.plan_report()["source"] == "persisted"
        assert sum(1 for _ in warm) == 100


def test_a_batch_reader_migrated_to_processes_views_the_ring(scalar_dataset):
    """On processes the batch reader's columns view the ring again (the
    new pool gets the reader's result transform), and a batch kept across
    the swap back to threads still reads its values."""
    kept = []
    with make_batch_reader(scalar_dataset.url, reader_pool_type="thread", workers_count=1,
                           shuffle_row_groups=False, predicate=tp.in_range("id", 0, 100)) as r:
        for n, batch in enumerate(r, start=1):
            kept.append((batch.id, batch.id.copy()))
            if n == 1:
                r._request_pool_migration("process")
            if n == 8:
                assert r.counters.get("zero_copy_batches", 0) >= 1
                r._request_pool_migration("thread")
        assert isinstance(r.pool, ThreadPool)
    assert all(np.array_equal(a, b) for a, b in kept)
    assert sorted(int(i) for a, _ in kept for i in a) == list(range(100))


def test_jax_predicates_and_the_port_agree_on_what_migrates(synthetic_dataset):
    """A range predicate pickles in both packages; the JAX reader has dill,
    so only the port needs the check."""
    import pickle
    pickle.dumps(tp.in_range("id", 0, 5))
    pickle.dumps(jp.in_range("id", 0, 5))
    assert reader_module._spawnable(tp.in_range("id", 0, 5))
    assert not reader_module._spawnable(tp.in_lambda(["id"], lambda v: True))
