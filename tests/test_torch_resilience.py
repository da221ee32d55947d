"""The port's resilience plane (``petastorm_tpu_torch.resilience``) held to
the JAX package's (``petastorm_tpu.resilience``) on the CPU: the same
seeded inputs through both, compared exactly. Retry schedules and
classifier verdicts; fault plans over one script of accesses (which fire,
the latency jitter slept); the guard, the quarantine report and the crash
ledger over the same event scripts; the ring's pending records; then end
to end, ``make_reader`` and ``make_batch_reader`` on dummy and thread pools
under injected faults in free and deterministic order, against the JAX
reader on the same store and plan. Last, the port's process pool on a few
spawned workers: a killed worker under a crash budget, the budget's
refusals, and ventilation after a death. Deadlines, hedging, the watchdog
and registry events are in ``tests/test_torch_straggler.py``."""
import os
import pickle
import signal
import sqlite3
from types import SimpleNamespace

import pytest

import petastorm_tpu.resilience as jres
import petastorm_tpu.resilience.faults as jfaults
import petastorm_tpu_torch.resilience as tres
import petastorm_tpu_torch.resilience.faults as tfaults
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.telemetry import TelemetryRegistry
from resilience_parity import (both, fast_policy, process_read, read_stream, records,
                               same)


# --------------------------------------------------------------------- policy
@pytest.mark.parametrize("jitter", ["none", "full", "decorrelated"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_retry_schedules_equal_jax(jitter, seed):
    def schedule(r, _):
        p = r.RetryPolicy(max_attempts=8, jitter=jitter, seed=seed,
                          backoff=r.ExponentialBackoff(base=0.05, multiplier=2.0, cap=1.0))
        return p.schedule(), p.schedule(12), pickle.loads(pickle.dumps(p)).schedule()
    same(both(schedule))


def test_default_policy_and_backoff_values_equal_jax():
    same(both(lambda r, _: (r.DEFAULT_READ_POLICY.schedule(),
                             [r.ExponentialBackoff(0.1, 2.0, 0.5).value(n) for n in range(5)],
                             r.no_retry().max_attempts)))


@pytest.mark.parametrize("make", [
    lambda r: IOError("conn reset"), lambda r: OSError("timeout"),
    lambda r: r.InjectedIOError("x"), lambda r: FileNotFoundError("gone"),
    lambda r: PermissionError("denied"), lambda r: ValueError("corrupt"),
    lambda r: r.InjectedCorruptionError("x"), lambda r: KeyError("k"),
    lambda r: r.StageDeadlineExceeded("slow"),
    lambda r: sqlite3.OperationalError("database is locked")])
def test_classifier_verdicts_equal_jax(make):
    same(both(lambda r, _: (r.default_io_classifier(make(r)), r.failover_classifier(make(r)),
                             r.sqlite_classifier(make(r)))))


def test_call_retries_and_sleeps_equal_jax():
    """One failure script through ``RetryPolicy.call`` with an injected
    sleep: attempts, retry callbacks, the slept delays, the give-up and
    the raised error, for permanent, exhausted and recovering sites."""
    def run(r, _):
        out = []
        for script in (["io", "io", "ok"], ["io"] * 6, ["perm"], ["io", "perm"]):
            p = r.RetryPolicy(max_attempts=4, seed=3, jitter="decorrelated",
                              backoff=r.ExponentialBackoff(base=0.1, multiplier=2.0, cap=1.0))
            seen, slept, retries, giveups = [], [], [], []

            def site():
                step = script[min(len(seen), len(script) - 1)]
                seen.append(step)
                if step == "io":
                    raise IOError("transient")
                if step == "perm":
                    raise FileNotFoundError("gone")
                return "data"
            try:
                result = p.call(site, sleep=slept.append,
                                on_retry=lambda a, e, d: retries.append((a, type(e).__name__, d)),
                                on_give_up=lambda a, e: giveups.append(a))
            except Exception as e:  # noqa: BLE001 - the error is part of the result
                result = type(e).__name__
            out.append((result, len(seen), slept, retries, giveups))
        return out
    same(both(run))


# ----------------------------------------------------------------- fault plans
ACCESS_SCRIPT = [(site, key, worker)
                 for i in range(60)
                 for site, key, worker in [("rowgroup.read", f"/d/part-{i % 5}.parquet", i % 3),
                                           ("worker.item", f"/d/part-{i % 5}.parquet", i % 2)]]


def _fire_script(r, specs, seed, script=ACCESS_SCRIPT):
    """Which accesses fire (index, exception type), what the latency
    faults slept, and the plan's stats, sleeping through an injected
    ``time.sleep``."""
    plan = r.FaultPlan(specs(r), seed=seed)
    faults_module = jfaults if r is jres else tfaults
    slept = []
    real = faults_module.time.sleep
    faults_module.time.sleep = slept.append
    fired = []
    try:
        for i, (site, key, worker) in enumerate(script):
            try:
                plan.fire(site, key=key, worker_id=worker)
            except Exception as e:  # noqa: BLE001 - the firing is the result
                fired.append((i, type(e).__name__))
    finally:
        faults_module.time.sleep = real
    return fired, slept, plan.stats()


PLANS = {
    "at": lambda r: [r.FaultSpec(site="rowgroup.read", at=7)],
    "rate": lambda r: [r.FaultSpec(site="rowgroup.read", rate=0.3)],
    "rate_times_key": lambda r: [r.FaultSpec(site="rowgroup.read", rate=0.5, times=4,
                                             key_substring="part-2")],
    "worker_pinned": lambda r: [r.FaultSpec(site="worker.item", kind="corruption", at=3,
                                            worker=1),
                                r.FaultSpec(site="rowgroup.read", rate=0.2, worker=2)],
    "latency_jitter": lambda r: [r.FaultSpec(site="rowgroup.read", kind="latency", rate=0.4,
                                             latency_s=0.01, latency_jitter_s=0.2),
                                 r.FaultSpec(site="worker.item", kind="latency", at=5,
                                             latency_s=0.03)],
    "mixed": lambda r: [r.FaultSpec(site="rowgroup.read", kind="corruption", rate=0.05),
                        r.FaultSpec(site="rowgroup.read", kind="ioerror", rate=0.25),
                        r.FaultSpec(site="rowgroup.read", kind="latency", rate=0.5,
                                    latency_s=0.0, latency_jitter_s=0.1)],
}


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_firings_and_jitter_equal_jax(name, seed):
    result = same(both(lambda r, _: _fire_script(r, PLANS[name], seed)))
    assert result[0] or result[1]   # the script exercises the plan


def test_fault_plan_pickle_resets_counters_as_jax():
    def run(r, _):
        plan = r.FaultPlan([r.FaultSpec(site="s", at=2), r.FaultSpec(site="s", rate=0.5)], seed=5)
        for _ in range(3):
            try:
                plan.fire("s")
            except IOError:
                pass
        clone = pickle.loads(pickle.dumps(plan))
        return clone.seed, clone.stats(), _fire_script(r, lambda _r: clone.specs, clone.seed,
                                                       [("s", "", 0)] * 10)
    same(both(run))


def test_fault_spec_validation_and_kill_refusal_equal_jax():
    def run(r, _):
        errors = []
        for kw in (dict(kind="nope", at=1), dict(), dict(at=1, rate=0.5), dict(at=0),
                   dict(rate=1.5), dict(kind="latency", at=1, latency_jitter_s=-0.1)):
            try:
                r.FaultSpec(site="s", **kw)
            except ValueError as e:
                errors.append(str(e))
        try:
            r.FaultPlan([r.FaultSpec(site="s", kind="worker_kill", at=1)]).fire("s")
        except RuntimeError as e:
            errors.append(str(e))
        return errors, r.in_spawned_worker()
    assert same(both(run))[1] is False


# --------------------------------------------------------- guard and quarantine
def _rowgroup(path="/d/part-0.parquet", rg=3):
    return SimpleNamespace(path=path, row_group=rg)


GUARD_SCRIPTS = [["io", "ok"], ["io", "io", "io", "io"], ["corrupt"], ["inj_io"] * 4,
                 ["inj_corrupt"], ["io", "inj_corrupt"], ["ok"]]


@pytest.mark.parametrize("degraded", [False, True])
def test_guard_and_quarantine_report_equal_jax(degraded):
    def run(r, registry_class):
        registry = registry_class()
        quarantine = r.RowGroupQuarantine(telemetry=registry)
        out = []
        for n, script in enumerate(GUARD_SCRIPTS):
            guard = r.RowGroupGuard(policy=fast_policy(r), degraded_mode=degraded, worker_id=n % 2,
                                    telemetry=registry)
            calls, evictions = [], []

            def build():
                step = script[min(len(calls), len(script) - 1)]
                calls.append(step)
                raise {"io": IOError("transient"), "corrupt": ValueError("corrupt bytes"),
                       "inj_io": r.InjectedIOError("injected io"),
                       "inj_corrupt": r.InjectedCorruptionError("injected corruption"),
                       }[step] if step != "ok" else None
            try:
                result = guard.run(lambda: build() or f"data{n}", _rowgroup(rg=n),
                                   on_retry=lambda a, e, d: evictions.append(a))
            except r.RowGroupSkipped as skip:
                quarantine.add(skip.record)
                result = "skipped"
            except Exception as e:  # noqa: BLE001 - the error is part of the result
                result = type(e).__name__
            out.append((result, len(calls), evictions))
        counters = registry.snapshot()["counters"]
        return out, counters, records(quarantine.report()), quarantine.paths(), len(quarantine)
    result = same(both(run))
    assert result[1]["resilience.retries_total"] > 0
    assert (result[4] > 0) == degraded


def test_quarantine_record_and_mark_admitted_equal_jax():
    def run(r, _):
        q = r.RowGroupQuarantine()
        q.add(r.QuarantineRecord(path="/d/a", row_group=(1, 2), error_type="E", error_message="m",
                                 attempts=2, state="pending_retry"))
        rec = pickle.loads(pickle.dumps(q.records[0]))
        return q.mark_admitted("/d/a"), records(q.report()), rec.piece
    same(both(run))


# ---------------------------------------------------------------- crash ledger
RECOVERY_SCRIPTS = {
    "claimed_item_returned": [("vent", (0, 0), "a"), ("vent", (0, 1), "b"), ("start", 0, (0, 0)),
                              ("start", 1, (0, 1)), ("done", (0, 1)), ("death", 0),
                              ("claimed",), ("dead",)],
    "double_death": [("death", 0), ("death", 0), ("crashes",)],
    "budget_exceeded": [("vent", (0, 0), "a"), ("start", 1, (0, 0)), ("death", 0),
                        ("death", 1), ("dead",)],
    "untracked": [("vent", None, "bare"), ("start", 0, None), ("done", None), ("death", 0)],
}


@pytest.mark.parametrize("name", sorted(RECOVERY_SCRIPTS))
def test_crash_recovery_scripts_equal_jax(name):
    def run(r, registry_class):
        registry = registry_class()
        ledger = r.WorkerCrashRecovery(budget=1, telemetry=registry)
        out = []
        for step in RECOVERY_SCRIPTS[name]:
            op = step[0]
            try:
                if op == "vent":
                    ledger.on_ventilated(step[1], ((step[2],), {}))
                elif op == "start":
                    ledger.on_started(step[1], step[2])
                elif op == "done":
                    ledger.on_processed(step[1])
                elif op == "death":
                    out.append(ledger.on_worker_death(step[1], -9))
                elif op == "claimed":
                    out.append(sorted(ledger.claimed_workers()))
                elif op == "dead":
                    out.append(sorted(ledger.dead_workers))
                else:
                    out.append(ledger.crashes)
            except r.CrashBudgetExceededError as e:
                out.append(("raised", str(e)))
        return out, registry.snapshot()["counters"]
    same(both(run))


def test_port_ledger_returns_queued_contexts_of_a_pipe_owner():
    """The port's pool sends each item down one worker's pipe: on a death it
    hands the ledger the contexts queued behind the claimed one, which come
    back too, counted, and only once."""
    registry = TelemetryRegistry()
    ledger = tres.WorkerCrashRecovery(budget=1, telemetry=registry)
    for pos in range(4):
        ledger.on_ventilated((0, pos), ((pos,), {}))
    ledger.on_started(0, (0, 0))
    ledger.on_started(1, (0, 3))
    lost = ledger.on_worker_death(0, -9, queued=((0, 0), (0, 1), (0, 2)))
    assert lost == [((0,), {}), ((1,), {}), ((2,), {})]
    assert ledger.claimed_workers() == {1}
    assert registry.snapshot()["counters"]["resilience.reventilated_items"] == 3


# --------------------------------------------------------------- shm ring
def test_ring_reader_has_pending():
    """A dead producer's unread records are seen by ``has_pending`` until
    the consumer has read them, and the ring's space comes back once the
    first record, still viewed, is released: what the pool's crash path
    waits on before it reclaims the ring."""
    import gc
    from petastorm_tpu_torch.native import make_ring
    from petastorm_tpu_torch.reader_impl.shm_ring import RingReader, SegmentClaim
    ring = make_ring(f"/pt_test_pending_{os.getpid()}", capacity=1 << 16, create=True, impl="py")
    reader = RingReader(ring)
    try:
        assert not reader.has_pending()
        for i in range(5):
            ring.write_tagged(ord("D"), bytes([i]) * 3000)
        kind, view = reader.try_read()
        assert kind == ord("D") and bytes(view[:1]) == b"\x00"
        claim = SegmentClaim()
        claim.track(view)
        reader.claim(claim)
        for i in range(1, 5):
            assert reader.has_pending()
            kind, rest = reader.try_read()
            assert bytes(rest[:1]) == bytes([i])
            rest.release()
            reader.complete()
        assert not reader.has_pending() and reader.try_read() is None
        reader.reap()
        assert ring.tail() < ring.head()     # the viewed record pins the span
        view.release()
        del view
        gc.collect()
        reader.reap()
        assert ring.tail() == ring.head()    # then everything comes back
    finally:
        reader.close()
        ring.close()


# ------------------------------------------------------------------ end to end
STORES = {"row": (jax_make_reader, make_reader), "batch": (jax_make_batch_reader,
                                                          make_batch_reader)}


@pytest.fixture(params=sorted(STORES))
def store(request, synthetic_dataset, scalar_dataset):
    url = synthetic_dataset.url if request.param == "row" else scalar_dataset.url
    return request.param, url


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_transient_faults_lossless_with_jax_retries(store, pool):
    kind, url = store
    # Access counts are per plan, shared by a thread pool's workers: a spec
    # with at=N is pinned to one worker, and first, so which accesses fire
    # does not depend on the threads' timing.
    plan = lambda r: r.FaultPlan([r.FaultSpec(site="rowgroup.read", kind="ioerror", at=2,
                                              worker=0),
                                  r.FaultSpec(site="rowgroup.read", kind="ioerror", rate=0.3)],
                                 seed=1)
    kwargs = dict(reader_pool_type=pool, workers_count=3, shuffle_row_groups=True, seed=5)
    clean = read_stream(STORES[kind][1], tres, url, kind == "batch", **kwargs)
    jax_run, port_run = [read_stream(factory, r, url, kind == "batch", fault_plan=plan(r), **kwargs)
                         for factory, r in zip(STORES[kind], (jres, tres))]
    assert port_run[0] == jax_run[0]
    assert sorted(port_run[0]) == sorted(clean[0]) and len(set(port_run[0])) == 100
    assert port_run[2] == jax_run[2]
    assert port_run[2]["resilience.retries_total"] > 0
    assert port_run[2]["resilience.giveups_total"] == 0


@pytest.mark.parametrize("order", ["free", "deterministic"])
@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_corrupt_row_group_quarantined_as_jax(store, pool, order):
    """A corruption pinned to one row group (the third read of one worker)
    under ``degraded_mode``: the same group quarantined, the same other
    rows in the same order, and in deterministic order the same cursors
    with the skip recorded."""
    kind, url = store
    worker = 0 if pool == "dummy" else 1
    plan = lambda r: r.FaultPlan([
        r.FaultSpec(site="rowgroup.read", kind="corruption", at=3, worker=worker),
        r.FaultSpec(site="rowgroup.read", kind="ioerror", rate=0.3)], seed=2)
    kwargs = dict(reader_pool_type=pool, workers_count=3, shuffle_row_groups=True, seed=5,
                  sample_order=order, degraded_mode=True)
    jax_run, port_run = [read_stream(factory, r, url, kind == "batch", fault_plan=plan(r), **kwargs)
                         for factory, r in zip(STORES[kind], (jres, tres))]
    assert port_run[0] == jax_run[0]
    assert len(port_run[0]) == len(set(port_run[0])) == 90
    assert port_run[2] == jax_run[2] and port_run[2]["resilience.quarantined_rowgroups"] == 1
    assert port_run[3] == jax_run[3]
    assert [(p["path"], p["row_group"], p["error_type"]) for p in port_run[3]["pieces"]] == \
        [(p["path"], p["row_group"], p["error_type"]) for p in jax_run[3]["pieces"]]
    if order == "deterministic":
        assert port_run[1] == jax_run[1]
        assert port_run[4] == jax_run[4] == 1


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_corruption_without_degraded_mode_raises_as_jax(store, pool):
    kind, url = store
    raised = []
    for factory, r in zip(STORES[kind], (jres, tres)):
        plan = r.FaultPlan([r.FaultSpec(site="rowgroup.read", kind="corruption", at=2)])
        with pytest.raises(r.InjectedCorruptionError):
            read_stream(factory, r, url, kind == "batch", fault_plan=plan, reader_pool_type=pool,
                  workers_count=2, shuffle_row_groups=False)
        # How far the other workers read before the stop is timing.
        raised.append([spec["fired"] for spec in plan.stats()["specs"]])
    assert raised[0] == raised[1] == [1]


def test_reader_argument_checks_as_jax(synthetic_dataset):
    for factory, r in ((jax_make_reader, jres), (make_reader, tres)):
        with pytest.raises(TypeError, match="HedgePolicy"):
            factory(synthetic_dataset.url, hedge_policy=object())
        with pytest.raises(ValueError, match="hang_timeout_s"):
            factory(synthetic_dataset.url, hang_timeout_s=-1)
        with pytest.warns(UserWarning, match="worker_crash_budget"):
            with factory(synthetic_dataset.url, reader_pool_type="thread", worker_crash_budget=1,
                         shuffle_row_groups=False) as reader:
                next(reader)
        with factory(synthetic_dataset.url, reader_pool_type="dummy",
                     shuffle_row_groups=False) as reader:
            next(reader)
            assert reader.watchdog is None and reader.watchdog_report() == {}
            assert reader.quarantine_report() == {"quarantined": 0, "by_error_type": {},
                                                  "by_state": {}, "pieces": []}


def test_process_reader_refuses_a_policy_that_does_not_pickle(synthetic_dataset):
    """A policy's classifier must reach a spawned worker: a lambda is
    refused at construction, before any process starts."""
    policy = tres.RetryPolicy(classify=lambda e: tres.TRANSIENT)
    with pytest.raises(ValueError, match="retry_policy"):
        make_reader(synthetic_dataset.url, reader_pool_type="process", retry_policy=policy)


def test_in_process_readers_share_one_cancel_token_and_processes_none(synthetic_dataset):
    """One token for the in-process workers; none crosses to a spawned
    worker. Read from the arguments the pool would start the workers with."""
    from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    from petastorm_tpu_torch.reader import Reader
    seen = {}
    for pool in (DummyPool(), ProcessPool(1)):
        reader = Reader.__new__(Reader)
        reader.telemetry = TelemetryRegistry()
        seen[type(pool).__name__] = reader._attach_resilience(pool, 0, 2.0, None, 5.0)
    assert isinstance(seen["DummyPool"]["cancel_token"], tres.CancellationToken)
    assert seen["ProcessPool"]["cancel_token"] is None
    assert seen["DummyPool"]["stage_deadline"] == tres.StageDeadline(soft_s=1.0, hard_s=2.0)


# ------------------------------------------------------------- process pool
def test_killed_process_worker_costs_no_row_under_a_budget(synthetic_dataset):
    ids, counters, _ = process_read(
        synthetic_dataset.url,
        [tres.FaultSpec(site="worker.item", kind="worker_kill", at=2, worker=1)], budget=1)
    assert ids == list(range(100))           # every row, exactly once
    assert counters["resilience.worker_crashes"] == 1
    assert counters["resilience.reventilated_items"] >= 1
    assert counters["transport.rings_reclaimed"] == 1


@pytest.mark.parametrize("budget, kills, error", [
    (0, 1, RuntimeError), (1, 2, tres.CrashBudgetExceededError)], ids=["budget0", "two_kills"])
def test_process_crash_budget_refusals(synthetic_dataset, budget, kills, error):
    specs = [tres.FaultSpec(site="worker.item", kind="worker_kill", at=2, worker=w)
             for w in range(kills)]
    with pytest.raises(error, match="died unexpectedly" if budget == 0 else "exceed"):
        process_read(synthetic_dataset.url, specs, budget)


def test_ventilate_after_a_kill_routes_around_the_dead_worker():
    """Items sent to a worker that died unseen are re-sent once its death
    is handled, and later items go to the survivor only."""
    from petastorm_tpu_torch.test_util.stub_workers import ContextIdentityWorker
    from petastorm_tpu_torch.workers_pool import EmptyResultError, ITEM_CONTEXT_KWARG
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    registry = TelemetryRegistry()
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.telemetry = registry
    pool.recovery = tres.WorkerCrashRecovery(budget=1, telemetry=registry)
    pool.start(ContextIdentityWorker)
    try:
        os.kill(pool.worker_pids[0], signal.SIGKILL)
        pool._processes[0].wait(timeout=10)
        for pos in range(6):                 # some go down the dead worker's pipe
            pool.ventilate(value=pos, **{ITEM_CONTEXT_KWARG: (0, pos)})
        got = []
        while True:
            try:
                got.append(pool.get_results())
            except EmptyResultError:
                break
        assert sorted(got) == list(range(6))
        assert pool.recovery.dead_workers == {0}
        for pos in range(6, 9):              # after the death: the survivor only
            pool.ventilate(value=pos, **{ITEM_CONTEXT_KWARG: (0, pos)})
        assert pool._inflight == [0, 3]
        assert sorted(pool.get_results() for _ in range(3)) == [6, 7, 8]
        counters = registry.snapshot()["counters"]
        assert counters["resilience.worker_crashes"] == 1
        assert counters["transport.rings_reclaimed"] == 1
    finally:
        pool.stop()
        pool.join()


def test_last_worker_death_stops_the_pool_under_a_budget_as_large_as_the_pool():
    """With every worker dead and budget to spare, the consumer is told
    that none is left, and the pool is stopped; a later ``ventilate`` is
    dropped, not raised on the ventilator's thread."""
    from petastorm_tpu_torch.test_util.stub_workers import ContextIdentityWorker
    from petastorm_tpu_torch.workers_pool import ITEM_CONTEXT_KWARG
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    registry = TelemetryRegistry()
    pool = ProcessPool(2, ring_capacity=1 << 20)
    pool.telemetry = registry
    pool.recovery = tres.WorkerCrashRecovery(budget=2, telemetry=registry)
    pool.start(ContextIdentityWorker)
    try:
        for pid, process in zip(pool.worker_pids, pool._processes):
            os.kill(pid, signal.SIGKILL)
            process.wait(timeout=10)
        for pos in range(4):
            pool.ventilate(value=pos, **{ITEM_CONTEXT_KWARG: (0, pos)})
        with pytest.raises(RuntimeError, match="All 2 worker processes died"):
            pool.get_results()
        assert pool._stopped and pool.recovery.dead_workers == {0, 1}
        assert registry.snapshot()["counters"]["resilience.worker_crashes"] == 2
        pool.ventilate(value=4, **{ITEM_CONTEXT_KWARG: (0, 4)})
    finally:
        pool.stop()
        pool.join()


@pytest.mark.parametrize("with_quarantine", [True, False], ids=["quarantine", "log"])
@pytest.mark.parametrize("pool_name", ["dummy", "thread", "process"])
def test_every_pool_routes_a_skip_record_alike(pool_name, with_quarantine, caplog):
    """A worker's skip record goes into the reader's quarantine, or to the
    log when none is attached, on each pool; other results pass."""
    from petastorm_tpu_torch.workers_pool import route_skip
    from petastorm_tpu_torch.workers_pool.dummy_pool import DummyPool
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    from petastorm_tpu_torch.workers_pool.thread_pool import ThreadPool
    pool = {"dummy": DummyPool, "thread": lambda: ThreadPool(2),
            "process": lambda: ProcessPool(2)}[pool_name]()
    if with_quarantine:
        pool.quarantine = tres.RowGroupQuarantine()
    record = tres.QuarantineRecord(path="/d/part-0.parquet", row_group=3, error_type="E",
                                   error_message="m", attempts=2, worker_id=1)
    with caplog.at_level("WARNING", logger="petastorm_tpu_torch.workers_pool"):
        assert route_skip(pool, tres.RowGroupSkippedMessage(record))
        assert not route_skip(pool, {"id": 7})
    if with_quarantine:
        assert pool.quarantine.paths() == ["/d/part-0.parquet"] and not caplog.records
    else:
        assert [r.getMessage() for r in caplog.records] == [
            "Row group quarantined with no aggregator attached: /d/part-0.parquet#3"]
