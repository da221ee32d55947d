"""The port's straggler and hang defences held to the JAX package's on the
CPU, exactly: stage deadlines, cancellation tokens and the straggler
monitor; hedged reads; registry events and thread-stack dumps; the
pipeline watchdog's ladder over a fake pool (the deterministic cases of
the JAX package's ``tests/test_straggler.py``); then end to end, soft and
hard budgets and hedged reads against the JAX reader's rows, a wedged
thread reader aborted, and a hung process worker killed by the watchdog
with the epoch completing."""
import pickle
import threading
import time
from types import SimpleNamespace

import pytest

import petastorm_tpu_torch.resilience as tres
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.reader import make_reader
from resilience_parity import PACKAGES, both, process_read, read_stream, same


# ------------------------------------------------------------------- deadlines
def test_stage_deadline_shapes_and_errors_equal_jax():
    def run(r, _):
        errors = []
        for kw in (dict(soft_s=-1), dict(soft_s=2.0, hard_s=1.0), dict()):
            try:
                r.StageDeadline(**kw)
            except ValueError as e:
                errors.append(str(e))
        d = r.StageDeadline.from_arg(1.0)
        explicit = r.StageDeadline(soft_s=0.1, hard_s=3.0)
        return (errors, r.StageDeadline.from_arg(None), (d.soft_s, d.hard_s),
                r.StageDeadline.from_arg(explicit) is explicit,
                pickle.loads(pickle.dumps(explicit)) == explicit)
    same(both(run))


def test_deadline_timers_and_cancel_token_equal_jax():
    """Edge-triggered cancellation, a cancellation-only timer, a hard
    overrun past an injected clock."""
    def run(r, _):
        out = []
        token = r.CancellationToken()
        timer = r.StageDeadline(hard_s=60.0).start(token)
        timer.check()
        token.request("test hang")
        for t in (timer, r.StageDeadline(hard_s=60.0).start(token), r.DeadlineTimer(None, token)):
            try:
                t.check()
                out.append("ok")
            except r.StageDeadlineExceeded as e:
                out.append(str(e).split(" after ")[0])
        out.append((token.requested, token.reason, token.generation))
        token.clear()
        out.append((token.requested, token.generation))
        late = r.StageDeadline(soft_s=0.5, hard_s=1.0).start()
        late._t0 -= 2.0   # two seconds in
        out.append(late.soft_exceeded)
        try:
            late.finish()
        except r.StageDeadlineExceeded as e:
            out.append(str(e).split(":")[0])
        return out
    same(both(run))


@pytest.mark.parametrize("scope", ["attempt", "item"])
def test_straggler_monitor_equal_jax(scope):
    def run(r, registry_class):
        reg = registry_class()
        mon = r.StragglerMonitor(r.StageDeadline(soft_s=0.01), telemetry=reg, scope=scope,
                                 site="worker.attempt")
        verdicts = [mon.observe(0.005), mon.observe(0.03, key="/d/p.parquet", worker_id=2),
                    mon.observe(0.25, key="x" * 300)]
        snap = reg.snapshot()
        events = [(e["seq"], e["payload"]) for e in snap["events"]["resilience.straggler"]]
        return (verdicts, mon.local_count, snap["counters"],
                snap["histograms"]["resilience.straggler_overrun_s"]["count"], events)
    same(both(run))


# --------------------------------------------------------------------- hedging
def _hedge_policy(r, delay_s=0.02, **kw):
    kw.setdefault("min_samples", 10 ** 9)
    return r.HedgePolicy(fallback_delay_s=delay_s, min_delay_s=0.001, **kw)


HEDGE_CASES = {
    "fast_primary": (dict(), lambda c: "primary", lambda c: "hedge"),
    "slow_primary_loses": (dict(), lambda c: (time.sleep(0.3), "slow")[1], lambda c: "fast"),
    "primary_still_wins": (dict(delay_s=0.01), lambda c: (time.sleep(0.05), "primary")[1],
                           lambda c: (time.sleep(3), "hedge")[1]),
    "fast_failure": (dict(), lambda c: (_ for _ in ()).throw(IOError("boom")), lambda c: "never"),
    "slow_failure_defers": (dict(delay_s=0.01),
                            lambda c: (time.sleep(0.1), (_ for _ in ()).throw(IOError("late"))),
                            lambda c: "hedge"),
    "no_spare_slot": (dict(delay_s=0.01, max_concurrent=0),
                      lambda c: (time.sleep(0.05), "primary")[1], lambda c: "hedge"),
}


@pytest.mark.parametrize("name", sorted(HEDGE_CASES))
def test_hedged_reads_equal_jax(name):
    kw, primary, hedge = HEDGE_CASES[name]

    def run(r, registry_class):
        reg = registry_class()
        ex = r.HedgedReadExecutor(_hedge_policy(r, **kw), telemetry=reg)
        try:
            out = ex.read(primary, hedge)
        except IOError as e:
            out = str(e)
        snap = reg.snapshot()
        return (out, ex.local_stats, snap["counters"],
                snap["histograms"]["resilience.read_latency_s"]["count"])
    same(both(run))


def test_hedge_policy_validation_and_delay_clamp_equal_jax():
    def run(r, registry_class):
        errors = []
        for kw in (dict(quantile=1.5), dict(fallback_delay_s=0),
                   dict(min_delay_s=2.0, max_delay_s=1.0), dict(max_concurrent=-1),
                   dict(min_samples=0)):
            try:
                r.HedgePolicy(**kw)
            except ValueError as e:
                errors.append(str(e))
        reg = registry_class()
        ex = r.HedgedReadExecutor(r.HedgePolicy(fallback_delay_s=0.5, min_delay_s=0.01,
                                                max_delay_s=1.0, min_samples=10), telemetry=reg)
        delays = [ex.current_delay()]
        hist = reg.histogram("resilience.read_latency_s")
        for v, n in ((0.002, 20), (0.3, 200), (30.0, 2000)):
            for _ in range(n):
                hist.observe(v)
            delays.append(ex.current_delay())
        return errors, delays, pickle.loads(pickle.dumps(r.HedgePolicy(quantile=0.9))).quantile
    same(both(run))


# ------------------------------------------------------------ registry events
def test_registry_events_equal_jax():
    def run(_, registry_class):
        reg = registry_class()
        keys = [sorted(reg.snapshot())]
        reg.record_event("rare", {"important": True})
        for i in range(5 * registry_class.EVENTS_PER_NAME):
            reg.record_event("chatty", {"i": i})
        snap = reg.snapshot()
        keys.append(sorted(snap))
        events = reg.events()
        reset = reg.reset()
        return (keys, registry_class.EVENTS_PER_NAME, events, reg.events("chatty"),
                snap["events"] == events, reset["events"] == events, "events" in reg.snapshot(),
                "events" in reg.reset())
    jax_result, port_result = both(run)
    # The JAX snapshot may carry planes the port does not have; the keys the
    # port has are the JAX package's, events included only when recorded.
    assert all(set(p) <= set(j) for p, j in zip(port_result[0], jax_result[0]))
    assert "events" not in port_result[0][0] and "events" in port_result[0][1]
    assert port_result[1:] == jax_result[1:]


def test_dump_thread_stacks_sees_this_thread():
    for r, _ in PACKAGES:
        assert any("test_dump_thread_stacks" in "".join(frames)
                   for frames in r.dump_thread_stacks().values())


# -------------------------------------------------------------------- watchdog
class _FakePool:
    def __init__(self):
        self.diagnostics = {"items_ventilated": 4, "items_processed": 2, "output_queue_size": 0}
        self.heartbeats = [10.0, 20.0]
        self.nudged = 0
        self.killed = []
        self.aborted = None

    def nudge(self):
        self.nudged += 1

    def kill_worker(self, wid):
        self.killed.append(wid)
        return True

    def abort(self, exc):
        self.aborted = exc


def _wait_until(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


def _ladder(r, registry_class, recovery=None, progress=False, wait=True):
    """A watchdog over a fake pool, its consumer waiting (or not) with the
    pipeline still (or moving): what each rung did."""
    pool, reg, token = _FakePool(), registry_class(), r.CancellationToken()
    wd = r.PipelineWatchdog(pool, telemetry=reg, cancel_token=token, recovery=recovery,
                            hang_timeout_s=0.15, interval_s=0.02,
                            escalation_interval_s=0.04).start()
    try:
        if wait:
            wd.enter_wait()
        if progress:
            end = time.monotonic() + 0.5
            while time.monotonic() < end:
                pool.diagnostics["items_processed"] += 1
                time.sleep(0.02)
        elif wait:
            assert _wait_until(lambda: pool.aborted is not None, 5.0)
        else:
            time.sleep(0.4)
    finally:
        wd.stop()
    snap = reg.snapshot()
    report = wd.report()
    dumps = snap.get("events", {}).get("resilience.watchdog.stack_dump", [])
    return (type(pool.aborted).__name__, pool.nudged >= 1, pool.killed, token.requested,
            {k: v for k, v in snap["counters"].items() if k != "reader.rows"},
            report["aborted"], report["stage"], bool(report["last_stack_dump"]),
            [("petastorm-tpu-watchdog" in d["payload"]["threads"]) for d in dumps])


@pytest.mark.parametrize("case", ["full_ladder", "kill_rung", "not_waiting", "progress"])
def test_watchdog_ladders_equal_jax(case):
    recovery = (SimpleNamespace(claimed_workers=lambda: {0, 1}, dead_workers={0})
                if case == "kill_rung" else None)
    result = same(both(lambda r, reg: _ladder(r, reg, recovery=recovery,
                                               progress=case == "progress",
                                               wait=case != "not_waiting")))
    if case == "kill_rung":
        assert result[2] == [1] and not result[3]   # killed, so no cancel
    if case == "full_ladder":
        assert result[0] == "PipelineHungError" and result[3]


def test_watchdog_validation_equal_jax():
    def run(r, _):
        try:
            r.PipelineWatchdog(_FakePool(), hang_timeout_s=0)
        except ValueError as e:
            return str(e)
    same(both(run))


def test_stage_deadline_and_hedging_keep_the_rows(synthetic_dataset):
    """Soft-overrun stragglers are counted (attempts and items), a hard
    budget quarantines a file that is always slow, and a hedged read masks
    a straggler without changing the seeded stream: as the JAX reader."""
    def run(r, **kwargs):
        return read_stream(make_reader if r is tres else jax_make_reader, r, synthetic_dataset.url,
                     False, reader_pool_type="thread", workers_count=2, shuffle_row_groups=True,
                     seed=3, **kwargs)

    soft = [run(r, stage_deadline_s=r.StageDeadline(soft_s=0.005),
                fault_plan=r.FaultPlan([r.FaultSpec(site="rowgroup.read", kind="latency",
                                                    rate=1.0, latency_s=0.03)]))
            for r, _ in PACKAGES]
    assert soft[1][0] == soft[0][0] and sorted(soft[1][0]) == list(range(100))
    assert soft[1][2]["resilience.stragglers_total"] == soft[0][2]["resilience.stragglers_total"] \
        == 10
    assert soft[1][2]["resilience.item_stragglers_total"] >= 10

    hard = [run(r, stage_deadline_s=r.StageDeadline(hard_s=0.01), degraded_mode=True,
                fault_plan=r.FaultPlan([r.FaultSpec(site="rowgroup.read", kind="latency",
                                                    rate=1.0, latency_s=0.05,
                                                    key_substring="part-00000")]))
            for r, _ in PACKAGES]
    assert hard[1][0] == hard[0][0] and len(hard[1][0]) == 80
    # The messages carry the attempt's seconds; the rest is the JAX report's.
    pieces = [[(p["path"], p["row_group"], p["error_type"], p["attempts"], p["worker_id"])
               for p in run[3]["pieces"]] for run in hard]
    assert pieces[1] == pieces[0] and hard[1][3]["quarantined"] == 2
    assert {p[2] for p in pieces[1]} == {"StageDeadlineExceeded"}

    clean = run(tres)
    hedged = [run(r, hedge_policy=r.HedgePolicy(fallback_delay_s=0.02, min_delay_s=0.005,
                                                min_samples=10 ** 9),
                  fault_plan=r.FaultPlan([r.FaultSpec(site="rowgroup.read", kind="latency",
                                                      at=1, latency_s=0.5)]))
              for r, _ in PACKAGES]
    assert hedged[1][0] == hedged[0][0] == clean[0]
    assert hedged[1][2]["resilience.hedge_wins"] >= 1
    assert hedged[1][2]["resilience.hedges_launched"] >= 1


def test_watchdog_aborts_a_wedged_thread_reader(synthetic_dataset):
    """A wedged worker: the consumer gets ``PipelineHungError`` with the
    stack dump recorded, not a reader that blocks for good."""
    import threading
    from petastorm_tpu_torch.transform import TransformSpec
    unwedge = threading.Event()

    def wedge(row):
        if row["id"] == 0:
            unwedge.wait(30)
        return row

    t0 = time.monotonic()
    try:
        with pytest.raises(tres.PipelineHungError, match="no progress"):
            with make_reader(synthetic_dataset.url, schema_fields=["id"],
                             reader_pool_type="thread", workers_count=2,
                             shuffle_row_groups=False, transform_spec=TransformSpec(wedge),
                             hang_timeout_s=0.4) as reader:
                try:
                    for _ in reader:
                        pass
                finally:
                    report = reader.watchdog_report()
                    events = reader.telemetry.events("resilience.watchdog.stack_dump")
    finally:
        unwedge.set()
    assert time.monotonic() - t0 < 15.0
    assert report["hangs_detected"] >= 1 and report["aborted"] and report["last_stack_dump"]
    assert events and "threads" in events[0]["payload"]


def test_watchdog_kills_only_the_hung_process_worker(synthetic_dataset):
    ids, counters, report = process_read(
        synthetic_dataset.url,
        [tres.FaultSpec(site="worker.item", kind="latency", at=1, worker=1, latency_s=600.0)],
        budget=1, hang_timeout_s=1.0)
    assert ids == list(range(100))
    assert counters["resilience.watchdog_kills"] == 1
    assert counters["resilience.worker_crashes"] == 1
    assert report["hangs_detected"] == 1 and not report["aborted"]
