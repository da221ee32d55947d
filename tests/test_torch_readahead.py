"""The port's readahead stage (``petastorm_tpu_torch.reader_impl.readahead``)
held to the JAX package's on the CPU: the fetcher's depth and byte bounds,
its submit-queue cap and claim-back, a failed fetch discarded and never
kept, the fault plan's ``rowgroup.read`` site under the fetchers' own
worker ids, the knob and its actuator; then the readers with
``readahead_depth`` against the JAX readers on the same stores (equal rows
in equal order, with and without the memory cache), its composition with
retries, quarantine and hedging, the trace-mode fetch spans and the
critical path's fetch edge, and the process pool's warning. The JAX
package's cases of ``tests/test_readahead.py`` that touch ported code are
here. Exact comparisons unless a bound is stated."""
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.reader_impl.readahead as jra
import petastorm_tpu.resilience as jres
import petastorm_tpu_torch.reader_impl.readahead as tra
import petastorm_tpu_torch.resilience as tres
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.autotune import MemoryBudget, ReadaheadDepthActuator
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, load_row_groups
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.resilience import (ExponentialBackoff, FaultPlan, FaultSpec, HedgePolicy,
                                            RetryPolicy)
from petastorm_tpu_torch.telemetry import TelemetryRegistry

FAST_POLICY = RetryPolicy(max_attempts=2, seed=0, backoff=ExponentialBackoff(base=0.001, cap=0.01))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """200 rows in 10 row groups over two files."""
    path = str(tmp_path_factory.mktemp("ra") / "ds")
    os.makedirs(path, exist_ok=True)
    t = pa.table({"id": np.arange(200, dtype=np.int64),
                  "x": np.arange(200, dtype=np.float64) / 7.0})
    pq.write_table(t.slice(0, 100), os.path.join(path, "a.parquet"), row_group_size=20)
    pq.write_table(t.slice(100), os.path.join(path, "b.parquet"), row_group_size=20)
    return f"file://{path}"


def _wait_until(fn, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return False


def _batch_ids(reader):
    return [int(x) for b in reader for x in b.id]


def _fetcher(module, store, **kw):
    """A fetcher of either package over the store; its row groups are read
    through the JAX package's planner, which the port's matches."""
    from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxContext
    from petastorm_tpu.etl.dataset_metadata import load_row_groups as jax_load
    ctx = (JaxContext if module is jra else DatasetContext)(store)
    rgs = (jax_load if module is jra else load_row_groups)(ctx)
    kw.setdefault("depth", 3)
    return module.ReadaheadFetcher(ctx.filesystem, ["id", "x"], **kw), rgs


def test_fetcher_constants_equal_jax():
    assert tra.FETCHER_WORKER_ID_BASE == jra.FETCHER_WORKER_ID_BASE == 1000
    assert tra._WAIT_POLL_S == jra._WAIT_POLL_S


@pytest.mark.parametrize("module", [jra, tra], ids=["jax", "port"])
def test_hit_after_a_fetch(store, module):
    ra, rgs = _fetcher(module, store)
    ra.start()
    try:
        ra.submit(rgs[0])
        assert _wait_until(lambda: ra.stats()["fetched_total"] >= 1)
        table = ra.pop(rgs[0])
        assert table.column("id").to_pylist() == list(range(20))
        s = ra.stats()
        assert (s["hits"], s["bytes_in_flight"], s["ahead"]) == (1, 0, 0)
    finally:
        ra.close()


def test_claim_back_and_queue_cap_equal_jax(store):
    """Fetchers not started: a pop claims its queued submission back (a
    miss), the fetcher skips the claimed entry once started, and
    submissions past the cap are dropped, identically in both packages."""
    out = []
    for module in (jra, tra):
        ra, rgs = _fetcher(module, store, max_queue=12)
        for _ in range(2):
            for rg in rgs:
                ra.submit(rg)
        first = dict(ra.stats())
        misses = [ra.pop(rg) for rg in rgs[:3]]
        ra.start()
        assert _wait_until(lambda: ra.stats()["ahead"] == 3)
        time.sleep(0.1)
        s = ra.stats()
        ready = [ra.pop(rg) is not None for rg in rgs[:6]]
        ra.close()
        out.append((first["queued"], first["submit_dropped"], misses, s["misses"],
                    s["fetched_total"], s["ahead"], s["queued"], ready, sorted(s)))
    assert out[1] == out[0]
    # The three claimed entries skipped, the next three fetched (the depth),
    # six left queued.
    assert out[1][:8] == (12, 8, [None] * 3, 3, 3, 3, 6, [False] * 3 + [True] * 3)


def test_depth_bounds_the_fetches_ahead(store):
    ra, rgs = _fetcher(tra, store, depth=2, fetchers=2)
    ra.start()
    try:
        for rg in rgs[:6]:
            ra.submit(rg)
        assert _wait_until(lambda: ra.stats()["ahead"] >= 2)
        time.sleep(0.2)
        s = ra.stats()
        assert s["ahead"] <= 2 and s["fetched_total"] <= 2
        for rg in rgs[:6]:
            if ra.pop(rg) is None:
                break
        assert _wait_until(lambda: ra.stats()["fetched_total"] >= 3)
    finally:
        ra.close()


def test_byte_budget_stalls_the_fetches(store):
    budget = MemoryBudget(1)
    ra, rgs = _fetcher(tra, store, depth=8, fetchers=1, budget=budget)
    ra.start()
    try:
        for rg in rgs[:4]:
            ra.submit(rg)
        assert _wait_until(lambda: ra.stats()["fetched_total"] == 1)
        time.sleep(0.2)
        assert ra.stats()["fetched_total"] == 1 and budget.used > 0
        assert ra.pop(rgs[0]) is not None
        assert _wait_until(lambda: ra.stats()["fetched_total"] >= 2)
    finally:
        ra.close()
    assert budget.used == 0


@pytest.mark.parametrize("module,res", [(jra, jres), (tra, tres)], ids=["jax", "port"])
def test_a_failed_fetch_is_discarded(store, module, res):
    plan = res.FaultPlan([res.FaultSpec(site="rowgroup.read", kind="ioerror", at=1)], seed=0)
    ra, rgs = _fetcher(module, store, fault_plan=plan)
    ra.start()
    try:
        ra.submit(rgs[0])
        assert _wait_until(lambda: ra.stats()["fetch_errors"] == 1)
        assert ra.pop(rgs[0]) is None and ra.stats()["fetched_total"] == 0
    finally:
        ra.close()


def test_fetchers_fire_under_their_own_worker_ids(store):
    """A spec pinned to worker 0 never fires on a fetcher; one pinned to a
    fetcher's id does, once."""
    plan = FaultPlan([FaultSpec(site="rowgroup.read", kind="ioerror", rate=1.0, worker=0),
                      FaultSpec(site="rowgroup.read", kind="ioerror", at=1,
                                worker=tra.FETCHER_WORKER_ID_BASE)], seed=0)
    ra, rgs = _fetcher(tra, store, fault_plan=plan, fetchers=1)
    ra.start()
    try:
        for rg in rgs[:3]:
            ra.submit(rg)
        assert _wait_until(lambda: ra.stats()["fetched_total"] == 2)
        assert ra.stats()["fetch_errors"] == 1
    finally:
        ra.close()
    assert [spec["fired"] for spec in plan.stats()["specs"]] == [0, 1]


def test_depth_knob_and_its_actuator(store):
    ra, _ = _fetcher(tra, store, depth=4)
    ra.set_readahead_depth(0)  # knob-ok: the setter's own floor
    assert ra.depth == 1
    ra.set_readahead_depth(3)  # knob-ok: the setter under test
    act = ReadaheadDepthActuator(ra)
    assert (act.lo, act.hi, act.value) == (1, 12, 3)
    assert act.set(100) == 12 and ra.depth == 12
    assert act.nudge(-100) == 1 and ra.depth == 1
    ra.close()
    with pytest.raises(ValueError, match="depth"):
        _fetcher(tra, store, depth=0)


def test_fetch_telemetry_and_spans(store):
    reg = TelemetryRegistry()
    reg.recorder.enable_trace()
    ra, rgs = _fetcher(tra, store, telemetry=reg, fetchers=1)
    ra.start()
    try:
        ra.submit(rgs[0], trace="e0:g0")
        assert _wait_until(lambda: ra.stats()["fetched_total"] == 1)
        ra.pop(rgs[0])
    finally:
        ra.close()
    snap = reg.snapshot()
    c, g = snap["counters"], snap["gauges"]
    assert c["io.readahead.hits"] == 1 and c["io.rowgroups_read"] == 1
    assert c["io.bytes_read"] > 0 and c["io.readahead.fetch_s"] > 0
    assert {"io.readahead.depth", "io.readahead.bytes_in_flight", "io.readahead.ahead"} <= set(g)
    spans = [sp.as_dict() for sp in reg.recorder.spans()]
    fetch = [sp for sp in spans if sp["name"] == "petastorm_tpu.fetch"]
    assert len(fetch) == 1 and fetch[0]["trace"] == "e0:g0" and fetch[0]["track"] == "fetch:0"
    assert fetch[0]["stage"] == "fetch"


# ------------------------------------------------------------------ readers
@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("cache", [None, 64 << 20])
def test_batch_reader_with_readahead_equal_jax(store, pool, cache):
    kw = dict(shuffle_row_groups=True, seed=3, reader_pool_type=pool, workers_count=2,
              num_epochs=2, memory_cache_size_bytes=cache)
    with jax_make_batch_reader(store, readahead_depth=4, **kw) as r:
        jax_ids = _batch_ids(r)
    with make_batch_reader(store, readahead_depth=4, **kw) as r:
        port_ids = _batch_ids(r)
        stats = r.readahead_report()
        counters = r.telemetry.snapshot()["counters"]
    with make_batch_reader(store, **kw) as r:
        plain = _batch_ids(r)
        assert r.readahead_report() == {}
    assert port_ids == jax_ids == plain and sorted(port_ids) == sorted(list(range(200)) * 2)
    assert counters["io.readahead.fetched_total"] == stats["fetched_total"]
    if cache is None:
        assert stats["hits"] + stats["misses"] == 20
        assert counters["io.rowgroups_read"] == stats["fetched_total"] + stats["misses"]


@pytest.mark.parametrize("pool", ["dummy", "thread"])
def test_row_reader_with_readahead_equal_jax(synthetic_dataset, pool):
    kw = dict(shuffle_row_groups=True, seed=5, reader_pool_type=pool, workers_count=2)
    with jax_make_reader(synthetic_dataset.url, readahead_depth=3, **kw) as r:
        jax_ids = [int(row.id) for row in r]
    with make_reader(synthetic_dataset.url, readahead_depth=3, **kw) as r:
        port_ids = [int(row.id) for row in r]
        stats = r.readahead_report()
    with make_reader(synthetic_dataset.url, **kw) as r:
        plain = [int(row.id) for row in r]
    assert port_ids == jax_ids == plain and stats["hits"] + stats["misses"] == 10


def test_a_predicate_reads_one_fetch_for_both_requests(store):
    from petastorm_tpu_torch.predicates import in_range
    with make_batch_reader(store, shuffle_row_groups=False, workers_count=1, readahead_depth=4,
                           predicate=in_range("id", 0, 1000)) as r:
        ids = _batch_ids(r)
        stats = r.readahead_report()
    assert ids == list(range(200))
    assert stats["hits"] + stats["misses"] == 10


def test_a_failing_file_is_quarantined_once_with_readahead(store):
    runs = []
    for factory, r, extra in ((jax_make_batch_reader, jres, {}),
                              (make_batch_reader, tres, {})):
        plan = r.FaultPlan([r.FaultSpec(site="rowgroup.read", kind="ioerror", rate=1.0,
                                        key_substring="a.parquet")], seed=0)
        policy = r.RetryPolicy(max_attempts=2, seed=0,
                               backoff=r.ExponentialBackoff(base=0.001, cap=0.01))
        with factory(store, shuffle_row_groups=False, workers_count=2, readahead_depth=4,
                     retry_policy=policy, fault_plan=plan, degraded_mode=True, **extra) as reader:
            ids = _batch_ids(reader)
            report = reader.quarantine_report()
            stats = reader.readahead_report()
        runs.append((sorted(ids), report["quarantined"]))
        assert stats["fetched_total"] >= stats["hits"]
    assert runs[1] == runs[0] == (list(range(100, 200)), 5)


def test_a_transient_fetch_error_costs_no_row(store):
    plan = FaultPlan([FaultSpec(site="rowgroup.read", kind="ioerror", at=1)], seed=0)
    with make_batch_reader(store, shuffle_row_groups=False, workers_count=2, readahead_depth=4,
                           retry_policy=FAST_POLICY, fault_plan=plan, degraded_mode=True) as r:
        ids = _batch_ids(r)
        report = r.quarantine_report()
    assert sorted(ids) == list(range(200)) and report["quarantined"] == 0


def test_latency_faults_with_readahead_deliver_every_row_once(synthetic_dataset):
    """Seeded latency faults with hedged reads: the fetchers' firings differ
    from the workers', the rows do not."""
    def run(depth):
        plan = FaultPlan([FaultSpec(site="rowgroup.read", kind="latency", rate=0.5,
                                    latency_s=0.02, latency_jitter_s=0.02)], seed=22)
        hedge = HedgePolicy(fallback_delay_s=0.005, min_delay_s=0.001, min_samples=10 ** 9)
        with make_reader(synthetic_dataset.url, schema_fields=["id"], workers_count=4,
                         shuffle_row_groups=True, seed=1, fault_plan=plan, hedge_policy=hedge,
                         readahead_depth=depth) as r:
            return [int(row.id) for row in r], r.readahead_report()
    with_ra, stats = run(4)
    without, _ = run(None)
    assert with_ra == without and sorted(with_ra) == list(range(100))
    assert stats["hits"] + stats["misses"] == 10


def test_hedged_fetches_keep_the_rows(store):
    hedge = HedgePolicy(fallback_delay_s=0.001, min_delay_s=0.001, min_samples=10 ** 9,
                        max_concurrent=2)
    kw = dict(shuffle_row_groups=False, workers_count=2)
    with make_batch_reader(store, readahead_depth=4, hedge_policy=hedge, **kw) as r:
        hedged = _batch_ids(r)
    with make_batch_reader(store, **kw) as r:
        plain = _batch_ids(r)
    assert hedged == plain


def test_autotune_registers_the_readahead_actuator(store):
    with make_batch_reader(store, shuffle_row_groups=False, workers_count=2, readahead_depth=2,
                           autotune=True) as r:
        _batch_ids(r)
        report = r.autotune_report()
    act = report["actuators"]["readahead_depth"]
    assert (act["lo"], act["hi"]) == (1, 8) and 1 <= act["value"] <= 8


def test_trace_mode_records_fetch_spans_and_the_fetch_edge(synthetic_dataset, monkeypatch):
    from petastorm_tpu_torch.loader import DataLoader
    monkeypatch.setenv("PETASTORM_TPU_TELEMETRY_TRACE", "1")
    with make_reader(synthetic_dataset.url, schema_fields=["id", "matrix"], workers_count=2,
                     readahead_depth=4, shuffle_row_groups=False) as r:
        loader = DataLoader(r, batch_size=10, device="cpu")
        ids = [int(i) for b in loader for i in b["id"]]
        critical = loader.critical_path_report()
        spans = [sp.as_dict() for sp in r.telemetry.recorder.spans()]
        snap = r.telemetry.snapshot()
    fetch = [sp for sp in spans if sp["name"] == "petastorm_tpu.fetch"]
    assert ids == list(range(100)) and fetch
    assert {sp["track"] for sp in fetch} <= {"fetch:0", "fetch:1"}
    assert all(sp["trace"].startswith("e0:g") for sp in fetch)
    assert snap["counters"]["io.readahead.fetch_s"] > 0
    # The fetch edge accrued self-time on some delivered batch.
    assert snap["histograms"]["trace.self.fetch_s"]["sum"] > 0
    assert set(critical["counts"]) >= {"fetch", "decode"} and critical["batches"] == 10


def test_reader_refuses_a_negative_depth(store):
    with pytest.raises(ValueError, match="readahead_depth"):
        make_batch_reader(store, readahead_depth=-1)


def test_hedge_handle_pool_reuses_and_bounds_its_handles(store):
    from petastorm_tpu_torch.reader_impl.row_reader_worker import _HedgeHandlePool
    ctx = DatasetContext(store)
    pool = _HedgeHandlePool(ctx.filesystem, max_idle=1)
    a, b = pool.acquire(), pool.acquire()
    assert a is not b
    rgs = load_row_groups(ctx)
    a.get(rgs[0].path)
    b.get(rgs[0].path)
    pool.release(a)
    pool.release(b)
    assert len(pool._idle) == 1 and not b._files and pool.acquire() is a
