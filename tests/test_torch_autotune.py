"""The port's autotune plane (``petastorm_tpu_torch.autotune``, the thread
pool's ``ConcurrencyGate``, the knobs on the ventilator, the shuffling
buffers and the loaders) held to the JAX package's on the CPU: the byte
ledger and payload sizes on the same payloads; both controllers fed one
seeded script of 240 registry states through the same fake actuators,
with a placement trial through a fake ``migrate_fn`` (equal ``history``,
verdict counters and outcome); both memory caches driven by one seeded
script of gets with their fill clocks patched (equal hits, evictions,
rejections and resident key order); then the readers with
``memory_cache_size_bytes`` and ``autotune`` against the JAX readers on
the same stores (equal rows per epoch, equal ``cache.mem.*`` counts), the
JAX package's cases of ``tests/test_autotune.py`` that touch ported code,
and the knob lint over the port. Exact comparisons unless a bound is
stated."""
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import petastorm_tpu.autotune as jauto
import petastorm_tpu.autotune.mem_cache as jmem
import petastorm_tpu_torch.autotune as tauto
import petastorm_tpu_torch.autotune.mem_cache as tmem
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.telemetry import TelemetryRegistry as JaxRegistry
from petastorm_tpu.workers_pool.thread_pool import ConcurrencyGate as JaxGate
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.resilience import FaultPlan, FaultSpec, InjectedIOError
from petastorm_tpu_torch.telemetry import TelemetryRegistry
from petastorm_tpu_torch.workers_pool.thread_pool import ConcurrencyGate

REPO = Path(__file__).resolve().parent.parent
PACKAGES = [(jauto, JaxRegistry), (tauto, TelemetryRegistry)]


def both(fn):
    return [fn(a, reg) for a, reg in PACKAGES]


def same(pair):
    assert pair[1] == pair[0]
    return pair[1]


# ------------------------------------------------------------ budget, sizes
class _Blob:
    x = 1


PAYLOADS = [np.zeros((10, 10), np.float32), b"abcd", "abcd", "été", None, 7, 2.5, True,
            {"a": np.zeros(8, np.int64), "b": b"xy"}, [b"xy", b"zw"], (1, "ab"),
            {"nested": [np.ones(3), {"k": b"v"}]}, frozenset({1, 2}), bytearray(b"123"),
            memoryview(b"12345"), _Blob()]


@pytest.mark.parametrize("index", range(len(PAYLOADS)))
def test_payload_nbytes_equal_jax(index):
    same(both(lambda a, _: a.payload_nbytes(PAYLOADS[index])))


def test_memory_budget_script_equal_jax():
    rng = np.random.default_rng(0)
    script = [(rng.choice(["reserve", "force", "release"]), int(rng.integers(0, 60)))
              for _ in range(200)]

    def run(a, reg_class):
        reg = reg_class()
        b = a.MemoryBudget(100, telemetry=reg)
        out = []
        for op, n in script:
            r = (b.reserve(n) if op == "reserve" else b.reserve(n, force=True) if op == "force"
                 else b.release(n))
            out.append((r, b.used, b.available, round(b.pressure, 9), b.would_fit(n)))
        gauges = reg.snapshot()["gauges"]
        return out, gauges["budget.capacity_bytes"], gauges["budget.used_bytes"]
    same(both(run))


def test_memory_budget_validation_as_jax():
    for a, _ in PACKAGES:
        with pytest.raises(ValueError):
            a.MemoryBudget(0)
        b = a.MemoryBudget(10)
        with pytest.raises(ValueError):
            b.reserve(-1)
        with pytest.raises(ValueError):
            b.release(-1)


# --------------------------------------------------------------- actuators
def _fake_actuator(a, name="fake", lo=1, hi=10, initial=4, telemetry=None):
    class Fake(a.Actuator):
        def __init__(self):
            self.applied = []
            super().__init__(name, lo, hi, initial, telemetry=telemetry)

        def _apply(self, value):
            self.applied.append(value)
    return Fake()


def test_actuator_clamps_and_records_as_jax():
    def run(a, reg_class):
        reg = reg_class()
        act = _fake_actuator(a, lo=2, hi=6, initial=4, telemetry=reg)
        out = [act.set(100), act.set(-3), act.set(2), act.nudge(+3), act.nudge(-10),
               act.at_min, act.at_max, act.value]
        snap = reg.snapshot()
        return out, act.applied, snap["gauges"]["autotune.fake"], \
            snap["counters"]["autotune.adjustments_total"]
    assert same(both(run))[1] == [6, 2, 5, 2]
    for a, _ in PACKAGES:
        with pytest.raises(ValueError, match="lo"):
            _fake_actuator(a, lo=5, hi=2)


def test_component_actuators_ranges_equal_jax():
    class Vent:
        max_inflight = 8

        def set_max_inflight(self, n):
            self.max_inflight = n

    class Loader:
        prefetch_depth = 2

        def set_prefetch_depth(self, n):
            self.prefetch_depth = n

    class Fetcher:
        depth = 3

        def set_readahead_depth(self, n):
            self.depth = n

    class Buf:
        capacity = 100
        min_target = 60

        def set_target_capacity(self, n):
            self.capacity_set = n

    def run(a, gate_class):
        gate = gate_class(4)
        acts = [a.WorkerConcurrencyActuator(gate, 4), a.VentilatorDepthActuator(Vent()),
                a.PrefetchDepthActuator(Loader()), a.ReadaheadDepthActuator(Fetcher()),
                a.ShuffleTargetActuator(Buf())]
        ranges = [(x.name, x.lo, x.hi, x.value) for x in acts]
        moved = [x.nudge(+100) for x in acts] + [x.nudge(-100) for x in acts]
        return ranges, moved, gate.limit
    pair = [run(jauto, JaxGate), run(tauto, ConcurrencyGate)]
    same(pair)
    assert pair[1][0][1] == ("ventilate_ahead", 2, 32, 8)


# -------------------------------------------------------------------- gate
def test_gate_limit_floor_and_accounting():
    gate = ConcurrencyGate(0)
    assert gate.limit == 1
    gate.set_limit(-5)  # knob-ok: the gate's own floor
    assert gate.limit == 1
    stop = threading.Event()
    assert gate.acquire(stop) and gate.active == 1
    gate.release()
    gate.release()   # releasing without a slot is a no-op
    assert gate.active == 0


def test_gate_raise_wakes_a_parked_worker():
    gate = ConcurrencyGate(1)
    stop = threading.Event()
    acquired = []
    assert gate.acquire(stop)
    t = threading.Thread(target=lambda: acquired.append(gate.acquire(stop)), daemon=True)
    t.start()
    time.sleep(0.1)
    assert not acquired
    gate.set_limit(2)  # knob-ok: the gate's own wakeup
    t.join(timeout=2)
    assert acquired == [True]


def test_gate_stop_unblocks_and_yield_reacquires():
    gate = ConcurrencyGate(1)
    stop = threading.Event()
    assert not gate.yield_if_held()
    assert gate.acquire(stop)
    result = []
    t = threading.Thread(target=lambda: result.append(gate.acquire(stop)), daemon=True)
    t.start()
    stop.set()
    t.join(timeout=2)
    assert result == [False]
    assert gate.yield_if_held() and gate.active == 0
    gate.nudge()
    assert gate.acquire(threading.Event())
    gate.release()


@pytest.mark.parametrize("limit", [1, 2])
def test_thread_pool_below_its_workers_neither_wedges_nor_reorders(synthetic_dataset, limit):
    """A limit below the worker count under the strict round-robin readout,
    with result queues of one: slot holders blocked on a full queue yield,
    so every row comes, in the order of an unlimited pool."""
    def ids(gate_limit):
        with make_reader(synthetic_dataset.url, schema_fields=["id"], workers_count=3,
                         results_queue_size=1, shuffle_row_groups=True, seed=1) as reader:
            if gate_limit is not None:
                reader.pool.concurrency_gate.set_limit(gate_limit)  # knob-ok: the gate under test
            out = [int(r.id) for r in reader]
            reader.pool.nudge()
        return out
    assert ids(limit) == ids(None) and sorted(ids(None)) == list(range(100))


# -------------------------------------------------------------- controller
def _script(seed: int, ticks: int = 240):
    """Per tick: counter increments, gauge values and a budget charge. The
    first 120 ticks draw at random among the signals; then a
    producer-bound streak that tops every knob and opens the placement
    trial, rows a tick falling during the trial (a revert), then random
    ticks again."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        inc, gauges, charge = {}, {}, 0
        phase = "random" if t < 120 or t >= 200 else "producer"
        if phase == "random":
            kind = rng.choice(["host", "device", "balanced", "queue", "fault", "memory", "idle"])
        else:
            kind = "host"
        if kind == "host":
            inc["loader.next_host_bound"] = int(rng.integers(3, 9))
            inc["loader.next_balanced"] = int(rng.integers(0, 2))
        elif kind == "device":
            inc["loader.next_device_bound"] = int(rng.integers(3, 9))
        elif kind == "balanced":
            inc["loader.next_balanced"] = int(rng.integers(3, 9))
        elif kind == "queue":
            gauges["pool.results_queue_capacity"] = 10.0
            gauges["pool.results_queue_depth"] = float(rng.integers(0, 11))
            gauges["ventilator.backlog"] = float(rng.integers(0, 3))
        elif kind == "fault":
            inc[str(rng.choice(["resilience.retries_total", "resilience.quarantined_rowgroups",
                                "resilience.worker_crashes"]))] = 1
            inc["loader.next_host_bound"] = 5
        elif kind == "memory":
            charge = int(rng.integers(0, 100))
        if kind != "idle":
            rows = 100.0 if phase == "random" or t < 150 else 20.0
            inc["reader.rows"] = rows + float(rng.integers(0, 10))
        out.append((inc, gauges, charge))
    return out


def _drive(a, reg_class, script):
    reg = reg_class()
    budget = a.MemoryBudget(100)
    cfg = a.AutotuneConfig(hysteresis=2, cooldown_ticks=1, placement_settle_ticks=3)
    ctrl = a.AutotuneController(reg, cfg, budget=budget)
    for name, lo, hi, initial in (("worker_concurrency", 1, 4, 2), ("ventilate_ahead", 2, 16, 8),
                                  ("readahead_depth", 1, 6, 2), ("prefetch_depth", 1, 4, 2),
                                  ("shuffle_target", 10, 1000, 800)):
        ctrl.register(_fake_actuator(a, name, lo, hi, initial))
    requests = []
    placement = ctrl.register(a.PlacementActuator(requests.append, "thread"))
    applied_at = {}
    verdicts = []
    for tick, (inc, gauges, charge) in enumerate(script):
        for name, n in inc.items():
            reg.counter(name).add(n)
        for name, v in gauges.items():
            reg.gauge(name).set(v)
        budget.release(budget.used)
        budget.reserve(charge)
        # The fake migration lands two ticks after its request.
        if len(requests) > len(applied_at):
            applied_at[len(requests)] = tick + 2
        if applied_at.get(len(requests)) == tick and not placement.applied:
            placement.mark_applied()
        verdicts.append(ctrl.tick())
    counters = {k: v for k, v in reg.snapshot()["counters"].items()
                if k.startswith("autotune.")}
    return (ctrl.history, verdicts, counters, requests, ctrl.placement_outcome,
            ctrl.actuator_values(), ctrl.report())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controllers_equal_over_a_seeded_script(seed):
    script = _script(seed)
    history, verdicts, counters, requests, outcome, values, report = same(
        both(lambda a, reg: _drive(a, reg, script)))
    assert len(script) >= 200
    assert counters["autotune.ticks_total"] == len(script)
    assert {v for v in verdicts} >= {"producer_bound", "consumer_bound", "balanced",
                                     "fault_hold", "idle"}
    assert any(h[1] == "placement" for h in history) and requests
    assert outcome is not None and outcome["verdict"] in ("kept", "reverted")


def test_controller_memory_pressure_and_fault_hold_as_jax():
    def run(a, reg_class):
        reg = reg_class()
        budget = a.MemoryBudget(100)
        budget.reserve(99)
        ctrl = a.AutotuneController(reg, a.AutotuneConfig(hysteresis=1, cooldown_ticks=0),
                                    budget=budget)
        acts = [ctrl.register(_fake_actuator(a, *spec)) for spec in (
            ("shuffle_target", 10, 1000, 1000), ("prefetch_depth", 1, 4, 4),
            ("ventilate_ahead", 1, 8, 8), ("readahead_depth", 1, 8, 4))]
        first = ctrl.tick()
        budget.release(99)
        reg.counter("loader.next_host_bound").add(5)
        reg.counter("resilience.retries_total").add(1)
        second = ctrl.tick()
        return first, second, [x.value for x in acts], ctrl.history
    first, second, values, _ = same(both(run))
    assert (first, second, values) == ("memory_pressure", "fault_hold", [500, 3, 6, 3])


def test_config_validation_as_jax():
    for a, _ in PACKAGES:
        for bad in (dict(hysteresis=0), dict(cooldown_ticks=-1),
                    dict(memory_high_watermark=2.0), dict(memory_budget_bytes=0),
                    dict(placement_settle_ticks=0), dict(placement_tolerance=1.0)):
            with pytest.raises(ValueError):
                a.AutotuneConfig(**bad)


def test_placement_config_is_not_ported():
    """The name is kept from when the port refused placement (ROADMAP item
    9, placement migration): ``AutotuneConfig(placement=True)`` now builds
    as in the JAX package, and a reader's placement actuator migrates its
    pool mid-epoch with every id once, as the JAX reader's does."""
    port, jax = tauto.AutotuneConfig(placement=True), jauto.AutotuneConfig(placement=True)
    assert (port.placement, port.placement_settle_ticks, port.placement_tolerance) == \
        (jax.placement, jax.placement_settle_ticks, jax.placement_tolerance)


def test_controller_thread_ticks_and_stops():
    reg = TelemetryRegistry()
    ctrl = tauto.AutotuneController(reg, tauto.AutotuneConfig(interval_s=0.01))
    reg.counter("loader.next_balanced").add(1)
    assert ctrl.start() is ctrl.start()
    deadline = time.monotonic() + 5
    while ctrl.report()["ticks"] < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    ctrl.stop()
    ctrl.stop()
    ticks = ctrl.report()["ticks"]
    assert ticks >= 3
    time.sleep(0.05)
    assert ctrl.report()["ticks"] == ticks


# ------------------------------------------------------------ memory cache
class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` steps through ``steps``:
    each fill's measured seconds, in order."""

    def __init__(self, fill_seconds):
        self._values = []
        t = 0.0
        for s in fill_seconds:
            self._values += [t, t + s]
            t += s + 1.0
        self._it = iter(self._values)

    def perf_counter(self):
        return next(self._it)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_memory_caches_equal_over_a_seeded_script(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(50, 400, 40)
    keys = (rng.zipf(1.3, 400) - 1) % 40
    fills = rng.uniform(0.001, 1.0, 400)
    monkeypatch.setattr(jmem, "time", _Clock(fills))
    monkeypatch.setattr(tmem, "time", _Clock(fills))

    def run(a, reg_class):
        reg = reg_class()
        cache = a.InMemoryRowGroupCache(1500, telemetry=reg)
        for k in keys:
            cache.get(f"k{k}", lambda k=k: np.zeros(int(sizes[k]), np.uint8))
        counters = {n: v for n, v in reg.snapshot()["counters"].items()
                    if n.startswith("cache.mem.")}
        return counters, cache.keys(), cache.size_bytes(), cache.stats()
    counters, keys_left, resident, _ = same(both(run))
    assert counters["cache.mem.evictions"] > 0 and counters["cache.mem.rejected_admissions"] > 0
    assert counters["cache.mem.hits"] > 0 and resident <= 1500 and keys_left


def test_cache_lru_cost_and_limit_under_a_shared_budget():
    entry = np.zeros(400, np.uint8)
    cache = tauto.InMemoryRowGroupCache(1000)
    cache._admit("a", entry, fill_s=1.0)
    cache._admit("b", entry, fill_s=1.0)
    cache.get("a", lambda: entry)
    cache._admit("c", entry, fill_s=1.0)
    assert cache.keys() == ["a", "c"]
    cache = tauto.InMemoryRowGroupCache(1000)
    cache._admit("slow", np.zeros(800, np.uint8), fill_s=5.0)
    cache._admit("fast", np.zeros(800, np.uint8), fill_s=0.001)
    assert cache.keys() == ["slow"]
    cache._admit("slower", np.zeros(800, np.uint8), fill_s=9.0)
    assert cache.keys() == ["slower"] and cache.budget.used == 800
    shared = tauto.MemoryBudget(100_000)
    cache = tauto.InMemoryRowGroupCache(1000, budget=shared)
    for i in range(5):
        cache._admit(f"k{i}", np.zeros(400, np.uint8), fill_s=0.1)
    assert len(cache) == 2 and shared.used == cache.size_bytes() <= 1000
    v = tauto.InMemoryRowGroupCache(100).get("big", lambda: np.zeros(500, np.uint8))
    assert v.nbytes == 500


def test_cache_failed_fill_and_fault_site_cache_nothing():
    cache = tauto.InMemoryRowGroupCache(1 << 20)

    def bad():
        raise IOError("permanent corruption")
    with pytest.raises(IOError):
        cache.get("k", bad)
    assert len(cache) == 0 and cache.get("k", lambda: b"fine") == b"fine"
    plan = FaultPlan([FaultSpec(site="cache.fill", at=1)])
    cache = tauto.InMemoryRowGroupCache(1 << 20, fault_plan=plan)
    with pytest.raises(InjectedIOError):
        cache.get("k", lambda: b"v")
    assert len(cache) == 0 and cache.get("k", lambda: b"v") == b"v"


def test_cache_pickles_empty_with_its_policy():
    plan = FaultPlan([FaultSpec(site="cache.fill", at=99)])
    cache = tauto.InMemoryRowGroupCache(12345, fault_plan=plan)
    cache.get("a", lambda: b"payload")
    clone = pickle.loads(pickle.dumps(cache))
    assert len(clone) == 0 and clone._size_limit == 12345 and clone._fault_plan is not None
    clone.get("b", lambda: b"v")
    assert "b" in clone
    cache.cleanup()
    assert len(cache) == 0 and cache.budget.used == 0


def test_concurrent_fillers_leave_one_entry():
    cache = tauto.InMemoryRowGroupCache(1 << 20)
    barrier = threading.Barrier(4)

    def fill():
        barrier.wait(timeout=5)
        return np.zeros(100, np.uint8)
    threads = [threading.Thread(target=cache.get, args=("k", fill)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(cache) == 1 and cache.budget.used == 100


def test_container_cells_copied_on_a_hit_as_jax():
    from petastorm_tpu.reader_impl.row_reader_worker import RowReaderWorker as JaxWorker
    from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
    rows = []
    for worker in (JaxWorker, RowReaderWorker):
        cols = {"a": [[1, 2], [3, 4]], "b": [{"k": 1}, {"k": 2}], "c": ["imm", "utable"],
                "d": [np.arange(3), np.arange(3, 6)], "e": np.arange(6).reshape(2, 3)}
        row = worker._rows_from_decoded(object.__new__(worker), cols, [1])[0]
        picked = worker._cols_from_decoded(object.__new__(worker), cols, [1])
        row["a"].append(99)
        row["b"]["k"] = -1
        row["d"][:] = -1
        picked["d"][0][:] = -1
        picked["e"][:] = -1
        assert cols["a"][1] == [3, 4] and cols["b"][1] == {"k": 2}
        assert cols["d"][1].tolist() == [3, 4, 5] and cols["e"][1].tolist() == [3, 4, 5]
        assert row["c"] is cols["c"][1]
        rows.append({k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in row.items()})
    same(rows)


# ------------------------------------------------------------------ readers
def _ids(reader, batched):
    return [int(v) for s in reader for v in (s.id if batched else [s.id])]


def _two_passes(factory, url, batched, **kwargs):
    """Two epochs through one reader, ``reset()`` between them: the ids of
    each, and the cache counters after each."""
    out = []
    with factory(url, num_epochs=1, **kwargs) as reader:
        for _ in range(2):
            if reader.last_row_consumed:
                reader.reset()
            ids = _ids(reader, batched)
            counters = {k: v for k, v in reader.telemetry.snapshot()["counters"].items()
                        if k.startswith("cache.mem.")}
            out.append((ids, counters))
    return out


STORES = {"row": (jax_make_reader, make_reader), "batch": (jax_make_batch_reader,
                                                          make_batch_reader)}


@pytest.mark.parametrize("kind", sorted(STORES))
@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("readahead", [None, 3])
def test_memory_cache_readers_equal_jax(synthetic_dataset, scalar_dataset, kind, pool,
                                        readahead):
    url = synthetic_dataset.url if kind == "row" else scalar_dataset.url
    kw = dict(reader_pool_type=pool, workers_count=3, shuffle_row_groups=True, seed=5,
              memory_cache_size_bytes=1 << 30, readahead_depth=readahead)
    jax_run = _two_passes(STORES[kind][0], url, kind == "batch", **kw)
    port_run = _two_passes(STORES[kind][1], url, kind == "batch", **kw)
    plain = _two_passes(STORES[kind][1], url, kind == "batch",
                        **{**kw, "memory_cache_size_bytes": None, "readahead_depth": None})
    assert port_run == jax_run
    assert [ids for ids, _ in port_run] == [ids for ids, _ in plain]
    assert sorted(port_run[0][0]) == list(range(100)) and plain[0][1] == {}
    first, second = port_run[0][1], port_run[1][1]
    assert first["cache.mem.misses"] == first["cache.mem.inserts"] == 10
    assert second["cache.mem.hits"] == 10 and second["cache.mem.misses"] == 10


def test_two_epoch_streams_with_a_cache_equal_jax(synthetic_dataset):
    kw = dict(num_epochs=2, reader_pool_type="thread", workers_count=2, shuffle_row_groups=True,
              seed=3, memory_cache_size_bytes=1 << 30)
    with jax_make_reader(synthetic_dataset.url, **kw) as r:
        jax_ids = _ids(r, False)
    with make_reader(synthetic_dataset.url, **kw) as r:
        port_ids = _ids(r, False)
        c = r.telemetry.snapshot()["counters"]
    assert port_ids == jax_ids and sorted(port_ids) == sorted(list(range(100)) * 2)
    assert c["cache.mem.hits"] > 0 and c["cache.mem.inserts"] == 10


def test_cached_rows_equal_the_uncached_reader(synthetic_dataset):
    def read(cache_bytes):
        with make_reader(synthetic_dataset.url, num_epochs=2, shuffle_row_groups=False,
                         workers_count=2, memory_cache_size_bytes=cache_bytes) as r:
            rows = {}
            for row in r:
                rows.setdefault(int(row.id), []).append(row)
        return rows
    cached, plain = read(1 << 30), read(None)
    assert sorted(cached) == sorted(plain) == list(range(100))
    for rid, copies in cached.items():
        for a in copies:
            b = plain[rid][0]
            np.testing.assert_array_equal(a.image_png, b.image_png)
            np.testing.assert_array_equal(a.matrix, b.matrix)
            np.testing.assert_array_equal(a.varlen, b.varlen)
            assert a.partition_key == b.partition_key and a.decimal_col == b.decimal_col


def test_cache_hits_are_mutation_isolated(synthetic_dataset):
    with make_reader(synthetic_dataset.url, num_epochs=2, shuffle_row_groups=False,
                     reader_pool_type="dummy", memory_cache_size_bytes=1 << 30) as r:
        it = iter(r)
        first = next(it)
        first.matrix[:] = -1.0
        rows = {int(row.id): row for row in it}
        assert r.telemetry.snapshot()["counters"]["cache.mem.hits"] > 0
    np.testing.assert_array_equal(rows[int(first.id)].matrix,
                                  synthetic_dataset.rows[int(first.id)]["matrix"])


def test_lazy_and_ngram_readers_through_the_cache_equal_jax(synthetic_dataset):
    from petastorm_tpu.ngram import NGram as JaxNGram
    from petastorm_tpu_torch.ngram import NGram
    kw = dict(reader_pool_type="dummy", shuffle_row_groups=False, num_epochs=2,
              memory_cache_size_bytes=1 << 30)
    with make_reader(synthetic_dataset.url, schema_fields=["id", "matrix"],
                     row_materialization="lazy", **kw) as r:
        lazy = [int(row.id) for row in r]
    assert lazy == list(range(100)) * 2
    windows = []
    for factory, ngram_class, extra in ((jax_make_reader, JaxNGram, {}),
                                        (make_reader, NGram, {})):
        ngram = ngram_class({0: ["id", "matrix"], 1: ["id", "matrix"]}, delta_threshold=1,
                            timestamp_field="id", dense=True)
        with factory(synthetic_dataset.url, schema_fields=ngram, **kw, **extra) as r:
            windows.append([(w["id"].tolist(), w["matrix"].tolist()) for w in r])
    same(windows)
    assert len(windows[1]) == 2 * 90


def test_quarantined_rowgroup_never_enters_the_cache(synthetic_dataset):
    plan = FaultPlan([FaultSpec(site="rowgroup.read", kind="corruption", rate=1.0,
                                key_substring="00000")])
    with make_reader(synthetic_dataset.url, num_epochs=2, shuffle_row_groups=False,
                     workers_count=2, memory_cache_size_bytes=1 << 30, degraded_mode=True,
                     fault_plan=plan) as r:
        ids = sorted({int(row.id) for row in r})
        report = r.quarantine_report()
        keys = r._cache.keys()
    assert report["quarantined"] > 0 and keys
    assert all("00000" not in k.split(":")[1] for k in keys)
    assert len(ids) < 100


def test_cache_fill_fault_in_degraded_mode_as_jax(synthetic_dataset):
    """One injected fill fault: the guard reads the group again, and no
    entry ever held a faulted fill."""
    import petastorm_tpu.resilience as jres
    import petastorm_tpu_torch.resilience as tres
    runs = []
    for factory, r, extra in ((jax_make_reader, jres, {}),
                              (make_reader, tres, {})):
        plan = r.FaultPlan([r.FaultSpec(site="cache.fill", at=1)])
        with factory(synthetic_dataset.url, shuffle_row_groups=False, reader_pool_type="dummy",
                     memory_cache_size_bytes=1 << 30, degraded_mode=True, fault_plan=plan,
                     **extra) as reader:
            ids = [int(row.id) for row in reader]
            counters = reader.telemetry.snapshot()["counters"]
            runs.append((ids, reader.quarantine_report()["quarantined"],
                         len(reader._cache.keys()), counters["cache.mem.misses"],
                         counters["resilience.retries_total"]))
    assert same(runs) == (list(range(100)), 0, 10, 11, 1)


def test_predicate_with_a_cache_warns_as_jax(synthetic_dataset):
    from petastorm_tpu_torch.predicates import in_lambda
    with pytest.warns(UserWarning, match="bypasses row-group caching"):
        with make_reader(synthetic_dataset.url, reader_pool_type="dummy",
                         predicate=in_lambda(["id"], lambda v: v["id"] < 50),
                         memory_cache_size_bytes=1 << 20) as r:
            n = sum(1 for _ in r)
    assert n == 50


def test_autotune_reader_registers_its_knobs(synthetic_dataset):
    cfg = tauto.AutotuneConfig(interval_s=0.02)
    with make_reader(synthetic_dataset.url, num_epochs=2, shuffle_row_groups=False,
                     workers_count=2, autotune=True, autotune_config=cfg) as r:
        assert set(r.autotune.actuator_values()) == {"worker_concurrency", "ventilate_ahead"}
        n = sum(1 for _ in r)
        deadline = time.monotonic() + 5
        while r.telemetry.snapshot()["counters"]["autotune.ticks_total"] < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        report = r.autotune_report()
    assert n == 200 and set(report) == {"ticks", "actuators", "adjustments"}
    for adj in report["adjustments"]:
        rng = report["actuators"][adj["actuator"]]
        assert rng["lo"] <= adj["new"] <= rng["hi"]
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy") as r:
        assert r.autotune is None and r.autotune_report() == {}
        assert "autotune.ticks_total" not in r.telemetry.snapshot()["counters"]
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy", autotune=True) as r:
        assert set(r.autotune.actuator_values()) == {"ventilate_ahead"}
        sum(1 for _ in r)


def test_placement_refused_by_the_reader(synthetic_dataset, scalar_dataset, monkeypatch,
                                         tmp_path):
    """The name is kept from when the readers refused placement: both
    packages' readers now register a placement actuator, and its request
    migrates the pool thread -> process -> thread mid-epoch with every id
    delivered once, the same multiset in both packages."""
    monkeypatch.setenv("PETASTORM_TPU_PLAN_CACHE", str(tmp_path))
    for kind in ("row", "batch"):
        _placement_parity(synthetic_dataset.url if kind == "row" else scalar_dataset.url, kind)


def _placement_parity(url, kind):
    runs = []
    for factory, cfg in (((make_reader, tauto.AutotuneConfig), (jax_make_reader,
                                                               jauto.AutotuneConfig))
                         if kind == "row" else
                         ((make_batch_reader, tauto.AutotuneConfig),
                          (jax_make_batch_reader, jauto.AutotuneConfig))):
        with factory(url, workers_count=2, seed=6, autotune=True,
                     autotune_config=cfg(placement=True, interval_s=60)) as r:
            act = r.autotune.actuator("placement")
            ids, backends = [], []
            for n, item in enumerate(r, start=1):
                ids += [int(i) for i in np.atleast_1d(item.id)]
                backends.append(r.diagnostics["pool_type"])
                if n in ((20, 60) if kind == "row" else (2, 6)):
                    act.set(1 - act.value)   # knob-ok: the test drives the actuator
            runs.append((sorted(ids), act.applied, r.telemetry.snapshot()["counters"]
                         ["autotune.placement_migrations"], "process" in backends))
    assert runs[0] == runs[1] == (list(range(100)), True, 2, True)


def test_private_cache_budget_is_not_the_pressure_signal(synthetic_dataset):
    cfg = tauto.AutotuneConfig(interval_s=60)
    with make_reader(synthetic_dataset.url, num_epochs=2, shuffle_row_groups=False,
                     workers_count=2, autotune=True, autotune_config=cfg,
                     memory_cache_size_bytes=200_000) as r:
        assert r.autotune.budget is None
        sum(1 for _ in r)
        before = r.autotune.actuator_values()
        assert all(r.autotune.tick() != "memory_pressure" for _ in range(10))
        assert r.autotune.actuator_values() == before


def test_shared_budget_engages_memory_pressure(synthetic_dataset):
    cfg = tauto.AutotuneConfig(interval_s=60, hysteresis=1, cooldown_ticks=0,
                               memory_budget_bytes=1_000_000)
    with make_reader(synthetic_dataset.url, num_epochs=2, shuffle_row_groups=False,
                     reader_pool_type="dummy", autotune=True, autotune_config=cfg,
                     memory_cache_size_bytes=500_000, readahead_depth=2) as r:
        budget = r.autotune.budget
        assert budget.capacity == 1_000_000
        assert r._cache.budget is budget and r.readahead.budget is budget
        sum(1 for _ in r)
        assert budget.used > 0
        budget.reserve(budget.capacity - budget.used - 1, force=True)
        sh = r.autotune.register(_fake_actuator(tauto, "shuffle_target", 10, 1000, 1000))
        assert r.autotune.tick() == "memory_pressure" and sh.value == 500


def test_process_reader_warns_of_private_caches_and_ignores_readahead(synthetic_dataset):
    with pytest.warns(UserWarning) as caught:
        reader = make_reader(synthetic_dataset.url, schema_fields=["id"],
                             reader_pool_type="process", workers_count=1, num_epochs=2,
                             shuffle_row_groups=False, memory_cache_size_bytes=1 << 30,
                             readahead_depth=4)
    with reader:
        ids = sorted(int(s.id) for s in reader)
        assert reader.readahead is None and reader.readahead_report() == {}
    messages = " ".join(str(w.message) for w in caught)
    assert "PRIVATE cache" in messages and "readahead_depth" in messages
    assert ids == sorted(list(range(100)) * 2)


def test_ring_capacity_follows_the_budget():
    from petastorm_tpu_torch.reader import (MAX_RING_CAPACITY, MIN_RING_CAPACITY,
                                            _ring_capacity_from_budget)
    from petastorm_tpu.reader import _ring_capacity_from_budget as jax_ring
    for budget in (None, 1 << 20, 512 << 20, 64 << 30):
        cfg = tauto.AutotuneConfig(memory_budget_bytes=budget)
        want = _ring_capacity_from_budget(cfg, 4)
        assert want == (None if budget is None else jax_ring(cfg, 4))
    assert _ring_capacity_from_budget(tauto.AutotuneConfig(memory_budget_bytes=1), 4) \
        == MIN_RING_CAPACITY
    assert _ring_capacity_from_budget(tauto.AutotuneConfig(memory_budget_bytes=1 << 40), 4) \
        == MAX_RING_CAPACITY


# -------------------------------------------------------------------- knobs
def test_ventilator_knob():
    from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator
    got = []
    vent = ConcurrentVentilator(lambda **kw: got.append(kw["i"]), [{"i": i} for i in range(6)],
                                max_ventilation_queue_size=2)
    vent.start()
    deadline = time.monotonic() + 5
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    assert got == [0, 1]          # the cap holds
    vent.set_max_inflight(5)      # knob-ok: the setter under test
    while len(got) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got == [0, 1, 2, 3, 4] and vent.max_inflight == 5
    vent.set_max_inflight(0)      # knob-ok: the setter's floor
    assert vent.max_inflight == 1
    vent.stop()


def test_row_buffer_target_knob_equal_jax():
    from petastorm_tpu.reader_impl.shuffling_buffer import RandomShufflingBuffer as JaxBuffer
    from petastorm_tpu_torch.reader_impl.shuffling_buffer import RandomShufflingBuffer
    out = []
    for cls in (JaxBuffer, RandomShufflingBuffer):
        buf = cls(100, min_after_retrieve=10, extra_capacity=50, seed=0)
        caps = [buf.min_target]
        for n in (50, 5, 999):
            buf.set_target_capacity(n)  # knob-ok: the setter under test
            caps.append(buf.capacity)
        buf.add_many(list(range(99)))
        buf.set_target_capacity(20)  # knob-ok: a shrink between can_add and a bulk add
        buf.add_many(list(range(40)))
        caps += [buf.size, buf.can_add, [buf.retrieve() for _ in range(5)]]
        out.append(caps)
    assert same(out)[:4] == [11, 50, 11, 100]


def test_batched_buffer_target_knob_equal_jax():
    from petastorm_tpu.jax.batched_buffer import BatchedRandomShufflingBuffer as JaxBuffer
    from petastorm_tpu_torch.loader.batched_buffer import BatchedRandomShufflingBuffer
    out = []
    for cls in (JaxBuffer, BatchedRandomShufflingBuffer):
        buf = cls(100, min_after_retrieve=10, batch_size=5, extra_capacity=20, seed=0)
        caps = [buf.min_target]
        buf.set_target_capacity(2)     # knob-ok: the setter under test
        caps.append(buf.capacity)
        buf.add_many({"x": np.arange(10)})
        buf.set_target_capacity(400)   # knob-ok: a grow after a shrink
        caps.append(buf.capacity)
        while buf.can_add:
            buf.add_many({"x": np.arange(10)})
        caps += [buf.size, buf.retrieve()["x"].tolist()]
        tight = cls(100, min_after_retrieve=98, batch_size=16, seed=0)
        tight.set_target_capacity(50)  # knob-ok: the configured bound wins
        caps.append(tight.capacity)
        out.append(caps)
    assert same(out)[:3] == [15, 15, 100] and out[1][-1] == 100


def test_lazy_buffer_target_knob_equal_jax():
    from petastorm_tpu.reader_impl.shuffling_buffer import BatchShufflingBuffer as JaxBuffer
    from petastorm_tpu_torch.reader_impl.shuffling_buffer import BatchShufflingBuffer
    out = []
    for cls in (JaxBuffer, BatchShufflingBuffer):
        buf = cls(100, min_after_retrieve=10, seed=0)
        caps = [buf.min_target]
        for n in (50, 3, 500):
            buf.set_target_capacity(n)  # knob-ok: the setter under test
            caps.append(buf.capacity)
        out.append(caps)
    same(out)


def test_loaders_register_their_knobs_while_they_run(synthetic_dataset, scalar_dataset):
    from petastorm_tpu_torch.loader import BatchedDataLoader, DataLoader
    cfg = tauto.AutotuneConfig(interval_s=60)
    with make_reader(synthetic_dataset.url, num_epochs=None, schema_fields=["id", "matrix"],
                     shuffle_row_groups=False, workers_count=2, autotune=True,
                     autotune_config=cfg) as r:
        loader = DataLoader(r, batch_size=10, shuffling_queue_capacity=40,
                            min_after_retrieve=20, seed=0, device="cpu", prefetch=2)
        it = iter(loader)
        for _ in range(5):
            next(it)
        act = r.autotune.actuator("prefetch_depth")
        assert (act.lo, act.hi, act.value) == (1, 8, 2)
        assert r.autotune.actuator("shuffle_target").lo == 21
        assert act.set(8) == 8 and loader.prefetch_depth == 8
        assert r.telemetry.snapshot()["gauges"]["loader.prefetch_queue_capacity"] == 8
        for _ in range(20):
            next(it)
        it.close()
        assert r.autotune.actuator("prefetch_depth") is None
        assert r.autotune.actuator("shuffle_target") is None
    with make_batch_reader(scalar_dataset.url, num_epochs=1, workers_count=2, autotune=True,
                           autotune_config=cfg) as r:
        loader = BatchedDataLoader(r, batch_size=10, shuffling_queue_capacity=40, seed=0,
                                   device="cpu")
        it = iter(loader)
        next(it)
        assert r.autotune.actuator("shuffle_target") is not None
        it.close()


@pytest.mark.parametrize("depths", [(1, 8), (4, 1), (2, 6, 1, 3)])
def test_prefetch_depth_changes_keep_the_batches(synthetic_dataset, depths):
    """The depth moved mid-epoch (through the actuator) leaves the batches
    equal to a loader that was never tuned."""
    from petastorm_tpu_torch.loader import DataLoader

    def batches(moves):
        kw = dict(schema_fields=["id", "matrix"], shuffle_row_groups=True, seed=2,
                  workers_count=2)
        with make_reader(synthetic_dataset.url, **kw) as r:
            loader = DataLoader(r, batch_size=8, device="cpu", prefetch=2)
            act = tauto.PrefetchDepthActuator(loader, hi=8)
            out = []
            for i, b in enumerate(loader):
                if moves and i % 3 == 0 and i // 3 < len(moves):
                    act.set(moves[i // 3])
                out.append((b["id"].tolist(), b["matrix"].numpy().tobytes()))
        return out
    assert batches(depths) == batches(())


def test_port_sets_no_knob_outside_its_autotune_package():
    files = sorted(str(p) for p in (REPO / "petastorm_tpu_torch").rglob("*.py")
                   if "autotune" not in p.relative_to(REPO / "petastorm_tpu_torch").parts)
    assert len(files) > 50
    done = subprocess.run([sys.executable, str(REPO / "tools" / "check_knobs.py"), *files],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "check_knobs: ok" in done.stdout
