"""The port's live appending datasets (``petastorm_tpu_torch.discovery``,
``utils/growth.py``, the grown ``EpochPlan`` and ventilator, the readers'
``refresh_interval_s``, ``refresh_dataset``, ``dataset_growth_report``,
manifest cursors and ``reset()`` rebase, ``MeshDataLoader.admit_growth`` and
the mixer's registry) held to the JAX package's on the CPU: the cases of
``tests/test_live_data.py`` run through both packages, each on its own copy
of the same seeded store and the same appends. Ids, ordinals, segments,
cursors and the reports' keys and deterministic values compare exactly; a
JAX cursor resumes in the port and the port's in the JAX reader; the
lookup plane sees appended keys as the JAX reader's does; and
``tools/check_listing.py`` finds no raw listing in the port outside its
discovery package."""
import os
import random
import shutil
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.discovery as jdisc
import petastorm_tpu.index as jidx
import petastorm_tpu.resilience as jres
import petastorm_tpu_torch.discovery as tdisc
import petastorm_tpu_torch.index as tidx
import petastorm_tpu_torch.resilience as tres
from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxContext
from petastorm_tpu.etl.dataset_metadata import load_row_groups as jax_load_row_groups
from petastorm_tpu.jax import MeshDataLoader as JaxMeshDataLoader
from petastorm_tpu.jax import MeshReaderFactory as JaxMeshReaderFactory
from petastorm_tpu.predicates import in_range as jax_in_range
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.reader_impl.epoch_plan import EpochPlan as JaxEpochPlan
from petastorm_tpu.telemetry import make_registry as jax_registry
from petastorm_tpu.utils.growth import GrowthSchedule as JaxGrowthSchedule
from petastorm_tpu.weighted_sampling_reader import WeightedSamplingReader as JaxMixer
from petastorm_tpu.workers_pool.ventilator import ConcurrentVentilator as JaxVentilator
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, load_row_groups
from petastorm_tpu_torch.loader import MeshDataLoader, MeshReaderFactory
from petastorm_tpu_torch.predicates import in_range
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.reader_impl.epoch_plan import EpochPlan
from petastorm_tpu_torch.telemetry import make_registry
from petastorm_tpu_torch.utils.growth import GrowthSchedule
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader
from petastorm_tpu_torch.workers_pool.ventilator import ConcurrentVentilator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(
    name="jax", disc=jdisc, res=jres, idx=jidx, Context=JaxContext,
    load_row_groups=jax_load_row_groups, make_reader=jax_make_reader,
    make_batch_reader=jax_make_batch_reader, EpochPlan=JaxEpochPlan,
    Ventilator=JaxVentilator, registry=jax_registry, Schedule=JaxGrowthSchedule,
    Mixer=JaxMixer, in_range=jax_in_range,
    mesh=lambda url, **kw: JaxMeshDataLoader(JaxMeshReaderFactory(url, batched=True), **kw))
PORT = types.SimpleNamespace(
    name="port", disc=tdisc, res=tres, idx=tidx, Context=DatasetContext,
    load_row_groups=load_row_groups, make_reader=make_reader,
    make_batch_reader=make_batch_reader, EpochPlan=EpochPlan,
    Ventilator=ConcurrentVentilator, registry=make_registry, Schedule=GrowthSchedule,
    Mixer=WeightedSamplingReader, in_range=in_range,
    mesh=lambda url, **kw: MeshDataLoader(MeshReaderFactory(url, batched=True), device="cpu",
                                          **kw))


def both(fn):
    """``fn(pkg)`` for the JAX package, then the port."""
    return [fn(JAX), fn(PORT)]


def same(pair):
    jax_value, port_value = pair
    assert port_value == jax_value
    return port_value


# ---------------------------------------------------------------- helpers
def write_scalar_file(path, start, rows=20, row_group_size=10, id_type=None, extra_col=False):
    cols = {"id": pa.array(np.arange(start, start + rows), type=id_type or pa.int64()),
            "val": pa.array(np.arange(start, start + rows, dtype=np.float64))}
    if extra_col:
        cols["extra"] = pa.array(np.zeros(rows))
    pq.write_table(pa.table(cols), path, row_group_size=row_group_size)


@pytest.fixture()
def stores(tmp_path):
    """A store per package (a: ids 0-19, b: ids 20-39, groups of 10), the
    same bytes; ``stores[pkg.name]`` is its root."""
    roots = {}
    for name in ("jax", "port"):
        root = str(tmp_path / f"live_{name}")
        os.makedirs(root)
        write_scalar_file(f"{root}/a.parquet", 0)
        write_scalar_file(f"{root}/b.parquet", 20)
        roots[name] = root
    return roots


def batch_ids(batch):
    return tuple(int(x) for x in batch.id)


def drain_ids(it, n=None):
    out = []
    for batch in it:
        out.append(batch_ids(batch))
        if n is not None and len(out) >= n:
            break
    return out


def live_kw(**kw):
    """The deterministic live reader of the JAX tests."""
    base = dict(reader_pool_type="dummy", num_epochs=3, shuffle_row_groups=True, seed=7,
                sample_order="deterministic", refresh_interval_s=0)
    base.update(kw)
    return base


def report_shape(report: dict) -> dict:
    """A growth report's keys and its deterministic values (the watcher's
    clocks, wall times and file stats left out)."""
    out = {"keys": sorted(report), "applied": report.get("applied"),
           "items": report.get("items"), "enabled": report.get("enabled")}
    disc = report.get("discovery")
    if disc is not None:
        out["discovery_keys"] = sorted(disc)
        out["counts"] = {k: disc[k] for k in ("polls", "failed_polls", "snapshot_id",
                                               "files_known", "row_groups_known")}
        out["pending"] = sorted((os.path.basename(a["path"]), a["state"]) for a in disc["pending"])
        out["refused"] = sorted((os.path.basename(a["path"]), a["state"], a["drift"])
                                for a in disc["refused"])
        out["admissions"] = [(os.path.basename(a["path"]), a["row_groups"], a["drift"],
                              a["attempts"]) for a in disc["admissions"]]
    return out


# ---------------------------------------------------------- schema drift
@pytest.mark.parametrize("case", ["identical", "added", "changed", "missing"])
def test_classify_schema_drift_equal_jax(case):
    base = pa.schema([("id", pa.int64()), ("val", pa.float64())])
    cand = {"identical": base,
            "added": pa.schema([("id", pa.int64()), ("val", pa.float64()),
                                ("extra", pa.float64())]),
            "changed": pa.schema([("id", pa.float32()), ("val", pa.float64())]),
            "missing": pa.schema([("id", pa.int64())])}[case]
    kind, detail = same(both(lambda p: p.disc.classify_schema_drift(base, cand)))
    assert kind == {"identical": "identical", "added": "compatible", "changed": "incompatible",
                    "missing": "incompatible"}[case]
    assert detail == "" if case == "identical" else detail


# -------------------------------------------------------------- snapshots
def test_snapshot_ordinals_and_manifest_roundtrip_equal_jax():
    def run(p):
        FileEntry = p.disc.FileEntry
        snap = p.disc.DatasetSnapshot([FileEntry("/d/a.parquet", 3, 0),
                                       FileEntry("/d/b.parquet", 2, 3)])
        grown = snap.extended([("/d/c.parquet", 4, 1.0, 100)])
        manifest = grown.manifest("/d")
        rebuilt = p.disc.DatasetSnapshot.from_manifest(manifest, "/d")
        return (snap.total_row_groups, grown.total_row_groups, grown.snapshot_id,
                grown.files[-1].first_ordinal, list(grown.files[-1].ordinals), manifest,
                [f.first_ordinal for f in rebuilt.files], "/d/c.parquet" in grown, len(grown))
    assert same(both(run))[:2] == (5, 9)


def test_snapshot_from_row_groups_equal_jax(stores):
    def run(p):
        ctx = p.Context(f"file://{stores['port']}")
        snap = p.disc.DatasetSnapshot.from_row_groups(p.load_row_groups(ctx))
        return [(os.path.basename(f.path), f.num_row_groups, f.first_ordinal) for f in snap.files]
    assert same(both(run)) == [("a.parquet", 2, 0), ("b.parquet", 2, 2)]


@pytest.mark.parametrize("bad", ["non-contiguous", "duplicate"])
def test_snapshot_refuses_as_jax(bad):
    def run(p):
        with pytest.raises(ValueError) as e:
            if bad == "non-contiguous":
                p.disc.DatasetSnapshot([p.disc.FileEntry("/d/a", 3, 1)])
            else:
                p.disc.DatasetSnapshot([p.disc.FileEntry("/d/a", 3, 0)]).extended(
                    [("/d/a", 1, 0.0, -1)])
        return str(e.value)
    same(both(run))


# ---------------------------------------------------- the growth schedule
@pytest.mark.parametrize("steps", [
    [], [(2, 7)], [(1, 5), (3, 9)], [(0, 6)], [(2, 6), (2, 8)], [(3, 6), (1, 8)],
    [(4, 4)], [(1, 5), (5, 5), (6, 12)]])
def test_growth_schedule_equal_jax(steps):
    def run(p):
        sched = p.Schedule.base(4)
        landed = [sched.extend(e, n) for e, n in steps]
        return (landed, sched.segments, sched.final_size, sched.last_epoch, sched.grown,
                [sched.size_at(e) for e in range(10)], [sched.cum_items(e) for e in range(10)],
                [sched.slot(i) for i in range(60)])
    same(both(run))


@pytest.mark.parametrize("bad", ["shrink", "strict", "empty", "order"])
def test_growth_schedule_refuses_as_jax(bad):
    def run(p):
        with pytest.raises(ValueError) as e:
            if bad == "shrink":
                p.Schedule.base(4).extend(1, 3)
            elif bad == "strict":
                s = p.Schedule([(0, 4), (3, 6)])
                s.extend(1, 8, strict=True)
            elif bad == "empty":
                p.Schedule([])
            else:
                p.Schedule([(2, 4), (1, 6)])
        return str(e.value)
    same(both(run))


def test_growth_schedule_rebase_equal_jax():
    def run(p):
        s = p.Schedule([(0, 4), (2, 7), (5, 9)])
        s.rebase()
        return s.segments, s.size_at(0), s.grown
    assert same(both(run)) == ([(0, 9)], 9, False)


# --------------------------------------------------------- the epoch plan
def test_epoch_plan_growth_segments_equal_jax():
    def run(p):
        plan = p.EpochPlan(seed=5, num_items=4, shuffled=True)
        plan.extend(2, 7)
        round_trip = []
        for consumed in range(20):
            e, r, k = plan.cursor_fields(consumed)
            round_trip.append(plan.consumed_from_cursor(e, r, k) == consumed)
        return ([plan.num_items_at(e) for e in range(5)], [plan.cum_items(e) for e in range(5)],
                [plan.slot_epoch(c) for c in range(20)], [plan.permutation(e) for e in range(4)],
                all(round_trip), plan.describe())
    got = same(both(run))
    order = list(range(7))
    random.Random(5 + 2).shuffle(order)
    assert got[0] == [4, 4, 7, 7, 7] and got[3][2] == order


def test_epoch_plan_growth_validation_and_describe_equal_jax():
    def run(p):
        plan = p.EpochPlan(seed=1, num_items=4)
        errors = []
        for args in ((1, 3), (2, 6), (1, 8)):
            try:
                plan.extend(*args)
            except ValueError as e:
                errors.append(str(e))
        plan.extend(2, 9)
        before = (plan.growth_segments, plan.describe())
        plan.rebase()
        return (errors, before, plan.growth_segments, plan.num_items,
                "growth" in p.EpochPlan(seed=1, num_items=4).describe())
    errors, before, after, items, plain_growth = same(both(run))
    assert before == ([(0, 4), (2, 9)], {"version": 1, "seed": 1, "items": 4, "shuffled": False,
                                         "window": 0, "growth": [[2, 9]]})
    assert (after, items, plain_growth, len(errors)) == ([(0, 9)], 9, False, 2)


@pytest.mark.parametrize("window,growth", [(2, [(1, 6)]), (3, [(1, 5), (3, 9)]),
                                           (4, [(2, 10)])])
def test_epoch_plan_window_needed_linear_across_growth_equal_jax(window, growth):
    def run(p):
        plan = p.EpochPlan(seed=3, num_items=4, window=window, growth=growth)
        total = plan.cum_items(5)
        return [plan.needed_linear(c) for c in range(total)], total
    linear, total = same(both(run))
    assert sorted(linear) == list(range(total))


# -------------------------------------------------------- the ventilator
def _ventilated(p, items, growth_first, **kw):
    seen = []
    v = p.Ventilator(lambda **k: seen.append(k["i"]), [{"i": i} for i in range(items)],
                     item_context_key="ctx", **kw)
    effective = [v.extend_items([{"i": 10 + j}]) for j in range(growth_first)]
    segments = v.growth_segments
    v.start()
    deadline = time.monotonic() + 10
    credited = 0
    while not v.completed() and time.monotonic() < deadline:
        if len(seen) > credited:
            v.processed_item()
            credited += 1
        time.sleep(0.001)
    v.stop()
    return effective, segments, seen


def test_ventilator_extend_items_before_start_equal_jax():
    got = same(both(lambda p: _ventilated(p, 3, 1, iterations=3)))
    effective, segments, seen = got
    assert effective == [0] and segments == [(0, 4)] and len(seen) == 12
    assert seen[:4].count(10) == 1


def test_ventilator_growth_orders_epochs_of_their_sizes_equal_jax():
    """A resumed grown table: epoch 0 ventilates 2 items, epochs 1+ 3, each
    shuffled over its own items."""
    def run(p):
        seen = []
        v = p.Ventilator(lambda **k: seen.append((k["ctx"], k["i"])),
                         [{"i": i} for i in range(3)], iterations=4, item_context_key="ctx",
                         randomize_item_order=True, random_seed=9,
                         growth_segments=[(0, 2), (1, 3)])
        v.start()
        deadline = time.monotonic() + 10
        while not v.completed() and time.monotonic() < deadline:
            if seen:
                v.processed_item()
            time.sleep(0.001)
        v.stop()
        return seen
    seen = same(both(run))
    assert len(seen) == 2 + 3 * 3


def test_ventilator_growth_watermark_and_state_equal_jax():
    def run(p):
        v = p.Ventilator(lambda **k: None, [{"i": i} for i in range(3)], iterations=None,
                         item_context_key="ctx", growth_segments=[(0, 2), (1, 3)])
        states = []
        for ctx in ((0, 0), (0, 1), (1, 0), (1, 2), (1, 1)):
            v.processed_item(item_context=ctx)
            states.append((v.state["epoch"], v.state["offset"]))
        return states
    assert same(both(run)) == [(0, 1), (1, 0), (1, 1), (1, 1), (2, 0)]


def test_ventilator_extend_clamps_past_resumed_growth_segment_equal_jax():
    def run(p):
        v = p.Ventilator(lambda **k: None, [{"i": i} for i in range(4)], iterations=None,
                         start_epoch=1, item_context_key="ctx", growth_segments=[(0, 2), (3, 4)])
        effective = v.extend_items([{"i": 99}])
        plan = p.EpochPlan(seed=1, num_items=2, growth=[(3, 4)])
        plan.extend(effective, 5)
        return effective, v.growth_segments, plan.growth_segments, v.extend_items([])
    assert same(both(run)) == (3, [(0, 2), (3, 5)], [(0, 2), (3, 5)], 3)


@pytest.mark.parametrize("segments", [[(0, 2), (1, 4)], [(0, 4), (1, 3)], [(1, 3)]])
def test_ventilator_growth_segments_validated_as_jax(segments):
    def run(p):
        with pytest.raises(ValueError) as e:
            p.Ventilator(lambda **k: None, [{"i": i} for i in range(3)],
                         growth_segments=segments)
        return str(e.value)
    same(both(run))


def test_ventilator_rebase_growth_equal_jax():
    def run(p):
        v = p.Ventilator(lambda **k: None, [{"i": i} for i in range(3)], iterations=1,
                         growth_segments=[(0, 2), (1, 3)])
        with pytest.raises(RuntimeError):
            v.rebase_growth()
        v.start()
        deadline = time.monotonic() + 10
        while not v.completed() and time.monotonic() < deadline:
            v.processed_item()
            time.sleep(0.001)
        v.rebase_growth()
        return v.growth_segments
    assert same(both(run)) == [(0, 3)]


# --------------------------------------------------------------- listing
def test_list_data_files_retries_injected_ioerrors_equal_jax(stores):
    def run(p):
        ctx = p.Context(f"file://{stores['port']}")
        telemetry = p.registry()
        plan = p.res.FaultPlan([p.res.FaultSpec("discovery.list", "ioerror", at=1, times=2)],
                               seed=0)
        files = p.disc.list_data_files(ctx.filesystem, stores["port"], fault_plan=plan,
                                       telemetry=telemetry)
        counters = telemetry.snapshot()["counters"]
        return ([os.path.basename(f) for f in files], counters["discovery.list_retries_total"],
                counters["discovery.list_failures_total"],
                telemetry.snapshot()["histograms"]["discovery.list_s"]["count"])
    assert same(both(run)) == (["a.parquet", "b.parquet"], 1, 0, 1)


def test_list_data_files_gives_up_and_counts_as_jax(stores):
    def run(p):
        ctx = p.Context(f"file://{stores['port']}")
        telemetry = p.registry()
        plan = p.res.FaultPlan([p.res.FaultSpec("discovery.list", "ioerror", rate=1.0)], seed=0)
        with pytest.raises(IOError):
            p.disc.list_data_files(ctx.filesystem, stores["port"], fault_plan=plan,
                                   telemetry=telemetry,
                                   retry_policy=p.res.RetryPolicy(
                                       max_attempts=3, backoff=p.res.ExponentialBackoff(
                                           base=0.0, multiplier=1.0, cap=0.0),
                                       jitter="none", seed=0))
        counters = telemetry.snapshot()["counters"]
        return counters["discovery.list_failures_total"], counters["discovery.list_retries_total"]
    assert same(both(run)) == (1, 2)


@pytest.mark.parametrize("name", ["_metadata", "_common_metadata", ".hidden", "x.crc",
                                  "part-0.parquet", "part-1.parq", "noext"])
def test_is_data_file_and_sidecar_filter_equal_jax(stores, name):
    root = stores["port"]
    with open(f"{root}/{name}", "wb") as f:
        f.write(b"x")

    def run(p):
        ctx = p.Context(f"file://{root}")
        return (p.disc.is_data_file(f"{root}/{name}"),
                [os.path.basename(f) for f in p.disc.list_data_files(ctx.filesystem, root)])
    keep, listed = same(both(run))
    assert (name in listed) == keep
    assert keep == (name in ("part-0.parquet", "part-1.parq", "noext"))


def test_plan_time_listing_goes_through_list_data_files(stores, monkeypatch):
    """``DatasetContext.file_paths()`` lists through the discovery plane, as
    the JAX package's does, so a flaky store's listing is retried."""
    from petastorm_tpu_torch.discovery import listing
    calls = []
    real = listing.list_data_files
    monkeypatch.setattr(listing, "list_data_files",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    import petastorm_tpu_torch.etl.dataset_metadata as md
    monkeypatch.setattr(md, "list_data_files", listing.list_data_files)
    ctx = DatasetContext(f"file://{stores['port']}")
    assert [os.path.basename(f) for f in ctx.file_paths()] == ["a.parquet", "b.parquet"]
    assert calls == [stores["port"]]
    assert ctx.file_paths() == JaxContext(f"file://{stores['port']}").file_paths()


# --------------------------------------------------------------- watcher
def _watcher(p, root, **kwargs):
    ctx = p.Context(f"file://{root}")
    snap = p.disc.DatasetSnapshot.from_row_groups(p.load_row_groups(ctx))
    kwargs.setdefault("reference_schema", ctx.arrow_schema())
    kwargs.setdefault("telemetry", p.registry())
    return p.disc.DatasetWatcher(ctx, base_snapshot=snap, **kwargs)


def _summary(s):
    return {k: s[k] for k in ("ok", "listed", "new", "admitted", "pending", "refused")
            if k in s}


def test_watcher_torn_footer_pending_then_admitted_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        telemetry = p.registry()
        quarantine = p.res.RowGroupQuarantine(telemetry=telemetry)
        watcher = _watcher(p, root, telemetry=telemetry, quarantine=quarantine)
        with open(f"{root}/new.parquet", "wb") as f:
            f.write(b"PAR1 torn half-written footer")
        first = _summary(watcher.poll_once())
        pending = [a["state"] for a in watcher.report()["pending"]]
        by_state = dict(quarantine.report()["by_state"])
        write_scalar_file(f"{root}/new.parquet", 100)
        second = _summary(watcher.poll_once())
        growth = watcher.has_growth
        staged = [(os.path.basename(a.path), a.num_row_groups, a.drift)
                  for a in watcher.drain_staged()]
        counters = telemetry.snapshot()["counters"]
        return (first, pending, by_state, second, growth, staged,
                watcher.snapshot.total_row_groups, quarantine.report()["by_state"],
                {k: v for k, v in counters.items() if k.startswith("discovery.files")},
                sorted(telemetry.snapshot()["gauges"]))
    got = same(both(run))
    assert got[2] == {"pending_retry": 1} and got[7] == {"admitted_after_retry": 1}
    assert got[5] == [("new.parquet", 2, "identical")] and got[6] == 6


def test_watcher_incompatible_drift_refused_then_revalidated_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        watcher = _watcher(p, root)
        write_scalar_file(f"{root}/drift.parquet", 50, id_type=pa.float32())
        with pytest.warns(UserWarning, match="incompatible schema drift"):
            first = _summary(watcher.poll_once())
        again = _summary(watcher.poll_once())
        refused = [(os.path.basename(a["path"]), a["drift"]) for a in watcher.report()["refused"]]
        time.sleep(0.02)
        write_scalar_file(f"{root}/drift.parquet", 50, rows=30)
        fixed = _summary(watcher.poll_once())
        return first, again, refused, fixed, watcher.report()["refused"], watcher.has_growth
    got = same(both(run))
    assert got[0]["refused"] == 1 and got[1]["refused"] == 0 and got[3]["admitted"] == 1


def test_watcher_compatible_drift_admitted_with_warning_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        watcher = _watcher(p, root)
        write_scalar_file(f"{root}/extra.parquet", 60, extra_col=True)
        with pytest.warns(UserWarning, match="compatible schema drift"):
            summary = _summary(watcher.poll_once())
        staged = watcher.drain_staged()[0]
        return summary, staged.drift, staged.detail
    assert same(both(run))[1] == "compatible"


def test_watcher_listing_failure_keeps_snapshot_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        plan = p.res.FaultPlan([p.res.FaultSpec("discovery.list", "ioerror", rate=1.0)], seed=0)
        policy = p.res.RetryPolicy(max_attempts=2, backoff=p.res.ExponentialBackoff(
            base=0.0, multiplier=1.0, cap=0.0), jitter="none", seed=0)
        watcher = _watcher(p, root, fault_plan=plan, retry_policy=policy)
        write_scalar_file(f"{root}/c.parquet", 40)
        summary = watcher.poll_once()
        return (summary["ok"], watcher.has_growth, watcher.snapshot.total_row_groups,
                watcher.report()["failed_polls"], watcher.report()["polls"])
    assert same(both(run)) == (False, False, 4, 1, 1)


def test_watcher_validation_stats_ride_admission_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        watcher = _watcher(p, root, stats_columns=("id",))
        write_scalar_file(f"{root}/c.parquet", 200)
        watcher.poll_once()
        stats = watcher.drain_staged()[0].stats
        return [(s["id"].min, s["id"].max, s["id"].null_count, s["id"].has_min_max)
                for s in stats]
    assert same(both(run)) == [(200, 209, 0, True), (210, 219, 0, True)]


def test_watcher_background_thread_and_report_keys_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        telemetry = p.registry()
        watcher = _watcher(p, root, poll_interval_s=0.02, telemetry=telemetry)
        with pytest.raises(ValueError):
            _watcher(p, root).start()
        watcher.start()
        write_scalar_file(f"{root}/c.parquet", 40)
        deadline = time.monotonic() + 10
        while not watcher.has_growth and time.monotonic() < deadline:
            time.sleep(0.01)
        watcher.stop()
        report = watcher.report()
        gauges = telemetry.snapshot()["gauges"]
        return (watcher.has_growth, sorted(report), report["max_admission_lag_s"] < 10,
                sorted(k for k in gauges if k.startswith("discovery.")))
    got = same(both(run))
    assert got[0] and {"discovery.ingest_lag_s", "discovery.max_admission_lag_s",
                       "discovery.snapshot_age_s", "discovery.files_pending"} <= set(got[3])


# --------------------------------------------------------- kwarg checks
@pytest.mark.parametrize("case,match", [
    ("subset", "rowgroup_subset"), ("shard_seed", "shard_seed"), ("negative", ">= 0"),
    ("multi", "single dataset root")])
def test_refresh_kwarg_checks_as_jax(stores, case, match):
    url = f"file://{stores['port']}"
    kw = {"subset": dict(refresh_interval_s=1.0, rowgroup_subset=[0], shuffle_row_groups=False),
          "shard_seed": dict(refresh_interval_s=1.0, shard_seed=3, cur_shard=0, shard_count=2),
          "negative": dict(refresh_interval_s=-1.0),
          "multi": dict(refresh_interval_s=1.0)}[case]
    target = [url, url] if case == "multi" else url

    def run(p):
        with pytest.raises(ValueError, match=match) as e:
            p.make_batch_reader(target, **kw)
        return str(e.value)
    same(both(run))


def test_refresh_dataset_needs_refresh_interval_and_report_off_as_jax(stores):
    def run(p):
        with p.make_batch_reader(f"file://{stores[p.name]}", reader_pool_type="dummy") as r:
            with pytest.raises(RuntimeError, match="refresh_interval_s"):
                r.refresh_dataset()
            return r.dataset_growth_report(), "manifest" in r.state_dict()
    assert same(both(run)) == ({"enabled": False}, False)


# ------------------------------------------------ determinism under growth
def test_pre_refresh_epoch_byte_identical_equal_jax(stores, tmp_path):
    def epoch0(p, root, append):
        with p.make_batch_reader(f"file://{root}", **live_kw(num_epochs=2, seed=11)) as r:
            it = iter(r)
            first = [batch_ids(next(it))]
            if append:
                write_scalar_file(f"{root}/c.parquet", 40)
                assert r.refresh_dataset()["applied"]
            first += [batch_ids(next(it)) for _ in range(3)]
            return first

    control = str(tmp_path / "control")
    shutil.copytree(stores["port"], control)
    grown = same(both(lambda p: epoch0(p, stores[p.name], True)))
    assert grown == epoch0(PORT, control, False)
    assert {x for b in grown for x in b} == set(range(40))


def _manifest_resume(p, root, pool, growth_epoch, workers_count=3, num_epochs=3, seed=11):
    """The whole stream from epoch 0 of a hand-built manifest cursor whose
    growth batch (c.parquet) is effective from ``growth_epoch``."""
    manifest = {"base": [["a.parquet", 2], ["b.parquet", 2]],
                "growth": [{"epoch": growth_epoch, "files": [["c.parquet", 2]], "items": 2}]}
    resume = {"epoch": 0, "offset": 0, "items": 6, "seed": seed,
              "sample_order": "deterministic", "window": 0, "window_delivered": 0,
              "skipped_ordinals": [], "manifest": manifest,
              "plan": {"version": 1, "seed": seed, "items": 4, "shuffled": True, "window": 0,
                       "growth": [[growth_epoch, 6]]}}
    with p.make_batch_reader(f"file://{root}", **live_kw(reader_pool_type=pool,
                                                         workers_count=workers_count,
                                                         num_epochs=num_epochs, seed=seed,
                                                         resume_state=resume)) as r:
        return drain_ids(iter(r))


@pytest.mark.parametrize("pool,growth_epoch", [("dummy", 1), ("thread", 1), ("process", 1),
                                               ("dummy", 2), ("thread", 2)])
def test_growth_epoch_equals_the_jax_readers_stream(stores, pool, growth_epoch):
    """The epoch after an admission delivers the old and new groups as a
    function of (seed, epoch, grown plan): the port's stream on each pool
    equals the JAX reader's own."""
    for root in stores.values():
        write_scalar_file(f"{root}/c.parquet", 40)
    want = _manifest_resume(JAX, stores["jax"], "dummy", growth_epoch)
    got = _manifest_resume(PORT, stores["port"], pool, growth_epoch,
                           workers_count=2 if pool == "process" else 3)
    assert got == want
    sizes = [4 if e < growth_epoch else 6 for e in range(3)]
    assert len(got) == sum(sizes)
    assert {x for b in got[:sizes[0]] for x in b} == set(range(40 if growth_epoch else 60))
    assert {x for b in got[-6:] for x in b} == set(range(60))


def test_checkpoint_resume_across_refresh_boundary_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", **live_kw()) as r:
            it = iter(r)
            for _ in range(3):
                next(it)
            cursor = r.state_dict()
            write_scalar_file(f"{root}/c.parquet", 40)
            r.refresh_dataset()
            applied = r.dataset_growth_report()["applied"]
            remainder = drain_ids(it)
            post = r.state_dict()
        with p.make_batch_reader(f"file://{root}", **live_kw(resume_state=cursor)) as r2:
            it2 = iter(r2)
            r2.refresh_dataset()
            again = drain_ids(it2)
        return cursor, applied, remainder, post, again
    cursor, applied, remainder, post, again = same(both(run))
    assert cursor["manifest"]["growth"] == [] and applied[0]["items"] == 2
    assert post["manifest"]["growth"] and remainder == again


def test_resume_post_growth_manifest_cursor_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", **live_kw()) as r:
            it = iter(r)
            next(it)
            write_scalar_file(f"{root}/c.parquet", 40)
            r.refresh_dataset()
            for _ in range(4):
                next(it)
            cursor = r.state_dict()
            remainder = drain_ids(it)
        with p.make_batch_reader(f"file://{root}", **live_kw(resume_state=cursor)) as r2:
            again = drain_ids(iter(r2))
        return cursor, remainder, again
    cursor, remainder, again = same(both(run))
    assert cursor["manifest"]["growth"] and remainder == again


@pytest.mark.parametrize("direction", ["jax cursor into the port", "port cursor into jax"])
def test_manifest_cursors_cross_between_packages(stores, direction):
    """A live cursor saved by one package resumes in the other with the same
    remaining ids, before and after the growth."""
    src, dst = (JAX, PORT) if direction.startswith("jax") else (PORT, JAX)
    for root in stores.values():
        write_scalar_file(f"{root}/c.parquet", 40)
    with src.make_batch_reader(f"file://{stores[src.name]}", **live_kw(num_epochs=4)) as r:
        it = iter(r)
        for _ in range(2):
            next(it)
        write_scalar_file(f"{stores[src.name]}/d.parquet", 60)
        r.refresh_dataset()
        for _ in range(5):
            next(it)
        cursor = r.state_dict()
        want = drain_ids(it)
    assert cursor["manifest"]["growth"][0]["files"] == [["d.parquet", 2]]
    # The other package's store gets d.parquet as the cursor saw it.
    write_scalar_file(f"{stores[dst.name]}/d.parquet", 60)
    with dst.make_batch_reader(f"file://{stores[dst.name]}",
                               **live_kw(num_epochs=4, resume_state=cursor)) as r2:
        got = drain_ids(iter(r2))
        again = r2.state_dict()
    assert got == want and again["manifest"] == cursor["manifest"]


@pytest.mark.parametrize("items", [3, 1])
def test_resume_growth_batch_count_mismatch_as_jax(stores, items):
    def run(p):
        root = stores[p.name]
        write_scalar_file(f"{root}/c.parquet", 40)
        manifest = {"base": [["a.parquet", 2], ["b.parquet", 2]],
                    "growth": [{"epoch": 1, "files": [["c.parquet", 2]], "items": items}]}
        resume = {"epoch": 0, "offset": 0, "items": 4 + items, "seed": 11,
                  "sample_order": "deterministic", "window": 0, "window_delivered": 0,
                  "skipped_ordinals": [], "manifest": manifest,
                  "plan": {"version": 1, "seed": 11, "items": 4, "shuffled": True,
                           "window": 0, "growth": [[1, 4 + items]]}}
        with pytest.raises(ValueError, match="growth batch") as e:
            p.make_batch_reader(f"file://{root}", **live_kw(seed=11, resume_state=resume))
        return str(e.value)
    same(both(run))


def test_manifest_cursor_refuses_shard_seed_as_jax(stores):
    def run(p):
        resume = {"epoch": 0, "offset": 0, "items": 4, "seed": 1,
                  "manifest": {"base": [["a.parquet", 2], ["b.parquet", 2]], "growth": []}}
        with pytest.raises(ValueError, match="shard_seed") as e:
            p.make_batch_reader(f"file://{stores[p.name]}", reader_pool_type="dummy",
                                shuffle_row_groups=False, cur_shard=0, shard_count=2,
                                shard_seed=3, resume_state=resume)
        return str(e.value)
    same(both(run))


# ---------------------------------------------------- fault-drill epochs
def test_appended_corrupt_file_epoch_completes_pending_retry_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=None,
                                 shuffle_row_groups=False, refresh_interval_s=0) as r:
            it = iter(r)
            ids = [batch_ids(next(it)) for _ in range(2)]
            with open(f"{root}/torn.parquet", "wb") as f:
                f.write(b"PAR1 not parquet")
            r.refresh_dataset()
            pending = [a["state"] for a in r.dataset_growth_report()["discovery"]["pending"]]
            first = dict(r.quarantine_report()["by_state"])
            ids += [batch_ids(next(it)) for _ in range(4)]
            write_scalar_file(f"{root}/torn.parquet", 100)
            r.refresh_dataset()
            after = (r.dataset_growth_report()["discovery"]["pending"],
                     r.quarantine_report()["by_state"])
            new = []
            for _ in range(12):
                new.append(batch_ids(next(it)))
            return ids, pending, first, after, new, report_shape(r.dataset_growth_report())
    ids, pending, first, after, new, shape = same(both(run))
    assert pending == ["pending_retry"] and first == {"pending_retry": 1}
    assert {x for b in ids for x in b} == set(range(40))
    assert after == ([], {"admitted_after_retry": 1})
    assert any(100 in b for b in new)


def test_incompatible_drift_degrades_to_last_good_snapshot_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=None,
                                 shuffle_row_groups=False, refresh_interval_s=0) as r:
            it = iter(r)
            next(it)
            write_scalar_file(f"{root}/bad.parquet", 99, id_type=pa.float32())
            with pytest.warns(UserWarning, match="incompatible schema drift"):
                r.refresh_dataset()
            shape = report_shape(r.dataset_growth_report())
            ids = {x for _ in range(6) for x in batch_ids(next(it))}
            return shape, ids, r.telemetry.snapshot()["counters"]["discovery.files_refused"]
    shape, ids, refused = same(both(run))
    assert len(shape["refused"]) == 1 and not shape["applied"]
    assert ids <= set(range(40)) and refused == 1


def test_listing_ioerrors_retry_no_crash_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        plan = p.res.FaultPlan([p.res.FaultSpec("discovery.list", "ioerror", at=1)], seed=0)
        with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=None,
                                 shuffle_row_groups=False, fault_plan=plan,
                                 refresh_interval_s=0) as r:
            it = iter(r)
            next(it)
            write_scalar_file(f"{root}/c.parquet", 40)
            r.refresh_dataset()
            counters = r.telemetry.snapshot()["counters"]
            return (report_shape(r.dataset_growth_report()),
                    counters["discovery.list_retries_total"],
                    counters["discovery.files_admitted"], counters["discovery.items_extended"])
    shape, retries, admitted, extended = same(both(run))
    assert shape["applied"] and retries > 0 and (admitted, extended) == (1, 2)


def test_background_poll_admits_and_tracks_lag(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=None,
                                 shuffle_row_groups=False, refresh_interval_s=0.05) as r:
            it = iter(r)
            next(it)
            write_scalar_file(f"{root}/c.parquet", 40)
            deadline = time.monotonic() + 15
            grew = False
            while time.monotonic() < deadline and not grew:
                grew = 40 in batch_ids(next(it))
            gauges = r.telemetry.snapshot()["gauges"]
            disc = r.dataset_growth_report()["discovery"]
            return (grew, gauges["discovery.ingest_lag_s"] < 15,
                    gauges["discovery.snapshot_age_s"] < 15, disc["max_admission_lag_s"] < 15,
                    r.dataset_growth_report()["refresh_interval_s"])
    assert same(both(run)) == (True, True, True, True, 0.05)


# ------------------------------------------------------------ row reader
def test_make_reader_growth_with_petastorm_store_equal_jax(tmp_path):
    from dataset_utils import create_test_dataset

    def run(p):
        base = tmp_path / p.name
        url = f"file://{base}/ds"
        create_test_dataset(url, num_rows=40, rows_per_row_group=10)
        create_test_dataset(f"file://{base}/donor", num_rows=60, rows_per_row_group=10, seed=9)
        donor = sorted(f for f in os.listdir(f"{base}/donor") if f.endswith(".parquet"))
        with p.make_reader(url, reader_pool_type="dummy", num_epochs=3, seed=3,
                           sample_order="deterministic", refresh_interval_s=0,
                           schema_fields=["id"]) as r:
            it = iter(r)
            first = [int(next(it).id) for _ in range(10)]
            shutil.copy(f"{base}/donor/{donor[-1]}", f"{base}/ds/zz-appended.parquet")
            applied = r.refresh_dataset()["applied"]
            rest = [int(row.id) for row in it]
        return first, [(b["epoch"], b["files"], b["items"]) for b in applied], rest
    first, applied, rest = same(both(run))
    assert set(first) <= set(range(40)) and applied[0][1] == [["zz-appended.parquet", 2]]
    assert set(rest) - set(range(40)), "appended rows never served"


# ---------------------------------------------------------- reset rebase
def test_reset_rebases_growth_into_new_pass_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", **live_kw(num_epochs=1, seed=5,
                                                             shuffle_row_groups=False)) as r:
            first = drain_ids(iter(r))
            write_scalar_file(f"{root}/c.parquet", 40)
            r.reset()
            second = drain_ids(iter(r))
            return first, second, r.state_dict()["manifest"], report_shape(
                r.dataset_growth_report())
    first, second, manifest, shape = same(both(run))
    assert len(first) == 4 and len(second) == 6
    assert {x for b in second for x in b} == set(range(60))
    assert ["c.parquet", 2] in manifest["base"] and manifest["growth"] == []


def test_reset_rebases_manifest_resume_without_discovery_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        write_scalar_file(f"{root}/c.parquet", 40)
        manifest = {"base": [["a.parquet", 2], ["b.parquet", 2]],
                    "growth": [{"epoch": 2, "files": [["c.parquet", 2]], "items": 2}]}
        resume = {"epoch": 0, "offset": 0, "items": 6, "seed": 11,
                  "sample_order": "deterministic", "window": 0, "window_delivered": 0,
                  "skipped_ordinals": [], "manifest": manifest,
                  "plan": {"version": 1, "seed": 11, "items": 4, "shuffled": True, "window": 0,
                           "growth": [[2, 6]]}}
        with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=1,
                                 shuffle_row_groups=True, seed=11,
                                 sample_order="deterministic", resume_state=resume) as r:
            first = drain_ids(iter(r))
            report = report_shape(r.dataset_growth_report())
            r.reset()
            second = drain_ids(iter(r))
        return first, report, second
    first, report, second = same(both(run))
    assert len(first) == 4 and report["enabled"] is False and report["applied"]
    assert len(second) == 6 and {x for b in second for x in b} == set(range(60))


# --------------------------------------------- growth composes with knobs
def test_growth_respects_sharding_stream_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        write_scalar_file(f"{root}/c.parquet", 40)
        streams = {}
        for shard in (0, 1):
            os.rename(f"{root}/c.parquet", f"{root}/.c")
            with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy",
                                     num_epochs=None, shuffle_row_groups=False, cur_shard=shard,
                                     shard_count=2, refresh_interval_s=0) as r:
                it = iter(r)
                ids = [batch_ids(next(it))]
                os.rename(f"{root}/.c", f"{root}/c.parquet")
                applied = r.refresh_dataset()["applied"]
                for _ in range(14):
                    ids.append(batch_ids(next(it)))
                streams[shard] = (ids, [(b["items"], b["row_groups"]) for b in applied])
        return streams
    streams = same(both(run))
    new = set(range(40, 60))
    s0 = {x for b in streams[0][0] for x in b}
    s1 = {x for b in streams[1][0] for x in b}
    assert streams[0][1] == streams[1][1] == [(1, 2)]
    assert s0 & new and s1 & new and not (s0 & s1 & new)


def test_growth_prunes_new_footers_incrementally_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        with p.make_batch_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=None,
                                 shuffle_row_groups=False, predicate=p.in_range("id", 0, 45),
                                 refresh_interval_s=0) as r:
            it = iter(r)
            next(it)
            write_scalar_file(f"{root}/c.parquet", 40)
            before = r.telemetry.snapshot()["counters"].get("io.rowgroups_pruned", 0)
            r.refresh_dataset()
            applied = r.dataset_growth_report()["applied"][0]
            after = r.telemetry.snapshot()["counters"]["io.rowgroups_pruned"]
            pruning = r.pruning_report()
            ids = {x for _ in range(20) for x in batch_ids(next(it))}
            return (applied, after - before, pruning["row_groups_pruned"],
                    pruning["row_groups_kept"], sorted(ids))
    applied, delta, pruned, kept, ids = same(both(run))
    assert (applied["pruned"], applied["items"], delta) == (1, 1, 1)
    assert set(range(40, 45)) <= set(ids) and max(ids) < 50


# ------------------------------------------------------------------ mixer
def test_mixer_registry_and_report_equal_jax(stores, tmp_path):
    def run(p):
        other = str(tmp_path / f"other_{p.name}")
        os.makedirs(other)
        write_scalar_file(f"{other}/x.parquet", 1000)
        r1 = p.make_batch_reader(f"file://{stores[p.name]}", reader_pool_type="dummy",
                                 num_epochs=None, shuffle_row_groups=False)
        r2 = p.make_batch_reader(f"file://{other}", reader_pool_type="dummy", num_epochs=1,
                                 shuffle_row_groups=False)
        mixer = p.Mixer([r1, r2], [0.5, 0.5], seed=3)
        picks = []
        try:
            for _ in range(100):
                try:
                    picks.append(batch_ids(next(mixer)))
                except StopIteration:
                    break
            rep = mixer.report()
            snap = mixer.telemetry.snapshot()
        finally:
            mixer.stop()
            mixer.join()
        members = [{k: m[k] for k in ("index", "weight", "draws", "starved", "exhausted")}
                   for m in rep["members"]]
        return (picks, members, sorted(rep), snap["counters"],
                sorted(k for k in snap["gauges"] if k.startswith("mixer.")),
                all(m["lag_s"] >= 0 for m in rep["members"]))
    picks, members, keys, counters, gauges, lag_ok = same(both(run))
    assert members[1]["starved"] == 1 and members[1]["exhausted"]
    assert counters["mixer.m0.draws_total"] == members[0]["draws"]
    assert gauges == ["mixer.m0.lag_s", "mixer.m1.lag_s"] and lag_ok


def test_mixer_counters_keep_their_output():
    class Stub:
        schema, ngram, batched_output, last_row_consumed = "s", None, False, False

        def __init__(self, n):
            self.left = n

        def __next__(self):
            if not self.left:
                raise StopIteration
            self.left -= 1
            return self.left
    mixer = WeightedSamplingReader([Stub(3), Stub(50)], [0.5, 0.5], seed=1)
    with pytest.raises(StopIteration):
        for _ in range(100):
            next(mixer)
    counters = mixer.counters
    assert set(counters) == {f"mixer.m{i}.{k}" for i in (0, 1)
                             for k in ("draws_total", "starved_total", "lag_s")}
    assert counters["mixer.m0.starved_total"] == 1
    assert all(isinstance(counters[f"mixer.m{i}.draws_total"], int) for i in (0, 1))


# ------------------------------------------------------------ mesh growth
def _mesh_root(tmp_path, name, rows=64, group=8):
    root = str(tmp_path / name)
    os.makedirs(root)
    write_scalar_file(f"{root}/a.parquet", 0, rows=rows, row_group_size=group)
    return root


def test_mesh_admit_growth_future_epoch_equal_jax(tmp_path):
    def run(p):
        root = _mesh_root(tmp_path, f"mesh_{p.name}")
        loader = p.mesh(f"file://{root}", batch_size=16, num_epochs=3, seed=0, num_hosts=2)
        try:
            it = iter(loader)
            epoch0 = {int(x) for _ in range(4) for x in np.asarray(next(it)["id"])}
            write_scalar_file(f"{root}/b.parquet", 100, rows=32, row_group_size=8)
            result = loader.admit_growth(12)
            rest = sorted(int(x) for batch in it for x in np.asarray(batch["id"]))
            state = loader.state_dict()
            plans = [loader.epoch_plan(e) for e in range(4)]
            sizes = [loader._g_at(e) for e in range(4)]
        finally:
            loader.close()
        return epoch0, result, rest, state["num_rowgroups"], state["growth"], plans, sizes
    jax_run, port_run = both(run)
    # The effective epoch depends on how far the staging ran ahead: compare
    # the plans of each package's own schedule.
    for got in (jax_run, port_run):
        epoch0, result, rest, groups, growth, plans, sizes = got
        assert epoch0 == set(range(64)) and groups == 12
        assert result["admitted"] == 4 and result["folded"] == 0
        assert 1 <= result["effective_epoch"] <= 2 and growth[0] == [0, 8]
        assert set(range(100, 132)) <= set(rest)
        eff = result["effective_epoch"]
        assert sizes == [8 if e < eff else 12 for e in range(4)]
    if jax_run[1] == port_run[1]:
        assert jax_run[5] == port_run[5] and jax_run[2] == port_run[2]


def test_mesh_admit_growth_fold_into_live_epoch_equal_jax(tmp_path):
    def run(p):
        root = _mesh_root(tmp_path, f"meshfold_{p.name}", rows=256)
        loader = p.mesh(f"file://{root}", batch_size=16, num_epochs=1, seed=None, num_hosts=2,
                        host_queue_depth=1)
        try:
            it = iter(loader)
            seen = [int(x) for x in np.asarray(next(it)["id"])]
            write_scalar_file(f"{root}/b.parquet", 1000, rows=16, row_group_size=8)
            result = loader.admit_growth(34, fold_into_live_epoch=True)
            seen += [int(x) for batch in it for x in np.asarray(batch["id"])]
            counters = loader.telemetry.snapshot()["counters"]
            events = loader.telemetry.events("mesh.growth")
        finally:
            loader.close()
        return result, sorted(seen), counters["mesh.growth_admitted"], len(events)
    result, seen, admitted, events = same(both(run))
    assert result == {"admitted": 2, "effective_epoch": 1, "folded": 2}
    assert seen == sorted(list(range(256)) + list(range(1000, 1016)))
    assert admitted == 2 and events == 1


@pytest.mark.parametrize("case", ["growth table", "grown while down", "no growth table",
                                  "shrunk", "malformed"])
def test_mesh_growth_cursor_resume_equal_jax(tmp_path, case):
    def run(p):
        root = _mesh_root(tmp_path, f"meshres_{p.name}")
        state = {"mesh": True, "epoch": 1, "hosts": {"0": 0, "1": 0}, "num_rowgroups": 12,
                 "num_hosts": 2, "growth": [[0, 8], [1, 12]]}
        groups = 12
        if case == "grown while down":
            groups = 14
        elif case == "no growth table":
            state = {**state, "num_rowgroups": 8}
            del state["growth"]
        elif case == "shrunk":
            groups = 8
        elif case == "malformed":
            state = {**state, "growth": [[0, 8], [1, 10]]}
        if case in ("shrunk", "malformed"):
            with pytest.raises(ValueError) as e:
                p.mesh(f"file://{root}", batch_size=16, num_hosts=2, num_rowgroups=groups,
                       resume_state=state)
            return str(e.value)
        loader = p.mesh(f"file://{root}", batch_size=16, num_epochs=1, num_hosts=2,
                        num_rowgroups=groups, resume_state=state)
        try:
            return ([loader._g_at(e) for e in range(4)], loader._g_schedule.segments,
                    loader.epoch_plan(1), loader.epoch_plan(2))
        finally:
            loader.close()
    got = same(both(run))
    if case == "grown while down":
        assert got[0] == [8, 12, 14, 14]
    elif case == "no growth table":
        assert got[0] == [8, 8, 12, 12]


def test_mesh_admit_growth_on_resumed_loader_spares_cursor_epoch_equal_jax(tmp_path):
    def run(p):
        root = _mesh_root(tmp_path, f"meshres2_{p.name}")
        state = {"mesh": True, "epoch": 2, "hosts": {"0": 1, "1": 1}, "num_rowgroups": 8,
                 "num_hosts": 2}
        loader = p.mesh(f"file://{root}", batch_size=16, num_epochs=None, num_hosts=2, seed=3,
                        resume_state=state)
        try:
            result = loader.admit_growth(10)
            with pytest.raises(ValueError, match="monotonic"):
                loader.admit_growth(9)
            return result, loader._g_at(2), loader._g_at(3), loader.admit_growth(10)
        finally:
            loader.close()
    assert same(both(run)) == ({"admitted": 2, "effective_epoch": 3, "folded": 0}, 8, 10,
                               {"admitted": 0, "effective_epoch": None, "folded": 0})


def test_mesh_growth_cursor_resumes_with_the_jax_loaders_rows(tmp_path):
    """A cursor saved after growth by either loader resumes in the other with
    the same rows."""
    root = _mesh_root(tmp_path, "meshcross")
    loader = PORT.mesh(f"file://{root}", batch_size=16, num_epochs=2, seed=1, num_hosts=2)
    try:
        it = iter(loader)
        next(it)
        write_scalar_file(f"{root}/b.parquet", 100, rows=32, row_group_size=8)
        loader.admit_growth(12)
        for _ in range(5):
            next(it)
        state = loader.state_dict()
    finally:
        loader.close()
    assert state["growth"][0] == [0, 8]

    def rest(p):
        resumed = p.mesh(f"file://{root}", batch_size=16, num_epochs=2 - state["epoch"],
                         seed=1, num_hosts=2, resume_state=state)
        try:
            return sorted(int(x) for batch in resumed for x in np.asarray(batch["id"]))
        finally:
            resumed.close()
    assert same(both(rest))


# ------------------------------------------------------ the lookup plane
def test_lookup_plane_sees_appended_keys_after_refresh_equal_jax(stores):
    def run(p):
        root = stores[p.name]
        p.idx.build_field_index(f"file://{root}", ["id"])
        url = f"file://{root}"
        with p.make_batch_reader(url, reader_pool_type="dummy", num_epochs=2,
                                 refresh_interval_s=0) as reader:
            before = int(reader.lookup([27])[0]["id"])
            with pytest.raises(KeyError):
                reader.lookup([45])
            write_scalar_file(f"{root}/c.parquet", 40)
            applied = reader.refresh_dataset()["applied"]
            after = int(reader.lookup([45])[0]["id"])
            view = len(reader.dataset_view())
            growth_files = reader.telemetry.snapshot()["counters"]["index.growth_files_total"]
        # A plane made after the growth (here: the base files are newer than
        # the sidecar) reconciles too.
        with p.make_batch_reader(url, reader_pool_type="dummy", num_epochs=2,
                                 refresh_interval_s=0) as late:
            late.refresh_dataset()
            late_row = {k: np.asarray(v).tolist() for k, v in late.lookup([52])[0].items()}
            late_view = len(late.dataset_view())
        return before, len(applied), after, view, growth_files, late_row, late_view
    assert same(both(run))[:5] == (27, 1, 45, 60, 1)


# ----------------------------------------------------- the plan's node
def test_refresh_lowers_to_the_discovery_node_as_jax(stores):
    def run(p):
        with p.make_batch_reader(f"file://{stores[p.name]}", reader_pool_type="dummy",
                                 refresh_interval_s=0.5) as r:
            node = r._plan.operators["discovery"].to_dict()
            validated = r._plan.validated
        return ({k: node[k] for k in ("name", "layer", "placement", "kind", "capacity",
                                      "induced_by", "downstream")},
                [v for v in validated if v.startswith("refresh")])
    node, rules = same(both(run))
    assert node["placement"] == "background" and len(rules) == 2


# ------------------------------------------------------------ the lint
def test_check_listing_lint_is_clean_on_the_port_and_catches(tmp_path):
    lint = os.path.join(REPO, "tools", "check_listing.py")
    port = os.path.join(REPO, "petastorm_tpu_torch")
    files = [os.path.join(d, f) for d, _, names in os.walk(port)  # listing-ok: test scan
             for f in names if f.endswith(".py") and os.sep + "discovery" not in d]
    assert len(files) > 100
    proc = subprocess.run([sys.executable, lint, *files], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n\ndef f(d):\n    return os.listdir(d)\n")
    proc = subprocess.run([sys.executable, lint, *files, str(bad)], capture_output=True,
                          text=True)
    assert proc.returncode == 1 and "list_data_files" in proc.stderr


def test_refresh_from_another_thread_while_pulling_folds_each_file_once(stores):
    """A caller's ``refresh_dataset()`` on one thread and the consumer's
    safe point on another fold growth one at a time: every admitted file
    is planned once, its items counted once."""
    import threading
    root = stores["port"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with make_batch_reader(f"file://{root}", reader_pool_type="thread", workers_count=4,
                               num_epochs=None, shuffle_row_groups=True, seed=2,
                               sample_order="deterministic", refresh_interval_s=0.001) as r:
            it = iter(r)
            stop = threading.Event()
            errors = []

            def refresher():
                while not stop.is_set():
                    try:
                        r.refresh_dataset()
                    except Exception as e:  # noqa: BLE001 - the assertion reports it
                        errors.append(repr(e))
                        return
            threads = [threading.Thread(target=refresher) for _ in range(4)]
            for t in threads:
                t.start()
            try:
                for k in range(12):
                    write_scalar_file(f"{root}/g{k:02d}.parquet", 100 + 20 * k)
                    for _ in range(5):
                        next(it)
                deadline = time.monotonic() + 10
                while len(r.dataset_growth_report()["discovery"]["admissions"]) < 12 \
                        and time.monotonic() < deadline:
                    next(it)
                r.refresh_dataset()
            finally:
                stop.set()
                for t in threads:
                    t.join(10)
            report = r.dataset_growth_report()
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    files = [f for b in report["applied"] for f, _ in b["files"]]
    assert sorted(files) == [f"g{k:02d}.parquet" for k in range(12)]
    assert report["items"] == 4 + 2 * 12 == 4 + sum(b["items"] for b in report["applied"])


def test_selector_admits_growth_unpruned_with_a_one_time_warning_as_jax(tmp_path):
    """A ``rowgroup_selector``'s stored index cannot cover appended files:
    both packages warn once and plan the growth unpruned."""
    import petastorm_tpu.reader as jreader
    import petastorm_tpu.selectors as jsel
    import petastorm_tpu_torch.reader as treader
    import petastorm_tpu_torch.selectors as tsel
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("Sel", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                               UnischemaField("label", np.int64, (), ScalarCodec(np.int64),
                                              False)])

    def store(url, ids):
        with materialize_dataset_local(url, schema, rows_per_row_group=10) as w:
            for i in ids:
                w.write_row({"id": i, "label": i // 10})

    def run(p):
        base = tmp_path / p.name
        store(f"file://{base}/ds", range(40))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            build_rowgroup_index(f"file://{base}/ds", [SingleFieldIndexer("label_ix", "label")])
        store(f"file://{base}/donor", range(100, 120))
        donor = sorted(f for f in os.listdir(f"{base}/donor")  # listing-ok: test fixture
                       if f.endswith(".parquet"))[0]
        sel = (jsel if p is JAX else tsel).SingleIndexSelector("label_ix", [1, 2])
        (jreader if p is JAX else treader)._ONE_SHOT_WARNED.clear()
        kw = dict(reader_pool_type="dummy", num_epochs=None, shuffle_row_groups=False,
                  refresh_interval_s=0, rowgroup_selector=sel, schema_fields=["id"])
        with pytest.warns(UserWarning, match="WITHOUT selector pruning"):
            first = p.make_reader(f"file://{base}/ds", **kw)
        with first as r:
            it = iter(r)
            head = sorted(int(next(it).id) for _ in range(20))
            shutil.copy(f"{base}/donor/{donor}", f"{base}/ds/zz.parquet")
            applied = r.refresh_dataset()["applied"]
            rest = {int(next(it).id) for _ in range(200)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p.make_reader(f"file://{base}/ds", **kw).stop()
        return (head, [(b["files"], b["items"], b["pruned"]) for b in applied],
                sorted(rest), [str(w.message) for w in caught if "selector" in str(w.message)])
    head, applied, rest, again = same(both(run))
    assert head == list(range(10, 30)) and applied == [([["zz.parquet", 2]], 2, 0)]
    assert set(range(100, 120)) <= set(rest) and again == []

