"""The ops plane of petastorm_tpu_torch (timeline, anomaly bank, SLO watch,
postmortem black box, accounting, federation, the readers' and loaders'
wiring, the mesh rollup and the telemetry CLI), held against the JAX
package's on the same seeded inputs.

Equal ``metrics_view`` dicts at equal injected times give equal timeline
rings; equal window streams give equal detections; equal registries give
equal SLO violations, bundles, ledgers and rollups; each CLI reads the
other's files with equal exit codes and output. Waits are bounded and wait
on a condition.
"""
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np
import pytest

from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu import telemetry as jt
from petastorm_tpu.telemetry import accounting as jacct
from petastorm_tpu.telemetry import anomaly as janom
from petastorm_tpu.telemetry import postmortem as jpm
from petastorm_tpu.telemetry import slo as jslo
from petastorm_tpu.telemetry import timeseries as jts
from petastorm_tpu.telemetry.__main__ import main as jax_cli
from petastorm_tpu_torch import telemetry as tt
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.telemetry import accounting as tacct
from petastorm_tpu_torch.telemetry import anomaly as tanom
from petastorm_tpu_torch.telemetry import postmortem as tpm
from petastorm_tpu_torch.telemetry import slo as tslo
from petastorm_tpu_torch.telemetry import timeseries as tts
from petastorm_tpu_torch.telemetry.__main__ import main as torch_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jt, jts, janom, jslo, jpm, jacct), "torch": (tt, tts, tanom, tslo, tpm, tacct)}


@pytest.fixture(autouse=True)
def _reset_bundle_caps():
    """Both black boxes cap bundles a process: each test starts at zero."""
    jpm._process_bundle_count = tpm._process_bundle_count = 0
    yield
    jpm._process_bundle_count = tpm._process_bundle_count = 0


@pytest.fixture(scope="module")
def scalar_store(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = tmp_path_factory.mktemp("torch_ops_scalar")
    n = 2000
    pq.write_table(pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                             "v": pa.array(np.arange(n, dtype=np.float64))}),
                   str(path / "part0.parquet"), row_group_size=100)
    return f"file://{path}"


@pytest.fixture(scope="module")
def row_store(tmp_path_factory):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = f"file://{tmp_path_factory.mktemp('torch_ops_rows')}/ds"
    schema = Unischema("OpsRows", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("vec", np.float32, (4,), NdarrayCodec(), False)])
    rng = np.random.default_rng(7)
    with materialize_dataset_local(url, schema, rows_per_row_group=20) as w:
        for i in range(200):
            w.write_row({"id": i, "vec": rng.standard_normal(4).astype(np.float32)})
    return url


def _wait(cond, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def _view(counters=None, gauges=None, hists=None):
    return {"counters": dict(counters or {}), "gauges": dict(gauges or {}),
            "histograms": dict(hists or {})}


def _hist(pkg, values):
    h = pkg[0].StreamingHistogram()
    for v in values:
        h.observe(v)
    return h.as_dict()


# --------------------------------------------------------------- timeline
def _feed(pkg, scenario):
    """One timeline fed a seeded stream of metrics views at injected times."""
    ts = pkg[1]
    rng = np.random.default_rng({"rates": 1, "pool_family": 2, "ring": 3, "mesh": 4}[scenario])
    tl = ts.MetricsTimeline(interval_s=0.5, window_count=6 if scenario == "ring" else 120)
    t, rows, stall, busy, decode = 100.0, 0.0, 0.0, {}, []
    for step in range(14):
        t += 0.5 + float(rng.uniform(-0.05, 0.05))
        rows += float(rng.integers(0, 500))
        stall += float(rng.uniform(0, 0.7))
        decode.extend(float(x) for x in rng.exponential(0.01, size=int(rng.integers(1, 20))))
        counters = {"reader.rows": rows, "loader.samples": rows, "loader.delivery_wait_s": stall,
                    "io.bytes_read": rows * 64.0}
        if scenario == "rates" and step == 8:
            counters["reader.rows"] = 3.0   # a registry reset mid-run
            decode = decode[-2:]            # and its histograms drained
        if scenario == "pool_family":
            for w in range(3 if step < 6 else 4):   # worker 3 joins late
                busy[w] = busy.get(w, 0.0) + float(rng.uniform(0, 0.6))
                counters[f"pool.w{w}.busy_s"] = busy[w]
                counters[f"pool.w{w}.items"] = float(step * (w + 1))
        if scenario == "mesh":
            for h in range(3):
                counters[f"mesh.host{h}.rows"] = rows * (h + 1)
        gauges = {"ventilator.backlog": float(rng.integers(0, 9)),
                  "loader.input_stall_pct": None if step == 5 else float(rng.uniform(0, 40))}
        hists = {"worker.decode_s": _hist(pkg, decode),
                 "loader.host_wait_seconds": _hist(pkg, decode[-5:])}
        tl.sample(_view(counters, gauges, hists), now_s=t)
    return tl


@pytest.mark.parametrize("scenario", ["rates", "pool_family", "ring", "mesh"])
def test_timeline_rings_equal_jax(scenario):
    jax_tl, torch_tl = _feed(PKGS["jax"], scenario), _feed(PKGS["torch"], scenario)
    assert torch_tl.as_dict() == jax_tl.as_dict()
    assert torch_tl.series_names() == jax_tl.series_names()
    names = set(torch_tl.series_names())
    if scenario == "rates":
        assert {"rows_per_s", "stall_frac", "decode_p99_s", "input_stall_pct"} <= names
    if scenario == "pool_family":
        assert {"pool.utilization", "pool.w3.busy_frac", "pool.w0.items_per_s"} <= names
    if scenario == "ring":
        assert len(torch_tl.windows()) == 6 and torch_tl.as_dict()["windows_total"] == 13
    if scenario == "mesh":
        assert {"mesh.host0.rows_per_s", "mesh.host2.rows_per_s"} <= names
    rows_series = torch_tl.series("rows_per_s")
    assert rows_series == jax_tl.series("rows_per_s") and all(v >= 0 for v in rows_series)
    parts = [jax_tl.as_dict(last=3), jax_tl.as_dict()]
    assert tts.concat_timeline_dicts(parts) == jts.concat_timeline_dicts(parts)
    assert tts.render_sparkline(rows_series, width=10) == jts.render_sparkline(rows_series, 10)


@pytest.mark.parametrize("value", ["", "0.25", "1", "on", "off", "0", "-2", "garbage"])
def test_timeline_interval_from_env_equals_jax(value):
    env = {jts.TIMELINE_ENV: value}
    assert tts.timeline_interval_from_env(env) == jts.timeline_interval_from_env(env)
    assert tts.TIMELINE_ENV == jts.TIMELINE_ENV


@pytest.mark.parametrize("spec", [("x", "median", "a.b"), ("x", "rate", "a.*.*"),
                                  ("x", "util", "a.b"), ("x", "rate", "a.*"),
                                  ("x{}", "rate", "a.*")])
def test_series_spec_refusals_equal_jax(spec):
    outcomes = []
    for ts in (jts, tts):
        try:
            ts.SeriesSpec(*spec)
            outcomes.append("ok")
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]
    assert [(s.name, s.kind, s.metric) for s in tts.DEFAULT_SERIES] \
        == [(s.name, s.kind, s.metric) for s in jts.DEFAULT_SERIES]


def test_sampler_rides_the_snapshot_not_the_metrics_view():
    reg = tt.TelemetryRegistry()
    reg.counter("reader.rows").add(10)
    tl = tt.MetricsTimeline(interval_s=60.0)
    reg.timeline = tl
    sampler = tt.TimelineSampler(reg, tl, interval_s=60.0).start()
    reg.counter("reader.rows").add(5)
    sampler.stop()   # the terminal window
    assert len(tl.windows()) == 1 and tl.windows()[0]["series"]["rows_per_s"] > 0
    assert reg.snapshot()["timeline"] == tl.as_dict()
    assert "timeline" not in reg.metrics_view()
    assert reg.metrics_view()["counters"]["timeline.samples_total"] == 1
    assert set(reg.metrics_view()) == set(jt.TelemetryRegistry().metrics_view())


# ---------------------------------------------------------------- anomaly
def _windows(values, name="rows_per_s", interval=1.0):
    return {"interval_s": interval, "window_count": 120, "windows_total": len(values),
            "windows": [{"index": i, "t_s": (i + 1) * interval, "dt_s": interval,
                         "series": dict(v) if isinstance(v, dict) else {name: v}}
                        for i, v in enumerate(values)]}


ANOMALY_STREAMS = {
    "collapse": [1000.0] * 6 + [10.0, 5.0, 0.0] + [1000.0] * 4 + [0.0, 0.0],
    "collapse_single_gap": [1000.0] * 6 + [0.0] + [1000.0] * 5,
    "collapse_below_min_value": [30.0] * 8 + [0.0] * 3,
    "spike_persist": [{"stall_frac": 0.12 + 0.001 * i} for i in range(8)]
    + [{"stall_frac": 0.9}, {"stall_frac": 0.95}],
    "spike_single": [{"stall_frac": 0.12 + 0.001 * i} for i in range(8)]
    + [{"stall_frac": 0.9}, {"stall_frac": 0.12}],
    "slope": [{"ingest_lag_s": 1.0 + 0.9 * i} for i in range(8)],
    "slope_not_monotonic": [{"ingest_lag_s": v} for v in (1, 3, 2, 5, 7, 6, 9, 8)],
    "skew": [{"mesh.host0.rows_per_s": 1000.0, "mesh.host1.rows_per_s": 300.0}] * 6,
    "skew_transient": [{"mesh.host0.rows_per_s": 1000.0, "mesh.host1.rows_per_s": 300.0}] * 3
    + [{"mesh.host0.rows_per_s": 1000.0, "mesh.host1.rows_per_s": 950.0}] * 3,
}


@pytest.mark.parametrize("stream", sorted(ANOMALY_STREAMS))
def test_anomaly_banks_detect_what_jax_detects(stream):
    timeline = _windows(ANOMALY_STREAMS[stream])
    out = {}
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        reg = pkg[0].TelemetryRegistry()
        fired = []
        monitor = pkg[2].AnomalyMonitor(reg, on_detection=fired.append)
        for w in timeline["windows"]:
            monitor.observe_window(w)
        counters = reg.metrics_view()["counters"]
        out[name] = (monitor.report(), fired, counters,
                     {k: [e["payload"] for e in v] for k, v in reg.events().items()},
                     pkg[2].detect_over_timeline(timeline))
    assert out["torch"] == out["jax"]
    detected = {d["rule"] for d in out["torch"][1]}
    want = {"collapse": {"throughput_collapse"}, "spike_persist": {"stall_spike"},
            "slope": {"ingest_lag_growth"}, "skew": {"host_skew_divergence"}}
    assert detected == want.get(stream, set())


@pytest.mark.parametrize("kwargs", [dict(kind="drift"), dict(min_windows=1),
                                    dict(persist=0), dict()])
def test_anomaly_rule_refusals_equal_jax(kwargs):
    base = dict(name="r", series="rows_per_s", kind="collapse", threshold=0.1)
    outcomes = []
    for mod in (janom, tanom):
        try:
            mod.AnomalyRule(**dict(base, **kwargs))
            outcomes.append("ok")
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


# -------------------------------------------------------------------- SLO
SLO_SPECS = ["input_stall_pct<=1", "batch_p99_s<=0.5,quarantined<=0",
             "counter:resilience.worker_crashes<=0", "loader.input_stall_pct<=3",
             "gauge:ventilator.backlog<=4, rate:reader.rows<=1000", " , reshards<=2 ,"]
BAD_SLO_SPECS = ["input_stall_pct", "not_a_rule<=1", "input_stall_pct<=x", "median:a.b<=1"]


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_parse_rules_equals_jax(spec):
    as_tuples = lambda rules: [(r.name, r.kind, r.metric, r.max_value) for r in rules]
    assert as_tuples(tslo.parse_rules(spec)) == as_tuples(jslo.parse_rules(spec))
    assert as_tuples(tslo.DEFAULT_RULES) == as_tuples(jslo.DEFAULT_RULES)


@pytest.mark.parametrize("spec", BAD_SLO_SPECS)
def test_parse_rules_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jslo.parse_rules(spec)
    with pytest.raises(ValueError):
        tslo.parse_rules(spec)


def _slo_registry(pkg, rows, crashes):
    reg = pkg[0].TelemetryRegistry()
    reg.counter("reader.rows").add(rows)
    reg.counter("resilience.worker_crashes").add(crashes)
    reg.counter("resilience.quarantined_rowgroups").add(1)
    reg.gauge("loader.input_stall_pct").set(7.5)
    reg.gauge("ventilator.backlog").set(2)
    for v in (0.1, 0.2, 2.5):
        reg.histogram("loader.host_wait_seconds").observe(v)
    return reg


def test_slo_evaluation_and_watcher_equal_jax():
    rules_spec = "input_stall_pct<=5,batch_p99_s<=1,quarantined<=0,counter:resilience." \
                 "worker_crashes<=0,rate:reader.rows<=1000,gauge:ventilator.backlog<=4"
    out = {}
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        rules = pkg[3].parse_rules(rules_spec)
        prev = _slo_registry(pkg, 100, 0).metrics_view()
        reg = _slo_registry(pkg, 5100, 1)
        evaluated = pkg[3].evaluate_rules(reg.metrics_view(), rules, prev=prev, dt_s=2.0)
        entered = []
        watcher = pkg[3].SloWatcher(reg, rules, on_violation=entered.append)
        first, second = watcher.check_once(), watcher.check_once()
        report = watcher.report()
        out[name] = (evaluated, [v["rule"] for v in first], [v["rule"] for v in second],
                     [v["rule"] for v in entered], report,
                     [e["payload"] for e in reg.events("slo.violation")])
    assert out["torch"] == out["jax"]
    assert set(out["torch"][3]) == {"input_stall_pct", "batch_p99_s", "quarantined",
                                    "resilience.worker_crashes"}


# -------------------------------------------------------------- black box
def _bundle_registry(pkg):
    reg = pkg[0].TelemetryRegistry()
    reg.counter("trace.critical_path.decode").add(7)
    reg.counter("trace.critical_path.stage").add(2)
    reg.histogram("trace.self.decode_s").observe(0.02)
    reg.record_event("anomaly.throughput_collapse", {"value": 1})
    reg.record_event("slo.violation", {"rule": "quarantined", "value": 1.0})
    tl = pkg[1].MetricsTimeline(interval_s=1.0)
    reg.timeline = tl
    for i, rows in enumerate((0.0, 100.0, 250.0, 250.0)):
        tl.sample({"counters": {"reader.rows": rows}}, now_s=10.0 + i)
    reg.pipeline_id, reg.created_at = "p-fixed", 1.5e9
    return reg


def _write_bundles(pkg, directory):
    reg = _bundle_registry(pkg)
    box = pkg[4].BlackBox(str(directory), reg, label="reader", config={"workers_count": 3})
    box.add_collector("quarantine", lambda: {"quarantined": 1, "pieces": []})
    box.add_collector("broken", lambda: 1 / 0)
    box.add_collector("watchdog", lambda: {"hangs_detected": 0})
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        fatal = box.write_bundle("RuntimeError", exc=e)
    slo = box.write_bundle("slo_quarantined")
    return box, fatal, slo


def _normalised_bundle(path):
    bundle = jpm.load_bundle(path)
    bundle["manifest"].update(pid=0, unix_time_s=0.0)
    tb = bundle["manifest"]["error"]
    if tb:
        tb["traceback"] = re.sub(r"petastorm_tpu(_torch)?", "PKG", tb["traceback"])
    bundle["stacks"] = sorted(bundle["stacks"])   # thread names; frames differ
    bundle["reports"]["broken"] = "collector_error" in bundle["reports"]["broken"]
    return bundle


def test_bundles_equal_jax_after_normalising_times_pids_and_paths(tmp_path):
    jbox, jfatal, jslo_path = _write_bundles(PKGS["jax"], tmp_path / "jax")
    tbox, tfatal, tslo_path = _write_bundles(PKGS["torch"], tmp_path / "torch")
    assert sorted(tbox.bundles()) == sorted(jbox.bundles()) == ["RuntimeError", "slo_quarantined"]
    assert os.path.basename(tfatal) == os.path.basename(jfatal)
    for jp, tp in ((jfatal, tfatal), (jslo_path, tslo_path)):
        assert sorted(os.listdir(tp)) == sorted(os.listdir(jp))
        assert _normalised_bundle(tp) == _normalised_bundle(jp)


def test_render_report_gives_jax_text_on_both_packages_bundles(tmp_path):
    for pkg_name in ("jax", "torch"):
        _, fatal, slo = _write_bundles(PKGS[pkg_name], tmp_path / pkg_name)
        for path in (fatal, slo):
            bundle = jpm.load_bundle(path)
            assert tpm.load_bundle(path) == bundle
            text = tpm.render_report(bundle)
            assert text == jpm.render_report(bundle)
            assert "dominant edge: decode" in text and "rows_per_s" in text


def test_bundle_cap_and_latch_equal_jax(tmp_path):
    out = {}
    for name in ("jax", "torch"):
        pm = PKGS[name][4]
        box = pm.BlackBox(str(tmp_path / name), PKGS[name][0].TelemetryRegistry())
        first = box.write_bundle("slo_stall")
        again = box.write_bundle("slo_stall")
        rest = [box.write_bundle(f"r{i}") for i in range(12)]
        out[name] = (first == again, [os.path.basename(p) if p else None for p in rest],
                     pm._MAX_BUNDLES_PER_PROCESS)
    jax_out, torch_out = out["jax"], out["torch"]
    pid = str(os.getpid())
    assert [b.replace(pid, "PID") if b else b for b in torch_out[1]] \
        == [b.replace(pid, "PID") if b else b for b in jax_out[1]]
    assert torch_out[0] and torch_out[2] == jax_out[2] == 8
    assert sum(b is not None for b in torch_out[1]) == 7
    assert tpm.blackbox_dir_from_env({tpm.BLACKBOX_ENV: " /x "}) == "/x"
    assert tpm.blackbox_dir_from_env({}) is None


def test_load_bundle_refuses_a_directory_that_is_no_bundle(tmp_path):
    for pm in (jpm, tpm):
        with pytest.raises(OSError):
            pm.load_bundle(str(tmp_path / "nope"))


# ---------------------------------------------- accounting and federation
ACCOUNTING_VIEWS = {
    "reader": _view({"reader.rows": 500.0, "io.bytes_read": 4096.0, "cache.mem.hits": 3.0,
                     "io.readahead.hits": 2.0, "io.readahead.fetch_s": 0.25},
                    hists={"worker.decode_s": {"count": 2, "sum": 0.4}}),
    "loader_only": _view({"loader.samples": 64.0, "loader.bytes_staged": 1e6,
                          "trace.span.decode_s": 0.9}),
    "mesh": _view({"reader.rows": 10.0, "mesh.host_decode_s": 1.5,
                   "transport.zero_copy_bytes": 77.0},
                  hists={"worker.decode_s": {"count": 1, "sum": 0.2}}),
    "empty": _view(),
}


@pytest.mark.parametrize("source", sorted(ACCOUNTING_VIEWS))
def test_accounting_totals_equal_jax(source):
    view = ACCOUNTING_VIEWS[source]
    assert tacct.accounting_totals(view) == jacct.accounting_totals(view)
    assert tacct.ACCOUNTING_FIELDS == jacct.ACCOUNTING_FIELDS
    assert tacct.ACCOUNTING_SCHEMA_VERSION == jacct.ACCOUNTING_SCHEMA_VERSION


def test_ledgers_restarts_and_merges_equal_jax():
    stream = [("p1", "a", {"rows": 10, "bytes_read": 100}), ("p1", "a", {"rows": 25}),
              ("p2", None, {"rows": 7, "decode_s": 0.5}), ("p1", "a", {"rows": 4}),   # a reset
              ("p1", "a", {"rows": 9, "cache_hits": 2}), ("p2", None, {"rows": 7})]
    out = {}
    for name in ("jax", "torch"):
        mod = PKGS[name][5]
        ledger, second = mod.AccountingLedger(), mod.AccountingLedger()
        deltas = [ledger.apply(pid, tenant, totals, member=f"m-{pid}")
                  for pid, tenant, totals in stream]
        second.apply("p3", "a", {"rows": 5})
        restored = mod.AccountingLedger()
        restored.restore(ledger.dump())
        out[name] = (deltas, ledger.report(),
                     mod.merge_accounting_reports([ledger.report(), second.report(), None]),
                     restored.report())
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["tenants"]["a"]["rows"] == 25 + 4 + 5


def test_federation_equals_jax():
    snaps, timelines = {}, {}
    for i in range(3):
        reg = jt.TelemetryRegistry()
        reg.counter("reader.rows").add(100 * (i + 1))
        reg.gauge("loader.input_stall_pct").set(float(i))
        for v in (0.01 * (i + 1), 0.5):
            reg.histogram("worker.decode_s").observe(v)
        snaps[f"h{i}"] = reg.snapshot()
        values = [100.0 * (i + 1) + k for k in range(4 + i)]
        timelines[f"h{i}"] = _windows(values)
    assert tt.federate_snapshots(snaps) == jt.federate_snapshots(snaps)
    assert tt.federate_snapshots(snaps, key_label="tenant") \
        == jt.federate_snapshots(snaps, key_label="tenant")
    assert tt.federate_timelines(timelines, key_label="host") \
        == jt.federate_timelines(timelines, key_label="host")
    assert tt.federate_timelines({}) == jt.federate_timelines({})


# ----------------------------------------------------------- reader wiring
def _family(name: str) -> str:
    return re.sub(r"\.(w|host)\d+\.", r".\1*.", name)


def _read_all(reader):
    batched = reader.batched_output if hasattr(reader, "batched_output") \
        else reader.is_batched_reader
    if batched:
        return sum(len(b.id) for b in reader)
    return sum(1 for _ in reader)


@pytest.mark.parametrize("flavor", ["row", "batch"])
def test_reader_ops_plane_equals_jax(flavor, row_store, scalar_store):
    url = row_store if flavor == "row" else scalar_store
    make = {"row": (jax_make_reader, make_reader),
            "batch": (jax_make_batch_reader, make_batch_reader)}[flavor]
    kw = dict(workers_count=2, seed=3, sample_order="deterministic", num_epochs=1,
              timeline_interval_s=0.05, tenant="ops", rowgroup_pruning=False)
    out = {}
    for name, fn in zip(("jax", "torch"), make):
        with fn(url, **kw) as reader:
            rows = _read_all(reader)
        tl = reader.timeline_report()
        names = {_family(n) for w in tl["windows"] for n in w["series"]}
        acct = reader.accounting_report()
        out[name] = {"rows": rows, "names": names, "acct": acct,
                     "keys": {r: set(getattr(reader, r)()) for r in
                              ("timeline_report", "anomaly_report", "slo_report",
                               "accounting_report")}}
    jax_out, torch_out = out["jax"], out["torch"]
    assert torch_out["rows"] == jax_out["rows"] == (200 if flavor == "row" else 2000)
    assert torch_out["names"] == jax_out["names"]
    assert {"rows_per_s", "pool.utilization"} <= torch_out["names"]
    assert torch_out["keys"] == jax_out["keys"]
    for field in ("rows", "cache_hits"):
        assert torch_out["acct"]["totals"][field] == jax_out["acct"]["totals"][field]
    assert set(torch_out["acct"]["totals"]) == set(jax_out["acct"]["totals"])
    assert torch_out["acct"]["tenant"] == jax_out["acct"]["tenant"] == "ops"


def test_signatures_carry_the_jax_defaults():
    import inspect
    from petastorm_tpu.jax.loader import LoaderBase as JaxLoaderBase
    from petastorm_tpu.jax.mesh_loader import MeshDataLoader as JaxMesh
    from petastorm_tpu.reader import Reader as JaxReader
    from petastorm_tpu_torch.loader.loader import LoaderBase
    from petastorm_tpu_torch.loader.mesh_loader import MeshDataLoader
    from petastorm_tpu_torch.reader import Reader
    names = ("timeline_interval_s", "timeline_anomaly", "telemetry_publish", "tenant")
    for ours, theirs in ((make_reader, jax_make_reader), (make_batch_reader, jax_make_batch_reader)):
        a, b = inspect.signature(ours).parameters, inspect.signature(theirs).parameters
        assert [a[n].default for n in names] == [b[n].default for n in names]
    a, b = inspect.signature(MeshDataLoader).parameters, inspect.signature(JaxMesh).parameters
    assert [a[n].default for n in names if n != "timeline_anomaly"] \
        == [b[n].default for n in names if n != "timeline_anomaly"]
    for method in ("timeline_report", "anomaly_report", "slo_report", "accounting_report"):
        assert callable(getattr(Reader, method)) and callable(getattr(JaxReader, method))
    assert callable(LoaderBase.timeline_report) and callable(JaxLoaderBase.timeline_report)


def test_environment_variables_do_what_the_arguments_do(scalar_store, tmp_path, monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_TIMELINE", "0.05")
    monkeypatch.setenv("PETASTORM_TPU_SLO_WATCH", "1")
    monkeypatch.setenv("PETASTORM_TPU_BLACKBOX", str(tmp_path))
    kw = dict(workers_count=2, shuffle_row_groups=False, num_epochs=1, rowgroup_pruning=False)
    armed = {}
    for name, fn in (("jax", jax_make_batch_reader), ("torch", make_batch_reader)):
        with fn(scalar_store, **kw) as reader:
            _read_all(reader)
        armed[name] = (bool(reader.timeline_report()["windows"]),
                       reader.anomaly_monitor is not None, reader.slo_watcher is not None,
                       reader.blackbox is not None, sorted(reader.slo_report()))
    assert armed["torch"] == armed["jax"] == (True, True, True, True, sorted(armed["jax"][4]))
    # The publisher's variable (no aggregator listens: windows drop, counted).
    monkeypatch.setenv("PETASTORM_TPU_TELEMETRY_PUBLISH", f"ipc://{tmp_path}/none.sock")
    monkeypatch.delenv("PETASTORM_TPU_TIMELINE")
    t0 = time.perf_counter()
    with make_batch_reader(scalar_store, **kw) as reader:
        assert reader._telemetry_publisher is not None
        _read_all(reader)
    assert time.perf_counter() - t0 < 10.0
    assert reader.telemetry.metrics_view()["counters"]["fabric.send_errors"] >= 2
    assert reader._timeline is None and reader.timeline_report() == {}


def test_reader_fatal_and_slo_trip_write_jax_bundles(scalar_store, tmp_path, monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_SLO_WATCH", "quarantined<=0")
    reasons = {}
    for name, fn, res_mod in (("jax", jax_make_batch_reader, "petastorm_tpu.resilience"),
                              ("torch", make_batch_reader, "petastorm_tpu_torch.resilience")):
        monkeypatch.setenv("PETASTORM_TPU_BLACKBOX", str(tmp_path / name))
        res = __import__(res_mod, fromlist=["FaultPlan"])
        plan = lambda: res.FaultPlan([res.FaultSpec("rowgroup.read", "corruption", at=3,
                                                    worker=0)])
        kw = dict(workers_count=1, shuffle_row_groups=False, num_epochs=1,
                  rowgroup_pruning=False)
        reader = fn(scalar_store, fault_plan=plan(), **kw)
        with pytest.raises(res.InjectedCorruptionError):
            with reader:
                _read_all(reader)
        degraded = fn(scalar_store, fault_plan=plan(), degraded_mode=True, **kw)
        with degraded:
            _read_all(degraded)
            degraded.slo_watcher.check_once()
        reasons[name] = (sorted(reader.blackbox.bundles()), sorted(degraded.blackbox.bundles()))
        bundle = tpm.load_bundle(reader.blackbox.bundles()["InjectedCorruptionError"])
        assert set(bundle["reports"]) >= {"cursor", "plan", "quarantine", "pruning", "readahead",
                                          "autotune", "slo", "anomaly", "watchdog"}
        assert bundle["config"]["pool_type"] == "thread"
    assert reasons["torch"] == reasons["jax"] \
        == (["InjectedCorruptionError"], ["slo_quarantined"])


def test_watchdog_abort_hook_writes_a_bundle(scalar_store, tmp_path, monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_BLACKBOX", str(tmp_path))
    with make_batch_reader(scalar_store, workers_count=1, num_epochs=1,
                           hang_timeout_s=60.0) as reader:
        assert reader.watchdog.on_abort is not None
        reader.watchdog.on_abort(RuntimeError("no progress for 60 s"))
        _read_all(reader)
    assert sorted(reader.blackbox.bundles()) == ["watchdog_abort"]
    manifest = tpm.load_bundle(reader.blackbox.bundles()["watchdog_abort"])["manifest"]
    assert manifest["error"]["type"] == "RuntimeError"


def test_loader_timeline_report_shares_the_readers_ring(scalar_store):
    from petastorm_tpu_torch.loader import BatchedDataLoader
    with make_batch_reader(scalar_store, workers_count=2, num_epochs=1,
                           timeline_interval_s=0.02) as reader:
        loader = BatchedDataLoader(reader, batch_size=250, device="cpu")
        batches = sum(1 for _ in loader)
        assert _wait(lambda: reader._timeline.windows())
        assert loader.timeline_report()["interval_s"] == reader.timeline_report()["interval_s"]
        assert loader.telemetry.timeline is reader._timeline
    assert batches == 8
    names = {n for w in reader.timeline_report()["windows"] for n in w["series"]}
    assert "samples_per_s" in names


def test_process_reader_feeds_the_per_worker_family(scalar_store):
    with make_batch_reader(scalar_store, reader_pool_type="process", workers_count=2,
                           shuffle_row_groups=False, num_epochs=1,
                           timeline_interval_s=0.1) as reader:
        rows = _read_all(reader)
        counters = reader.telemetry.metrics_view()["counters"]
    assert rows == 2000
    assert [k for k in counters if k.startswith("pool.w") and k.endswith(".items")]
    names = {n for w in reader.timeline_report()["windows"] for n in w["series"]}
    assert any(n.startswith("pool.w") and n.endswith(".items_per_s") for n in names)
    assert "pool.utilization" in names


# ------------------------------------------------------------------- mesh
def _mesh_epoch(pkg, url, hosts):
    if pkg == "jax":
        from petastorm_tpu.jax import MeshDataLoader as Mesh
        from petastorm_tpu.jax import MeshReaderFactory as Factory
        extra = {}
    else:
        from petastorm_tpu_torch.loader.mesh_loader import MeshDataLoader as Mesh
        from petastorm_tpu_torch.loader.mesh_loader import MeshReaderFactory as Factory
        extra = {"num_hosts": hosts, "device": "cpu"}
    factory = Factory(url, batched=True, timeline_interval_s=0.05)
    with Mesh(factory, batch_size=200, seed=0, num_epochs=1, drop_last=False, pad_last=True,
              timeline_interval_s=0.05, **extra) as loader:
        rows = sum(next(iter(b.values())).shape[0] for b in loader)
        report = loader.mesh_report()
        names = set(loader.telemetry.metrics_view()["counters"]) \
            | set(loader.telemetry.metrics_view()["gauges"])
    return rows, report, names


def test_mesh_epoch_gives_the_jax_rollup_and_report(scalar_store):
    jax_rows, jax_rep, jax_names = _mesh_epoch("jax", scalar_store, 8)
    rows, rep, names = _mesh_epoch("torch", scalar_store, 8)
    assert rows == jax_rows == 2000
    # The report: the JAX keys less the quality plane's.
    assert set(rep) == set(jax_rep) - {"quality"}
    for key in ("hosts", "multiprocess", "reshard_events", "hosts_lost"):
        assert rep[key] == jax_rep[key], key
    assert {h: (v["rows"], v["rowgroups"]) for h, v in rep["per_host"].items()} \
        == {h: (v["rows"], v["rowgroups"]) for h, v in jax_rep["per_host"].items()}
    assert set(rep["critical_path"]) == set(jax_rep["critical_path"])
    fed, jax_fed = rep["timeline"], jax_rep["timeline"]
    assert fed["key_label"] == jax_fed["key_label"] == "host"
    assert sorted(fed["members"]) == sorted(jax_fed["members"])
    assert len([m for m in fed["members"] if m.startswith("h")]) == 8 and "mesh" in fed["members"]
    assert set(fed["series"]) == set(jax_fed["series"])
    assert len([s for s in fed["series"]
                if s.startswith("mesh:mesh.host") and s.endswith(".rows_per_s")]) == 8
    # The registry's mesh.* tallies under the JAX names and kinds.
    mesh = lambda n: {x for x in n if x.startswith("mesh.")}
    assert mesh(names) == mesh(jax_names)


# -------------------------------------------------------------------- CLI
def _cli_files(pkg_name, tmp_path):
    """A snapshot with a timeline, a plain one, a collapse, a trace-mode one
    and a bundle, each written by ``pkg_name``'s package."""
    pkg = PKGS[pkg_name]
    d = tmp_path / pkg_name
    d.mkdir()
    files = {}

    def snapshot(name, values, counters=None, trace=False):
        reg = pkg[0].TelemetryRegistry(spans_enabled=trace)
        if trace:
            reg.recorder.enable_trace()
            for g in range(3):
                for stage in ("decode", "stage"):
                    with reg.span(f"petastorm_tpu.{stage}", trace=f"e0:g{g}", stage=stage,
                                  track=stage):
                        pass
        reg.counter("reader.rows").add(sum(values) if values else 0)
        reg.gauge("mesh.hosts").set(2)
        reg.counter("mesh.host0.rows").add(5)
        for k, v in (counters or {}).items():
            reg.counter(k).add(v)
        reg.histogram("loader.host_wait_seconds").observe(0.25)
        reg.record_event("slo.violation", {"rule": "quarantined"})
        reg.pipeline_id, reg.created_at = f"p-{name}", 1.0e9
        snap = reg.snapshot()
        if values is not None:
            snap["timeline"] = _windows(values)
        path = str(d / f"{name}.json")
        pkg[0].write_snapshot(path, snap)
        files[name] = path

    snapshot("steady", [1000.0] * 10)
    snapshot("steady_prev", [1000.0] * 8, counters={"reader.rows": -0.0})
    snapshot("collapse", [1000.0] * 8 + [10.0] * 3)
    snapshot("plain", None)
    snapshot("live", [1000.0] * 5, counters={"anomaly.detections_total": 2})
    snapshot("h1", [30.0, 40.0, 50.0])
    snapshot("traced", None, trace=True)
    _, files["bundle"], _ = _write_bundles(pkg, d / "box")
    files["missing"] = str(d / "missing.json")
    return files


CLI_CASES = {
    "dump": lambda f, o: ["dump", f["steady"]],
    "dump_json": lambda f, o: ["dump", f["steady"], "--format", "json"],
    "dump_prometheus": lambda f, o: ["dump", f["steady"], "--format", "prometheus"],
    "dump_missing": lambda f, o: ["dump", f["missing"]],
    "watch": lambda f, o: ["watch", f["plain"], "--count", "1", "--interval", "0"],
    "top": lambda f, o: ["top", f["steady"], "--count", "1", "--no-clear"],
    "top_series": lambda f, o: ["top", f["steady"], "--count", "1", "--no-clear",
                                "--series", "rows"],
    "top_no_timeline": lambda f, o: ["top", f["plain"], "--count", "1", "--no-clear"],
    "top_needs_a_path": lambda f, o: ["top"],
    "timeline": lambda f, o: ["timeline", f["steady"], "--json", o("series.json")],
    "timeline_last": lambda f, o: ["timeline", f["steady"], "--last", "2", "--json",
                                   o("last.json")],
    "timeline_federated": lambda f, o: ["timeline", f["steady"], f["h1"]],
    "timeline_without_one": lambda f, o: ["timeline", f["plain"]],
    "postmortem": lambda f, o: ["postmortem", f["bundle"]],
    "postmortem_missing": lambda f, o: ["postmortem", f["missing"]],
    "trace": lambda f, o: ["trace", f["traced"], "--out", o("trace.json")],
    "trace_without_spans": lambda f, o: ["trace", f["plain"], "--out", o("none.json")],
    "check_default": lambda f, o: ["check", f["steady"]],
    "check_slo": lambda f, o: ["check", f["steady"], "--slo", "batch_p99_s<=0.1",
                               "--slo", "counter:reader.rows<=1e9"],
    "check_rate": lambda f, o: ["check", f["steady"], "--prev", f["steady_prev"],
                                "--window-s", "2", "--slo", "rate:reader.rows<=100"],
    "check_prev_without_window": lambda f, o: ["check", f["steady"], "--prev",
                                               f["steady_prev"]],
    "check_anomaly_collapse": lambda f, o: ["check", f["collapse"], "--anomaly"],
    "check_anomaly_steady": lambda f, o: ["check", f["steady"], "--anomaly"],
    "check_anomaly_without_timeline": lambda f, o: ["check", f["plain"], "--anomaly"],
    "check_anomaly_live_counter": lambda f, o: ["check", f["live"], "--anomaly"],
}
CLI_RC = {"dump_missing": 1, "top_needs_a_path": 1, "timeline_without_one": 1,
          "postmortem_missing": 1, "trace_without_spans": 1, "check_default": 0,
          "check_slo": 2, "check_rate": 2, "check_prev_without_window": 1,
          "check_anomaly_collapse": 2, "check_anomaly_live_counter": 2}


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    text = re.sub(r"petastorm_tpu(_torch)?", "PKG", out.getvalue() + err.getvalue())
    return rc, text


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_each_cli_reads_the_others_files_alike(case, writer, tmp_path):
    files = _cli_files(writer, tmp_path)
    results = {}
    for name, main in (("jax", jax_cli), ("torch", torch_cli)):
        outdir = tmp_path / f"out_{name}"
        outdir.mkdir()
        argv = CLI_CASES[case](files, lambda n, d=outdir: str(d / n))
        rc, text = _run_cli(main, argv)
        written = sorted(p.name for p in outdir.iterdir())
        contents = [json.loads((outdir / p).read_text()) for p in written]
        results[name] = (rc, text.replace(str(outdir), "OUT"), written, contents)
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == CLI_RC.get(case, 0)


def test_python_m_runs_the_cli(tmp_path):
    import subprocess
    files = _cli_files("torch", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "petastorm_tpu_torch.telemetry", "check",
                           files["collapse"], "--anomaly"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 2 and "FAIL anomaly throughput_collapse" in proc.stdout


# ------------------------------------------------------- metric docs lint
def test_every_port_metric_name_is_documented(monkeypatch):
    """``tools/check_metric_docs.py`` over the port, with the JAX schema
    tables and docs/cuda_port.md as its documents."""
    import importlib
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        mod = importlib.import_module("check_metric_docs")
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(mod, "PACKAGE", os.path.join(REPO, "petastorm_tpu_torch"))
    monkeypatch.setattr(mod, "DOCS", (os.path.join(REPO, "docs", "observability.md"),
                                      os.path.join(REPO, "docs", "cuda_port.md")))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = mod.main([])
    assert rc == 0, out.getvalue()
    count = int(re.search(r"(\d+) metric registrations all documented", out.getvalue()).group(1))
    assert count >= 100
