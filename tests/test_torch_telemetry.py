"""The telemetry core of petastorm_tpu_torch (``petastorm_tpu_torch.telemetry``
and the telemetry side of ``metrics``) against the JAX package's
``petastorm_tpu.telemetry`` on the same seeded inputs.

Exact equality wherever both compute the same thing: histogram buckets,
counts, sums, quantiles and merges; Prometheus text byte for byte; JSON
snapshots through each other's readers; Chrome traces, lineage indexes and
complete lineages of the same span dicts; stall and critical-path reports
of the same sequences. Timing-dependent values (a span's measured
duration) are only held to their type and sign.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import petastorm_tpu.telemetry as jt
from petastorm_tpu.metrics import PipelineMetrics as JaxPipelineMetrics
from petastorm_tpu_torch import telemetry as tt
from petastorm_tpu_torch.metrics import PipelineMetrics, traced_span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(seed: int, n: int = 2000) -> np.ndarray:
    """Latencies over nine decades (1e-7 .. 1e3 s) plus exact bucket bounds,
    zeros and one negative value: every bucket edge case."""
    rng = np.random.default_rng(seed)
    v = 10.0 ** rng.uniform(-7, 3, n)
    return np.concatenate([v, np.array(jt.LATENCY_BOUNDS_S[:6]), [0.0, 0.0, -1.0]])


def test_bounds_equal_the_jax_packages():
    assert tt.LATENCY_BOUNDS_S == jt.LATENCY_BOUNDS_S
    assert tt.SIZE_BOUNDS == jt.SIZE_BOUNDS
    assert tt.SNAPSHOT_SCHEMA_VERSION == jt.SNAPSHOT_SCHEMA_VERSION
    assert (tt.TELEMETRY_EXPORT_ENV, tt.TELEMETRY_SPANS_ENV, tt.TELEMETRY_TRACE_ENV) == \
        (jt.TELEMETRY_EXPORT_ENV, jt.TELEMETRY_SPANS_ENV, jt.TELEMETRY_TRACE_ENV)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bounds", ["latency", "size"])
def test_histogram_equals_the_jax_histogram(seed, bounds):
    b = {"latency": None, "size": jt.SIZE_BOUNDS}[bounds]
    values = _values(seed) * (1e6 if bounds == "size" else 1.0)
    h, j = tt.StreamingHistogram(b), jt.StreamingHistogram(b)
    for v in values:
        h.observe(float(v))
        j.observe(float(v))
    assert h.buckets() == j.buckets()
    assert (h.count, h.sum) == (j.count, j.sum)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert h.quantile(q) == j.quantile(q)
    assert h.as_dict() == j.as_dict()
    # merge: a second histogram of other values into each
    h2, j2 = tt.StreamingHistogram(b), jt.StreamingHistogram(b)
    for v in _values(seed + 10)[:300]:
        h2.observe(float(v))
        j2.observe(float(v))
    h.merge(h2)
    j.merge(j2)
    assert h.as_dict() == j.as_dict()
    assert h.drain() == j.drain()
    assert h.as_dict() == j.as_dict() and h.count == 0


def test_histogram_rejects_what_the_jax_histogram_rejects():
    for mod in (tt, jt):
        with pytest.raises(ValueError):
            mod.StreamingHistogram([])
        with pytest.raises(ValueError):
            mod.StreamingHistogram([2.0, 1.0])
        with pytest.raises(ValueError):
            mod.StreamingHistogram().quantile(1.5)
        with pytest.raises(ValueError):
            mod.StreamingHistogram().merge(mod.StreamingHistogram([1.0]))


def _fill(registry, seed: int):
    """The same counters, gauges, histograms and spans (fixed durations,
    through ``record``) into a registry of either package."""
    rng = np.random.default_rng(seed)
    for name in ("reader.rows", "loader.batches", "transport.deserialize_s", "a-b.c d"):
        registry.counter(name).add(float(rng.integers(0, 1000)) / 7.0)
    registry.gauge("ventilator.backlog").set(3)
    registry.gauge("pool.results_queue_depth", lambda: 7.5)
    registry.gauge("dead", lambda: 1 / 0)
    registry.gauge("nan").set(float("nan"))
    for name, bounds in (("worker.decode_s", None), ("loader.batch_bytes", jt.SIZE_BOUNDS)):
        h = registry.histogram(name, bounds=bounds)
        for v in _values(seed)[:200] * (1e5 if bounds else 1.0):
            h.observe(float(v))
    rec = registry.recorder
    rec.enable()
    for i, (name, dur) in enumerate([("petastorm_tpu.stage", 0.25), ('we"ird\nname', 0.5),
                                     ("petastorm_tpu.stage", 0.125)]):
        rec.record(name, 10.0 + i, dur, stage="stage" if i != 1 else None)


def _comparable(snap: dict) -> dict:
    """A snapshot without its per-registry identity (pid, creation time)
    and with NaN gauges made comparable."""
    out = {k: v for k, v in snap.items() if k not in ("pipeline_id", "created_at")}
    out["gauges"] = {k: ("nan" if v != v else v) for k, v in snap["gauges"].items()}
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_and_prometheus_text_equal_the_jax_packages(seed):
    ours, theirs = tt.TelemetryRegistry(), jt.TelemetryRegistry()
    _fill(ours, seed)
    _fill(theirs, seed)
    snap, jsnap = ours.snapshot(), theirs.snapshot()
    assert _comparable(snap) == _comparable(jsnap)
    assert set(snap) == set(jsnap)
    assert tt.to_prometheus_text(snap) == jt.to_prometheus_text(jsnap)
    assert tt.to_prometheus_text(snap, prefix="x") == jt.to_prometheus_text(jsnap, prefix="x")
    # Each package's parser reads the other's export, and both read it alike.
    text = tt.to_prometheus_text(snap)

    def as_text(parsed):   # NaN != NaN: compare the values' reprs
        return {k: {lab: repr(v) for lab, v in d.items()} for k, d in parsed.items()}
    assert as_text(jt.parse_prometheus_text(text)) == as_text(tt.parse_prometheus_text(text))
    parsed = jt.parse_prometheus_text(text)
    assert parsed["petastorm_tpu_reader_rows"][""] == snap["counters"]["reader.rows"]
    assert "petastorm_tpu_dead" not in parsed   # a dead gauge is skipped, not faked
    # JSON: lossless through the JAX reader and ours.
    assert jt.from_json(tt.to_json(snap)) == json.loads(tt.to_json(snap))
    assert tt.to_json(snap) == jt.to_json(dict(snap))
    assert tt.from_json(jt.to_json(jsnap))["histograms"] == jsnap["histograms"]
    # reset(): the pre-reset snapshot, equal too, and the registries zeroed.
    assert _comparable(ours.reset()) == _comparable(theirs.reset())
    assert _comparable(ours.snapshot()) == _comparable(theirs.snapshot())


def test_prometheus_parser_rejects_what_the_jax_parser_rejects():
    for bad in ("metric{le=} nope\n", "1bad 2\n", "metric 1 2 3\n"):
        for mod in (tt, jt):
            with pytest.raises(ValueError):
                mod.parse_prometheus_text(bad)


def test_write_snapshot_and_periodic_exporter(tmp_path):
    reg = tt.TelemetryRegistry()
    reg.counter("reader.rows").add(5)
    tt.write_snapshot(str(tmp_path / "s.json"), reg.snapshot())
    tt.write_snapshot(str(tmp_path / "s.prom"), reg.snapshot(), fmt="prometheus")
    assert jt.from_json((tmp_path / "s.json").read_text())["counters"]["reader.rows"] == 5
    assert jt.parse_prometheus_text((tmp_path / "s.prom").read_text())[
        "petastorm_tpu_reader_rows"][""] == 5
    with pytest.raises(ValueError):
        tt.write_snapshot(str(tmp_path / "x"), {}, fmt="xml")
    with pytest.raises(ValueError):
        tt.PeriodicExporter(reg, str(tmp_path / "p.json"), interval_s=0)
    path = tmp_path / "p.json"
    exp = tt.PeriodicExporter(reg, str(path), interval_s=0.02).start()
    with pytest.raises(RuntimeError):
        exp.start()
    deadline = time.monotonic() + 5
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert path.exists()
    reg.counter("reader.rows").add(2)
    exp.stop()   # the final flush carries the last value
    assert json.loads(path.read_text())["counters"]["reader.rows"] == 7


def test_exporter_flushes_at_interpreter_exit(tmp_path):
    """An exporter whose owner never stops it writes its last snapshot from
    the atexit hook (the thread's interval is far too long to tick)."""
    path = tmp_path / "exit.json"
    code = ("from petastorm_tpu_torch import telemetry as t\n"
            "r = t.TelemetryRegistry(); r.counter('c').add(3)\n"
            f"e = t.PeriodicExporter(r, {str(path)!r}, interval_s=3600).start()\n"
            "r.counter('c').add(1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(path.read_text())["counters"]["c"] == 4


def test_recorder_ring_bound_trace_mode_and_noop():
    rec = tt.SpanRecorder(capacity=3)
    assert rec.span("x") is rec.span("y")   # the disabled path's shared no-op
    with rec.span("x"):
        pass
    assert rec.spans() == []
    rec.enable()
    for i in range(5):
        rec.record(f"s{i}", float(i), 0.5)
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"] and rec.dropped == 2
    rec.enable_trace(capacity=10)
    assert rec.trace_enabled and rec.capacity == 10
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"]   # growing keeps them
    with rec.span("lineage", trace="e0:g3", stage="decode", track="worker:1") as live:
        pass
    sp = rec.spans()[-1]
    assert (sp.trace, sp.stage, sp.track) == ("e0:g3", "decode", "worker:1")
    assert live.span_id and sp.span_id == live.span_id and sp.duration_s >= 0
    assert sp.pid == os.getpid() and sp.thread == threading.current_thread().name
    with pytest.raises(ValueError):
        tt.SpanRecorder(capacity=0)
    assert tt.SpanRecorder.aggregate_spans(rec.spans()) == \
        jt.SpanRecorder.aggregate_spans(rec.spans())


def test_record_remote_reanchors_and_feeds_stage_counters():
    """Spans from another process end at the given anchor (their clock is
    not ours) and accrue ``trace.span.{stage}_s``, as the JAX recorder's."""
    compact = [("petastorm_tpu.worker_decode", "decode", 0.5, "e0:g1", "worker:0"),
               ("petastorm_tpu.worker_decode", "decode", 0.25, "e0:g2", "worker:1")]
    ours, theirs = tt.TelemetryRegistry(), jt.TelemetryRegistry()
    ours.recorder.enable_trace()
    theirs.recorder.enable_trace()
    ours.recorder.record_remote(compact, pid=42, anchor_s=100.0)
    theirs.recorder.record_remote(compact, pid=42, anchor_s=100.0)
    assert [s.as_dict() for s in ours.recorder.spans()] == \
        [s.as_dict() for s in theirs.recorder.spans()]
    assert ours.recorder.spans()[0].start_s == 99.5
    assert ours.peek_counter("trace.span.decode_s") == 0.75 == \
        theirs.peek_counter("trace.span.decode_s")
    off = tt.SpanRecorder()
    off.record_remote(compact)
    assert off.spans() == []


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs os.fork")
def test_recorder_pid_refreshes_after_fork():
    from petastorm_tpu_torch.telemetry import recorder
    read, write = os.pipe()
    pid = os.fork()
    if pid == 0:   # the child: its spans carry its own pid
        rec = recorder.SpanRecorder(enabled=True)
        rec.record("child", 0.0, 0.0)
        os.write(write, pickle.dumps((os.getpid(), rec.spans()[0].pid)))
        os._exit(0)
    os.waitpid(pid, 0)
    child_pid, span_pid = pickle.loads(os.read(read, 4096))
    os.close(read)
    os.close(write)
    assert span_pid == child_pid != os.getpid()
    assert recorder._PID == os.getpid()


def _span_dicts(seed: int):
    """Span dicts as a trace-mode snapshot holds them: lineage and batch
    ids, mesh-style host tracks, stage and thread lanes, instants."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        kind = int(rng.integers(0, 6))
        d = {"name": f"petastorm_tpu.{['ventilate', 'worker_decode', 'stage', 'host_batch', 'transport', 'pool_wait'][kind]}",
             "start_s": round(float(rng.uniform(0, 5)), 6),
             "duration_s": 0.0 if kind == 0 else round(float(rng.uniform(0, 0.1)), 6),
             "thread": f"t{int(rng.integers(0, 3))}", "thread_id": 7, "pid": int(rng.integers(1, 3))}
        if kind in (0, 1):
            d["trace"] = f"e{int(rng.integers(0, 2))}:g{int(rng.integers(0, 6))}"
            d["stage"] = "ventilate" if kind == 0 else "decode"
        elif kind in (2, 3):
            d["trace"] = f"b{i}"
            if kind == 2:
                d["stage"] = "stage"
        if kind == 1:
            d["track"] = (f"h{int(rng.integers(0, 2))}:worker:{int(rng.integers(0, 2))}"
                          if rng.random() < 0.5 else f"worker:{int(rng.integers(0, 2))}")
        if kind == 4:
            d["track"] = "transport:0"
            d["extra"] = {"rows": int(rng.integers(1, 9))}
        if rng.random() < 0.3:
            d["span_id"], d["parent_id"] = i + 1, max(0, i - 1)
        out.append(d)
    out.append({"name": "bare", "start_s": 1.0, "duration_s": 0.5, "thread": "main",
                "thread_id": 1, "pid": 1, "trace": "not-a-lineage"})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_trace_and_lineage_equal_the_jax_packages(seed, tmp_path):
    spans = _span_dicts(seed)
    meta = {"critical_path": {"decode": 3}}
    assert tt.to_chrome_trace(spans, meta) == jt.to_chrome_trace(spans, meta)
    assert tt.lineage_index(spans) == jt.lineage_index(spans)
    assert tt.complete_lineages(spans) == jt.complete_lineages(spans)
    assert tt.complete_lineages(spans, required=("decode",)) == \
        jt.complete_lineages(spans, required=("decode",))
    tt.write_chrome_trace(str(tmp_path / "t.json"), spans, meta)
    assert json.loads((tmp_path / "t.json").read_text()) == jt.to_chrome_trace(spans, meta)
    for trace_id in ("e3:g17", "b4", "x", "e:g", "eX:g1"):
        assert tt.TraceContext.parse(trace_id) == (
            None if jt.TraceContext.parse(trace_id) is None
            else tt.TraceContext(*jt.TraceContext.parse(trace_id).__dict__.values()))
    assert tt.TraceContext(2, 9).id == jt.TraceContext(2, 9).id == "e2:g9"


@pytest.mark.parametrize("seed", [0, 1])
def test_stall_attributor_equals_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    waits, busies = rng.exponential(0.01, 300), rng.exponential(0.02, 300)
    waits[::7] = 0.0
    busies[::11] = 0.0
    waits[5] = -1.0   # clamped to 0 by both
    ours_reg, theirs_reg = tt.TelemetryRegistry(), jt.TelemetryRegistry()
    ours = tt.StallAttributor(ours_reg, device_bound_below=0.1, host_bound_above=0.4)
    theirs = jt.StallAttributor(theirs_reg, device_bound_below=0.1, host_bound_above=0.4)
    assert ours.report() == theirs.report()   # idle
    for w, b in zip(waits, busies):
        assert ours.observe(float(w), float(b)) == theirs.observe(float(w), float(b))
    pm, jpm = PipelineMetrics(tt.TelemetryRegistry()), JaxPipelineMetrics(jt.TelemetryRegistry())
    for m in (pm, jpm):
        m.record_batch(8, 100, 0.3, 0.1)
    assert ours.report(pm) == theirs.report(jpm)
    assert ours.steps == theirs.steps == 300
    assert _comparable(ours_reg.snapshot()) == _comparable(theirs_reg.snapshot())
    for mod in (tt, jt):
        with pytest.raises(ValueError):
            mod.StallAttributor(device_bound_below=0.5, host_bound_above=0.2)


@pytest.mark.parametrize("seed", [0, 1])
def test_critical_path_attributor_equals_the_jax_one(seed):
    """The same per-stage self-time increments between deliveries give the
    same winners, histograms and report; a second attributor over the same
    registry counts only its own batches."""
    rng = np.random.default_rng(seed)
    regs = tt.TelemetryRegistry(), jt.TelemetryRegistry()
    atts = [tt.CriticalPathAttributor(regs[0]), jt.CriticalPathAttributor(regs[1])]
    assert atts[0].report() == atts[1].report()
    sources = [("counter", "loader.shuffle_s"), ("counter", "loader.stage_s"),
               ("counter", "transport.deserialize_s"), ("hist", "worker.decode_s"),
               ("counter", "trace.span.decode_s"), ("counter", "io.readahead.fetch_s")]
    for batch in range(60):
        for kind, name in sources:
            if rng.random() < 0.6:
                dv = float(rng.exponential(0.01))
                for reg in regs:
                    (reg.counter(name).add(dv) if kind == "counter"
                     else reg.histogram(name).observe(dv))
        if batch == 30:   # a late second attributor starts at its own baseline
            atts += [tt.CriticalPathAttributor(regs[0]), jt.CriticalPathAttributor(regs[1])]
        winners = [a.observe_batch() for a in atts]
        assert winners[0] == winners[1] and winners[2:3] == winners[3:4]
    assert atts[0].report() == atts[1].report()
    assert atts[2].report() == atts[3].report()
    assert atts[2].report()["batches"] == 30
    assert _comparable(regs[0].snapshot()) == _comparable(regs[1].snapshot())


def test_registry_reset_and_identity_checked_gauges():
    reg = tt.TelemetryRegistry()
    c = reg.counter("c")
    assert reg.counter("c") is c
    with pytest.raises(ValueError):
        c.add(-1)
    fn = lambda: 2.0  # noqa: E731
    g = reg.gauge("g", fn)
    g.clear_function(lambda: 3.0)   # not the registered one: kept
    assert g.value == 2.0
    g.clear_function(fn)
    assert g.value == 0.0
    assert reg.peek_counter("absent") == 0.0 and reg.find_counter("absent") is None
    assert reg.find_histogram("absent") is None and "absent" not in reg.snapshot()["counters"]


def test_pipeline_metrics_view_equals_the_jax_view():
    """Baselines: a second view over the same registry counts only its own
    batches; a registry-wide reset re-baselines at zero; reset() returns
    what the view held. Both packages alike."""
    regs = tt.TelemetryRegistry(), jt.TelemetryRegistry()
    views = [PipelineMetrics(regs[0]), JaxPipelineMetrics(regs[1])]
    for v in views:
        v.record_batch(8, 64, 0.5, 0.25)
    late = [PipelineMetrics(regs[0]), JaxPipelineMetrics(regs[1])]
    for v in views + late:
        v.record_batch(4, 32, 0.125, 0.0)
    assert [v.as_dict() for v in views[:1] + late[:1]] == [v.as_dict() for v in views[1:] + late[1:]]
    assert late[0].batches == 2 and views[0].batches == 3
    assert views[0].reset() == views[1].reset()
    for reg in regs:
        reg.reset()
    for v in views + late:
        v.record_batch(2, 16, 0.5, 0.5)
    assert [v.as_dict() for v in views[:1] + late[:1]] == [v.as_dict() for v in views[1:] + late[1:]]
    assert regs[0].snapshot()["histograms"] == regs[1].snapshot()["histograms"]


def test_traced_span_pairs_a_profiler_range_with_a_recorder_span():
    import torch
    reg = tt.TelemetryRegistry(spans_enabled=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with traced_span("petastorm_tpu.stage", reg, trace="b1", stage="stage", track="stager"):
            pass
        with traced_span("plain"):
            pass
    names = [e.name for e in prof.events()]
    assert "petastorm_tpu.stage" in names and "plain" in names
    (sp,) = reg.recorder.spans()
    assert (sp.name, sp.trace, sp.stage, sp.track) == ("petastorm_tpu.stage", "b1", "stage",
                                                       "stager")
    assert reg.peek_counter("trace.span.stage_s") == sp.duration_s
    with pytest.raises(KeyError):   # an exception leaves both ranges closed and propagates
        with traced_span("boom", reg):
            raise KeyError("x")
    assert [s.name for s in reg.recorder.spans()] == ["petastorm_tpu.stage", "boom"]


@pytest.mark.parametrize("env,spans,trace", [({}, False, False),
                                              ({"PETASTORM_TPU_TELEMETRY_SPANS": "1"}, True, False),
                                              ({"PETASTORM_TPU_TELEMETRY_TRACE": "1"}, True, True)])
def test_make_registry_honours_the_environment(monkeypatch, env, spans, trace):
    for name in (tt.TELEMETRY_SPANS_ENV, tt.TELEMETRY_TRACE_ENV):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = tt.make_registry(), jt.make_registry()
    assert (ours.recorder.enabled, ours.recorder.trace_enabled) == (spans, trace) == \
        (theirs.recorder.enabled, theirs.recorder.trace_enabled)
    assert ours.recorder.capacity == theirs.recorder.capacity
