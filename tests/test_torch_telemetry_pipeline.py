"""The telemetry plane wired through petastorm_tpu_torch's readers, pools
and loaders, held against the JAX package's on one store.

On both readers (``make_reader``, ``make_batch_reader``), every pool
(thread, process, dummy) and ``DataLoader``/``BatchedDataLoader``:

* ``stage_breakdown()`` and ``stall_report()`` have the JAX loaders' keys,
  and ``Reader.diagnostics`` the JAX reader's;
* the metric names both packages' layers produce are the same set, but for
  :data:`JAX_ONLY`, each with the reason the port lacks it (the
  critical-path winners and self-time histograms are made on first use by
  whichever stage wins a batch, so they depend on timing and are held as a
  family, not by name);
* the counts that do not depend on timing are equal (rows, batches,
  samples, staged bytes, stall steps);
* process workers' decode spans reach the parent in trace mode, with every
  row group's lineage complete, and ``export_trace`` writes them as a Chrome
  trace that reads back.
"""
import json
import warnings

import pytest

from petastorm_tpu.jax import BatchedDataLoader as JaxBatchedDataLoader
from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.telemetry import complete_lineages as jax_complete_lineages
from petastorm_tpu.telemetry import to_chrome_trace as jax_to_chrome_trace
from petastorm_tpu_torch import telemetry as tt
from petastorm_tpu_torch.loader import (BatchedDataLoader, DataLoader, InMemBatchedDataLoader)
from petastorm_tpu_torch.loader.mesh_loader import MeshDataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

#: Names the JAX pipeline produces and this package does not, and why.
JAX_ONLY = {
    "io.bytes_read": "the JAX workers' I/O accounting rides its resilience plane (retry "
                     "policy, hedged reads), which is not ported (ROADMAP item 9)",
    "io.rowgroups_read": "as io.bytes_read",
    "resilience.retries_total": "the retry policy is not ported (item 9, resilience)",
    "resilience.giveups_total": "the retry policy is not ported (item 9, resilience)",
    "resilience.quarantined_rowgroups": "degraded mode's quarantine is not ported (item 9)",
}
#: Made on first use by the stage that wins (or accrues time in) a batch.
TIMING_FAMILIES = ("trace.critical_path.", "trace.self.")

ROW_FIELDS = ["id", "id2", "matrix"]
BATCH_FIELDS = ["id", "float_col", "int_col"]
POOLS = ["thread", "process", "dummy"]


def _names(snapshot: dict) -> set:
    names = set(snapshot["counters"]) | set(snapshot["gauges"]) | set(snapshot["histograms"])
    return {n for n in names if not n.startswith(TIMING_FAMILIES)}


def _run(reader, loader):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batches = sum(1 for _ in loader)
    return {"batches": batches, "snapshot": reader.telemetry.snapshot(),
            "breakdown": loader.stage_breakdown(), "stall": loader.stall_report(),
            "critical": loader.critical_path_report(), "metrics": loader.metrics.as_dict(),
            "diagnostics": reader.diagnostics}


def _row_pair(url, pool, **extra):
    kw = dict(schema_fields=ROW_FIELDS, reader_pool_type=pool, workers_count=2,
              shuffle_row_groups=False, **extra)
    with make_reader(url, **kw) as r:
        loader = DataLoader(r, batch_size=16, shuffling_queue_capacity=40, seed=1, device="cpu")
        assert loader.telemetry is r.telemetry
        ours = _run(r, loader)
    with jax_make_reader(url, rowgroup_pruning=False, **kw) as j:
        theirs = _run(j, JaxDataLoader(j, batch_size=16, shuffling_queue_capacity=40, seed=1))
    return ours, theirs


def _batch_pair(url, pool):
    kw = dict(schema_fields=BATCH_FIELDS, reader_pool_type=pool, workers_count=2,
              shuffle_row_groups=False)
    with make_batch_reader(url, **kw) as r:
        ours = _run(r, BatchedDataLoader(r, batch_size=16, device="cpu"))
    with jax_make_batch_reader(url, rowgroup_pruning=False, **kw) as j:
        theirs = _run(j, JaxBatchedDataLoader(j, batch_size=16))
    return ours, theirs


def _check_pair(ours, theirs, rows):
    assert ours["batches"] == theirs["batches"] == rows // 16
    assert set(ours["breakdown"]) == set(theirs["breakdown"])
    assert set(ours["stall"]) == set(theirs["stall"])
    assert set(ours["stall"]["host_side"]) == set(theirs["stall"]["host_side"])
    assert set(ours["critical"]) == set(theirs["critical"])
    assert set(ours["critical"]["counts"]) == set(theirs["critical"]["counts"])
    # The first delivery is the pipeline's spin-up, in both packages.
    assert ours["stall"]["steps"] == theirs["stall"]["steps"] == ours["batches"] - 1
    assert ours["critical"]["batches"] == theirs["critical"]["batches"] == ours["batches"]
    assert ours["metrics"]["batches"] == theirs["metrics"]["batches"]
    assert ours["metrics"]["samples"] == theirs["metrics"]["samples"]
    for snap in (ours["snapshot"], theirs["snapshot"]):
        assert snap["counters"]["reader.rows"] == rows
        assert snap["counters"]["loader.samples"] == ours["metrics"]["samples"]
    assert set(ours["diagnostics"]) == set(theirs["diagnostics"])
    for key in ("items_ventilated", "items_processed", "items_inprocess", "workers_count",
                "pool_type"):
        assert ours["diagnostics"][key] == theirs["diagnostics"][key], key
    assert set(ours["snapshot"]) == set(theirs["snapshot"]) - {"explain"}
    lacking = _names(theirs["snapshot"]) - _names(ours["snapshot"])
    assert lacking <= set(JAX_ONLY), sorted(lacking - set(JAX_ONLY))
    assert _names(ours["snapshot"]) <= _names(theirs["snapshot"])
    for names in (ours["snapshot"]["counters"], ours["snapshot"]["histograms"]):
        for n in names:
            if n.startswith(TIMING_FAMILIES):
                stage = n.split(".")[2].removesuffix("_s")
                assert stage in tt.trace.CRITICAL_STAGES, n


@pytest.mark.parametrize("pool", POOLS)
def test_row_reader_and_data_loader_telemetry_match_the_jax_pipeline(synthetic_dataset, pool):
    ours, theirs = _row_pair(synthetic_dataset.url, pool)
    _check_pair(ours, theirs, rows=100)
    snap = ours["snapshot"]
    assert snap["gauges"]["pool.backend"] == (1.0 if pool == "process" else 0.0)
    assert ours["breakdown"]["shuffle_s"] > 0 and ours["breakdown"]["pool_queue_s"] > 0
    assert (ours["breakdown"]["decode_s"] > 0) == (pool != "process")
    if pool == "process":   # the consumer's transport stage and the workers' busy time
        assert snap["counters"]["transport.deserialize_s"] > 0
        assert sum(v for k, v in snap["counters"].items()
                   if k.startswith("pool.w") and k.endswith(".items")) == 10
    # The pass is over: the shuffle buffer's gauges no longer hold it.
    assert snap["gauges"]["shuffle_buffer.fill"] == 0.0


@pytest.mark.parametrize("pool", POOLS)
def test_batch_reader_and_batched_loader_telemetry_match_the_jax_pipeline(scalar_dataset, pool):
    ours, theirs = _batch_pair(scalar_dataset.url, pool)
    _check_pair(ours, theirs, rows=100)
    snap, jsnap = ours["snapshot"], theirs["snapshot"]
    assert snap["histograms"]["batch.rows_per_op"]["count"] == \
        jsnap["histograms"]["batch.rows_per_op"]["count"] == 10
    if pool == "process":
        for name in ("transport.zero_copy_batches", "transport.zero_copy_bytes"):
            assert snap["counters"][name] == jsnap["counters"][name] > 0, name


def test_process_workers_spans_reach_the_parent_and_export(synthetic_dataset, tmp_path,
                                                           monkeypatch):
    """Trace mode on a process reader: each row group's decode, timed in a
    spawned worker, arrives as a span under its lineage id; every lineage is
    complete (ventilated and decoded), as in the JAX pipeline; the Chrome
    trace holds the worker, ``host_batch`` and ``stage`` spans."""
    monkeypatch.setenv(tt.TELEMETRY_TRACE_ENV, "1")
    kw = dict(schema_fields=ROW_FIELDS, reader_pool_type="process", workers_count=2,
              shuffle_row_groups=False)
    with make_reader(synthetic_dataset.url, **kw) as r:
        loader = DataLoader(r, batch_size=20, device="cpu")
        assert sum(1 for _ in loader) == 5
        spans = [s.as_dict() for s in r.telemetry.recorder.spans()]
        n = loader.export_trace(str(tmp_path / "trace.json"))
        snap = r.telemetry.snapshot()
    with jax_make_reader(synthetic_dataset.url, rowgroup_pruning=False, **kw) as j:
        jloader = JaxDataLoader(j, batch_size=20)
        assert sum(1 for _ in jloader) == 5
        jspans = [s.as_dict() for s in j.telemetry.recorder.spans()]
    decode = [s for s in spans if s["name"] == "petastorm_tpu.worker_decode"]
    assert len(decode) == 10 == sum(s["name"] == "petastorm_tpu.worker_decode" for s in jspans)
    assert {s["pid"] for s in decode} <= set(r.pool.worker_pids)
    assert all(s["thread"] == "remote" and s["track"].startswith("worker:") for s in decode)
    assert complete_lineages_of(spans) == jax_complete_lineages(jspans) == \
        [f"e0:g{i}" for i in sorted(range(10), key=str)]
    assert snap["counters"]["trace.span.decode_s"] == pytest.approx(
        sum(s["duration_s"] for s in decode), abs=1e-5)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert n == len(spans) and trace == jax_to_chrome_trace(
        spans, {"critical_path": loader.critical_path_report()["counts"]})
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] in ("X", "i")}
    assert {"petastorm_tpu.worker_decode", "petastorm_tpu.host_batch", "petastorm_tpu.stage",
            "petastorm_tpu.ventilate", "petastorm_tpu.pool_wait",
            "petastorm_tpu.transport"} <= names
    assert snap["trace_events"] and set(snap) >= {"trace_events", "spans"}


def complete_lineages_of(spans):
    return tt.complete_lineages(spans)


def test_export_trace_needs_trace_mode(synthetic_dataset, tmp_path, monkeypatch):
    monkeypatch.delenv(tt.TELEMETRY_TRACE_ENV, raising=False)
    with make_reader(synthetic_dataset.url, schema_fields=["id"], reader_pool_type="dummy") as r:
        loader = DataLoader(r, batch_size=50, device="cpu")
        assert sum(1 for _ in loader) == 2
        with pytest.raises(RuntimeError, match="trace mode is off"):
            loader.export_trace(str(tmp_path / "t.json"))
        r.telemetry.recorder.enable_trace()
        assert loader.export_trace(str(tmp_path / "t.json")) == 0
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"] == []


def test_every_loader_has_the_reports(synthetic_dataset, scalar_dataset):
    with make_batch_reader(scalar_dataset.url, schema_fields=BATCH_FIELDS,
                           reader_pool_type="dummy") as r:
        loader = InMemBatchedDataLoader(r, batch_size=25, num_epochs=2, seed=0, device="cpu")
        assert loader.telemetry is r.telemetry
        assert sum(1 for _ in loader) == 8
        assert loader.stall_report()["steps"] == 7
        assert loader.critical_path_report()["batches"] == 8
        assert loader.stage_breakdown()["stage_s"] > 0
    from petastorm_tpu_torch.loader.mesh_loader import MeshReaderFactory
    factory = MeshReaderFactory(synthetic_dataset.url, schema_fields=["id"],
                                reader_pool_type="dummy")
    mesh = MeshDataLoader(factory, batch_size=20, num_hosts=2, device="cpu")
    assert sum(1 for _ in mesh) == 5
    assert mesh.stall_report()["steps"] == 4 and mesh.critical_path_report()["batches"] == 5
    assert set(mesh.stage_breakdown()) == {"decode_s", "pool_queue_s", "shuffle_s",
                                           "host_wait_s", "stage_s", "device_put_wait_s"}
    mesh.close()


def test_a_second_loader_over_one_reader_counts_its_own_batches(scalar_dataset):
    with make_batch_reader(scalar_dataset.url, schema_fields=BATCH_FIELDS,
                           reader_pool_type="dummy", num_epochs=2) as r:
        first = BatchedDataLoader(r, batch_size=10, shuffling_queue_capacity=30, seed=0,
                                  device="cpu")
        it = iter(first)
        for _ in range(10):
            next(it)
        it.close()
        second = BatchedDataLoader(r, batch_size=10, device="cpu")
        assert second.metrics.batches == 0 and second.stage_breakdown()["shuffle_s"] == 0.0
        assert sum(1 for _ in second) > 0
        assert second.stall_report()["steps"] == second.metrics.batches - 1
        # The registry's counter holds both loaders' staged batches (the
        # first staged up to ``prefetch`` past the ten it delivered); a view
        # counts from its construction on, as the JAX package's does.
        total = r.telemetry.peek_counter("loader.batches")
        assert first.metrics.batches == total and 10 + second.metrics.batches <= total


def test_reader_gauges_and_diagnostics(synthetic_dataset):
    with make_reader(synthetic_dataset.url, schema_fields=["id"], workers_count=3,
                     results_queue_size=7, shuffle_row_groups=False) as r:
        rows = [r.next() for _ in range(10)]
        d = r.diagnostics
        assert d["pool_type"] == "thread" and d["workers_count"] == 3
        assert d["results_queue_capacity"] == 7
        gauges = d["telemetry"]["gauges"]
        assert gauges["pool.results_queue_capacity"] == 21
        assert gauges["ventilator.max_inflight"] == 12
        assert 0 <= gauges["ventilator.backlog"] <= 12
        assert d["ventilator_backlog"] >= 0
    assert [row.id for row in rows] == list(range(10))


def test_pool_profiling_enabled_prints_on_join(synthetic_dataset, capsys):
    with make_reader(synthetic_dataset.url, schema_fields=["id"],
                     pool_profiling_enabled=True) as r:
        assert sum(1 for _ in r) == 100
    assert "function calls" in capsys.readouterr().out
    for pool in ("process", "dummy"):
        with pytest.warns(UserWarning, match="pool_profiling_enabled only applies"):
            make_batch_reader(synthetic_dataset.url, reader_pool_type=pool, workers_count=1,
                              schema_fields=["id"], pool_profiling_enabled=True).stop()


@pytest.mark.parametrize("suffix", ["json", "prom"])
def test_export_environment_variable_writes_snapshots(synthetic_dataset, tmp_path, monkeypatch,
                                                      suffix):
    path = tmp_path / f"snap.{suffix}"
    monkeypatch.setenv(tt.TELEMETRY_EXPORT_ENV, str(path))
    with make_reader(synthetic_dataset.url, schema_fields=["id"], reader_pool_type="dummy") as r:
        assert sum(1 for _ in r) == 100
    text = path.read_text()   # stop() flushed the final snapshot
    if suffix == "json":
        assert tt.from_json(text)["counters"]["reader.rows"] == 100
    else:
        assert tt.parse_prometheus_text(text)["petastorm_tpu_reader_rows"][""] == 100


def test_a_wait_longer_than_the_poll_period_counts_whole(monkeypatch):
    """The consumer polls the staged queue (``_STAGE_POLL_S``) to notice a
    dead staging thread; a wait spanning several polls is still one wait,
    all of it delivery wait, none of it consumer busy time."""
    import time

    import numpy as np

    from petastorm_tpu_torch.loader import loader as loader_module
    monkeypatch.setattr(loader_module, "_STAGE_POLL_S", 0.02)

    class Slow(loader_module.LoaderBase):
        def _host_batches(self):
            for _ in range(3):
                time.sleep(0.15)
                yield {"x": np.zeros((2, 2), np.float32)}

    loader = Slow(2, device="cpu")
    assert sum(1 for _ in loader) == 3
    report = loader.stall_report()
    assert report["steps"] == 2
    assert report["delivery_wait_s"] > 0.25 and report["consumer_busy_s"] < 0.05
    assert report["verdict"] == "host_bound"
