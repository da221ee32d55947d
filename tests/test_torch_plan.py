"""The planning layer of petastorm_tpu_torch against the JAX package
(``tests/test_plan.py``): the validation pass's messages, the lowered
plan's ``describe()``, the lowering table, the fusions' byte identity, the
plan cache's records across the two packages, and row-group coalescing; and
the top-level error exports."""
import inspect
import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.plan as jplan
import petastorm_tpu.predicates as jp
import petastorm_tpu_torch.plan as tplan
import petastorm_tpu_torch.predicates as tp
from petastorm_tpu.autotune import AutotuneConfig as JaxAutotuneConfig
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.autotune import AutotuneConfig as TorchAutotuneConfig
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

pytestmark = pytest.mark.plan


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    d = str(tmp_path / "plans")
    monkeypatch.setenv(tplan.PLAN_CACHE_ENV, d)
    monkeypatch.delenv(tplan.PLAN_FUSION_ENV, raising=False)
    return d


@pytest.fixture(scope="module")
def scalar_store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_plan") / "scalar")
    os.makedirs(root)
    for i in range(2):
        ids = np.arange(i * 60, (i + 1) * 60)
        pq.write_table(pa.table({"id": ids, "val": ids.astype(np.float64) * 0.5,
                                 "w": ids % 7}),
                       os.path.join(root, f"part{i}.parquet"), row_group_size=10)
    return f"file://{root}"


def _error(factory, url, **kw):
    with pytest.raises(ValueError) as exc:
        factory(url, reader_pool_type="dummy", **kw)
    return str(exc.value)


VALIDATION_CASES = {
    "subset x shard": dict(rowgroup_subset=[1], cur_shard=0, shard_count=2),
    "subset x shuffle": dict(rowgroup_subset=[1], shuffle_row_groups=True),
    "window x order": dict(shuffle_window=4),
    "bad sample order": dict(sample_order="sorted"),
    "negative window": dict(shuffle_window=-1, sample_order="deterministic"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_messages_equal_jax(scalar_store, synthetic_dataset, case):
    kw = VALIDATION_CASES[case]
    batch = _error(make_batch_reader, scalar_store, **kw)
    assert batch == _error(jax_make_batch_reader, scalar_store, **kw)
    row = _error(make_reader, synthetic_dataset.url, **kw)
    assert row == _error(jax_make_reader, synthetic_dataset.url, **kw)
    with pytest.raises(ValueError) as port_exc:
        tplan.validate_reader_config(kw)
    with pytest.raises(ValueError) as jax_exc:
        jplan.validate_reader_config(kw)
    assert str(port_exc.value) == str(jax_exc.value) == batch


def test_validation_of_row_materialization_and_the_rules_checked(synthetic_dataset):
    assert _error(make_reader, synthetic_dataset.url, row_materialization="soon") == \
        _error(jax_make_reader, synthetic_dataset.url, row_materialization="soon")
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy") as r:
        assert r._plan.validated == [rule.name for rule in tplan.CONFLICT_RULES]
        assert {rule.name for rule in tplan.CONFLICT_RULES} <= \
            {rule.name for rule in jplan.CONFLICT_RULES}


def test_lowering_table_names_every_kwarg_of_the_port():
    """Every kwarg of the port's two entry points is in the port's table,
    with the JAX table's operators."""
    from petastorm_tpu_torch import reader as reader_module
    for fn in (reader_module.make_reader, reader_module.make_batch_reader):
        for name in inspect.signature(fn).parameters:
            assert name in tplan.LOWERING_TABLE, (fn.__name__, name)
    for name, ops in tplan.LOWERING_TABLE.items():
        assert jplan.LOWERING_TABLE[name] == ops, name


DESCRIBE_CASES = {
    "row defaults": ("row", dict()),
    "row predicate": ("row", dict(predicate="range", reader_pool_type="thread")),
    "row ngram predicate": ("row", dict(predicate="range", ngram=True)),
    "row process": ("row", dict(reader_pool_type="process", workers_count=2,
                                predicate="range")),
    "row deterministic lazy": ("row", dict(sample_order="deterministic", shuffle_window=2,
                                           row_materialization="lazy",
                                           memory_cache_size_bytes=1 << 20)),
    "row fusion off": ("row", dict(predicate="range", fusion="0")),
    "row placement": ("row", dict(autotune=True, placement=True)),
    "row placement dummy": ("row", dict(autotune=True, placement=True,
                                        reader_pool_type="dummy")),
    "batch defaults": ("batch", dict()),
    "batch predicate": ("batch", dict(predicate="range", readahead_depth=2)),
    "batch process": ("batch", dict(reader_pool_type="process", workers_count=2)),
    "batch convert early": ("batch", dict(convert_early_to_numpy=True)),
    "batch fusion off": ("batch", dict(predicate="range", fusion="off")),
    "batch placement": ("batch", dict(autotune=True, placement=True,
                                      schema_fields=["id", "w"])),
}


def _lowered(pkg, flavor, url, kw):
    plan, preds = (tplan, tp) if pkg == "port" else (jplan, jp)
    kw = dict(kw)
    kwargs = {"reader_pool_type": kw.pop("reader_pool_type", "thread"), **kw}
    ngram = kwargs.pop("ngram", False)
    if kwargs.pop("predicate", None):
        kwargs["predicate"] = preds.in_range("id", 0, 50)
    if kwargs.pop("placement", False):
        config = TorchAutotuneConfig if pkg == "port" else JaxAutotuneConfig
        kwargs["autotune_config"] = config(placement=True)
    fields = kwargs.pop("schema_fields", None) or ["id", "val", "w"]
    key = "dataset_url" if pkg == "port" or flavor == "row" else "dataset_url_or_urls"
    return plan.lower_reader_kwargs(flavor, {key: url, **kwargs},
                                    schema_field_names=sorted(fields), ngram=ngram)


@pytest.mark.parametrize("case", sorted(DESCRIBE_CASES))
def test_lowered_plan_describes_as_jax(scalar_store, monkeypatch, case):
    flavor, kw = DESCRIBE_CASES[case]
    if "fusion" in kw:
        kw = dict(kw)
        monkeypatch.setenv(tplan.PLAN_FUSION_ENV, kw.pop("fusion"))
    port = _lowered("port", flavor, scalar_store, kw)
    jax = _lowered("jax", flavor, scalar_store, kw)
    assert port.describe() == jax.describe()
    assert list(port.operators) == list(jax.operators)
    assert port.pool_type == jax.pool_type


def test_readers_report_the_jax_plan(scalar_store, synthetic_dataset):
    kw = dict(reader_pool_type="thread", workers_count=2, shuffle_row_groups=False)
    with make_batch_reader(scalar_store, predicate=tp.in_range("id", 0, 50), **kw) as r, \
            jax_make_batch_reader(scalar_store, predicate=jp.in_range("id", 0, 50), **kw) as j:
        assert r.plan_report() == j.plan_report()
        assert r.plan_report()["source"] == "default" and r.plan_report()["cache"] == "off"
    with make_reader(synthetic_dataset.url, **kw) as r, \
            jax_make_reader(synthetic_dataset.url, **kw) as j:
        assert r.plan_report() == j.plan_report()


def test_plan_dict_round_trips_across_packages(scalar_store):
    jax = _lowered("jax", "batch", scalar_store,
                   dict(reader_pool_type="process", workers_count=3, predicate="range",
                        sample_order="deterministic", memory_cache_size_bytes=1 << 20))
    payload = json.loads(json.dumps(jax.to_dict()))
    port = tplan.PipelinePlan.from_dict(payload)
    assert port.to_dict() == jax.to_dict()
    assert port.pool_type == "process"
    assert jplan.PipelinePlan.from_dict(json.loads(json.dumps(port.to_dict()))).to_dict() \
        == jax.to_dict()
    payload["plan_schema_version"] = 999
    with pytest.raises(ValueError, match="schema version"):
        tplan.PipelinePlan.from_dict(payload)


# ------------------------------------------------------------------ fusions
def _row_epoch(factory, url, fusion, monkeypatch, **kw):
    monkeypatch.setenv(tplan.PLAN_FUSION_ENV, fusion)
    with factory(url, num_epochs=1, **kw) as r:
        if r.row_materialization == "lazy":
            out = []
            try:
                while True:
                    b = r.next_batch()
                    out.append({k: np.asarray(v) for k, v in b.columns.items()})
            except StopIteration:
                pass
        else:
            out = [r_._asdict() for r_ in r]
        names = r._plan.fusion_names()
    return out, names


def _assert_identical(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            xa, ya = np.asarray(x[k]), np.asarray(y[k])
            assert xa.dtype == ya.dtype and xa.shape == ya.shape, k
            assert xa.tobytes() == ya.tobytes(), k


ROW_FUSION_CASES = {
    "eager": lambda p: dict(predicate=p.in_range("id", 10, 70)),
    "eager shuffled rows": lambda p: dict(predicate=p.in_set({3, 14, 15, 92, 65}, "id"),
                                          shuffle_rows=True, seed=3),
    "lazy": lambda p: dict(predicate=p.in_range("id2", 1, 4), row_materialization="lazy"),
    "drop partitions": lambda p: dict(predicate=p.in_range("id", 5, 95),
                                      shuffle_row_drop_partitions=2),
    "deterministic": lambda p: dict(predicate=p.in_range("id", 20, 90), seed=5,
                                    shuffle_row_groups=True, sample_order="deterministic"),
}


@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("case", sorted(ROW_FUSION_CASES))
def test_row_fusion_is_byte_identical_to_unfused_and_jax(synthetic_dataset, monkeypatch,
                                                         case, pool):
    kw = dict(reader_pool_type=pool, workers_count=2, shuffle_row_groups=False,
              schema_fields=["id", "id2", "matrix", "image_png"])
    kw_port = {**kw, **ROW_FUSION_CASES[case](tp)}
    fused, names = _row_epoch(make_reader, synthetic_dataset.url, "1", monkeypatch, **kw_port)
    assert tplan.FUSION_MASK_DECODE in names
    unfused, names = _row_epoch(make_reader, synthetic_dataset.url, "0", monkeypatch,
                                **kw_port)
    assert not names
    jax, _ = _row_epoch(jax_make_reader, synthetic_dataset.url, "1", monkeypatch,
                        **{**kw, **ROW_FUSION_CASES[case](jp)})
    _assert_identical(fused, unfused)
    _assert_identical(fused, jax)


def test_the_fused_row_worker_reads_each_group_once(synthetic_dataset, monkeypatch):
    """Unfused, a group with a passing row is read twice (its predicate
    columns, then the rest); fused, once (``io.rowgroups_read``)."""
    reads = {}
    for fusion in ("1", "0"):
        monkeypatch.setenv(tplan.PLAN_FUSION_ENV, fusion)
        with make_reader(synthetic_dataset.url, reader_pool_type="dummy",
                         shuffle_row_groups=False, rowgroup_pruning=False,
                         predicate=tp.in_set({5, 25, 45}, "id2")) as r:
            rows = list(r)
            reads[fusion] = r.telemetry.snapshot()["counters"]["io.rowgroups_read"]
        assert rows
    assert reads["1"] == 10 and reads["0"] == 20


BATCH_FUSION_CASES = {
    "predicate": lambda p: dict(predicate=p.in_range("id", 10, 80)),
    "predicate rows": lambda p: dict(predicate=p.in_pseudorandom_split([0.4, 0.6], 1, "id"),
                                     schema_fields=["id", "val"]),
    "no predicate": lambda p: dict(shuffle_rows=True, seed=4),
    "empty groups": lambda p: dict(predicate=p.in_set({5, 117}, "id"), rowgroup_pruning=False),
}


@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("case", sorted(BATCH_FUSION_CASES))
def test_batch_fusion_is_byte_identical_to_unfused_and_jax(scalar_store, monkeypatch, case,
                                                           pool):
    def epoch(factory, fusion, preds):
        monkeypatch.setenv(tplan.PLAN_FUSION_ENV, fusion)
        with factory(scalar_store, reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=False, **BATCH_FUSION_CASES[case](preds)) as r:
            out = []
            try:
                while True:
                    out.append(dict(r.next_batch()))
            except StopIteration:
                pass
            return out, r._plan.fusion_names()
    fused, names = epoch(make_batch_reader, "1", tp)
    assert tplan.FUSION_DECODE_TRANSPORT in names
    unfused, names = epoch(make_batch_reader, "0", tp)
    assert not names
    jax, _ = epoch(jax_make_batch_reader, "1", jp)
    _assert_identical(fused, unfused)
    _assert_identical(fused, jax)


def test_the_transport_fusion_stays_off_spawned_workers(scalar_store):
    from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool
    with make_batch_reader(scalar_store, reader_pool_type="thread", workers_count=1) as r:
        assert tplan.FUSION_DECODE_TRANSPORT in r._worker_args_for(r.pool)["plan_fusions"]
        spawned = r._worker_args_for(ProcessPool(1))["plan_fusions"]
        assert tplan.FUSION_DECODE_TRANSPORT not in spawned
        assert sum(len(b.id) for b in r) == 120
    with make_batch_reader(scalar_store, reader_pool_type="dummy",
                           convert_early_to_numpy=True) as r:
        fusion = r._plan.fusion(tplan.FUSION_DECODE_TRANSPORT)
        assert not fusion["applied"] and "convert_early_to_numpy" in fusion["reason"]


# --------------------------------------------------------------- plan cache
KEY = dict(fingerprint="f" * 32, store_type="file", host="h1")


def _caches(directory, ttl_s=None):
    return (tplan.PlanCache(directory, ttl_s=ttl_s), jplan.PlanCache(directory, ttl_s=ttl_s))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_record_written_by_either_package_loads_in_the_other(tmp_path, writer):
    port, jax = _caches(str(tmp_path / "c"))
    record = {"backend": "process", "trial": {"verdict": "kept", "backend": "process"},
              "actuators": {"worker_concurrency": 3}, "profile": None}
    write, read = (port, jax) if writer == "port" else (jax, port)
    key_w = (tplan if writer == "port" else jplan).PlanKey(**KEY)
    key_r = (jplan if writer == "port" else tplan).PlanKey(**KEY)
    assert key_w.filename == key_r.filename
    assert write.store(key_w, record)
    loaded = read.load(key_r)
    assert loaded["backend"] == "process" and loaded["trial"] == record["trial"]
    assert loaded["key"] == KEY
    assert tplan.roofline_seeds(loaded) == jplan.roofline_seeds(loaded) == \
        {"actuators": {"worker_concurrency": 3}}


CACHE_MISSES = {
    "unknown key": lambda path, rec: None,
    "corrupt json": lambda path, rec: open(path, "w").write("{not json"),
    "schema drift": lambda path, rec: json.dump({**rec, "plan_schema_version": 999},
                                                open(path, "w")),
    "fingerprint mismatch": lambda path, rec: json.dump(
        {**rec, "key": {**KEY, "fingerprint": "0" * 32}}, open(path, "w")),
    "stale": lambda path, rec: json.dump({**rec, "created_at": time.time() - 10.0},
                                         open(path, "w")),
    "bad backend": lambda path, rec: json.dump({**rec, "backend": "dummy"}, open(path, "w")),
}


@pytest.mark.parametrize("case", sorted(CACHE_MISSES))
def test_cache_misses_equal_jax(tmp_path, case):
    results = []
    for pkg in (tplan, jplan):
        d = str(tmp_path / pkg.__name__)
        cache = pkg.PlanCache(d, ttl_s=5.0)
        key = pkg.PlanKey(**KEY)
        assert cache.store(key, {"backend": "thread", "trial": None, "actuators": {}})
        path = os.path.join(d, key.filename)
        record = json.load(open(path))
        if case == "unknown key":
            key = pkg.PlanKey(**{**KEY, "host": "other"})
        else:
            CACHE_MISSES[case](path, record)
        results.append((cache.load(key), os.path.exists(path)))
    assert results[0] == results[1]
    assert results[0][0] is None


def test_cache_ttl_and_switch_read_the_jax_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(tplan.PLAN_CACHE_TTL_ENV, "12.5")
    assert tplan.PlanCache(str(tmp_path)).ttl_s == jplan.PlanCache(str(tmp_path)).ttl_s == 12.5
    monkeypatch.setenv(tplan.PLAN_CACHE_TTL_ENV, "soon")
    assert tplan.PlanCache(str(tmp_path)).ttl_s == tplan.DEFAULT_PLAN_TTL_S
    for off in ("0", "off", "false"):
        monkeypatch.setenv(tplan.PLAN_CACHE_ENV, off)
        assert not tplan.PlanCache().enabled and not jplan.PlanCache().enabled
    monkeypatch.setenv(tplan.PLAN_CACHE_ENV, str(tmp_path))
    assert tplan.plan_cache_dir() == jplan.plan_cache_dir() == str(tmp_path)
    key = tplan.PlanKey.for_dataset("hdfs://nn/ds", ["a", "b"], host="h")
    assert key == tplan.PlanKey(**jplan.PlanKey.for_dataset("hdfs://nn/ds", ["a", "b"],
                                                            host="h").to_dict())
    assert key.store_type == "hdfs"


# --------------------------------------------------------------- coalescing
@pytest.mark.parametrize("coalescing", [2, 3])
@pytest.mark.parametrize("kind", ["row", "batch", "ngram"])
def test_coalesced_rows_equal_jax(synthetic_dataset, scalar_store, kind, coalescing):
    kw = dict(reader_pool_type="thread", workers_count=2, shuffle_row_groups=True, seed=9,
              rowgroup_coalescing=coalescing)
    if kind == "batch":
        def read(factory):
            with factory(scalar_store, **kw) as r:
                return [(b.id.tolist(), b.val.tolist()) for b in r], r._num_items
    elif kind == "row":
        def read(factory):
            with factory(synthetic_dataset.url, schema_fields=["id", "matrix"], **kw) as r:
                return [(int(x.id), x.matrix.tobytes()) for x in r], r._num_items
    else:
        def read(factory):
            cls = NGram if factory is make_reader else JaxNGram
            ngram = cls({0: ["id", "id2"], 1: ["id"]}, delta_threshold=1, timestamp_field="id")
            with factory(synthetic_dataset.url, schema_fields=ngram, **kw) as r:
                return [(int(w[0].id), int(w[1].id)) for w in r], r._num_items
    port = read(make_reader if kind != "batch" else make_batch_reader)
    jax = read(jax_make_reader if kind != "batch" else jax_make_batch_reader)
    assert port == jax and port[0]
    if kind == "batch":   # two files of six groups each
        assert port[1] == 2 * -(-6 // coalescing)


def test_a_cursor_resumes_only_under_its_coalescing(scalar_store):
    kw = dict(reader_pool_type="dummy", seed=2)
    with make_batch_reader(scalar_store, rowgroup_coalescing=3, **kw) as r:
        next(r)
        state = r.state_dict()
    with make_batch_reader(scalar_store, rowgroup_coalescing=3, resume_state=state, **kw) as r:
        assert sum(len(b.id) for b in r) >= 60
    with pytest.raises(ValueError, match="rowgroup_coalescing"):
        make_batch_reader(scalar_store, resume_state=state, **kw)


def test_the_cli_passes_rowgroup_coalescing(monkeypatch, scalar_store):
    from petastorm_tpu_torch.benchmark import cli, throughput
    seen = {}

    def fake(url, **kw):
        seen.update(kw)
        raise SystemExit(0)
    monkeypatch.setattr(throughput, "reader_throughput", fake)
    with pytest.raises(SystemExit):
        cli.main([scalar_store, "--rowgroup-coalescing", "4"])
    assert seen["reader_extra_kwargs"] == {"rowgroup_coalescing": 4}


# ---------------------------------------------------------------- exports
@pytest.mark.parametrize("name", ["PetastormTpuError", "MetadataError",
                                  "MetadataGenerationError", "NoDataAvailableError",
                                  "SchemaError"])
def test_error_classes_are_exported_as_in_the_jax_package(name):
    import petastorm_tpu
    import petastorm_tpu_torch
    from petastorm_tpu_torch import errors
    exported = getattr(petastorm_tpu_torch, name)
    assert exported is getattr(errors, name) and name in petastorm_tpu_torch.__all__
    assert issubclass(exported, petastorm_tpu_torch.PetastormTpuError)
    assert exported.__name__ == getattr(petastorm_tpu, name).__name__
