"""Statistics pruning of petastorm_tpu_torch against the JAX package
(``tests/test_io_pruning.py`` case by case): the footer statistics
``load_row_group_stats`` reads, and the readers' plan-time pruning, on the
same stores with the same kwargs in both packages. Kept rows, their order,
``pruning_report()`` (with ``column_stats``) and the pruning counters must
be equal; so must a JAX cursor saved under pruning and resumed in the
port."""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.predicates as jp
import petastorm_tpu_torch.predicates as tp
from petastorm_tpu.etl import dataset_metadata as jmeta
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.etl import dataset_metadata as tmeta
from petastorm_tpu_torch.reader import make_batch_reader, make_reader

pytestmark = pytest.mark.io


@pytest.fixture(autouse=True)
def _no_plan_cache(monkeypatch):
    monkeypatch.setenv("PETASTORM_TPU_PLAN_CACHE", "off")


def _write_store(path, table, row_group_size=10, **kw):
    os.makedirs(path, exist_ok=True)
    pq.write_table(table, os.path.join(path, "part0.parquet"), row_group_size=row_group_size,
                   **kw)
    return f"file://{path}"


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The JAX tests' stores, written once: ``monotonic`` (100 rows in 10
    groups, a float column all-NaN in group 3, a nullable column all-null
    in group 4), ``nostats`` (statistics off), ``hive`` (two year
    partitions), ``summary`` (with a summary ``_metadata``)."""
    root = tmp_path_factory.mktemp("torch_prune")
    rng = np.random.default_rng(0)
    n = 100
    f = np.linspace(0.0, 1.0, n)
    f[30:40] = np.nan
    v = pa.array([None if 40 <= i < 50 else i for i in range(n)], type=pa.int64())
    out = {"monotonic": _write_store(str(root / "mono"), pa.table({
        "id": np.arange(n, dtype=np.int64), "f": f, "v": v,
        "noise": rng.standard_normal(n)}))}
    out["nostats"] = _write_store(str(root / "nostats"), pa.table({
        "id": np.arange(50, dtype=np.int64)}), write_statistics=False)
    hive = str(root / "hive")
    for year, base in (("2023", 0), ("2024", 100)):
        _write_store(os.path.join(hive, f"year={year}"), pa.table({
            "id": np.arange(base, base + 20, dtype=np.int64)}))
    out["hive"] = f"file://{hive}"
    out["summary"] = _write_store(str(root / "summary"), pa.table({
        "id": np.arange(60, dtype=np.int64), "s": [f"k{i:03d}" for i in range(60)]}))
    tmeta.write_summary_metadata(out["summary"])
    return out


# ------------------------------------------------------ load_row_group_stats
def _stats_tuple(st):
    return (st.min, st.max, st.null_count, st.num_rows, st.has_min_max)


def _both_stats(url, columns, refs=None, **kw):
    out = []
    for meta in (jmeta, tmeta):
        ctx = meta.DatasetContext(url)
        rgs = meta.load_row_groups(ctx) if refs is None else refs(meta, ctx)
        stats = meta.load_row_group_stats(ctx, rgs, columns, **kw)
        out.append({k: {c: _stats_tuple(s) for c, s in v.items()} for k, v in stats.items()})
    return out


STATS_CASES = {
    "footer": lambda t: (_write_store(str(t / "ds"), pa.table({
        "id": np.arange(40, dtype=np.int64), "s": [f"k{i:03d}" for i in range(40)]})),
        {"id", "s"}),
    "disabled statistics": lambda t: (_write_store(str(t / "ds"), pa.table({
        "id": np.arange(20, dtype=np.int64)}), write_statistics=False), {"id"}),
    "null counts": lambda t: (_write_store(str(t / "ds"), pa.table({
        "v": pa.array([None] * 10 + list(range(10)), type=pa.int64())})), {"v"}),
    "nested column": lambda t: (_write_store(str(t / "ds"), pa.table({
        "id": np.arange(10, dtype=np.int64),
        "vec": pa.array([[1.0, 2.0]] * 10, type=pa.list_(pa.float32()))})), {"id", "vec"}),
    "nan bounds": lambda t: (_write_store(str(t / "ds"), pa.table({
        "f": np.where(np.arange(30) < 10, np.nan, np.arange(30, dtype=np.float64))})), {"f"}),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_footer_stats_equal_jax(tmp_path, case):
    url, columns = STATS_CASES[case](tmp_path)
    port, jax = _both_stats(url, columns)
    assert port == jax and port


def test_summary_metadata_stats_equal_the_footer_scan(stores):
    """The summary ``_metadata`` path gives what the footers give, and the
    JAX package's answer."""
    url = stores["summary"]
    port, jax = _both_stats(url, {"id", "s"})
    assert port == jax and len(port) == 6
    ctx = tmeta.DatasetContext(url)
    assert tmeta._read_summary_metadata(ctx) is not None
    os.rename(os.path.join(ctx.root_path, "_metadata"), os.path.join(ctx.root_path, "_saved"))
    try:
        footers, _ = _both_stats(url, {"id", "s"})
    finally:
        os.rename(os.path.join(ctx.root_path, "_saved"), os.path.join(ctx.root_path, "_metadata"))
    assert footers == port


def test_unreadable_footer_is_counted_and_gives_no_stats(tmp_path):
    url = _write_store(str(tmp_path / "ds"), pa.table({"id": np.arange(20, dtype=np.int64)}))
    bad = os.path.join(str(tmp_path / "ds"), "bad.parquet")
    with open(bad, "wb") as f:
        f.write(b"not a parquet file at all")
    from petastorm_tpu.resilience import RetryPolicy as JaxPolicy
    from petastorm_tpu.telemetry import make_registry as jax_registry
    from petastorm_tpu_torch.resilience import RetryPolicy
    from petastorm_tpu_torch.telemetry import make_registry
    counts = []
    for meta, registry, policy in ((jmeta, jax_registry(), JaxPolicy(max_attempts=1)),
                                   (tmeta, make_registry(), RetryPolicy(max_attempts=1))):
        ctx = meta.DatasetContext(url)
        refs = [meta.RowGroupRef(os.path.join(ctx.root_path, "part0.parquet"), 0),
                meta.RowGroupRef(bad, 0)]
        stats = meta.load_row_group_stats(ctx, refs, {"id"}, telemetry=registry,
                                          retry_policy=policy)
        counts.append((sorted(stats), registry.snapshot()["counters"].get(
            "io.stats_footer_errors_total")))
    assert counts[0] == counts[1]
    assert counts[0][1] == 1 and all(path != bad for path, _ in counts[0][0])


# ------------------------------------------------------------ reader pruning
def _batch_ids(reader):
    return [int(x) for b in reader for x in b.id]


def _row_ids(reader):
    return [int(r.id) for r in reader]


def _read(factory, url, ids_of, **kw):
    with factory(url, **kw) as r:
        ids = ids_of(r)
        report = r.pruning_report()
        counters = r.telemetry.snapshot()["counters"]
    return ids, report, {k: counters.get(k) for k in ("io.rowgroups_pruned",
                                                      "io.rowgroups_planned")}


BATCH_CASES = {
    "range": ("monotonic", lambda p: dict(predicate=p.in_range("id", 0, 25))),
    "range shuffled": ("monotonic", lambda p: dict(predicate=p.in_range("id", 0, 25),
                                                   shuffle_row_groups=True, seed=11)),
    "pruning off": ("monotonic", lambda p: dict(predicate=p.in_range("id", 0, 25),
                                                rowgroup_pruning=False)),
    "no intervals": ("monotonic", lambda p: dict(predicate=p.in_pseudorandom_split(
        [0.5, 0.5], 0, "id"))),
    "nan bound": ("monotonic", lambda p: dict(predicate=p.in_range("f", 0.5, 0.65))),
    "all null group": ("monotonic", lambda p: dict(predicate=p.in_set({44}, "v"))),
    "empty plan": ("monotonic", lambda p: dict(predicate=p.in_set({-1}, "id"))),
    "negated": ("monotonic", lambda p: dict(predicate=p.in_negate(p.in_range("id", 10, 90)))),
    "shard 0": ("monotonic", lambda p: dict(predicate=p.in_range("id", 0, 45), cur_shard=0,
                                            shard_count=2)),
    "shard 1": ("monotonic", lambda p: dict(predicate=p.in_range("id", 0, 45), cur_shard=1,
                                            shard_count=2)),
    "disabled statistics": ("nostats", lambda p: dict(predicate=p.in_range("id", 0, 10))),
    "hive key and column": ("hive", lambda p: dict(
        schema_fields=["id"], predicate=p.in_reduce([p.in_set({"2024"}, "year"),
                                                     p.in_range("id", 0, 1000)], all))),
    "hive key only": ("hive", lambda p: dict(schema_fields=["id"],
                                             predicate=p.in_set({"2024"}, "year"))),
    "summary metadata": ("summary", lambda p: dict(predicate=p.in_set({"k015", "k042"}, "s"))),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_reader_pruning_equals_jax(stores, case):
    store, kwargs_of = BATCH_CASES[case]
    common = dict(shuffle_row_groups=False, reader_pool_type="thread", workers_count=2)
    port = _read(make_batch_reader, stores[store], _batch_ids, **{**common, **kwargs_of(tp)})
    jax = _read(jax_make_batch_reader, stores[store], _batch_ids, **{**common, **kwargs_of(jp)})
    assert port == jax


def test_pruned_groups_hold_no_passing_row(stores):
    """Pruning on and off keep the same rows; the report and the counters
    say what was dropped."""
    kw = dict(shuffle_row_groups=False, workers_count=2, predicate=tp.in_range("id", 0, 25))
    on, report, counters = _read(make_batch_reader, stores["monotonic"], _batch_ids, **kw)
    off, report_off, _ = _read(make_batch_reader, stores["monotonic"], _batch_ids,
                               rowgroup_pruning=False, **kw)
    assert on == off == list(range(25))
    assert report["enabled"] and report["row_groups_pruned"] == 7
    assert report["row_groups_kept"] == 3 and report["fields"] == ["id"]
    assert report["column_stats"]["id"] == {"min": 0.0, "max": 99.0, "null_count": 0,
                                            "num_rows": 100, "groups": 10}
    assert counters == {"io.rowgroups_pruned": 7, "io.rowgroups_planned": 3}
    assert not report_off["enabled"]


def test_a_plan_that_pruning_empties_is_an_empty_epoch(stores):
    """An empty pruned plan is not NoDataAvailableError (that stays for
    filters, selectors and shards), in both packages, on every pool."""
    for pool in ("dummy", "thread"):
        for factory, p in ((make_batch_reader, tp), (jax_make_batch_reader, jp)):
            with factory(stores["monotonic"], reader_pool_type=pool, num_epochs=2,
                         predicate=p.in_set({-1}, "id")) as r:
                assert _batch_ids(r) == []
                assert r.pruning_report()["row_groups_kept"] == 0
    from petastorm_tpu_torch.errors import NoDataAvailableError
    with pytest.raises(NoDataAvailableError):
        make_batch_reader(stores["hive"], filters=[("year", "=", "1999")])


ROW_CASES = {
    "range": lambda p: dict(predicate=p.in_range("id", 0, 30)),
    "range shuffled": lambda p: dict(predicate=p.in_range("id", 0, 30), shuffle_row_groups=True,
                                     seed=3),
    "set deterministic": lambda p: dict(predicate=p.in_set({5, 55, 95}, "id"),
                                        shuffle_row_groups=True, seed=4,
                                        sample_order="deterministic"),
    "empty plan": lambda p: dict(predicate=p.in_set({-5}, "id")),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_row_reader_pruning_equals_jax(synthetic_dataset, case):
    common = dict(shuffle_row_groups=False, reader_pool_type="thread", workers_count=2,
                  schema_fields=["id", "id2"])
    port = _read(make_reader, synthetic_dataset.url, _row_ids, **{**common, **ROW_CASES[case](tp)})
    jax = _read(jax_make_reader, synthetic_dataset.url, _row_ids,
                **{**common, **ROW_CASES[case](jp)})
    assert port == jax


@pytest.mark.parametrize("sample_order", ["free", "deterministic"])
def test_a_jax_cursor_saved_under_pruning_resumes_in_the_port(synthetic_dataset, sample_order):
    """The JAX reader prunes, reads 12 rows and saves its cursor; the port
    resumes it (the same work items, so it is accepted) and reads what a
    resumed JAX reader reads."""
    kw = dict(reader_pool_type="dummy", seed=7, shuffle_row_groups=True,
              schema_fields=["id"], sample_order=sample_order)
    with jax_make_reader(synthetic_dataset.url, predicate=jp.in_range("id", 20, 80), **kw) as j:
        head = [int(next(j).id) for _ in range(12)]
        state = j.state_dict()
    with jax_make_reader(synthetic_dataset.url, predicate=jp.in_range("id", 20, 80),
                         resume_state=state, **kw) as j:
        want = _row_ids(j)
    with make_reader(synthetic_dataset.url, predicate=tp.in_range("id", 20, 80),
                     resume_state=state, **kw) as r:
        got = _row_ids(r)
        assert r.pruning_report()["row_groups_kept"] == 6
    assert got == want
    assert set(head) | set(got) == set(range(20, 80))
