"""The port's random-access plane (``petastorm_tpu_torch.index``,
``Reader.lookup``, ``Reader.dataset_view``, ``gather_rows``) held to the JAX
package's on the CPU: the cases of ``tests/test_index.py`` through both
packages on the same seeded stores. Both packages' builds write the same sidecar
and each package loads the other's; lookups, views and
``gather_rows(to_device=False)`` equal the JAX plane's on the same keys
and equal an epoch read of the same rows (thread and process pools); the
telemetry counts, the quarantine's skip-and-record and fail-fast paths,
the legacy bridge and the SLO rule are the JAX package's. Exact
comparisons. Controls: a sidecar with a wrong row offset, and a lookup
plane whose disk tier stores decoded values, must fail the comparisons.
The appended-file case runs the planes' ``extend_files``; the readers'
growth reconciliation after ``refresh_dataset()`` is held to the JAX
package's in ``tests/test_torch_live_data.py``."""
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.index as jidx
import petastorm_tpu_torch.index as tidx
import petastorm_tpu_torch.resilience as tres
from petastorm_tpu.autotune import InMemoryRowGroupCache as JaxMemCache
from petastorm_tpu.etl.dataset_metadata import DatasetContext as JaxContext
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.telemetry import make_registry as jax_registry
from petastorm_tpu_torch.autotune import InMemoryRowGroupCache
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext
from petastorm_tpu_torch.local_disk_cache import LocalDiskCache
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.reader_impl.row_reader_worker import RowReaderWorker
from petastorm_tpu_torch.resilience import InjectedCorruptionError
from petastorm_tpu_torch.telemetry import make_registry
from resilience_parity import fast_policy

PACKAGES = [(jidx, JaxContext, jax_registry), (tidx, DatasetContext, make_registry)]


def both(fn):
    return [fn(*p) for p in PACKAGES]


def same(pair):
    assert pair[1] == pair[0]
    return pair[1]


def write_scalar_file(path, start, rows=20, row_group_size=10):
    pq.write_table(pa.table({"id": pa.array(np.arange(start, start + rows)),
                             "val": pa.array(np.arange(start, start + rows, dtype=np.float64))}),
                   path, row_group_size=row_group_size)


@pytest.fixture()
def indexed_store(tmp_path):
    """A plain Parquet store (a: ids 0-19, b: ids 20-39, 10 rows a group)
    with the port's field index on ``id``."""
    root = str(tmp_path / "store")
    os.makedirs(root)
    write_scalar_file(f"{root}/a.parquet", 0)
    write_scalar_file(f"{root}/b.parquet", 20)
    tidx.build_field_index(f"file://{root}", ["id"])
    return root


@pytest.fixture(scope="module")
def synthetic_indexed(tmp_path_factory):
    """A store of its own (the shared one may get other sidecars): the
    synthetic petastorm dataset, 100 rows in 10 groups, indexed on ``id``."""
    from dataset_utils import create_test_dataset
    url = f"file://{tmp_path_factory.mktemp('indexed')}/ds"
    create_test_dataset(url, num_rows=100, rows_per_row_group=10)
    tidx.build_field_index(url, ["id"])
    return url


def cells_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def rows_equal(got, want) -> bool:
    return len(got) == len(want) and all(
        (g is None and w is None) or (g is not None and w is not None and set(g) == set(w)
                                      and all(cells_equal(g[k], w[k]) for k in g))
        for g, w in zip(got, want))


def rows_match_epoch(rows, keys, epoch_rows) -> bool:
    return [int(r["id"]) for r in rows] == keys and all(
        set(r) == set(epoch_rows[int(r["id"])])
        and all(cells_equal(c, epoch_rows[int(r["id"])][n]) for n, c in r.items())
        for r in rows)


def index_counters(plane) -> dict:
    return {k: v for k, v in plane._telemetry.metrics_view()["counters"].items()
            if k.startswith("index.")}


# ------------------------------------------------------------------ sidecar
@pytest.mark.parametrize("value", [42, np.int64(42), True, 0.5, np.float32(0.5), "abc",
                                   b"\x01\xff", 1, "1", b"1", -3, 1e300])
def test_encode_key_typed_tags_equal_jax(value):
    assert tidx.encode_key(value) == jidx.encode_key(value)


def test_encode_key_refuses_as_jax():
    for pkg in (jidx, tidx):
        with pytest.raises(TypeError, match="unindexable"):
            pkg.encode_key(object())
    assert len({tidx.encode_key(1), tidx.encode_key("1"), tidx.encode_key(b"1")}) == 3


def test_build_load_roundtrip_equal_jax(indexed_store, tmp_path):
    url = f"file://{indexed_store}"
    path = os.path.join(indexed_store, tidx.INDEX_SIDECAR_NAME)
    with open(path) as f:
        port_doc = json.load(f)
    jax_built = jidx.build_field_index(url, ["id"])
    with open(path) as f:
        assert json.load(f) == port_doc == jax_built.to_dict()
    # Each package loads the other's file.
    jax_loaded = jidx.FieldIndex.load(JaxContext(url))
    tidx.build_field_index(url, ["id"])
    port_loaded = tidx.FieldIndex.load(DatasetContext(url))
    assert port_loaded.to_dict() == jax_loaded.to_dict() == port_doc
    idx = port_loaded
    assert idx.files == ["a.parquet", "b.parquet"] and idx.row_counts == [[10, 10], [10, 10]]
    assert idx.num_rows == 40 and idx.generation == 1 and idx.fields_indexed == ["id"]
    assert idx.entries_for("id", 27) == [("b.parquet", 0, 7)] == \
        jax_loaded.entries_for("id", 27)
    assert idx.entries_for("id", 999) == []
    with pytest.raises(MetadataError, match="not indexed"):
        idx.entries_for("val", 1.0)
    assert tidx.INDEX_FORMAT == jidx.INDEX_FORMAT and \
        tidx.INDEX_SIDECAR_NAME == jidx.INDEX_SIDECAR_NAME and \
        tidx.GROUP_GRANULAR == jidx.GROUP_GRANULAR


def test_load_missing_and_bad_format_as_jax(tmp_path):
    root = str(tmp_path / "empty")
    os.makedirs(root)
    write_scalar_file(f"{root}/a.parquet", 0)

    def run(pkg, ctx, _):
        with pytest.raises(Exception, match="build_field_index") as missing:
            pkg.FieldIndex.load(ctx(f"file://{root}"))
        with pytest.raises(Exception, match="unsupported field-index") as bad:
            pkg.FieldIndex.from_dict({"format": "petastorm-tpu.field-index.v999"})
        return type(missing.value).__name__, type(bad.value).__name__
    assert same(both(run)) == ("MetadataError", "MetadataError")


@pytest.mark.parametrize("ordinal", [0, 15, 20, -1, 39, 40, -41])
def test_ordinal_space_equal_jax(indexed_store, ordinal):
    def run(pkg, ctx, _):
        idx = pkg.FieldIndex.load(ctx(f"file://{indexed_store}"))
        try:
            return idx.ordinal_to_location(ordinal)
        except IndexError:
            return "IndexError"
    assert same(both(run)) == {0: ("a.parquet", 0, 0), 15: ("a.parquet", 1, 5),
                               20: ("b.parquet", 0, 0), -1: ("b.parquet", 1, 9),
                               39: ("b.parquet", 1, 9)}.get(ordinal, "IndexError")


def test_extend_field_index_monotonic_equal_jax(tmp_path):
    def run(pkg, _ctx, _reg):
        root = str(tmp_path / pkg.__name__)
        os.makedirs(root)
        write_scalar_file(f"{root}/a.parquet", 0)
        write_scalar_file(f"{root}/b.parquet", 20)
        pkg.build_field_index(f"file://{root}", ["id"])
        write_scalar_file(f"{root}/c.parquet", 40)
        idx = pkg.extend_field_index(f"file://{root}")
        again = pkg.extend_field_index(f"file://{root}")
        return (idx.to_dict(), idx.entries_for("id", 45), idx.entries_for("id", 27),
                again.generation, again.num_rows)
    doc, e45, e27, gen, rows = same(both(run))
    assert doc["files"] == ["a.parquet", "b.parquet", "c.parquet"] and doc["generation"] == 2
    assert e45 == [("c.parquet", 0, 5)] and e27 == [("b.parquet", 0, 7)]
    assert (gen, rows) == (2, 60)


# ------------------------------------------------------- epoch cell identity
def _epoch_rows(url, pool):
    with make_reader(url, reader_pool_type=pool, workers_count=2, shuffle_row_groups=False,
                     num_epochs=1) as reader:
        return {int(s.id): s._asdict() for s in reader}


@pytest.mark.parametrize("pool,keys", [("thread", [3, 17, 42, 99, 64]),
                                       ("process", [5, 28, 77])])
def test_lookup_equal_epoch_and_jax(synthetic_indexed, pool, keys):
    epoch_rows = _epoch_rows(synthetic_indexed, pool)
    with make_reader(synthetic_indexed, reader_pool_type=pool, workers_count=2,
                     shuffle_row_groups=False, num_epochs=1) as reader:
        rows = reader.lookup(keys)
        assert rows_match_epoch(rows, keys, epoch_rows)
        view = reader.dataset_view()
        assert rows_equal(view[[int(k) for k in keys]], rows)
    jax_plane = jidx.IndexLookupPlane.for_dataset(synthetic_indexed)
    try:
        assert rows_equal(rows, jax_plane.lookup(keys))
    finally:
        jax_plane.close()


def test_control_wrong_row_offset_fails_the_epoch_comparison(synthetic_indexed, tmp_path):
    """A sidecar whose entry for one key points one row further must fail
    the lookup-vs-epoch comparison."""
    import shutil
    root = str(tmp_path / "ds")
    shutil.copytree(synthetic_indexed[len("file://"):], root)
    path = os.path.join(root, tidx.INDEX_SIDECAR_NAME)
    with open(path) as f:
        doc = json.load(f)
    entry = doc["fields"]["id"][tidx.encode_key(42)][0]
    entry[2] = (entry[2] + 1) % 10
    with open(path, "w") as f:
        json.dump(doc, f)
    epoch_rows = _epoch_rows(synthetic_indexed, "thread")
    with make_reader(f"file://{root}", reader_pool_type="dummy", num_epochs=1) as reader:
        assert not rows_match_epoch(reader.lookup([42]), [42], epoch_rows)
        assert rows_match_epoch(reader.lookup([41]), [41], epoch_rows)


# ------------------------------------------------ grouping and cache sharing
def test_lookup_coalesces_and_shares_decoded_cache_as_jax(indexed_store):
    def run(pkg, _ctx, registry):
        cache = (JaxMemCache if pkg is jidx else InMemoryRowGroupCache)(1 << 24)
        reg = registry()
        plane = pkg.IndexLookupPlane.for_dataset(f"file://{indexed_store}", cache=cache,
                                                 telemetry=reg)
        try:
            first = plane.lookup([1, 3, 5, 7])
            c1 = index_counters(plane)
            second = plane.lookup([2, 4])
            c2 = index_counters(plane)
            hist = reg.metrics_view()["histograms"]["index.lookup_s"]["count"]
        finally:
            plane.close()
        return ([{k: float(v) for k, v in r.items()} for r in first + second],
                {k: v for k, v in c1.items() if k != "index.growth_files_total"},
                {k: v for k, v in c2.items() if k != "index.growth_files_total"}, hist)
    rows, c1, c2, hist = same(both(run))
    assert [int(r["id"]) for r in rows] == [1, 3, 5, 7, 2, 4]
    assert c1["index.rowgroups_touched_total"] == 1 and c1["index.cache_misses_total"] == 1
    assert c2["index.rowgroups_touched_total"] == 2 and c2["index.cache_hits_total"] == 1
    assert c2["index.rows_served_total"] == 6 and hist == 2


def test_lookup_shares_the_readers_cache_with_the_epoch(synthetic_indexed):
    with make_reader(synthetic_indexed, reader_pool_type="thread", workers_count=2,
                     memory_cache_size_bytes=1 << 30, num_epochs=1) as reader:
        epoch_rows = {int(s.id): s._asdict() for s in reader}
        keys = [7, 33, 90, 91]
        assert rows_match_epoch(reader.lookup(keys), keys, epoch_rows)
        c = reader.telemetry.metrics_view()["counters"]
    assert c["index.cache_hits_total"] == 3 and c["index.cache_misses_total"] == 0


@pytest.mark.parametrize("raw_tier_stores_decoded", [False, True], ids=["raw", "control"])
def test_lookup_through_the_disk_tier(synthetic_indexed, tmp_path, monkeypatch,
                                      raw_tier_stores_decoded):
    """The disk tier's lookups decode each retrieval and equal the epoch
    rows, hits after the epoch's fills; a plane whose disk fill stores the
    decoded columns (the control) must fail that comparison."""
    if raw_tier_stores_decoded:
        real = RowReaderWorker._read_columns

        def decoded_fill(self, rowgroup, columns, zero_copy=True):
            data, n = real(self, rowgroup, columns)
            return (data, n) if zero_copy else (self._decode_columns(data, np.arange(n)), n)
        monkeypatch.setattr(RowReaderWorker, "_read_columns", decoded_fill)
    epoch_rows = _epoch_rows(synthetic_indexed, "thread")
    kw = dict(cache_type="local-disk", cache_location=str(tmp_path / "c"),
              cache_size_limit=1 << 30)
    keys = [4, 58, 99]
    try:
        with make_reader(synthetic_indexed, reader_pool_type="dummy", **kw) as reader:
            assert len(list(reader)) == 100
            rows = reader.lookup(keys)
            c = reader.telemetry.metrics_view()["counters"]
        ok = rows_match_epoch(rows, keys, epoch_rows)
    except Exception:  # noqa: BLE001 - a decode of decoded cells may raise
        ok = False
    assert ok is not raw_tier_stores_decoded
    if not raw_tier_stores_decoded:
        assert c["index.cache_hits_total"] == 3 and c["index.cache_misses_total"] == 0
        assert len(LocalDiskCache(str(tmp_path / "c"), 1 << 30)) == 10


def test_lookup_missing_key_semantics_as_jax(indexed_store):
    def run(pkg, _ctx, registry):
        plane = pkg.IndexLookupPlane.for_dataset(f"file://{indexed_store}",
                                                 telemetry=registry())
        try:
            with pytest.raises(KeyError, match="not in the 'id' index") as e:
                plane.lookup([1, 999])
            rows = plane.lookup([1, 999, 2], on_missing="skip")
            return (str(e.value), [int(r["id"]) for r in rows],
                    index_counters(plane)["index.keys_missing_total"])
        finally:
            plane.close()
    assert same(both(run))[1:] == ([1, 2], 1)


def test_lookup_column_projection_as_jax(indexed_store):
    def run(pkg, _ctx, _reg):
        plane = pkg.IndexLookupPlane.for_dataset(f"file://{indexed_store}")
        try:
            rows = plane.lookup([8], columns=["val"])
            with pytest.raises(ValueError, match="unknown column") as e:
                plane.lookup([8], columns=["nope"])
            return [{k: float(v) for k, v in r.items()} for r in rows], str(e.value)
        finally:
            plane.close()
    assert same(both(run))[0] == [{"val": 8.0}]


def test_extend_files_makes_appended_keys_visible_as_jax(indexed_store):
    def run(pkg, ctx, registry):
        url = f"file://{indexed_store}"
        plane = pkg.IndexLookupPlane.for_dataset(url, telemetry=registry())
        try:
            with pytest.raises(KeyError):
                plane.lookup([45])
            path = f"{indexed_store}/c_{pkg.__name__}.parquet"
            write_scalar_file(path, 40)
            added = plane.extend_files([(path, 2)])
            again = plane.extend_files([(path, 2)])
            row = plane.lookup([45])[0]
            return (added, again, int(row["id"]), plane.index.num_rows, plane.index.generation,
                    index_counters(plane)["index.growth_files_total"])
        finally:
            plane.close()
            os.remove(f"{indexed_store}/c_{pkg.__name__}.parquet")
    assert same(both(run)) == (1, 0, 45, 60, 2, 1)


# -------------------------------------------------------------- quarantine
def _faulty(pkg_res):
    return pkg_res.FaultPlan([pkg_res.FaultSpec(site="rowgroup.read", kind="corruption",
                                                rate=1.0, key_substring="b.parquet")], seed=0)


def test_quarantined_group_lookup_skips_and_records_as_jax(indexed_store):
    import petastorm_tpu.resilience as jres

    def run(factory, res):
        with factory(f"file://{indexed_store}", reader_pool_type="dummy", num_epochs=1,
                     retry_policy=fast_policy(res), degraded_mode=True,
                     fault_plan=_faulty(res)) as reader:
            rows = reader.lookup([5, 25, 15])
            report = reader.quarantine_report()
            skipped = reader.telemetry.metrics_view()["counters"]["index.keys_skipped_total"]
            view = reader.dataset_view()
            got = view[[5, 25]]
            with pytest.raises(LookupError, match="quarantined"):
                view[25]
            return ([int(r["id"]) for r in rows], report["quarantined"] >= 1,
                    any("b.parquet" in p["path"] for p in report["pieces"]), skipped,
                    int(got[0]["id"]), got[1])
    port = run(make_batch_reader, tres)
    assert port == run(jax_make_batch_reader, jres) == ([5, 15], True, True, 1, 5, None)


def test_lookup_corruption_without_degraded_mode_fails_fast(indexed_store):
    with make_batch_reader(f"file://{indexed_store}", reader_pool_type="dummy", num_epochs=1,
                           retry_policy=fast_policy(tres), fault_plan=_faulty(tres)) as reader:
        with pytest.raises(InjectedCorruptionError):
            reader.lookup([25])
        assert reader.lookup([5])[0]["id"] == 5


# ------------------------------------------------------------- DatasetView
def test_dataset_view_access_modes_as_jax(indexed_store):
    def run(pkg, _ctx, _reg):
        plane = pkg.IndexLookupPlane.for_dataset(f"file://{indexed_store}")
        try:
            view = pkg.DatasetView(plane)
            with pytest.raises(IndexError):
                view[40]
            return (len(view), int(view[0]["id"]), int(view[-1]["id"]),
                    [int(r["id"]) for r in view[18:22]],
                    [int(r["id"]) for r in view[[7, 33, 12]]],
                    sorted(pkg.DatasetView(plane, columns=["val"])[3]))
        finally:
            plane.close()
    assert same(both(run)) == (40, 0, 39, [18, 19, 20, 21], [7, 33, 12], ["val"])


def test_dataset_view_slices_equal_lookup(synthetic_indexed):
    with make_reader(synthetic_indexed, reader_pool_type="dummy") as reader:
        idx = reader._ensure_lookup_plane().index
        ordinals = [idx.num_rows - 1, 0, 57]
        ids = [int(r["id"]) for r in reader.dataset_view()[ordinals]]
        assert rows_equal(reader.dataset_view()[ordinals], reader.lookup(ids))
        assert rows_equal(reader.dataset_view()[10:14],
                          reader.lookup([int(r["id"]) for r in reader.dataset_view()[10:14]]))


def test_dataset_view_stable_across_resume(indexed_store):
    url = f"file://{indexed_store}"

    def mk(resume=None):
        return make_batch_reader(url, reader_pool_type="dummy", num_epochs=2,
                                 shuffle_row_groups=True, seed=7, sample_order="deterministic",
                                 resume_state=resume)

    probe = [0, 13, 27, 39]
    with mk() as r:
        next(iter(r))
        before = [int(r.dataset_view()[i]["id"]) for i in probe]
        cursor = r.state_dict()
    with mk(resume=cursor) as r2:
        after = [int(r2.dataset_view()[i]["id"]) for i in probe]
    assert before == after == probe


# ------------------------------------------------------------ legacy bridge
def test_legacy_build_warns_and_bridges_as_jax(tmp_path):
    import petastorm_tpu.etl.rowgroup_indexers as jix
    import petastorm_tpu.etl.rowgroup_indexing as jing
    import petastorm_tpu_torch.etl.rowgroup_indexers as tix
    import petastorm_tpu_torch.etl.rowgroup_indexing as ting

    def run(ix, ing, pkg, ctx_cls):
        root = str(tmp_path / pkg.__name__)
        os.makedirs(root)
        ids = np.arange(40)
        pq.write_table(pa.table({"id": ids, "part": [f"p{i % 4}" for i in ids]}),
                       f"{root}/a.parquet", row_group_size=10)
        url = f"file://{root}"
        with pytest.warns(DeprecationWarning, match="random-access"):
            ing.build_rowgroup_index(url, [ix.SingleFieldIndexer("by_part", "part"),
                                           ix.FieldNotNullIndexer("nn", "part")])
        ctx = ctx_cls(url)
        legacy = sorted(ing.get_row_group_indexes(ctx))
        doc = pkg.FieldIndex.load(ctx).to_dict()
        plane = pkg.IndexLookupPlane.for_dataset(url)
        try:
            rows = sorted(int(r["id"]) for r in plane.lookup(["p2"], field="part"))
        finally:
            plane.close()
        return legacy, doc, rows
    jax_out = run(jix, jing, jidx, JaxContext)
    port_out = run(tix, ting, tidx, DatasetContext)
    assert port_out == jax_out
    legacy, doc, rows = port_out
    assert legacy == ["by_part", "nn"] and sorted(doc["fields"]) == ["part"]
    assert all(off == tidx.GROUP_GRANULAR for _, _, off in
               tidx.FieldIndex.from_dict(doc).entries_for("part", "p2"))
    assert rows == list(range(2, 40, 4))


def test_legacy_bridge_writes_the_field_index_contents(tmp_path):
    """``build_rowgroup_index(emit_field_index=True)`` on a store whose key
    is unique per row: its bridged entries name the same groups as
    ``build_field_index``'s exact ones; with ``emit_field_index=False`` no
    sidecar is written."""
    import petastorm_tpu_torch.etl.rowgroup_indexers as tix
    import petastorm_tpu_torch.etl.rowgroup_indexing as ting
    root = str(tmp_path / "s")
    os.makedirs(root)
    write_scalar_file(f"{root}/a.parquet", 0)
    url = f"file://{root}"
    with pytest.warns(DeprecationWarning):
        ting.build_rowgroup_index(url, [tix.SingleFieldIndexer("by_id", "id")],
                                  emit_field_index=False)
    assert not os.path.exists(os.path.join(root, tidx.INDEX_SIDECAR_NAME))
    with pytest.warns(DeprecationWarning):
        ting.build_rowgroup_index(url, [tix.SingleFieldIndexer("by_id", "id")])
    bridged = tidx.FieldIndex.load(DatasetContext(url))
    exact = tidx.build_field_index(url, ["id"], save=False)
    assert bridged.files == exact.files and bridged.row_counts == exact.row_counts
    assert {k: [e[:2] for e in v] for k, v in bridged.fields["id"].items()} == \
        {k: [e[:2] for e in v] for k, v in exact.fields["id"].items()}


# ----------------------------------------------------------- batched gather
def test_gather_rows_equal_jax(indexed_store):
    def run(pkg, _ctx, registry):
        plane = pkg.IndexLookupPlane.for_dataset(f"file://{indexed_store}",
                                                 telemetry=registry())
        try:
            batch = pkg.gather_rows(plane.lookup([4, 30, 11]), to_device=False,
                                    telemetry=plane._telemetry)
            return ({k: (v.dtype.str, v.tolist()) for k, v in batch.items()},
                    index_counters(plane).get("index.gather_rows_total"))
        finally:
            plane.close()
    batch, gathered = same(both(run))
    assert batch == {"id": ("<i8", [4, 30, 11]), "val": ("<f8", [4.0, 30.0, 11.0])}
    assert gathered == 3


def test_gather_rows_onto_the_cpu_when_asked(indexed_store):
    import torch
    plane = tidx.IndexLookupPlane.for_dataset(f"file://{indexed_store}",
                                              telemetry=make_registry())
    try:
        batch = plane.gather([2, 21, 33], device="cpu")
        assert batch["id"].device == torch.device("cpu") and batch["id"].tolist() == [2, 21, 33]
        assert batch["val"].dtype == torch.float64
        assert index_counters(plane)["index.gather_rows_total"] == 3
        rows = plane.lookup([2])
        out = tidx.gather_rows(rows, device="cpu")
        out["val"][0] = -1.0   # the gather copies: the rows are untouched
        assert rows[0]["val"] == 2.0
    finally:
        plane.close()


def test_gather_rows_edge_semantics_as_jax():
    rows = [{"x": np.float32(1.0), "s": "a"}, None, {"x": np.float32(2.0), "s": "b"}]

    def run(pkg, _ctx, _reg):
        host = pkg.gather_rows(rows, to_device=False)
        with pytest.raises(TypeError, match="'s'"):
            pkg.gather_rows(rows, fields=["s"], to_device=False)
        return ({k: v.tolist() for k, v in host.items()}, pkg.gather_rows([]),
                pkg.gather_rows([None, None]))
    assert same(both(run)) == ({"x": [1.0, 2.0]}, {}, {})


# -------------------------------------------------------------- SLO, series
def test_lookup_p99_rule_and_series_membership():
    from petastorm_tpu_torch.telemetry.slo import (DEFAULT_RULES, evaluate_rules, parse_rules,
                                                   rule_value)
    from petastorm_tpu_torch.telemetry.timeseries import DEFAULT_SERIES
    rule = {r.name: r for r in DEFAULT_RULES}["index_lookup_p99_s"]
    assert rule.kind == "p99" and rule.metric == "index.lookup_s" and rule.max_value == 0.010
    assert parse_rules("index_lookup_p99_s<=0.02")[0].max_value == 0.02
    series = {s.name: s for s in DEFAULT_SERIES}
    assert series["index.lookup_p99_s"].metric == "index.lookup_s"
    assert series["index.lookups_per_s"].kind == "rate"
    assert rule_value(rule, {"histograms": {}}) is None
    bad = {"histograms": {"index.lookup_s": {"count": 100, "p99": 0.5}}}
    assert any(v["rule"] == "index_lookup_p99_s" for v in evaluate_rules(bad, [rule]))


def test_slo_evaluable_from_live_lookup_snapshot(indexed_store):
    from petastorm_tpu_torch.telemetry.slo import DEFAULT_RULES, evaluate_rules
    registry = make_registry()
    plane = tidx.IndexLookupPlane.for_dataset(f"file://{indexed_store}",
                                              cache=InMemoryRowGroupCache(1 << 24),
                                              telemetry=registry)
    try:
        plane.lookup([1])
        for _ in range(20):
            plane.lookup([2, 17, 35])
        snap = registry.metrics_view()
        assert snap["histograms"]["index.lookup_s"]["count"] == 21
        rules = [r for r in DEFAULT_RULES if r.name == "index_lookup_p99_s"]
        assert evaluate_rules(snap, rules) == []
    finally:
        plane.close()
