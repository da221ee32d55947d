"""Row-group selection and worker transforms of petastorm_tpu_torch against
the JAX package, on the same seeded, hive-partitioned stores: ``filters``,
``predicate``, ``rowgroup_selector``, ``cur_shard`` with ``shard_seed``,
``rowgroup_subset``, ``shuffle_row_drop_partitions`` with ``shuffle_rows``,
per-row, batched and pandas ``TransformSpec``s, and their combinations, on
``make_reader`` and ``make_batch_reader``. On the dummy and thread pools the
rows must be equal in the same order; on the process pool equal as a
multiset. Each error case must raise the same exception type.

Both packages prune row groups by Parquet statistics by default
(``rowgroup_pruning``): a predicate with ``intervals()`` plans the same
fewer groups in each, so the shuffled epochs stay equal in order.
"""
import functools
import os
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.predicates as jp
import petastorm_tpu.selectors as js
import petastorm_tpu_torch.predicates as tp
import petastorm_tpu_torch.selectors as ts
from petastorm_tpu.reader import (make_batch_reader as jax_make_batch_reader,
                                  make_reader as jax_make_reader)
from petastorm_tpu.transform import TransformSpec as JaxSpec
from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, write_dataset_metadata
from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.test_util import transforms as tt
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS, GROUP, PARTS = 120, 8, 4


@pytest.fixture(scope="module")
def row_store(tmp_path_factory):
    """A petastorm store written by the port with ``partition_by=["part"]``:
    4 partitions of 30 rows in groups of 8 (16 groups), an index on
    ``label``."""
    url = f"file://{tmp_path_factory.mktemp('selection')}/rows"
    schema = Unischema("Sel", [
        UnischemaField("id", np.int64, ()), UnischemaField("part", np.int32, ()),
        UnischemaField("label", np.int64, ()), UnischemaField("f0", np.float32, ()),
        UnischemaField("name", np.str_, (), nullable=True),
        UnischemaField("image", np.uint8, (8, 8, 3))])
    rng = np.random.default_rng(5)
    with materialize_dataset_local(url, schema, rows_per_row_group=GROUP,
                                   partition_by=["part"]) as w:
        for i in range(ROWS):
            w.write_row({"id": i, "part": i % PARTS, "label": int(rng.integers(0, 10)),
                         "f0": np.float32(np.nan if i % 11 == 0 else rng.standard_normal()),
                         "name": None if i % 5 == 0 else f"n{i % 13}",
                         "image": rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)})
    build_rowgroup_index(url, [SingleFieldIndexer("label_ix", "label")])
    return url


@pytest.fixture(scope="module")
def batch_store(tmp_path_factory):
    """A plain Parquet store in 4 hive partitions (``part=k``), 2 files each
    of 15 rows in groups of 5: int, float with NaN, string and a
    ``FixedSizeList(6)`` column declared ``(2, 3)``."""
    root = tmp_path_factory.mktemp("selection_batch") / "cols"
    rng = np.random.default_rng(9)
    ident = 0
    for part in range(PARTS):
        os.makedirs(root / f"part={part}")
        for f in range(2):
            n = 15
            ids = np.arange(ident, ident + n)
            ident += n
            f0 = rng.standard_normal(n).astype(np.float32)
            f0[ids % 7 == 0] = np.nan
            table = pa.table({
                "id": ids, "i0": rng.integers(0, 1000, n).astype(np.int32), "f0": f0,
                "s": [f"s{v}" for v in rng.integers(0, 9, n)],
                "vec": pa.array(rng.standard_normal((n, 6)).astype(np.float32).tolist(),
                                type=pa.list_(pa.float32(), 6))})
            pq.write_table(table, str(root / f"part={part}" / f"f{f}.parquet"),
                           row_group_size=5)
    url = f"file://{root}"
    write_dataset_metadata(DatasetContext(url), Unischema("cols", [
        UnischemaField("id", np.int64, ()), UnischemaField("i0", np.int32, ()),
        UnischemaField("f0", np.float32, ()), UnischemaField("s", np.str_, ()),
        UnischemaField("vec", np.float32, (2, 3))]))
    build_rowgroup_index(url, [SingleFieldIndexer("i0_ix", "i0")])
    return url


# ------------------------------------------------------------------ helpers
def _same_value(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def _row_key(row):
    return tuple(np.asarray(v).tobytes() if v is not None else b"<null>" for v in row)


def assert_same_rows(port, jax, ordered=True):
    assert len(port) == len(jax) > 0
    assert port[0]._fields == jax[0]._fields
    if not ordered:
        port, jax = sorted(port, key=_row_key), sorted(jax, key=_row_key)
    for p, j in zip(port, jax):
        for name in p._fields:
            assert _same_value(getattr(p, name), getattr(j, name)), name


def _read_rows(factory, url, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with factory(url, **kwargs) as reader:
            return list(reader), reader.schema


def _read_batches(factory, url, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with factory(url, **kwargs) as reader:
            out = []
            while True:
                try:
                    out.append({k: np.array(v, copy=True) for k, v in reader.next_batch().items()})
                except StopIteration:
                    return out, reader.schema


def _crop(pkg_spec):
    return pkg_spec(functools.partial(tt.center_crop, field="image", size=4),
                    edit_fields=[("image", np.uint8, (4, 4, 3), False)],
                    removed_fields=["name"])


def _batched(pkg_spec):
    return pkg_spec(functools.partial(tt.scale_and_drop, name="f0", factor=3, drop="name"),
                    removed_fields=["name"], batched=True)


def _row_kwargs(pkg, case):
    """The reader arguments of ``case`` built from ``pkg`` (``jp``/``tp``
    predicates, ``js``/``ts`` selectors) for either package."""
    p, s = (tp, ts) if pkg == "port" else (jp, js)
    spec = TransformSpec if pkg == "port" else JaxSpec
    return {
        "filters in": dict(filters=[("part", "in", {1, 3})], seed=2),
        "filters dnf": dict(filters=[[("part", "=", 0)], [("part", ">=", "3")]], seed=3),
        "predicate range": dict(predicate=p.in_range("label", 2, 7), seed=4, shuffle_rows=True),
        "predicate split": dict(predicate=p.in_pseudorandom_split([0.5, 0.5], 1, "id"), seed=5),
        "predicate nulls": dict(predicate=p.in_set({None, "n3", "n7"}, "name"), seed=6),
        "predicate on the partition key": dict(
            predicate=p.in_lambda(["part"], tt.int_field_equals, state=("part", 2)), seed=7),
        "selector": dict(rowgroup_selector=s.SingleIndexSelector("label_ix", [3, 8]), seed=8),
        "selector union": dict(rowgroup_selector=s.UnionIndexSelector(
            [s.SingleIndexSelector("label_ix", [1]), s.SingleIndexSelector("label_ix", [9])]),
            seed=8),
        "shard": dict(cur_shard=1, shard_count=3, seed=9),
        "shard seed": dict(cur_shard=2, shard_count=3, shard_seed=5, seed=9),
        "subset": dict(rowgroup_subset=[7, 2, 15, 0, 9], shuffle_row_groups=False),
        "drop partitions": dict(shuffle_row_drop_partitions=3, shuffle_rows=True, seed=10),
        "row transform": dict(transform_spec=_crop(spec), seed=11),
        "batched transform": dict(transform_spec=_batched(spec), seed=12, shuffle_rows=True),
        "combined": dict(filters=[("part", "!=", 1)],
                         predicate=p.in_pseudorandom_split([0.7, 0.3], 0, "id"),
                         cur_shard=0, shard_count=2, shard_seed=3,
                         shuffle_row_drop_partitions=2, shuffle_rows=True,
                         transform_spec=_crop(spec), seed=13),
        "combined subset": dict(filters=[("part", "in", [0, 2])],
                                rowgroup_selector=s.SingleIndexSelector("label_ix", range(6)),
                                rowgroup_subset=list(range(15, -1, -1)),
                                shuffle_row_groups=False, schema_fields=["id", "label", "f0"],
                                predicate=p.in_range("f0", -0.5), rowgroup_pruning=False),
    }[case]


ROW_CASES = ["filters in", "filters dnf", "predicate range", "predicate split",
             "predicate nulls", "predicate on the partition key", "selector",
             "selector union", "shard", "shard seed", "subset", "drop partitions",
             "row transform", "batched transform", "combined", "combined subset"]


def _pair(case, kwargs_of, **common):
    port, jax = kwargs_of("port", case), kwargs_of("jax", case)
    # Both packages prune by statistics unless the case says otherwise.
    return {**port, **common}, {**jax, **common}


# ------------------------------------------------------------- row reader
@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("case", ROW_CASES)
def test_row_reader_rows_equal_the_jax_rows_in_order(row_store, case, pool):
    workers = {"workers_count": 3} if pool == "thread" else {}
    port_kw, jax_kw = _pair(case, _row_kwargs, reader_pool_type=pool, **workers)
    port_rows, port_schema = _read_rows(make_reader, row_store, **port_kw)
    jax_rows, jax_schema = _read_rows(jax_make_reader, row_store, **jax_kw)
    assert list(port_schema.fields) == list(jax_schema.fields)
    assert_same_rows(port_rows, jax_rows, ordered=True)


@pytest.mark.parametrize("case", ["predicate split", "row transform", "combined"])
def test_row_reader_process_pool_gives_the_jax_multiset(row_store, case):
    port_kw, jax_kw = _pair(case, _row_kwargs)
    port_rows, _ = _read_rows(make_reader, row_store, reader_pool_type="process",
                              workers_count=2, **port_kw)
    jax_rows, _ = _read_rows(jax_make_reader, row_store, reader_pool_type="dummy", **jax_kw)
    assert_same_rows(port_rows, jax_rows, ordered=False)


def test_pruning_reorders_only_the_jax_shuffled_epoch(row_store):
    """With statistics pruning on in both packages (their default) the
    shuffled epochs are equal in order: both plan the same fewer groups. The
    name is kept from when only the JAX reader pruned."""
    port_rows, _ = _read_rows(make_reader, row_store, reader_pool_type="dummy", seed=4,
                              predicate=tp.in_range("label", 8))
    jax_rows, _ = _read_rows(jax_make_reader, row_store, reader_pool_type="dummy", seed=4,
                             predicate=jp.in_range("label", 8))
    assert_same_rows(port_rows, jax_rows, ordered=True)
    with make_reader(row_store, reader_pool_type="dummy", seed=4,
                     predicate=tp.in_range("label", 8)) as reader:
        report = reader.pruning_report()
    assert report["enabled"] and report["row_groups_pruned"] > 0


def test_drop_partitions_cover_every_row_once(row_store):
    rows, _ = _read_rows(make_reader, row_store, reader_pool_type="dummy",
                         shuffle_row_drop_partitions=5, seed=1, shuffle_rows=True)
    assert sorted(int(r.id) for r in rows) == list(range(ROWS))


def test_shards_are_disjoint_and_cover_the_store(row_store):
    ids = []
    for shard in range(3):
        rows, _ = _read_rows(make_reader, row_store, reader_pool_type="dummy", cur_shard=shard,
                             shard_count=3, shard_seed=11, seed=0)
        ids.append({int(r.id) for r in rows})
    assert not (ids[0] & ids[1]) and not (ids[1] & ids[2]) and not (ids[0] & ids[2])
    assert set().union(*ids) == set(range(ROWS))


def test_rowgroup_subset_reads_the_subset_in_its_order(row_store):
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    groups = load_row_groups(DatasetContext(row_store))
    subset = [11, 3, 6]
    rows, _ = _read_rows(make_reader, row_store, reader_pool_type="dummy",
                         rowgroup_subset=subset, shuffle_row_groups=False)
    want = []
    for i in subset:
        rg = groups[i]
        want += pq.ParquetFile(rg.path).read_row_group(rg.row_group, ["id"]).column(0).to_pylist()
    assert [int(r.id) for r in rows] == want


def test_transformed_schema_is_the_reader_schema(row_store):
    with make_reader(row_store, reader_pool_type="dummy", transform_spec=_crop(TransformSpec)) \
            as reader:
        row = next(reader)
        assert "name" not in reader.schema.fields and row.image.shape == (4, 4, 3)
        assert reader.schema.fields["image"].shape == (4, 4, 3)


def test_resume_counts_the_planned_items(row_store):
    kwargs = dict(reader_pool_type="dummy", seed=3, filters=[("part", "in", [0, 1])],
                  shuffle_row_drop_partitions=2)
    with make_reader(row_store, **kwargs) as reader:
        for _ in range(20):
            next(reader)
        state = reader.state_dict()
        rest = [int(r.id) for r in reader]
    assert state["items"] == 2 * 8   # 8 groups in two partitions, 2 copies each
    with make_reader(row_store, resume_state=state, **kwargs) as reader:
        resumed = [int(r.id) for r in reader]
    assert set(rest) <= set(resumed)
    for other in (dict(kwargs, shuffle_row_drop_partitions=3),
                  dict(kwargs, filters=[("part", "=", 0)])):
        with pytest.raises(ValueError):
            make_reader(row_store, resume_state=state, **other)


def test_a_jax_cursor_under_another_selection_is_refused_by_both(row_store):
    kwargs = dict(reader_pool_type="dummy", seed=3, filters=[("part", "in", [0, 1])])
    with jax_make_reader(row_store, **kwargs) as reader:
        next(reader)
        state = reader.state_dict()
    other = dict(kwargs, filters=[("part", "in", [0, 1, 2])])
    with pytest.raises(ValueError):
        jax_make_reader(row_store, resume_state=state, **other)
    with pytest.raises(ValueError):
        make_reader(row_store, resume_state=state, **other)


# ----------------------------------------------------------- batch reader
def _batch_kwargs(pkg, case):
    p, s = (tp, ts) if pkg == "port" else (jp, js)
    spec = TransformSpec if pkg == "port" else JaxSpec
    return {
        "filters": dict(filters=[("part", "in", {0, 2})], seed=1),
        "predicate kernel": dict(predicate=p.in_range("i0", 100, 700), seed=2, shuffle_rows=True),
        "predicate rows": dict(predicate=p.in_pseudorandom_split([0.4, 0.6], 1, "s"), seed=3),
        "selector": dict(rowgroup_selector=s.SingleIndexSelector("i0_ix", list(range(0, 1000, 7))),
                         seed=4),
        "shard seed": dict(cur_shard=1, shard_count=4, shard_seed=2, seed=5),
        "subset": dict(rowgroup_subset=[20, 4, 11], shuffle_row_groups=False),
        "drop partitions": dict(shuffle_row_drop_partitions=3, shuffle_rows=True, seed=6),
        "pandas transform": dict(transform_spec=spec(
            functools.partial(tt.add_sum_column, name="total", left="i0", right="f0"),
            edit_fields=[("total", np.float64, (), False)], removed_fields=["s"]), seed=7),
        "pandas tensor cells": dict(transform_spec=spec(
            functools.partial(tt.double_as_matrix, name="mat", source="vec", shape=(3, 2)),
            edit_fields=[("mat", np.float32, (3, 2), False)]), seed=8),
        "batched transform": dict(transform_spec=spec(
            functools.partial(tt.scale_and_drop, name="i0", factor=0.5, drop="s"),
            edit_fields=[("i0", np.float32, (), False)], removed_fields=["s"], batched=True),
            seed=9),
        "combined": dict(filters=[("part", "!=", 3)], predicate=p.in_range("f0", -1.0, 1.0),
                         cur_shard=0, shard_count=2, shard_seed=1,
                         shuffle_row_drop_partitions=2, shuffle_rows=True,
                         transform_spec=spec(
                             functools.partial(tt.add_sum_column, name="total", left="i0",
                                               right="f0"),
                             edit_fields=[("total", np.float64, (), False)]), seed=10),
    }[case]


BATCH_CASES = ["filters", "predicate kernel", "predicate rows", "selector", "shard seed",
               "subset", "drop partitions", "pandas transform", "pandas tensor cells",
               "batched transform", "combined"]


def _assert_same_batches(port, jax):
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        assert list(p) == list(j)
        for name in p:
            if p[name].dtype == object:
                assert [np.asarray(a).tobytes() for a in p[name]] == \
                    [np.asarray(a).tobytes() for a in j[name]], name
            else:
                assert p[name].dtype == j[name].dtype and p[name].shape == j[name].shape, name
                assert p[name].tobytes() == j[name].tobytes(), name


@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("case", BATCH_CASES)
def test_batch_reader_batches_equal_the_jax_batches_in_order(batch_store, case, pool):
    workers = {"workers_count": 3} if pool == "thread" else {}
    port_kw, jax_kw = _pair(case, _batch_kwargs, reader_pool_type=pool, **workers)
    port, port_schema = _read_batches(make_batch_reader, batch_store, **port_kw)
    jax, jax_schema = _read_batches(jax_make_batch_reader, batch_store, **jax_kw)
    assert list(port_schema.fields) == list(jax_schema.fields)
    _assert_same_batches(port, jax)


def _rows_of(batches):
    keys = []
    for b in batches:
        n = len(next(iter(b.values())))
        keys += [tuple(np.asarray(b[k][i]).tobytes() for k in sorted(b)) for i in range(n)]
    return sorted(keys)


@pytest.mark.parametrize("case", ["predicate rows", "pandas tensor cells", "combined"])
def test_batch_reader_process_pool_gives_the_jax_multiset(batch_store, case):
    port_kw, jax_kw = _pair(case, _batch_kwargs)
    port, _ = _read_batches(make_batch_reader, batch_store, reader_pool_type="process",
                            workers_count=2, **port_kw)
    jax, _ = _read_batches(jax_make_batch_reader, batch_store, reader_pool_type="dummy",
                           **jax_kw)
    assert _rows_of(port) == _rows_of(jax)


def test_untransformed_groups_stay_zero_copy_on_processes(batch_store):
    with make_batch_reader(batch_store, reader_pool_type="process", workers_count=2,
                           filters=[("part", "=", 1)], predicate=tp.in_range("i0", 0)) as reader:
        groups = sum(1 for _ in reader)
        counters = reader.counters
    assert groups == 6 and counters.get("zero_copy_batches") == groups


# ------------------------------------------------------------ error cases
ERROR_CASES = {
    "filters on a column": lambda p, s, spec: dict(filters=[("id", "=", 1)]),
    "filters bad op": lambda p, s, spec: dict(filters=[("part", "~", 1)]),
    "filters string for in": lambda p, s, spec: dict(filters=[("part", "in", "13")]),
    "filters empty group": lambda p, s, spec: dict(filters=[[("part", "=", 1)], []]),
    "unknown index": lambda p, s, spec: dict(rowgroup_selector=s.SingleIndexSelector("nope", [1])),
    "subset out of range": lambda p, s, spec: dict(rowgroup_subset=[0, 99],
                                                   shuffle_row_groups=False),
    "subset duplicate": lambda p, s, spec: dict(rowgroup_subset=[1, 1],
                                                shuffle_row_groups=False),
    "subset with shard": lambda p, s, spec: dict(rowgroup_subset=[1], cur_shard=0,
                                                 shard_count=2, shuffle_row_groups=False),
    "subset shuffled": lambda p, s, spec: dict(rowgroup_subset=[1]),
    "empty shard": lambda p, s, spec: dict(filters=[("part", "=", 1)], cur_shard=7,
                                           shard_count=8),
    "nothing left": lambda p, s, spec: dict(filters=[("part", "=", 7)]),
    "missing selected field": lambda p, s, spec: dict(transform_spec=spec(
        selected_fields=["id", "nope"])),
    "unknown predicate field": lambda p, s, spec: dict(predicate=p.in_set({1}, "nope")),
}


def _error_type(factory, url, kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with factory(url, reader_pool_type="dummy", **kwargs) as reader:
                list(reader)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            return type(e).__name__
    return None


@pytest.mark.parametrize("batched", [False, True], ids=["make_reader", "make_batch_reader"])
@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_cases_raise_the_jax_exception_type(row_store, batch_store, case, batched):
    url = batch_store if batched else row_store
    port_f, jax_f = ((make_batch_reader, jax_make_batch_reader) if batched
                     else (make_reader, jax_make_reader))
    want = _error_type(jax_f, url, ERROR_CASES[case](jp, js, JaxSpec))
    got = _error_type(port_f, url, ERROR_CASES[case](tp, ts, TransformSpec))
    assert want is not None and got == want


def test_drop_partitions_refuse_a_non_overlapping_ngram(row_store):
    ngram = NGram({0: ["id", "label"], 1: ["id"]}, delta_threshold=1, timestamp_field="id",
                  timestamp_overlap=False)
    with pytest.raises(NotImplementedError):
        make_reader(row_store, schema_fields=ngram, shuffle_row_drop_partitions=2)


def test_a_selector_on_a_store_without_an_index_raises_metadata_error(batch_store, tmp_path):
    from petastorm_tpu_torch.errors import MetadataError
    url = f"file://{tmp_path}/plain"
    table = pa.table({"x": np.arange(10)})
    os.makedirs(url[len("file://"):])
    pq.write_table(table, url[len("file://"):] + "/f.parquet")
    with pytest.raises(MetadataError):
        make_batch_reader(url, rowgroup_selector=ts.SingleIndexSelector("x", [1]))


# ---------------------------------------------- process-pool functions
def _closure_predicate():
    bound = 3
    return tp.in_lambda(["id"], lambda v: v["id"] < bound)


@pytest.mark.parametrize("what", ["lambda predicate", "closure transform", "main function"])
@pytest.mark.parametrize("batched", [False, True], ids=["make_reader", "make_batch_reader"])
def test_process_pool_refuses_what_does_not_pickle(row_store, batch_store, what, batched):
    def local(row):
        return row

    main_fn = type(local)(local.__code__, {"__name__": "__main__"}, "main_fn")
    main_fn.__module__ = "__main__"
    main_fn.__qualname__ = "main_fn"
    kwargs = {"lambda predicate": dict(predicate=_closure_predicate()),
              "closure transform": dict(transform_spec=TransformSpec(local)),
              "main function": dict(transform_spec=TransformSpec(main_fn))}[what]
    factory = make_batch_reader if batched else make_reader
    with pytest.raises(ValueError) as err:
        factory(batch_store if batched else row_store, reader_pool_type="process",
                workers_count=1, **kwargs)
    assert "module level" in str(err.value) and "reader_pool_type='thread'" in str(err.value)
    # The same objects run on threads.
    with factory(batch_store if batched else row_store, reader_pool_type="thread",
                 workers_count=1, **kwargs) as reader:
        assert sum(1 for _ in reader) > 0
