"""The lazy row plane of petastorm_tpu_torch against the JAX package's:
``ColumnarBatch``, ``concat_column_slices``, ``BatchShufflingBuffer`` and
``make_reader(row_materialization="lazy")``.

* ``BatchShufflingBuffer`` streams equal the JAX buffer's bit for bit for
  the same seed, adds and retrievals; a refill mixes exactly the rows
  buffered then, retrieval waits for ``min_after_retrieve``, slices are
  views of the pool.
* Lazy readers yield the JAX lazy readers' rows, in order, on the dummy
  pool (statistics pruning off on the JAX side, which the port has none
  of), with and without a predicate; an epoch is the eager epoch's
  multiset on threads and on processes.
* ``next()`` and ``next_batch()`` interleave without repeating a row, an
  eager row reader's ``next_batch()`` raises ``TypeError``, deterministic
  lazy cursors are the JAX cursors, and the fallbacks and refusals are the
  JAX reader's.

Every comparison is exact: the same decode on the same bytes.
"""
import collections
import pickle
import warnings

import numpy as np
import pytest

from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.reader_impl import batch_plane as jax_batch_plane
from petastorm_tpu.reader_impl.shuffling_buffer import BatchShufflingBuffer as JaxBuffer
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.reader_impl.batch_plane import ColumnarBatch, concat_column_slices
from petastorm_tpu_torch.reader_impl.shuffling_buffer import BatchShufflingBuffer
from petastorm_tpu_torch.transform import TransformSpec

FIELDS = ["id", "id2", "image_png", "matrix", "matrix_uint16", "nullable_int", "varlen"]
ROWS = 100


def _keep_even_ids(cols: dict) -> dict:
    keep = np.asarray(cols["id"]) % 2 == 0
    return {"id": np.asarray(cols["id"])[keep]}


def _cell_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _rows_equal(got, want) -> bool:
    return len(got) == len(want) and all(
        g._fields == w._fields and all(_cell_equal(getattr(g, f), getattr(w, f))
                                       for f in g._fields)
        for g, w in zip(got, want))


def _read(factory, url, **kw):
    kw = {"schema_fields": FIELDS, **kw}
    with factory(url, **kw) as reader:
        return list(reader)


# ------------------------------------------------------------- the buffer
def _batches(seed, count=12):
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for _ in range(count):
        n = int(rng.integers(1, 40))
        out.append({"id": np.arange(start, start + n),
                    "x": rng.random((n, 3)).astype(np.float32)})
        start += n
    return out


def _drive(buf, batches, seed):
    """Add and retrieve in a seeded pattern -> the retrieved slices."""
    rng = np.random.default_rng(seed)
    out, pending = [], list(batches)
    while True:
        while pending and buf.can_add:
            buf.add_many(pending.pop(0))
        if not pending and not buf.can_add:
            buf.finish()
        if buf.can_retrieve:
            out.append(buf.retrieve_batch(int(rng.integers(1, 30))))
        elif not pending:
            buf.finish()
            if not buf.can_retrieve:
                return out


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("capacity,min_after", [(50, 10), (120, 60), (2, 0)])
def test_buffer_stream_equals_jax(seed, capacity, min_after):
    got = _drive(BatchShufflingBuffer(capacity, min_after, seed=seed), _batches(seed), seed)
    want = _drive(JaxBuffer(capacity, min_after, seed=seed), _batches(seed), seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    ids = np.concatenate([g["id"] for g in got])
    total = sum(len(b["id"]) for b in _batches(seed))
    assert sorted(ids.tolist()) == list(range(total))


def test_a_refill_mixes_exactly_the_rows_buffered_then():
    buf = BatchShufflingBuffer(100, min_after_retrieve=30, seed=3)
    buf.add_many({"id": np.arange(0, 20)})
    assert not buf.can_retrieve            # 20 rows buffered, the floor is 30
    buf.add_many(ColumnarBatch({"id": np.arange(20, 40)}))
    assert buf.can_retrieve and buf.size == 40
    first = buf.retrieve_batch(15)["id"]
    buf.add_many({"id": np.arange(40, 200)})   # lands past the capacity: one batch of slack
    assert buf.size == 185 and not buf.can_add
    rest_of_pool = buf.retrieve_batch(100)["id"]
    assert len(rest_of_pool) == 25          # the pool drains before a refill
    assert set(first) | set(rest_of_pool) == set(range(40))
    nxt = buf.retrieve_batch(200)["id"]
    assert sorted(nxt) == list(range(40, 200)) and buf.size == 0
    with pytest.raises(ValueError):
        BatchShufflingBuffer(10, min_after_retrieve=10)
    buf.finish()
    with pytest.raises(RuntimeError):
        buf.add_many({"id": np.arange(3)})


def test_target_capacity_clamps_as_the_jax_buffer():
    for cls in (BatchShufflingBuffer, JaxBuffer):
        buf = cls(100, min_after_retrieve=20, seed=0)
        buf.set_target_capacity(5)
        assert buf.capacity == buf.min_target == 21
        buf.set_target_capacity(1000)
        assert buf.capacity == 100


def test_slices_are_views_and_batches_pickle():
    buf = BatchShufflingBuffer(50, seed=1)
    buf.add_many({"id": np.arange(10), "x": np.zeros((10, 4))})
    piece = buf.retrieve_batch(4)
    assert np.shares_memory(piece["x"], buf._pool["x"])
    assert concat_column_slices([piece]) is piece
    joined = concat_column_slices([piece, buf.retrieve_batch(6)])
    assert not np.shares_memory(joined["x"], piece["x"]) and len(joined["id"]) == 10
    batch = ColumnarBatch({"id": np.arange(5), "s": list("abcde")})
    again = pickle.loads(pickle.dumps(batch))
    assert again.num_rows == 5 and again.columns["s"] == list("abcde")
    taken = batch.take([4, 0])
    assert taken.columns["id"].tolist() == [4, 0] and taken.columns["s"] == ["e", "a"]
    assert batch.row_dict(2) == {"id": 2, "s": "c"}
    jax_batch = jax_batch_plane.ColumnarBatch({"id": np.arange(5), "s": list("abcde")})
    assert jax_batch.take([4, 0]).columns["s"] == taken.columns["s"]


def test_a_row_group_of_64_images_crosses_the_ring_as_its_rows_did():
    """The process pool publishes a ColumnarBatch as one pickled record: 64
    images at 224x224x3 (9.6 MB) cost what the 64 row dicts cost, and fit
    the smallest ring the reader sizes."""
    from petastorm_tpu_torch.reader import MIN_RING_CAPACITY
    images = [np.full((224, 224, 3), i, np.uint8) for i in range(64)]
    labels = np.arange(64, dtype=np.int32)
    lazy = len(pickle.dumps(ColumnarBatch({"image": images, "label": labels}),
                            protocol=pickle.HIGHEST_PROTOCOL))
    eager = len(pickle.dumps([{"image": im, "label": lab} for im, lab in zip(images, labels)],
                             protocol=pickle.HIGHEST_PROTOCOL))
    assert 64 * 224 * 224 * 3 < lazy <= eager
    assert lazy < MIN_RING_CAPACITY


# ------------------------------------------------------------- the reader
@pytest.mark.parametrize("kw", [dict(shuffle_row_groups=False),
                                dict(seed=3, shuffle_rows=True),
                                dict(seed=5, shuffle_row_drop_partitions=2)])
def test_lazy_rows_equal_the_jax_lazy_readers(synthetic_dataset, kw):
    kw = dict(kw, reader_pool_type="dummy", row_materialization="lazy")
    got = _read(make_reader, synthetic_dataset.url, **kw)
    want = _read(jax_make_reader, synthetic_dataset.url, **kw)
    assert len(got) == ROWS and _rows_equal(got, want)
    eager = _read(make_reader, synthetic_dataset.url, **dict(kw, row_materialization="eager"))
    assert _rows_equal(got, eager)   # one pool, one order: the same stream


def test_lazy_rows_with_a_predicate_equal_the_jax_readers(synthetic_dataset):
    from petastorm_tpu.predicates import in_lambda as jax_in_lambda
    kw = dict(reader_pool_type="dummy", row_materialization="lazy", seed=1, shuffle_rows=True)
    got = _read(make_reader, synthetic_dataset.url,
                predicate=in_lambda(["id2"], lambda v: v["id2"] % 3 == 0), **kw)
    want = _read(jax_make_reader, synthetic_dataset.url,
                 predicate=jax_in_lambda(["id2"], lambda v: v["id2"] % 3 == 0), **kw)
    assert 0 < len(got) < ROWS and _rows_equal(got, want)


@pytest.mark.parametrize("pool", ["thread", "process"])
def test_a_lazy_epoch_is_the_eager_multiset(synthetic_dataset, pool):
    kw = dict(reader_pool_type=pool, workers_count=2, seed=9, shuffle_rows=True, num_epochs=2,
              schema_fields=["id", "image_png", "matrix"])

    def keyed(rows):
        return sorted((int(r.id), r.image_png.tobytes(), r.matrix.tobytes()) for r in rows)
    with make_reader(synthetic_dataset.url, row_materialization="lazy", **kw) as reader:
        assert reader.row_materialization == "lazy"
        lazy = list(reader)
    with make_reader(synthetic_dataset.url, **kw) as reader:
        eager = list(reader)
    assert len(lazy) == 2 * ROWS and keyed(lazy) == keyed(eager)


def test_next_and_next_batch_interleave_without_repeats(synthetic_dataset):
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy", shuffle_row_groups=False,
                     row_materialization="lazy", schema_fields=["id"]) as reader:
        ids = [int(next(reader).id) for _ in range(3)]
        rest = reader.next_batch()               # the remainder of the first group
        assert isinstance(rest, ColumnarBatch) and rest.num_rows == 7
        assert np.shares_memory(rest.columns["id"], np.asarray(rest.columns["id"]).base)
        ids += rest.columns["id"].tolist()
        whole = reader.next_batch()
        assert whole.num_rows == 10
        ids += whole.columns["id"].tolist()
        ids += [int(r.id) for r in reader]
        with pytest.raises(StopIteration):
            reader.next_batch()
    assert ids == list(range(ROWS))
    with make_reader(synthetic_dataset.url, reader_pool_type="dummy") as reader:
        assert reader.row_materialization == "eager"
        with pytest.raises(TypeError, match="row_materialization='lazy'"):
            reader.next_batch()


def test_fallbacks_and_refusals_are_the_jax_readers(synthetic_dataset):
    url = synthetic_dataset.url
    ngram = NGram({0: ["id"], 1: ["id"]}, delta_threshold=10, timestamp_field="id")
    with pytest.warns(UserWarning, match="NGram"):
        with make_reader(url, schema_fields=ngram, row_materialization="lazy",
                         reader_pool_type="dummy") as reader:
            assert reader.row_materialization == "eager"
    per_row = TransformSpec(lambda row: row, selected_fields=["id"])
    with pytest.warns(UserWarning, match="per-row"):
        with make_reader(url, transform_spec=per_row, row_materialization="lazy",
                         reader_pool_type="dummy") as reader:
            assert reader.row_materialization == "eager"
    batched = TransformSpec(_keep_even_ids, batched=True, selected_fields=["id"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with make_reader(url, transform_spec=batched, row_materialization="lazy",
                         reader_pool_type="dummy", shuffle_row_groups=False) as reader:
            assert reader.row_materialization == "lazy"
            assert [int(r.id) for r in reader] == list(range(0, ROWS, 2))
    with pytest.raises(ValueError, match="'eager' or 'lazy'"):
        make_reader(url, row_materialization="columnar")
    with pytest.raises(ValueError, match="'eager' or 'lazy'"):
        jax_make_reader(url, row_materialization="columnar")


@pytest.mark.parametrize("cut", [0, 5, 10, 37])
def test_deterministic_lazy_cursors_are_the_jax_cursors(synthetic_dataset, cut):
    kw = dict(schema_fields=["id"], seed=4, sample_order="deterministic", shuffle_window=2,
              reader_pool_type="dummy", row_materialization="lazy")
    with make_reader(synthetic_dataset.url, **kw) as reader:
        head = [int(next(reader).id) for _ in range(cut)]
        state = reader.state_dict()
    with jax_make_reader(synthetic_dataset.url, **kw) as reader:
        want_head = [int(next(reader).id) for _ in range(cut)]
        want = reader.state_dict()
    assert head == want_head
    assert {k: state[k] for k in want if k in state} == {k: want[k] for k in state if k in want}
    with make_reader(synthetic_dataset.url, resume_state=state, **kw) as reader:
        rest = [int(r.id) for r in reader]
    assert set(head) | set(rest) == set(range(ROWS))


@pytest.mark.parametrize("n", [0, 1, 10, 37, 100, 133])
def test_free_lazy_cursors_are_the_jax_cursors(synthetic_dataset, n):
    """Free order: inside a row group the lazy cursors are equal; where a
    pull ends on a group the port's is one group past the JAX one (the
    port counts a group at its last row, the JAX reader at the next pull's
    confirmation, as for eager readers). A resume loses no row."""
    kw = dict(schema_fields=["id"], reader_pool_type="dummy", num_epochs=2, seed=11,
              row_materialization="lazy")

    def pull(factory, **extra):
        with factory(synthetic_dataset.url, **kw, **extra) as reader:
            return [int(next(reader).id) for _ in range(n)], reader.state_dict()
    ids, port = pull(make_reader)
    jax_ids, jax = pull(jax_make_reader)
    assert ids == jax_ids
    linear = [c["epoch"] * 10 + c["offset"] for c in (port, jax)]
    assert port["items"] == jax["items"] == 10 and port["seed"] == jax["seed"]
    if n % 10:
        assert {k: port[k] for k in jax if k in port} == {k: jax[k] for k in port if k in jax}
    else:
        assert linear[0] - linear[1] == (1 if n else 0)
    with make_reader(synthetic_dataset.url, resume_state=port, **kw) as reader:
        rest = [int(r.id) for r in reader]
    seen = collections.Counter(ids + rest)
    assert all(seen[i] >= 2 for i in range(ROWS))   # two epochs, no row lost
