"""The loaders over lazy readers (``row_materialization="lazy"``) in
petastorm_tpu_torch against the JAX package's loaders.

* ``DataLoader`` batches over a lazy reader equal the JAX ``DataLoader``'s
  bit for bit, shuffled (``BatchShufflingBuffer``) and in order, with the
  short last batch kept, padded or dropped; an epoch is the eager loader's
  multiset; a FIFO lazy loader's ``state_dict`` resumes without loss.
* ``MeshDataLoader`` over lazy readers: one simulated host delivers the
  JAX lazy mesh loader's stream, four hosts its multiset, and a column that
  cannot stack is dropped with the loaders' warning.
* ``WeightedSamplingReader`` of lazy members is lazy, hands a member's
  ``ColumnarBatch`` through untouched and mixes the JAX mixer's batches.

Every comparison is exact (values: the JAX loader's default policy narrows
int64 to int32, the port's keeps it).
"""
import numpy as np
import pytest

from petastorm_tpu.jax import DataLoader as JaxDataLoader
from petastorm_tpu.jax import MeshDataLoader as JaxMeshDataLoader
from petastorm_tpu.jax import MeshReaderFactory as JaxMeshReaderFactory
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu.weighted_sampling_reader import WeightedSamplingReader as JaxMixer
from petastorm_tpu_torch.loader import DataLoader, MeshDataLoader, MeshReaderFactory
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.reader_impl.batch_plane import ColumnarBatch
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

FIELDS = ["id", "id2", "image_png", "matrix", "matrix_uint16"]
ROWS = 100


def _port_batches(url, loader_kw, **reader_kw):
    reader_kw = {"schema_fields": FIELDS, "reader_pool_type": "dummy",
                 "row_materialization": "lazy", **reader_kw}
    with make_reader(url, **reader_kw) as reader:
        assert reader.row_materialization == reader_kw["row_materialization"]
        return [{k: v.numpy() for k, v in b.items()}
                for b in DataLoader(reader, device="cpu", **loader_kw)]


def _jax_batches(url, loader_kw, **reader_kw):
    reader_kw = {"schema_fields": FIELDS, "reader_pool_type": "dummy",
                 "row_materialization": "lazy", **reader_kw}
    with jax_make_reader(url, **reader_kw) as reader:
        return [{k: np.asarray(v) for k, v in b.items()}
                for b in JaxDataLoader(reader, **loader_kw)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            # Values, not dtypes: the JAX loader narrows int64 to int32 (x64
            # off), the port keeps every type torch has.
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("loader_kw", [
    dict(batch_size=16, drop_last=False),
    dict(batch_size=16, pad_last=True),
    dict(batch_size=16),
    dict(batch_size=16, shuffling_queue_capacity=40, seed=1, drop_last=False),
    dict(batch_size=7, shuffling_queue_capacity=64, min_after_retrieve=10, seed=3,
         drop_last=False),
])
@pytest.mark.parametrize("reader_kw", [dict(shuffle_row_groups=False),
                                       dict(seed=2, shuffle_rows=True)])
def test_lazy_batches_equal_the_jax_loaders(synthetic_dataset, loader_kw, reader_kw):
    got = _port_batches(synthetic_dataset.url, loader_kw, **reader_kw)
    want = _jax_batches(synthetic_dataset.url, loader_kw, **reader_kw)
    _assert_batches_equal(got, want)
    valid = [b["id"][b["__valid__"]] if "__valid__" in b else b["id"] for b in got]
    n = sum(len(v) for v in valid)
    assert n == (ROWS // loader_kw["batch_size"]) * loader_kw["batch_size"] \
        if loader_kw.get("drop_last", True) and not loader_kw.get("pad_last") else n == ROWS


def test_a_lazy_epoch_is_the_eager_loaders_multiset(synthetic_dataset):
    kw = dict(batch_size=10, shuffling_queue_capacity=30, seed=5, drop_last=False)
    lazy = _port_batches(synthetic_dataset.url, kw, seed=1, num_epochs=2)
    eager = _port_batches(synthetic_dataset.url, kw, seed=1, num_epochs=2,
                          row_materialization="eager")

    def keyed(batches):
        return sorted((int(i), m.tobytes()) for b in batches for i, m in zip(b["id"], b["matrix"]))
    assert keyed(lazy) == keyed(eager) and len(keyed(lazy)) == 2 * ROWS
    assert [b["id"].tolist() for b in lazy] != [b["id"].tolist() for b in eager]


def test_a_fifo_lazy_loader_resumes_without_loss(synthetic_dataset):
    kw = dict(schema_fields=["id"], reader_pool_type="dummy", seed=4,
              row_materialization="lazy")
    with make_reader(synthetic_dataset.url, **kw) as reader:
        loader = DataLoader(reader, batch_size=15, device="cpu", drop_last=False)
        it = iter(loader)
        head = [next(it)["id"].tolist() for _ in range(2)]
        state = loader.state_dict()
        it.close()
    with make_reader(synthetic_dataset.url, resume_state=state, **kw) as reader:
        rest = [b["id"].tolist() for b in DataLoader(reader, batch_size=15, device="cpu",
                                                     drop_last=False)]
    seen = [i for b in head + rest for i in b]
    # No row lost; read again, at most the rows delivered before the cut
    # (the cursor is the last one taken with nothing buffered).
    assert set(seen) == set(range(ROWS)) and len(seen) - ROWS <= 2 * 15
    with make_reader(synthetic_dataset.url, **kw) as reader:
        with pytest.raises(ValueError, match="shuffling_queue_capacity"):
            DataLoader(reader, batch_size=15, device="cpu", shuffling_queue_capacity=30,
                       seed=0).state_dict()


@pytest.mark.parametrize("hosts", [1, 4])
def test_lazy_mesh_loader_against_the_jax_lazy_mesh_loader(synthetic_dataset, hosts):
    kw = dict(schema_fields=FIELDS, row_materialization="lazy")

    def run(loader):
        with loader:
            return [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    got = run(MeshDataLoader(MeshReaderFactory(synthetic_dataset.url, **kw), batch_size=8,
                             num_hosts=hosts, seed=3, num_epochs=2, device="cpu",
                             pad_last=True))
    want = run(JaxMeshDataLoader(JaxMeshReaderFactory(synthetic_dataset.url,
                                                      **kw),
                                 batch_size=8, num_hosts=hosts, seed=3, num_epochs=2,
                                 pad_last=True))
    if hosts == 1:
        _assert_batches_equal(got, want)
    def ids(batches):
        return sorted(i for b in batches
                      for i in (b["id"][b["__valid__"]] if "__valid__" in b else b["id"]))
    half = len(got) // 2
    assert ids(got[:half]) == ids(got[half:]) == list(range(ROWS))
    assert ids(got) == ids(want)


def test_lazy_mesh_loader_drops_what_cannot_stack(synthetic_dataset):
    factory = MeshReaderFactory(synthetic_dataset.url, schema_fields=["id", "varlen",
                                                                      "partition_key"],
                                row_materialization="lazy")
    with pytest.warns(UserWarning, match="partition_key"):
        with MeshDataLoader(factory, batch_size=10, device="cpu") as loader:
            batches = list(loader)
    assert all(set(b) == {"id"} for b in batches) and len(batches) == ROWS // 10


def test_lazy_mixture_passes_batches_through_and_equals_jax(synthetic_dataset):
    url = synthetic_dataset.url
    port = [make_reader(url, schema_fields=["id", "matrix"], reader_pool_type="dummy", seed=s,
                        row_materialization="lazy") for s in (1, 2)]
    jax = [jax_make_reader(url, schema_fields=["id", "matrix"], reader_pool_type="dummy",
                           seed=s, row_materialization="lazy")
           for s in (1, 2)]
    with WeightedSamplingReader(port, [0.7, 0.3], seed=9) as mix, \
            JaxMixer(jax, [0.7, 0.3], seed=9) as jax_mix:
        assert mix.row_materialization == jax_mix.row_materialization == "lazy"
        for _ in range(12):
            got, want = mix.next_batch(), jax_mix.next_batch()
            assert isinstance(got, ColumnarBatch) and got.num_rows == want.num_rows
            for k in want.columns:
                np.testing.assert_array_equal(np.stack(list(got.columns[k])),
                                              np.stack(list(want.columns[k])))
    eager = make_reader(url, schema_fields=["id", "matrix"], reader_pool_type="dummy", seed=3)
    with WeightedSamplingReader([eager, make_reader(url, schema_fields=["id", "matrix"],
                                                    reader_pool_type="dummy", seed=4,
                                                    row_materialization="lazy")],
                                [0.5, 0.5], seed=1) as mix:
        assert mix.row_materialization == "eager"


def test_a_loader_over_a_lazy_mixture_equals_jax(synthetic_dataset):
    url = synthetic_dataset.url
    kw = dict(batch_size=12, shuffling_queue_capacity=50, seed=6, drop_last=False)

    def members(factory, **extra):
        return [factory(url, schema_fields=["id", "matrix"], reader_pool_type="dummy", seed=s,
                        row_materialization="lazy", **extra) for s in (1, 2)]
    with WeightedSamplingReader(members(make_reader), [0.6, 0.4], seed=2) as mix:
        got = [{k: v.numpy() for k, v in b.items()} for b in DataLoader(mix, device="cpu", **kw)]
    with JaxMixer(members(jax_make_reader), [0.6, 0.4], seed=2) as mix:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in JaxDataLoader(mix, **kw)]
    _assert_batches_equal(got, want)
