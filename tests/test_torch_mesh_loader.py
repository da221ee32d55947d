"""The port's ``MeshDataLoader`` against the JAX package's
(``petastorm_tpu/jax/mesh_loader.py``, ``tests/test_mesh_loader.py``), in
one process with simulated hosts: shard plans, the factory, the batch and
tail rules, epochs, host loss and the elastic reshard, NGram windows, and
cursors, which cross both ways. The conftest gives the JAX loader 8 CPU
devices, and its default is one host a device, so both sides get
``num_hosts`` explicitly. The port stages onto the CPU here."""
import collections

import numpy as np
import pytest

from petastorm_tpu.jax import MeshDataLoader as JaxMeshDataLoader
from petastorm_tpu.jax import MeshReaderFactory as JaxMeshReaderFactory
from petastorm_tpu_torch.loader import MeshDataLoader, MeshHostLostError, MeshReaderFactory
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.parallel.mesh import Mesh
from petastorm_tpu_torch.reader import make_batch_reader


@pytest.fixture(scope="module")
def scalar_store(tmp_path_factory):
    """The JAX test's store: 800 rows, 40 row groups of 20; row i has id i."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = tmp_path_factory.mktemp("torch_mesh_scalar")
    n = 800
    pq.write_table(pa.table({"id": np.arange(n, dtype=np.int64),
                             "x": (np.arange(n) * 0.5).astype(np.float32)}),
                   str(path / "part0.parquet"), row_group_size=20)
    return f"file://{path}"


@pytest.fixture(scope="module")
def token_store(tmp_path_factory):
    """16 NGram windows of 32 tokens, one a row group (the bench's layout)."""
    from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
    url = f"file://{tmp_path_factory.mktemp('torch_mesh_tokens')}/tokens"
    write_token_store(url, windows=16, window=32)
    return url


def _valid(batch, column="id"):
    arr = np.asarray(batch[column])
    if "__valid__" in batch:
        return arr[np.asarray(batch["__valid__"])].tolist()
    return arr.tolist()


def _port(scalar_store, **kwargs):
    kwargs.setdefault("device", "cpu")
    return MeshDataLoader(MeshReaderFactory(scalar_store, batched=True), **kwargs)


def _jax(scalar_store, **kwargs):
    return JaxMeshDataLoader(JaxMeshReaderFactory(scalar_store, batched=True), **kwargs)


def _epoch_ids(loader):
    ids = []
    with loader:
        for batch in loader:
            ids.extend(_valid(batch))
    return ids


# --------------------------------------------------------------- planning
@pytest.mark.parametrize("groups,hosts,seed,epoch", [
    (40, 4, 11, 0), (40, 4, 11, 1), (40, 8, None, 0), (40, 8, 0, 3), (7, 8, 3, 2),
    (13, 3, 0, 5), (1, 2, 5, 0), (100, 6, 42, 7), (40, 1, 9, 0)])
def test_epoch_plan_equals_the_jax_loaders(scalar_store, groups, hosts, seed, epoch):
    port = _port(scalar_store, batch_size=8, num_hosts=hosts, seed=seed, num_rowgroups=groups)
    jax_loader = _jax(scalar_store, batch_size=8, num_hosts=hosts, seed=seed,
                      num_rowgroups=groups)
    plan = port.epoch_plan(epoch)
    assert plan == jax_loader.epoch_plan(epoch)
    assert sorted(o for host in plan for o in host) == list(range(groups))
    port.close()
    jax_loader.close()


def test_a_host_reads_what_a_cur_shard_reader_reads(scalar_store):
    factory = MeshReaderFactory(scalar_store, batched=True)
    plan = _port(scalar_store, batch_size=80, num_hosts=4, seed=11).epoch_plan(0)
    for h in range(4):
        with make_batch_reader(scalar_store, cur_shard=h, shard_count=4, shard_seed=11,
                               shuffle_row_groups=False, workers_count=1) as reader:
            shard = [int(i) for b in reader for i in b.id]
        with factory(plan[h]) as reader:
            subset = [int(i) for b in reader for i in b.id]
        assert subset == [i for g in plan[h] for i in range(20 * g, 20 * g + 20)]
        assert sorted(subset) == sorted(shard)


# ---------------------------------------------------------------- factory
@pytest.mark.parametrize("owned", [{"cur_shard": 0, "shard_count": 2}, {"num_epochs": 2},
                                   {"shuffle_row_groups": True}, {"rowgroup_subset": [1]},
                                   {"shard_seed": 3}, {"resume_state": {}}])
def test_the_factory_refuses_what_the_loader_owns(scalar_store, owned):
    for factory in (MeshReaderFactory, JaxMeshReaderFactory):
        with pytest.raises(ValueError, match="owns"):
            factory(scalar_store, batched=True, **owned)


@pytest.mark.parametrize("batched,kwargs", [
    (True, {}), (True, {"workers_count": 2}), (True, {"reader_pool_type": "dummy"}),
    (True, {"reader_pool_type": "process"}), (False, {}), (False, {"workers_count": 3})])
def test_fifo_delivery_is_the_jax_factorys(scalar_store, batched, kwargs):
    port = MeshReaderFactory(scalar_store, batched=batched, **kwargs)
    jax_factory = JaxMeshReaderFactory(scalar_store, batched=batched, **kwargs)
    assert port.fifo_delivery == jax_factory.fifo_delivery
    assert port.reader_kwargs["workers_count"] == jax_factory.reader_kwargs["workers_count"]
    assert port.num_rowgroups() == jax_factory.num_rowgroups() == 40


# ------------------------------------------------------- batch, tail rules
def test_batch_divisibility_and_tail_rules(scalar_store):
    with pytest.raises(ValueError, match="divide evenly"):
        _port(scalar_store, batch_size=81, mesh=Mesh({"data": 8}, groups={}))
    with pytest.raises(ValueError, match="divide evenly"):
        _jax(scalar_store, batch_size=81)
    for make in (_port, _jax):
        with pytest.raises(ValueError, match="ragged tail"):
            make(scalar_store, batch_size=80, num_hosts=2, drop_last=False)


@pytest.mark.parametrize("how", ["keyword", "position"])
def test_the_batch_splits_over_the_data_axis_only(scalar_store, how):
    # The JAX loader's partition_spec= lays out a global array; the port
    # builds none, so it takes no spec, by keyword or in the JAX position.
    factory = MeshReaderFactory(scalar_store, batched=True)
    with pytest.raises(TypeError):
        if how == "keyword":
            MeshDataLoader(factory, batch_size=80, partition_spec=("data",), device="cpu")
        else:
            MeshDataLoader(factory, 80, None, ("data",), device="cpu")


@pytest.mark.parametrize("pad", [True, False])
def test_the_tail_is_padded_to_the_step_or_dropped(scalar_store, pad):
    """800 rows at 300 a batch: two full batches, then 200 rows padded to 300
    with a ``__valid__`` mask, or dropped."""
    kw = dict(drop_last=False, pad_last=True) if pad else {}
    with _port(scalar_store, batch_size=300, num_hosts=4, seed=1, **kw) as loader:
        batches = list(loader)
    assert [len(b["id"]) for b in batches] == ([300] * 3 if pad else [300] * 2)
    if pad:
        valid = batches[-1]["__valid__"]
        assert valid.sum() == 200 and valid[:200].all()
        assert sorted(i for b in batches for i in _valid(b)) == list(range(800))


# ------------------------------------------------------------ epoch parity
@pytest.mark.parametrize("hosts", [1, 3, 8])
def test_an_epoch_delivers_the_jax_multiset(scalar_store, hosts):
    kw = dict(batch_size=80, seed=3, num_epochs=1, num_hosts=hosts, drop_last=False,
              pad_last=True)
    loader = _port(scalar_store, **kw)
    ids = _epoch_ids(loader)
    report = loader.mesh_report()
    jax_ids = _epoch_ids(_jax(scalar_store, **kw))
    one_host = _epoch_ids(_port(scalar_store, **dict(kw, num_hosts=1)))
    assert sorted(ids) == sorted(jax_ids) == sorted(one_host) == list(range(800))
    assert report["reshard_events"] == 0 and not report["hosts_lost"]
    assert report["hosts"] == hosts and set(report["per_host"]) == set(range(hosts))
    assert sum(h["rowgroups"] for h in report["per_host"].values()) == 40
    assert sum(h["rows"] for h in report["per_host"].values()) == 800
    for stats in report["per_host"].values():
        assert 0.0 <= stats["input_stall_pct"] <= 100.0
    assert report["host_skew_s"] >= 0.0 and report["ingest_wall_s"] > 0


def test_one_host_delivers_the_plan_in_order(scalar_store):
    loader = _port(scalar_store, batch_size=40, seed=5, num_hosts=1)
    plan = loader.epoch_plan(0)[0]
    assert _epoch_ids(loader) == [i for g in plan for i in range(20 * g, 20 * g + 20)]


def test_epochs_reshuffle_by_seed(scalar_store):
    with _port(scalar_store, batch_size=80, seed=9, num_epochs=2, num_hosts=4) as loader:
        batches = [_valid(b) for b in loader]
    assert len(batches) == 20
    e1 = [i for b in batches[:10] for i in b]
    e2 = [i for b in batches[10:] for i in b]
    assert sorted(e1) == sorted(e2) == list(range(800))
    assert e1 != e2
    assert loader.epoch_plan(0) != loader.epoch_plan(1)


# ------------------------------------------------------------- host loss
def _counts(ids):
    return collections.Counter(ids)


def test_a_killed_host_reshards_exactly_once(scalar_store):
    loader = _port(scalar_store, batch_size=80, seed=0, num_epochs=1, num_hosts=8,
                   drop_last=False, pad_last=True)
    ids = []
    with loader:
        it = iter(loader)
        ids.extend(_valid(next(it)))
        loader.kill_host(5)
        for batch in it:
            ids.extend(_valid(batch))
        report = loader.mesh_report()
    counts = _counts(ids)
    assert sorted(counts) == list(range(800))
    assert set(counts.values()) == {1}, "duplicated rows"
    assert report["reshard_events"] == 1
    assert [lost["host"] for lost in report["hosts_lost"]] == [5]
    assert "killed" in report["hosts_lost"][0]["error"]


def test_a_killed_host_never_loses_rows_with_two_workers(scalar_store):
    factory = MeshReaderFactory(scalar_store, batched=True, workers_count=2)
    assert not factory.fifo_delivery
    loader = MeshDataLoader(factory, batch_size=80, seed=1, num_epochs=1, num_hosts=8,
                            drop_last=False, pad_last=True, host_queue_depth=1, device="cpu")
    ids = []
    with loader:
        it = iter(loader)
        ids.extend(_valid(next(it)))
        loader.kill_host(4)
        for batch in it:
            ids.extend(_valid(batch))
    assert sorted(set(ids)) == list(range(800)), "rows lost on reshard"


def test_strict_mode_raises_naming_the_host(scalar_store):
    with _port(scalar_store, batch_size=80, seed=0, num_epochs=1, num_hosts=8,
               strict=True) as loader:
        it = iter(loader)
        next(it)
        loader.kill_host(1)
        with pytest.raises(MeshHostLostError, match="host 1"):
            for _ in it:
                pass


def test_kill_host_outside_an_epoch_raises(scalar_store):
    loader = _port(scalar_store, batch_size=80, num_hosts=2)
    with pytest.raises(RuntimeError, match="no live epoch"):
        loader.kill_host(0)


class _FailingReader:
    """A reader whose first pull raises, as a host whose disk died."""

    batched_output = True

    def next_batch(self):
        raise OSError("injected read failure")

    def state_dict(self):
        return {"epoch": 0, "offset": 0}

    def stop(self):
        pass

    def join(self):
        pass


class _FaultyFactory(MeshReaderFactory):
    """Host 2's primary shard fails; recovery readers (subsets of it spread
    over the survivors) read clean."""

    def __init__(self, url, fault_shard):
        super().__init__(url, batched=True)
        self._fault_shard = list(fault_shard)

    def __call__(self, rowgroup_subset):
        if list(rowgroup_subset) == self._fault_shard:
            return _FailingReader()
        return super().__call__(rowgroup_subset)


def test_a_reader_failure_is_a_host_loss(scalar_store):
    plan = _port(scalar_store, batch_size=80, num_hosts=4).epoch_plan(0)
    factory = _FaultyFactory(scalar_store, plan[2])
    with MeshDataLoader(factory, batch_size=80, num_epochs=1, num_hosts=4, drop_last=False,
                        pad_last=True, device="cpu") as loader:
        ids = [i for batch in loader for i in _valid(batch)]
        report = loader.mesh_report()
    assert sorted(ids) == list(range(800))
    assert report["reshard_events"] == 1
    assert [lost["host"] for lost in report["hosts_lost"]] == [2]
    assert "injected read failure" in report["hosts_lost"][0]["error"]


def test_a_collation_error_fails_the_loader_not_a_host(token_store):
    ngram = NGram({o: ["ts", "token"] for o in range(32)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=False)
    loader = MeshDataLoader(MeshReaderFactory(token_store, schema_fields=ngram), batch_size=8,
                            num_hosts=2, device="cpu")
    with loader:
        with pytest.raises(ValueError, match="dense=True"):
            next(iter(loader))
        assert loader.mesh_report()["reshard_events"] == 0


# --------------------------------------------------------------- NGram/llm
def test_dense_ngram_windows_are_every_window_once(token_store):
    ngram = NGram({o: ["ts", "token"] for o in range(32)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    factory = MeshReaderFactory(token_store, schema_fields=ngram)
    assert not factory.fifo_delivery
    starts, tokens = [], {}
    with MeshDataLoader(factory, batch_size=8, seed=0, num_epochs=1, num_hosts=8,
                        device="cpu") as loader:
        for batch in loader:
            assert tuple(batch["token"].shape) == (8, 32)
            for ts, tok in zip(batch["ts"].numpy(), batch["token"].numpy()):
                assert (np.diff(ts) == 1).all()
                starts.append(int(ts[0]))
                tokens[int(ts[0])] = tok
    assert sorted(starts) == [i * 32 for i in range(16)]
    from petastorm_tpu.ngram import NGram as JaxNGram
    jax_ngram = JaxNGram({o: ["ts", "token"] for o in range(32)}, delta_threshold=1,
                         timestamp_field="ts", timestamp_overlap=False, dense=True)
    with JaxMeshDataLoader(JaxMeshReaderFactory(token_store, schema_fields=jax_ngram),
                           batch_size=8, seed=0, num_epochs=1, num_hosts=8) as loader:
        for batch in loader:
            for ts, tok in zip(np.asarray(batch["ts"]), np.asarray(batch["token"])):
                np.testing.assert_array_equal(tokens.pop(int(ts[0])), tok)
    assert not tokens


def test_row_readers_batch_their_rows(scalar_store, tmp_path):
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema("Rows", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                                UnischemaField("name", np.str_, (), ScalarCodec(np.str_), False)])
    url = f"file://{tmp_path}/rows"
    with materialize_dataset_local(url, schema, rows_per_row_group=10) as w:
        for i in range(60):
            w.write_row({"id": i, "name": f"r{i}"})
    with pytest.warns(UserWarning, match="name"):
        with MeshDataLoader(MeshReaderFactory(url), batch_size=12, num_hosts=3, seed=2,
                            device="cpu") as loader:
            batches = list(loader)
    assert all(set(b) == {"id"} for b in batches)
    assert sorted(i for b in batches for i in b["id"].tolist()) == list(range(60))


# ---------------------------------------------------------------- resume
def test_a_resume_restores_each_hosts_position(scalar_store):
    first = []
    with _port(scalar_store, batch_size=80, seed=4, num_hosts=4, num_epochs=1) as loader:
        it = iter(loader)
        for _ in range(3):
            first.extend(next(it)["id"].tolist())
        state = loader.state_dict()
    assert state["epoch"] == 0 and state["num_hosts"] == 4 and state["mesh"] is True
    assert sum(state["hosts"].values()) >= len(first) // 20 - 4
    rest = _epoch_ids(_port(scalar_store, batch_size=80, seed=4, num_hosts=4, num_epochs=1,
                            resume_state=state, drop_last=False, pad_last=True))
    assert sorted(set(first + rest)) == list(range(800))
    # Batches of whole groups: nothing is read twice either.
    assert len(first + rest) == 800


def test_a_changed_plan_is_refused(scalar_store):
    with _port(scalar_store, batch_size=80, seed=4, num_hosts=4, num_epochs=1) as loader:
        next(iter(loader))
        state = loader.state_dict()
    with pytest.raises(ValueError, match="do not transfer"):
        _port(scalar_store, batch_size=80, seed=4, num_hosts=8, resume_state=state)
    # Fewer row groups than saved: a live store only appends (more is growth
    # that happened while the job was down, which the loader adopts).
    with pytest.raises(ValueError, match="row groups"):
        _port(scalar_store, batch_size=80, seed=4, num_hosts=4, num_rowgroups=39,
              resume_state=state)
    # A live-data cursor (a growth table) resumes with the JAX loader's rows.
    grown = dict(state, growth=[[0, 32], [1, 40]])
    got = _epoch_ids(_port(scalar_store, batch_size=80, seed=4, num_hosts=4, num_epochs=2,
                           resume_state=grown))
    want = _epoch_ids(_jax(scalar_store, batch_size=80, seed=4, num_hosts=4, num_epochs=2,
                           resume_state=grown))
    assert sorted(got) == sorted(want) and len(got) > 800
    with pytest.raises(ValueError, match="not a MeshDataLoader state_dict"):
        _port(scalar_store, batch_size=80, num_hosts=4, resume_state={"epoch": 0})


def test_the_epoch_index_carries_across_epochs(scalar_store):
    with _port(scalar_store, batch_size=80, seed=6, num_hosts=4, num_epochs=2) as loader:
        it = iter(loader)
        epoch1 = [next(it)["id"].tolist() for _ in range(10)]
        first_of_e2 = next(it)["id"].tolist()
        state = loader.state_dict()
    assert state["epoch"] == 1
    resumed = _epoch_ids(_port(scalar_store, batch_size=80, seed=6, num_hosts=4, num_epochs=1,
                               resume_state=state))
    assert sorted(i for b in epoch1 for i in b) == list(range(800))
    assert sorted(first_of_e2 + resumed) == list(range(800))


def test_a_cursor_after_a_reshard_resumes_with_nothing_lost(scalar_store):
    kw = dict(batch_size=80, seed=0, num_hosts=8, num_epochs=1, drop_last=False, pad_last=True)
    seen = []
    with _port(scalar_store, **kw) as loader:
        it = iter(loader)
        seen.extend(_valid(next(it)))
        loader.kill_host(5)
        state = None
        for batch in it:
            seen.extend(_valid(batch))
            state = loader.state_dict()
            if "recovered" in state:
                break
    assert state is not None and state.get("recovered") and state.get("resharded") is True
    rest = _epoch_ids(_port(scalar_store, resume_state=state, **kw))
    counts = _counts(seen + rest)
    assert sorted(counts) == list(range(800)), "rows lost across the resume"
    # What a resume reads twice is bounded by the groups in flight, never a
    # whole host's shard.
    assert sum(v - 1 for v in counts.values()) <= 8 * 2 * 20


# ------------------------------------------------ cursors cross both ways
def _cursors(loader, batches):
    out = []
    with loader:
        it = iter(loader)
        for _ in range(batches):
            next(it)
            out.append(loader.state_dict())
    return out


@pytest.mark.parametrize("batch_size", [24, 40, 120])
def test_one_host_cursors_equal_the_jax_loaders_at_every_batch(scalar_store, batch_size):
    kw = dict(batch_size=batch_size, seed=2, num_hosts=1, num_epochs=1)
    port = _cursors(_port(scalar_store, **kw), 5)
    jax_cursors = _cursors(_jax(scalar_store, **kw), 5)
    assert port == jax_cursors
    assert set(port[0]) == {"mesh", "epoch", "hosts", "num_rowgroups", "num_hosts"}


@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_cursors_cross_both_ways(scalar_store, direction):
    kw = dict(batch_size=80, seed=7, num_hosts=4, num_epochs=1)
    first_make, then_make = (_port, _jax) if direction == "port to jax" else (_jax, _port)
    first = []
    with first_make(scalar_store, **kw) as loader:
        it = iter(loader)
        for _ in range(4):
            first.extend(_valid(next(it)))
        state = loader.state_dict()
    assert set(state) == {"mesh", "epoch", "hosts", "num_rowgroups", "num_hosts"}
    rest = _epoch_ids(then_make(scalar_store, resume_state=state,
                                **dict(kw, drop_last=False, pad_last=True)))
    assert sorted(set(first + rest)) == list(range(800))
    assert len(first + rest) == 800
