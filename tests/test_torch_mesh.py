"""The port's data-axis arithmetic (``parallel/mesh.py``) against the JAX
package's ``petastorm_tpu/parallel/mesh.py``: batch shard counts, the local
and global batch sizes, reader shards and the feeding topology, and their
refusals. One process here is one JAX process over the conftest's 8 CPU
devices; the multi-rank cases run on 2 spawned CPU gloo ranks, against the
JAX functions with the process count and index patched to the ranks'."""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

import torch_mesh_ranks
from petastorm_tpu.parallel import mesh as jax_mesh
from petastorm_tpu_torch.parallel import mesh as pmesh
from petastorm_tpu_torch.parallel.launch import run_ranks

SHAPES = [((8,), ("data",)), ((4, 2), ("data", "seq")), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("data", "seq", "model"))]
SPECS = [("data",), (("data", "seq"),), (None,), (), (("seq", "data"),), ("seq",)]


def _meshes(sizes, names):
    """The JAX mesh over the 8 CPU devices and the port's mesh of the same
    shape (no process groups: one process)."""
    return (jax_mesh.make_mesh(sizes, names),
            pmesh.Mesh(dict(zip(names, sizes)), groups={}))


def _axes(spec):
    return {name for part in spec if part is not None
            for name in ((part,) if isinstance(part, str) else part)}


@pytest.mark.parametrize("sizes,names,spec", [
    (sizes, names, spec) for sizes, names in SHAPES for spec in SPECS
    if _axes(spec) <= set(names)], ids=str)
def test_batch_shard_count_matches_jax(sizes, names, spec):
    jm, pm = _meshes(sizes, names)
    assert pmesh.batch_shard_count(pm, spec) == jax_mesh.batch_shard_count(
        jm, PartitionSpec(*spec))


@pytest.mark.parametrize("sizes,names", SHAPES)
def test_shardings_describe_what_jax_names(sizes, names):
    jm, pm = _meshes(sizes, names)
    for port, jax_sharding in ((pmesh.data_sharding(pm), jax_mesh.data_sharding(jm)),
                               (pmesh.data_sharding(pm, "seq" if "seq" in names else "data"),
                                jax_mesh.data_sharding(jm, "seq" if "seq" in names else "data")),
                               (pmesh.replicated(pm), jax_mesh.replicated(jm))):
        assert port.mesh is pm
        assert tuple(port.spec) == tuple(jax_sharding.spec)
        assert pmesh.batch_shard_count(pm, port.spec) == jax_mesh.batch_shard_count(
            jm, jax_sharding.spec)
    with pytest.raises(Exception):
        pmesh.data_sharding(pm).spec = ()   # frozen, as a NamedSharding is


@pytest.mark.parametrize("sizes,names", SHAPES)
@pytest.mark.parametrize("per_device", [1, 3])
def test_global_and_local_batch_sizes_match_jax(sizes, names, per_device):
    jm, pm = _meshes(sizes, names)
    g = pmesh.global_batch_size(per_device, pm)
    assert g == jax_mesh.global_batch_size(per_device, jm)
    # One process: it contributes the whole global batch, ragged or not.
    for global_batch in (g, g + 1):
        assert pmesh.process_local_batch_size(global_batch, pm) == \
            jax_mesh.process_local_batch_size(global_batch, jm) == global_batch


def test_one_process_reads_the_whole_store():
    jm, pm = _meshes((8,), ("data",))
    assert pmesh.reader_shard_for_mesh(pm) == pmesh.reader_shard_for_mesh() == \
        jax_mesh.reader_shard_for_mesh(jm) == (0, 1)


@pytest.mark.parametrize("num_hosts", [1, 3, 8])
def test_one_process_simulates_the_hosts_asked_for(num_hosts):
    jm, pm = _meshes((8,), ("data",))
    assert pmesh.mesh_feed_topology(pm, num_hosts) == \
        jax_mesh.mesh_feed_topology(jm, num_hosts) == (num_hosts, None, False)


def test_one_process_defaults_to_one_host():
    """JAX simulates one host per device of its mesh; a process of the port
    drives one device, so it defaults to one host."""
    jm, pm = _meshes((8,), ("data",))
    assert jax_mesh.mesh_feed_topology(jm) == (8, None, False)
    assert pmesh.mesh_feed_topology(pm) == pmesh.mesh_feed_topology(None) == (1, None, False)


def test_a_host_count_below_one_raises_in_both():
    jm, pm = _meshes((8,), ("data",))
    with pytest.raises(ValueError, match="num_hosts must be >= 1"):
        jax_mesh.mesh_feed_topology(jm, 0)
    with pytest.raises(ValueError, match="num_hosts must be >= 1"):
        pmesh.mesh_feed_topology(pm, 0)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(torch_mesh_ranks.mesh_arithmetic, 2, device="cpu", timeout_s=120)


def _jax_as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_match_jax_over_two_processes(ranks, monkeypatch, rank):
    got = ranks[rank]
    _jax_as_rank(monkeypatch, rank, 2)
    jm = jax_mesh.make_mesh((8,), ("data",))
    assert got["shard"] == got["shard_default"] == jax_mesh.reader_shard_for_mesh(jm) == (rank, 2)
    assert got["topology"] == got["topology_same"] == jax_mesh.mesh_feed_topology(jm) == \
        (2, rank, True)
    assert got["local_batch"] == jax_mesh.process_local_batch_size(8, jm) == 4
    assert got["global_batch"] == 6 and got["shard_count"] == 2


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_refuse_what_jax_refuses(ranks, monkeypatch, rank):
    got = ranks[rank]
    _jax_as_rank(monkeypatch, rank, 2)
    jm = jax_mesh.make_mesh((8,), ("data",))
    with pytest.raises(ValueError, match="conflicts"):
        jax_mesh.mesh_feed_topology(jm, 3)
    assert got["topology_conflict"].startswith("ValueError") and "conflicts" in \
        got["topology_conflict"]
    with pytest.raises(ValueError, match="not divisible"):
        jax_mesh.process_local_batch_size(7, jm)
    assert got["local_batch_ragged"].startswith("ValueError") and "not divisible" in \
        got["local_batch_ragged"]


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_along_another_axis_read_one_shard(ranks, rank):
    """A (data 1, seq 2) mesh: both ranks are one data rank, one host."""
    got = ranks[rank]
    assert got["shard_grid"] == (0, 1)
    assert got["topology_grid"] == (1, 0, True)


def test_sizes_are_plain_ints():
    pm = pmesh.Mesh({"data": np.int64(4)}, groups={})
    assert type(pmesh.batch_shard_count(pm, ("data",))) is int
