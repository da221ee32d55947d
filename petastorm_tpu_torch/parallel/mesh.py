"""A named grid of ``torch.distributed`` ranks: the port's counterpart of
``petastorm_tpu/parallel/mesh.py``, for the process groups that sequence
parallelism needs and the rank arithmetic of data-parallel ingestion.

A JAX mesh arranges devices and GSPMD derives every collective from it.
Here every rank is a process, and a mesh arranges the ranks of the
initialised default group into a grid with named axes; each axis gives this
rank one process group, the ranks that differ from it only along that axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


class Mesh:
    """Ranks of the default group as a grid: :attr:`shape` maps each axis
    name to its size, and :meth:`group` gives this rank's process group
    along an axis."""

    def __init__(self, shape: Dict[str, int], groups: Dict[str, object]):
        self.shape = dict(shape)
        self._groups = groups

    def group(self, axis: str):
        return self._groups[axis]

    def check_axes(self, *axes: Optional[str]) -> None:
        """Raise ``ValueError`` unless each of ``axes`` that is not None
        names an axis of the mesh (a ``PartitionSpec`` over a missing axis
        fails in the JAX package too)."""
        missing = [a for a in axes if a is not None and a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh's {list(self.shape)}")


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Arrange the ranks of the initialised default group into a grid of
    ``axis_sizes`` (rank-major, the last axis fastest), one process group per
    axis line. One size may be ``-1``, which absorbs the remaining ranks (as
    in a reshape). Every rank must call it, with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for {len(axis_names)} axis names")
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if world % known:
            raise ValueError(f"{world} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(f"Mesh {sizes} needs {total} ranks, have {world}")
    grid = np.arange(world).reshape(sizes)
    groups = {}
    for axis, name in enumerate(axis_names):
        lines = np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis])
        for line in lines:   # new_group is collective: every rank creates every line
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return Mesh(dict(zip(axis_names, sizes)), groups)


# ----------------------------------------------------------------- the data axis
# The rank arithmetic of ``petastorm_tpu/parallel/mesh.py:40-113``. A JAX
# mesh places the batch on devices through a ``NamedSharding``; here a rank's
# batch already is its slice, so a sharding is only a description of which
# mesh axes split the batch dimension.


@dataclass(frozen=True)
class BatchSharding:
    """``mesh`` and ``spec``, the batch dimension's layout: ``spec`` is a
    tuple as a ``PartitionSpec`` would be (``("data",)``, ``(("data",
    "seq"),)``, or ``()`` for a batch every rank holds whole)."""
    mesh: Mesh
    spec: Tuple = ()


def data_sharding(mesh: Mesh, data_axis: str = "data") -> BatchSharding:
    """The batch dimension split over ``data_axis``, the rest replicated."""
    return BatchSharding(mesh, (data_axis,))


def replicated(mesh: Mesh) -> BatchSharding:
    """Every rank holds the whole batch."""
    return BatchSharding(mesh, ())


def batch_shard_count(mesh: Mesh, spec) -> int:
    """How many ways ``spec`` splits dimension 0 (the batch) over ``mesh``:
    the divisor a global batch must have."""
    spec = tuple(spec)
    if len(spec) == 0 or spec[0] is None:
        return 1
    first = spec[0]
    names = (first,) if isinstance(first, str) else tuple(first)
    return int(np.prod([mesh.shape[name] for name in names]))


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> int:
    """The default group's world size, 1 without an initialised group."""
    return dist.get_world_size() if _initialized() else 1


def reader_shard_for_mesh(mesh: Optional[Mesh] = None,
                          data_axis: str = "data") -> Tuple[int, int]:
    """``(cur_shard, shard_count)`` of this rank's reader: its index along
    ``data_axis`` and the axis' size (without a mesh, its rank in the
    default group and the world size); ``(0, 1)`` without an initialised
    group. Ranks that differ only along other axes read the same shard."""
    if not _initialized():
        return 0, 1
    if mesh is None:
        return dist.get_rank(), dist.get_world_size()
    return dist.get_rank(mesh.group(data_axis)), int(mesh.shape[data_axis])


def mesh_feed_topology(mesh: Optional[Mesh],
                       num_hosts: Optional[int] = None) -> Tuple[int, Optional[int], bool]:
    """``(num_hosts, local_host_index, multiprocess)`` for feeding ``mesh``.

    With an initialised default group of more than one rank, one host is one
    rank of the mesh's ``"data"`` axis: ``num_hosts`` is pinned to the axis'
    size, and a
    ``num_hosts`` that differs raises. Otherwise every host is simulated in
    this process: ``num_hosts`` hosts (default **one**: a process here drives
    one device, where the JAX package defaults to one host per device of
    its mesh) and no local index."""
    if _world() > 1:
        if mesh is None:
            raise ValueError("a multi-rank topology needs the mesh its batch is split over")
        hosts = int(mesh.shape["data"])
        if num_hosts is not None and num_hosts != hosts:
            raise ValueError(
                f"num_hosts={num_hosts} conflicts with the {hosts} ranks of the mesh's "
                f"'data' axis: across ranks one host is one data rank")
        return hosts, dist.get_rank(mesh.group("data")), True
    n = int(num_hosts) if num_hosts is not None else 1
    if n < 1:
        raise ValueError(f"num_hosts must be >= 1, got {n}")
    return n, None, False


def global_batch_size(per_device_batch: int, mesh: Mesh, data_axis: str = "data") -> int:
    return per_device_batch * int(mesh.shape[data_axis])


def process_local_batch_size(global_batch: int, mesh: Optional[Mesh] = None,
                             data_axis: str = "data") -> int:
    """Rows this rank contributes a step for a global batch: the global batch
    over the data ranks (1 without an initialised group)."""
    ranks = reader_shard_for_mesh(mesh, data_axis)[1]
    if global_batch % ranks:
        raise ValueError(f"global_batch {global_batch} not divisible by the {ranks} data ranks")
    return global_batch // ranks
