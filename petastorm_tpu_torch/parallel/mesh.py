"""A named grid of ``torch.distributed`` ranks: the port's counterpart of
``petastorm_tpu/parallel/mesh.py::make_mesh`` for the process groups that
sequence parallelism needs.

A JAX mesh arranges devices and GSPMD derives every collective from it.
Here every rank is a process, and a mesh arranges the ranks of the
initialised default group into a grid with named axes; each axis gives this
rank one process group, the ranks that differ from it only along that axis.
"""
from __future__ import annotations

from typing import Dict, Sequence

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
