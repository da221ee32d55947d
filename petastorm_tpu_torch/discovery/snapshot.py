"""Immutable dataset snapshots in admission order (the JAX package's
``discovery/snapshot.py``).

A :class:`DatasetSnapshot` lists the admitted files in the order they were
admitted, which gives every row group its global ordinal: a new file's
groups always come after every group admitted before, so plans extend
instead of reshuffling and an ordinal means the same bytes for good. The
sorted listing ``load_row_groups`` plans from is not stable under growth
(an appended file may sort into the middle); the snapshot keeps its own
order.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

__all__ = ["FileEntry", "DatasetSnapshot"]


@dataclasses.dataclass(frozen=True)
class FileEntry:
    """One admitted file: its row groups and the global ordinal of its
    first (a file's groups are consecutive)."""

    path: str
    num_row_groups: int
    first_ordinal: int
    mtime: float = 0.0           # wall seconds; 0 = unknown
    size: int = -1               # bytes; -1 = unknown

    @property
    def ordinals(self) -> range:
        return range(self.first_ordinal, self.first_ordinal + self.num_row_groups)


class DatasetSnapshot:
    """The admitted files; :meth:`extended` returns a new snapshot with
    more, so a reader never sees half a poll."""

    __slots__ = ("files", "snapshot_id", "_paths")

    def __init__(self, files: Sequence[FileEntry], snapshot_id: int = 0):
        self.files: Tuple[FileEntry, ...] = tuple(files)
        self.snapshot_id = int(snapshot_id)
        expected = 0
        for f in self.files:
            if f.first_ordinal != expected:
                raise ValueError(f"snapshot ordinals must be contiguous in admission order: "
                                 f"{f.path} starts at {f.first_ordinal}, expected {expected}")
            expected += f.num_row_groups
        self._paths = frozenset(f.path for f in self.files)

    @property
    def total_row_groups(self) -> int:
        if not self.files:
            return 0
        last = self.files[-1]
        return last.first_ordinal + last.num_row_groups

    @property
    def paths(self) -> frozenset:
        return self._paths

    def __contains__(self, path: str) -> bool:
        return path in self._paths

    def __len__(self) -> int:
        return len(self.files)

    def extended(self, new_files: Sequence[Tuple[str, int, float, int]]) -> "DatasetSnapshot":
        """A new snapshot with ``(path, num_row_groups, mtime, size)``
        entries after the current ordinals."""
        files = list(self.files)
        next_ordinal = self.total_row_groups
        for path, n_groups, mtime, size in new_files:
            if path in self._paths:
                raise ValueError(f"{path} is already in the snapshot")
            files.append(FileEntry(path, int(n_groups), next_ordinal, mtime=mtime, size=size))
            next_ordinal += int(n_groups)
        return DatasetSnapshot(files, snapshot_id=self.snapshot_id + 1)

    def row_group_refs(self, ctx) -> list:
        """The snapshot's row groups as
        :class:`~petastorm_tpu_torch.etl.dataset_metadata.RowGroupRef` s in
        ordinal order, hive partition values parsed per file as planning
        does."""
        from petastorm_tpu_torch.etl.dataset_metadata import RowGroupRef
        out = []
        for f in self.files:
            pv = ctx.partition_values_for(f.path)
            out.extend(RowGroupRef(f.path, i, pv) for i in range(f.num_row_groups))
        return out

    def manifest(self, root_path: str) -> List[List[object]]:
        """``[[relative_path, num_row_groups], ...]`` in admission order: the
        cursor's record, from which a resumed reader rebuilds this ordinal
        assignment."""
        return [[os.path.relpath(f.path, root_path), f.num_row_groups] for f in self.files]

    @staticmethod
    def from_manifest(manifest: Sequence[Sequence[object]], root_path: str) -> "DatasetSnapshot":
        """A snapshot from :meth:`manifest`'s record, re-anchored under
        ``root_path``."""
        files: List[FileEntry] = []
        ordinal = 0
        for rel, n_groups in manifest:
            files.append(FileEntry(os.path.join(root_path, rel), int(n_groups), ordinal))
            ordinal += int(n_groups)
        return DatasetSnapshot(files)

    @staticmethod
    def from_row_groups(row_groups) -> "DatasetSnapshot":
        """The base snapshot of a planned ``load_row_groups`` list: files in
        plan order, ordinals the plan's positions."""
        counts: Dict[str, int] = {}
        order: List[str] = []
        for rg in row_groups:
            if rg.path not in counts:
                counts[rg.path] = 0
                order.append(rg.path)
            counts[rg.path] += 1
        files: List[FileEntry] = []
        ordinal = 0
        for path in order:
            files.append(FileEntry(path, counts[path], ordinal))
            ordinal += counts[path]
        return DatasetSnapshot(files)

    def __repr__(self):
        return (f"DatasetSnapshot(id={self.snapshot_id}, files={len(self.files)}, "
                f"row_groups={self.total_row_groups})")
