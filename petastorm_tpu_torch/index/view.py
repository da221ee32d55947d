"""``DatasetView``: random access by global row ordinal (the JAX package's
``petastorm_tpu/index/view.py``).

The ordinals are the index sidecar's: its append-only file order, then
row-group order, then row order, not any reader's epoch plan, so ``view[i]``
is the same row across a resume. Reads go through the owning
:class:`~petastorm_tpu_torch.index.IndexLookupPlane`: a slice shares the
lookup's cache, grouping and quarantine.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["DatasetView"]


class DatasetView:
    """``view[i]`` -> a row dict; ``view[i:j]`` and ``view[[i, j, k]]`` ->
    a list of row dicts, the ordinals of one row group served by one read.
    A row of a quarantined group (degraded mode) is ``None`` in a list
    (positions never shift), and ``view[i]`` of it raises ``LookupError``."""

    def __init__(self, plane, columns: Optional[Sequence[str]] = None):
        self._plane = plane
        self._columns = list(columns) if columns is not None else None

    def __len__(self) -> int:
        return self._plane.index.num_rows

    def __getitem__(self, item):
        if isinstance(item, slice):
            return self._fetch(range(*item.indices(len(self))))
        if isinstance(item, (list, tuple)):
            return self._fetch(item)
        row = self._fetch([item])[0]
        if row is None:
            raise LookupError(f"row {item} is unavailable (its row group was quarantined; "
                              f"see Reader.quarantine_report())")
        return row

    def _fetch(self, ordinals) -> List[Optional[dict]]:
        index = self._plane.index
        locations = [index.ordinal_to_location(int(i)) for i in ordinals]
        return self._plane.fetch_rows(locations, columns=self._columns)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"DatasetView({len(self)} rows, {len(self._plane.index.files)} files, "
                f"columns={self._columns or 'all'})")
