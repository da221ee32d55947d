"""The lazy row plane's unit of motion (the JAX package's
``reader_impl/batch_plane.py``).

``make_reader(row_materialization="lazy")`` workers publish one
:class:`ColumnarBatch` a row group instead of a list of row dicts. The
loaders move whole columns (a permutation, slices, one concatenate a
column), and a consumer that wants rows gets namedtuples whose cells index
the batch's columns, built only when a row is asked for.

Lifetime: a lazy row's array cells are views of the batch's column storage,
so a kept row pins its whole batch, and writing a cell writes the batch.
Copy a cell (``np.copy``) to keep or change it.

The lazy stream holds the same rows as the eager one, epoch by epoch (the
same multiset), but not in the same order: a shuffling buffer permutes a
pool of whole batches where the eager buffer draws one row at a time.

Imports no torch: the row worker runs it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class ColumnarBatch:
    """One decoded row group as ``{column: per-row values}``: numpy arrays
    where the decode is vectorized (scalar casts), lists of cells otherwise
    (images decode to one array a row). It pickles, so it crosses the
    process pool's ring as one record a row group."""

    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: Dict[str, object], num_rows: Optional[int] = None):
        if num_rows is None:
            num_rows = len(next(iter(columns.values()))) if columns else 0
        self.columns = columns
        self.num_rows = int(num_rows)

    def __len__(self) -> int:
        return self.num_rows

    def __reduce__(self):
        return (ColumnarBatch, (self.columns, self.num_rows))

    def row_dict(self, i: int) -> dict:
        """Row ``i`` as a dict whose cells are items or views of the
        columns, not copies."""
        return {name: col[i] for name, col in self.columns.items()}

    def take(self, indices) -> "ColumnarBatch":
        """The rows at ``indices``: one fancy index an array column (a copy,
        detached from this batch), a cell selection a list column."""
        idx = np.asarray(indices, dtype=np.intp)
        cols = {name: col[idx] if isinstance(col, np.ndarray) else [col[i] for i in idx]
                for name, col in self.columns.items()}
        return ColumnarBatch(cols, len(idx))


def concat_column_slices(parts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """One batch from column-dict slices: one ``np.concatenate`` a column.
    A single part passes through as it is, its columns still views of their
    source."""
    if len(parts) == 1:
        return parts[0]
    return {name: np.concatenate([p[name] for p in parts]) for name in parts[0]}
