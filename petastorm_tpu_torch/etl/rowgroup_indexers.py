"""Indexers: inverted maps from a field's values to the row groups that
hold them, built by :func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index`
and read by the selectors (:mod:`petastorm_tpu_torch.selectors`).

The same classes as the JAX package's ``petastorm_tpu.etl.rowgroup_indexers``,
with the same attributes, so an index pickled by either package loads in
the other; ``__setstate__`` also takes petastorm's own attribute names
(``_column_name``, ``_index_data``).
"""
from __future__ import annotations

import numpy as np


class RowGroupIndexerBase:
    """Fed the rows of each row group by ``process_row_group``, queried by
    ``get_row_group_indexes``."""

    @property
    def index_name(self) -> str:
        raise NotImplementedError

    @property
    def column_names(self):
        """Columns this indexer reads."""
        raise NotImplementedError

    @property
    def indexed_values(self):
        raise NotImplementedError

    def get_row_group_indexes(self, value):
        raise NotImplementedError

    def process_row_group(self, row_group_ordinal: int, rows) -> None:
        raise NotImplementedError


class SingleFieldIndexer(RowGroupIndexerBase):
    """Maps each distinct value of one field to the row groups holding it;
    an array-valued field indexes each element."""

    def __init__(self, index_name: str, index_field: str):
        self._index_name = index_name
        self._field = index_field
        self._index: dict = {}

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field]

    @property
    def indexed_values(self):
        return list(self._index.keys())

    def get_row_group_indexes(self, value):
        return self._index.get(value, set())

    def process_row_group(self, row_group_ordinal, rows):
        for row in rows:
            value = row[self._field]
            if value is None:
                continue
            if isinstance(value, (np.ndarray, list, tuple)):
                for v in value:
                    self._index.setdefault(v, set()).add(row_group_ordinal)
            else:
                self._index.setdefault(value, set()).add(row_group_ordinal)

    def __eq__(self, other):
        return (type(self) is type(other) and self._field == other._field
                and self._index == other._index)

    def __setstate__(self, state):
        self._index_name = state.get("_index_name")
        self._field = state.get("_field", state.get("_column_name"))
        self._index = dict(state.get("_index", state.get("_index_data", {})))


class FieldNotNullIndexer(RowGroupIndexerBase):
    """Indexes the row groups holding at least one non-null value of a field."""

    NOT_NULL_KEY = "__not_null__"

    def __init__(self, index_name: str, index_field: str):
        self._index_name = index_name
        self._field = index_field
        self._row_groups: set = set()

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._field]

    @property
    def indexed_values(self):
        return [self.NOT_NULL_KEY]

    def get_row_group_indexes(self, value=None):
        return self._row_groups

    def process_row_group(self, row_group_ordinal, rows):
        for row in rows:
            if row[self._field] is not None:
                self._row_groups.add(row_group_ordinal)
                return

    def __setstate__(self, state):
        self._index_name = state.get("_index_name")
        self._field = state.get("_field", state.get("_column_name"))
        self._row_groups = set(state.get("_row_groups", state.get("_index_data", set())))
