"""Row-group selectors: choose row groups through the indexes stored with
the dataset (:func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index`).

The same classes as the JAX package's ``petastorm_tpu.selectors``. A
selector's ordinals index the store's row groups in their unfiltered,
deterministic order.
"""
from __future__ import annotations

from typing import Sequence


class RowGroupSelectorBase:
    def get_index_names(self) -> Sequence[str]:
        """Names of the stored indexes this selector reads."""
        raise NotImplementedError

    def select_row_groups(self, index_dict) -> set:
        """The selected row-group ordinals, given ``{index_name: indexer}``."""
        raise NotImplementedError

    def describe(self) -> str:
        """A one-line description of the selection."""
        return type(self).__name__


class SingleIndexSelector(RowGroupSelectorBase):
    """Row groups holding any of ``values_list`` in the named index."""

    def __init__(self, index_name: str, values_list):
        self._index_name = index_name
        self._values = list(values_list)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        indexer = index_dict[self._index_name]
        selected = set()
        for v in self._values:
            selected |= set(indexer.get_row_group_indexes(v))
        return selected

    def describe(self):
        return f"{self._index_name} in {len(self._values)} value(s)"


class IntersectIndexSelector(RowGroupSelectorBase):
    """Row groups every member selector selects."""

    def __init__(self, selectors: Sequence[SingleIndexSelector]):
        self._selectors = list(selectors)

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]

    def select_row_groups(self, index_dict):
        sets = [s.select_row_groups(index_dict) for s in self._selectors]
        return set.intersection(*sets) if sets else set()

    def describe(self):
        return " AND ".join(s.describe() for s in self._selectors) or "(empty)"


class UnionIndexSelector(RowGroupSelectorBase):
    """Row groups any member selector selects."""

    def __init__(self, selectors: Sequence[SingleIndexSelector]):
        self._selectors = list(selectors)

    def get_index_names(self):
        return [name for s in self._selectors for name in s.get_index_names()]

    def select_row_groups(self, index_dict):
        result = set()
        for s in self._selectors:
            result |= s.select_row_groups(index_dict)
        return result

    def describe(self):
        return " OR ".join(s.describe() for s in self._selectors) or "(empty)"
