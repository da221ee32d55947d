"""The random-access plane (the JAX package's ``petastorm_tpu/index``): a
saved field -> row-group index, keyed lookups, ordinal access and a
batched gather onto the card.

* :func:`build_field_index` / :func:`extend_field_index`: build and extend
  the ``_petastorm_tpu_index.json`` sidecar (the JAX package's file);
* ``Reader.lookup(keys)`` / ``Reader.dataset_view()``: point reads that
  share the reader's cache, quarantine and registry;
* :class:`IndexLookupPlane`: the same reads without a reader;
* :func:`gather_rows`: looked-up rows -> one tensor a field.

Imports without torch.
"""
from petastorm_tpu_torch.index.build import (build_field_index, extend_field_index,
                                               index_from_legacy_indexers,
                                               scan_files_into_index)
from petastorm_tpu_torch.index.gather import gather_rows
from petastorm_tpu_torch.index.lookup import IndexLookupPlane, matching_offsets
from petastorm_tpu_torch.index.sidecar import (GROUP_GRANULAR, INDEX_FORMAT, INDEX_SIDECAR_NAME,
                                               FieldIndex, encode_key)
from petastorm_tpu_torch.index.view import DatasetView

__all__ = ["FieldIndex", "IndexLookupPlane", "DatasetView", "build_field_index",
           "extend_field_index", "gather_rows", "index_from_legacy_indexers",
           "scan_files_into_index", "matching_offsets", "encode_key", "GROUP_GRANULAR",
           "INDEX_FORMAT", "INDEX_SIDECAR_NAME"]
