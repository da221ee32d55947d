"""Build and load the row-group indexes that ``rowgroup_selector=`` reads.

:func:`build_rowgroup_index` feeds every row group of a store to the
given indexers (:mod:`.rowgroup_indexers`) and stores them, pickled, in
the ``_common_metadata`` sidecar under the JAX package's key.
:func:`get_row_group_indexes` loads them back, from that key or from
petastorm's own.

The stored pickle names the indexer classes as the JAX package does
(``petastorm_tpu.etl.rowgroup_indexers``), so either package reads an
index the other built. Loading goes through
:class:`~petastorm_tpu_torch.etl.legacy.RestrictedUnpickler`, whose one
allowlist maps the indexer names of the JAX package, of petastorm and of
this package onto this package's classes, allows a few plain types, and
refuses everything else: it never imports the module a pickle names.

Deprecated, as in the JAX package: the random-access plane
(:func:`petastorm_tpu_torch.index.build_field_index`, ``Reader.lookup()``)
indexes exact rows. ``build_rowgroup_index(emit_field_index=True)`` also
writes its keyed indexers into that plane's sidecar, group-granular.
"""
from __future__ import annotations

import logging
import pickle
import pickletools
from concurrent.futures import ThreadPoolExecutor
import warnings
from typing import Dict, Sequence

import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl import rowgroup_indexers
from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, load_row_groups,
                                                      write_dataset_metadata)
from petastorm_tpu_torch.etl.legacy import restricted_loads
from petastorm_tpu_torch.etl.rowgroup_indexers import RowGroupIndexerBase

logger = logging.getLogger(__name__)

TPU_ROWGROUPS_INDEX_KEY = b"petastorm-tpu.rowgroups_index.v1"
LEGACY_ROWGROUPS_INDEX_KEY = b"dataset-toolkit.rowgroups_index.v1"

#: The module name the stored pickle gives the indexer classes.
STORED_INDEXER_MODULE = "petastorm_tpu.etl.rowgroup_indexers"



def loads_index(data: bytes) -> Dict[str, RowGroupIndexerBase]:
    """The pickled index, through the reference-store unpickler's one
    allowlist (:func:`~petastorm_tpu_torch.etl.legacy.restricted_loads`)."""
    return restricted_loads(data)


def dumps_index(index_dict: Dict[str, RowGroupIndexerBase]) -> bytes:
    """Pickle ``index_dict`` with this package's indexer classes named as
    :data:`STORED_INDEXER_MODULE`. Protocol 2 names a class by a ``GLOBAL``
    opcode, ``c<module>\\n<name>\\n``, which carries no length: those
    opcodes are rewritten in place."""
    data = pickle.dumps(index_dict, protocol=2, fix_imports=False)
    own = rowgroup_indexers.__name__ + " "
    out, last = [], 0
    for opcode, arg, pos in pickletools.genops(data):
        if opcode.name == "GLOBAL" and arg.startswith(own):
            out += [data[last:pos], b"c", STORED_INDEXER_MODULE.encode(), b"\n",
                    arg[len(own):].encode(), b"\n"]
            last = pos + len(arg) + 2
    out.append(data[last:])
    return b"".join(out)


_DEPRECATION = (
    "petastorm_tpu_torch.etl.rowgroup_indexing is deprecated: the random-access "
    "plane (petastorm_tpu_torch.index.build_field_index + Reader.lookup()) indexes "
    "exact rows and serves point reads through the decoded cache. The legacy "
    "group-granular index keeps working for rowgroup_selector=.")


def build_rowgroup_index(dataset_url_or_ctx, indexers: Sequence[RowGroupIndexerBase],
                         num_workers: int = 10,
                         emit_field_index: bool = True) -> Dict[str, RowGroupIndexerBase]:
    """Feed every row group of the store, by its ordinal in the store's
    deterministic order, to ``indexers``, store them in the dataset
    metadata and return ``{index_name: indexer}``.

    .. deprecated:: use :func:`petastorm_tpu_torch.index.build_field_index`.
       ``emit_field_index=True`` (the default) also saves every keyed
       single-field indexer as a group-granular field-index sidecar, so
       ``Reader.lookup()`` works on the store (a lookup decodes the group
       and filters it by value); a failure there is logged, never raised."""
    warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
    ctx = (dataset_url_or_ctx if isinstance(dataset_url_or_ctx, DatasetContext)
           else DatasetContext(dataset_url_or_ctx))
    row_groups = load_row_groups(ctx)
    columns = sorted({c for ix in indexers for c in ix.column_names})

    def _read(job):
        ordinal, rg = job
        with ctx.filesystem.open(rg.path, "rb") as f:
            table = pq.ParquetFile(f).read_row_group(rg.row_group, columns=columns)
        return ordinal, table.to_pylist()

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for ordinal, rows in pool.map(_read, enumerate(row_groups)):
            for ix in indexers:
                ix.process_row_group(ordinal, rows)

    index_dict = {ix.index_name: ix for ix in indexers}
    write_dataset_metadata(ctx, None, extra_kv={TPU_ROWGROUPS_INDEX_KEY: dumps_index(index_dict)})
    if emit_field_index:
        try:
            from petastorm_tpu_torch.index.build import index_from_legacy_indexers
            bridged = index_from_legacy_indexers(ctx, indexers, num_workers=num_workers)
            if bridged.fields_indexed:
                bridged.save(ctx)
        except Exception:  # noqa: BLE001 - the legacy index is stored either way
            logger.exception("could not bridge the legacy indexers to the field-index "
                             "sidecar; Reader.lookup() needs build_field_index()")
    return index_dict


def get_row_group_indexes(dataset_url_or_ctx) -> Dict[str, RowGroupIndexerBase]:
    """The stored ``{index_name: indexer}``; raises ``MetadataError`` when
    the store has none."""
    ctx = (dataset_url_or_ctx if isinstance(dataset_url_or_ctx, DatasetContext)
           else DatasetContext(dataset_url_or_ctx))
    kv = ctx.key_value_metadata()
    for key in (TPU_ROWGROUPS_INDEX_KEY, LEGACY_ROWGROUPS_INDEX_KEY):
        if key in kv:
            return loads_index(kv[key])
    raise MetadataError(f"Dataset at {ctx.root_path} has no row-group index. "
                        f"Build one with build_rowgroup_index().")
