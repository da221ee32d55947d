"""The persisted field -> row-group index sidecar (the JAX package's
``petastorm_tpu/index/sidecar.py``; the same file, read and written by
either package).

The index is a versioned JSON sidecar (``_petastorm_tpu_index.json``) at
the dataset root, next to ``_metadata``/``_common_metadata``. It maps each
distinct value of one or more **key fields** to the exact rows holding it:

.. code-block:: json

    {"format": "petastorm-tpu.field-index.v1",
     "generation": 2,
     "files": ["part_0.parquet", "part_1.parquet"],
     "row_counts": [[10, 10], [10, 10]],
     "fields": {"id": {"i:42": [[1, 0, 2]]}}}

* ``files`` — relative data-file paths, **append-only**: an entry's file
  ordinal never changes once written, so the index extends monotonically
  as files are appended.
* ``row_counts`` — per-file per-row-group row counts, parallel to
  ``files``; gives :class:`~petastorm_tpu_torch.index.DatasetView` a stable
  global row ordinal (file order, then group order, then row order).
* ``fields`` — per key field, ``encoded key -> [[file, row_group,
  row_offset], ...]``. ``row_offset`` is the row's position *within* its
  row group; the sentinel ``-1`` marks a **group-granular** entry (the
  legacy indexer bridge has no row offsets — lookups decode the group and
  filter by value).

Keys are encoded as tagged strings (``i:42``, ``f:0.5``, ``s:abc``,
``b:<hex>``) so a JSON object can hold them without losing the type; the
query side encodes through the same function, so matching is exact and
never crosses types (``1`` and ``"1"`` are different keys).
"""
from __future__ import annotations

import json
import posixpath
from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

from petastorm_tpu_torch.errors import MetadataError

__all__ = ["FieldIndex", "INDEX_SIDECAR_NAME", "INDEX_FORMAT",
           "GROUP_GRANULAR", "encode_key"]

#: Sidecar file name at the dataset root (underscore prefix keeps it out of
#: the data-file listing, like ``_metadata``).
INDEX_SIDECAR_NAME = "_petastorm_tpu_index.json"

#: Format identifier; bump the suffix on an incompatible layout change.
INDEX_FORMAT = "petastorm-tpu.field-index.v1"

#: ``row_offset`` sentinel for group-granular entries (no per-row offset —
#: the lookup plane decodes the group and filters by the key value).
GROUP_GRANULAR = -1


def encode_key(value) -> str:
    """Encode one key value as the sidecar's tagged-string form.

    Typed tags keep JSON round-trips lossless and cross-type collisions
    impossible. numpy scalars unwrap to their Python value first, so
    ``np.int64(7)`` and ``7`` address the same entry.
    """
    item = getattr(value, "item", None)
    if item is not None and not hasattr(value, "__len__"):
        value = item()
    if isinstance(value, bool):
        return f"i:{int(value)}"
    if isinstance(value, int):
        return f"i:{value}"
    if isinstance(value, float):
        return f"f:{value!r}"
    if isinstance(value, str):
        return f"s:{value}"
    if isinstance(value, (bytes, bytearray, memoryview)):
        return "b:" + bytes(value).hex()
    raise TypeError(
        f"unindexable key type {type(value).__name__!r}: key fields must "
        f"hold int/float/str/bytes values (or arrays of them)")


class FieldIndex:
    """In-memory form of the sidecar; see the module docstring for the
    on-disk layout. Mutations are **append-only** (``add_file`` /
    ``add_entry``): existing ordinals and entries are never rewritten, so
    a reader holding an older generation stays correct for everything it
    already resolved."""

    def __init__(self, files: Optional[List[str]] = None,
                 row_counts: Optional[List[List[int]]] = None,
                 fields: Optional[Dict[str, Dict[str, list]]] = None,
                 generation: int = 0):
        self.files: List[str] = list(files or [])
        self.row_counts: List[List[int]] = [list(c) for c in (row_counts or [])]
        self.fields: Dict[str, Dict[str, list]] = {
            f: {k: [list(e) for e in v] for k, v in m.items()}
            for f, m in (fields or {}).items()}
        self.generation = int(generation)
        self._file_ordinals = {rel: i for i, rel in enumerate(self.files)}
        self._cum_rows: Optional[List[int]] = None  # lazy prefix sums

    # ------------------------------------------------------------ queries
    @property
    def fields_indexed(self) -> List[str]:
        return sorted(self.fields)

    def has_file(self, rel_path: str) -> bool:
        return rel_path in self._file_ordinals

    def keys(self, field: str):
        """Decoded distinct keys of one field (enumeration/debug surface)."""
        out = []
        for enc in self._field_map(field):
            tag, _, raw = enc.partition(":")
            out.append({"i": int, "f": float, "s": str}.get(tag, str)(raw)
                       if tag != "b" else bytes.fromhex(raw))
        return out

    def entries_for(self, field: str, value) -> List[Tuple[str, int, int]]:
        """``[(rel_path, row_group, row_offset), ...]`` for one key value
        (empty when the key is absent; ``row_offset`` may be
        :data:`GROUP_GRANULAR`)."""
        entries = self._field_map(field).get(encode_key(value), ())
        return [(self.files[f], rg, off) for f, rg, off in entries]

    def _field_map(self, field: str) -> Dict[str, list]:
        try:
            return self.fields[field]
        except KeyError:
            raise MetadataError(
                f"field {field!r} is not indexed (indexed fields: "
                f"{self.fields_indexed}); rebuild with "
                f"petastorm_tpu_torch.index.build_field_index") from None

    @property
    def num_rows(self) -> int:
        return self._cum()[len(self._cum()) - 1] if self._cum() else 0

    def ordinal_to_location(self, ordinal: int) -> Tuple[str, int, int]:
        """Global row ordinal -> ``(rel_path, row_group, row_offset)``.
        The ordinal space is the sidecar's append-only file order, so it is
        stable across reader resume and monotonic under growth."""
        cum = self._cum()
        total = cum[-1] if cum else 0
        if not -total <= ordinal < total:
            raise IndexError(f"row ordinal {ordinal} out of range for "
                             f"{total} indexed rows")
        if ordinal < 0:
            ordinal += total
        fi = bisect_right(cum, ordinal)
        local = ordinal - (cum[fi - 1] if fi else 0)
        for rg, n in enumerate(self.row_counts[fi]):
            if local < n:
                return self.files[fi], rg, local
            local -= n
        raise IndexError(f"row ordinal {ordinal} beyond recorded row counts "
                         f"of {self.files[fi]!r} (stale sidecar?)")

    def _cum(self) -> List[int]:
        if self._cum_rows is None:
            cum, total = [], 0
            for counts in self.row_counts:
                total += sum(counts)
                cum.append(total)
            self._cum_rows = cum
        return self._cum_rows

    # ---------------------------------------------------------- mutation
    def add_file(self, rel_path: str, group_row_counts: Sequence[int]) -> int:
        """Register one data file (append-only); returns its ordinal.
        Re-registering an already-indexed file returns the existing ordinal
        and changes nothing — extension is idempotent per file."""
        existing = self._file_ordinals.get(rel_path)
        if existing is not None:
            return existing
        ordinal = len(self.files)
        self.files.append(rel_path)
        self.row_counts.append([int(n) for n in group_row_counts])
        self._file_ordinals[rel_path] = ordinal
        self._cum_rows = None
        return ordinal

    def add_entry(self, field: str, value, file_ordinal: int, row_group: int,
                  row_offset: int = GROUP_GRANULAR) -> None:
        self.fields.setdefault(field, {}).setdefault(
            encode_key(value), []).append(
            [int(file_ordinal), int(row_group), int(row_offset)])

    # ------------------------------------------------------- persistence
    @staticmethod
    def sidecar_path(ctx) -> str:
        if ctx.is_multi_path:
            raise MetadataError("a field index needs a single dataset root (multi-URL views "
                                "enumerate a fixed file list with no sidecar home)")
        return posixpath.join(ctx.root_path, INDEX_SIDECAR_NAME)

    def to_dict(self) -> dict:
        return {"format": INDEX_FORMAT, "generation": self.generation,
                "files": self.files, "row_counts": self.row_counts,
                "fields": self.fields}

    @classmethod
    def from_dict(cls, doc: dict) -> "FieldIndex":
        fmt = doc.get("format")
        if fmt != INDEX_FORMAT:
            raise MetadataError(
                f"unsupported field-index format {fmt!r} (this build reads "
                f"{INDEX_FORMAT!r}); rebuild with "
                f"petastorm_tpu_torch.index.build_field_index")
        return cls(files=doc.get("files"), row_counts=doc.get("row_counts"),
                   fields=doc.get("fields"),
                   generation=doc.get("generation", 0))

    def save(self, ctx) -> None:
        """Persist (atomic single-file write; ``generation`` was bumped by
        the build that mutated the index)."""
        path = self.sidecar_path(ctx)
        payload = json.dumps(self.to_dict(), sort_keys=True).encode("utf-8")
        with ctx.filesystem.open(path, "wb") as f:
            f.write(payload)

    @classmethod
    def load(cls, ctx) -> "FieldIndex":
        """Load the dataset's sidecar; :class:`MetadataError` when absent
        or unreadable (pointing at the build entry point — absence is a
        configuration problem, never a silent empty index)."""
        path = cls.sidecar_path(ctx)
        try:
            if not ctx.filesystem.exists(path):
                raise MetadataError(
                    f"Dataset at {ctx.root_path} has no field index sidecar "
                    f"({INDEX_SIDECAR_NAME}). Build one with "
                    f"petastorm_tpu_torch.index.build_field_index(url, "
                    f"fields=[...])")
            with ctx.filesystem.open(path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
        except (OSError, IOError, ValueError) as e:
            raise MetadataError(
                f"Could not read field index sidecar at {path}: {e}") from e
        return cls.from_dict(doc)
