"""File admission: every new file is checked before it can extend a plan
(the JAX package's ``discovery/admission.py``).

``discovered`` -> ``pending_retry`` -> ``admitted`` | ``refused``:

* ``pending_retry``: the footer does not read (a file still being written,
  a transient IO error). The file goes to the reader's
  :class:`~petastorm_tpu_torch.resilience.RowGroupQuarantine` in that state
  and is checked again at every later poll: it is never banned for good.
* ``admitted``: the footer reads and the schema matches, or only adds
  columns (admitted with a warning: the reader reads its planned columns
  only). A file that was pending flips its quarantine record to
  ``admitted_after_retry``.
* ``refused``: a planned column changed its type or is gone. The file is
  refused loudly and the reader serves on from the last good snapshot. It
  is checked again only when its size or mtime changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["FileAdmission", "AdmittedFile", "classify_schema_drift", "read_new_file_footer",
           "DRIFT_IDENTICAL", "DRIFT_COMPATIBLE", "DRIFT_INCOMPATIBLE", "STATE_PENDING",
           "STATE_ADMITTED", "STATE_REFUSED"]

DRIFT_IDENTICAL = "identical"
DRIFT_COMPATIBLE = "compatible"
DRIFT_INCOMPATIBLE = "incompatible"

STATE_PENDING = "pending_retry"
STATE_ADMITTED = "admitted"
STATE_REFUSED = "refused"


@dataclasses.dataclass
class FileAdmission:
    """One file's admission record (the watcher's; :meth:`as_dict` is
    JSON-safe)."""

    path: str
    state: str = STATE_PENDING
    attempts: int = 0
    detail: str = ""
    drift: Optional[str] = None
    num_row_groups: int = 0
    size: int = -1
    mtime: float = 0.0
    first_seen_wall: float = 0.0
    last_checked_wall: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class AdmittedFile:
    """An admitted file staged for the plan. ``stats`` holds one
    ``{column: ColumnStats}`` a row group for the pruner's columns, from the
    footer read that admitted the file: pruning the growth costs no IO."""

    path: str
    num_row_groups: int
    mtime: float
    size: int
    drift: str
    detail: str = ""
    stats: Tuple[Dict[str, object], ...] = ()


def classify_schema_drift(reference_schema, candidate_schema) -> Tuple[str, str]:
    """``(kind, detail)`` of a new file's Arrow schema against the dataset's:
    :data:`DRIFT_IDENTICAL`; :data:`DRIFT_COMPATIBLE` when every reference
    column is there with its type and the file only adds columns;
    :data:`DRIFT_INCOMPATIBLE` when a reference column is missing or
    changed its type."""
    ref = {f.name: f for f in reference_schema}
    cand = {f.name: f for f in candidate_schema}
    missing = sorted(set(ref) - set(cand))
    if missing:
        return DRIFT_INCOMPATIBLE, f"missing column(s): {', '.join(missing)}"
    changed = [f"{name}: {ref_field.type} -> {cand[name].type}"
               for name, ref_field in ref.items() if not cand[name].type.equals(ref_field.type)]
    if changed:
        return DRIFT_INCOMPATIBLE, f"type change(s): {'; '.join(changed)}"
    added = sorted(set(cand) - set(ref))
    if added:
        nullability = "nullable" if all(cand[n].nullable for n in added) else "NON-nullable"
        return DRIFT_COMPATIBLE, f"added {nullability} column(s): {', '.join(added)}"
    return DRIFT_IDENTICAL, ""


def read_new_file_footer(filesystem, path: str, stats_columns=(), fault_plan=None,
                         worker_id: int = 0):
    """One read of ``path``'s Parquet footer: ``(num_row_groups,
    arrow_schema, per_group_stats)``, the statistics one
    ``{column: ColumnStats}`` a group over ``stats_columns`` (empty dicts
    without). Raises on an unreadable footer (``OSError``, or
    ``pyarrow.ArrowInvalid``, a ``ValueError``, for torn bytes). Fires the
    ``discovery.footer`` fault site."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.dataset_metadata import _column_stats_for_row_group

    if fault_plan is not None:
        fault_plan.fire("discovery.footer", key=str(path), worker_id=worker_id)
    with filesystem.open(path, "rb") as f:
        pf = pq.ParquetFile(f)
        md = pf.metadata
        schema = pf.schema_arrow
        columns = set(stats_columns)
        stats = tuple(_column_stats_for_row_group(md.row_group(i), columns) if columns else {}
                      for i in range(md.num_row_groups))
    return md.num_row_groups, schema, stats
