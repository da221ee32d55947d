"""NGram: windowed sequence readout over timestamp-sorted rows.

An :class:`NGram` turns a row dataset into a dataset of fixed-length time
windows. Windows are assembled **within a row group** (they never cross its
boundary), after sorting the group's rows by ``timestamp_field``;
``delta_threshold`` drops windows with a timestamp gap, and
``timestamp_overlap=False`` yields disjoint windows. A sample is
``{offset: row_namedtuple}`` for every offset in ``fields``, or, with
``dense=True``, ``{field_name: (length, *shape) array}``.

Given the same rows it forms the same windows, in the same order, as the
JAX package's ``NGram``; it is this package's own copy.
"""
from __future__ import annotations

import decimal
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from petastorm_tpu_torch.unischema import Unischema, UnischemaField, match_unischema_fields


class NGram:
    """:param fields: ``{offset: [UnischemaField or field-name regex, ...]}``
        — which fields are read at each relative timestep
    :param delta_threshold: max allowed timestamp delta between *consecutive*
        rows of a window; windows containing a larger gap are dropped
    :param timestamp_field: the field (or its name) windows are ordered by
    :param timestamp_overlap: when False, yielded windows do not share rows
    :param dense: samples become ``{field_name: np.ndarray}`` with a leading
        ``(length,)`` window axis instead of ``{offset: namedtuple}``.
        Requires every offset to declare the same field set. When all
        window fields decode to plain numeric columns the reader assembles
        windows column-major, with no per-row dicts or namedtuples.
    """

    def __init__(self,
                 fields: Dict[int, Sequence[Union[UnischemaField, str]]],
                 delta_threshold: Union[int, float, decimal.Decimal],
                 timestamp_field: Union[UnischemaField, str],
                 timestamp_overlap: bool = True,
                 dense: bool = False):
        if not isinstance(fields, dict) or not fields:
            raise ValueError("fields must be a non-empty dict of {offset: [fields]}")
        keys = sorted(fields.keys())
        if keys != list(range(min(keys), max(keys) + 1)):
            raise ValueError(f"fields offsets must be consecutive integers, got {keys}")
        self._fields = {k: list(v) for k, v in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self._timestamp_overlap = timestamp_overlap
        self._dense = dense
        if dense:
            self._validate_dense()

    @property
    def length(self) -> int:
        return max(self._fields) - min(self._fields) + 1

    @property
    def fields(self):
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def timestamp_field_name(self) -> str:
        f = self._timestamp_field
        return f.name if isinstance(f, UnischemaField) else f

    @property
    def timestamp_overlap(self) -> bool:
        return self._timestamp_overlap

    @property
    def dense(self) -> bool:
        return self._dense

    def _validate_dense(self) -> None:
        """Dense windows stack one array per field over the window axis, so
        every offset must read the same fields (regex specs are checked
        again after :meth:`resolve_regex_field_names` expands them)."""
        names = [tuple(sorted(f.name if isinstance(f, UnischemaField) else f
                              for f in self._fields[k]))
                 for k in sorted(self._fields)]
        if any(n != names[0] for n in names):
            raise ValueError(
                "dense=True requires the same field set at every offset; "
                f"got {dict(zip(sorted(self._fields), names))}")

    # -------------------------------------------------------------- schemas
    def resolve_regex_field_names(self, schema: Unischema) -> None:
        """Expand any string patterns in ``fields`` against ``schema``."""
        resolved = {}
        for offset, specs in self._fields.items():
            out: List[UnischemaField] = []
            for spec in specs:
                if isinstance(spec, UnischemaField):
                    out.append(spec)
                else:
                    matched = match_unischema_fields(schema, [spec])
                    if not matched:
                        raise ValueError(f"NGram field pattern {spec!r} matched nothing")
                    out.extend(matched)
            seen = set()
            resolved[offset] = [f for f in out if not (f.name in seen or seen.add(f.name))]
        self._fields = resolved
        if self._dense:
            self._validate_dense()
            varlen = sorted({f.name for specs in resolved.values()
                             for f in specs if None in (f.shape or ())})
            if varlen:
                raise ValueError(
                    f"dense=True requires fixed-shape fields; {varlen} are "
                    f"variable-length. Pad them at write time, exclude "
                    f"them, or use dense=False")

    def get_field_names_at_timestep(self, timestep: int) -> List[str]:
        if timestep not in self._fields:
            return []
        return [f.name if isinstance(f, UnischemaField) else f
                for f in self._fields[timestep]]

    def get_schema_at_timestep(self, schema: Unischema, timestep: int) -> Unischema:
        """Schema view of the fields read at one timestep."""
        names = [n for n in self.get_field_names_at_timestep(timestep)
                 if n in schema.fields]
        return schema.create_schema_view(names)

    def get_field_names_at_all_timesteps(self) -> List[str]:
        names = set()
        for ts in self._fields:
            names.update(self.get_field_names_at_timestep(ts))
        names.add(self.timestamp_field_name)
        return sorted(names)

    # ------------------------------------------------------------- assembly
    def _pass_threshold(self, timestamps) -> bool:
        """True when every consecutive delta is <= delta_threshold."""
        for prev, cur in zip(timestamps, timestamps[1:]):
            if cur - prev > self._delta_threshold:
                return False
        return True

    def form_ngram(self, data: List[dict], schema: Unischema) -> List[Dict[int, object]]:
        """Windows of one row group's decoded rows, which must be sorted by
        the timestamp field: a list of ``{offset: namedtuple}`` dicts."""
        ts_name = self.timestamp_field_name
        offsets = sorted(self._fields)
        length = self.length
        schemas = {off: self.get_schema_at_timestep(schema, off) for off in offsets}
        out = []
        i = 0
        n = len(data)
        while i + length <= n:
            window = data[i:i + length]
            timestamps = [row[ts_name] for row in window]
            if self._pass_threshold(timestamps):
                sample = {}
                for pos, offset in enumerate(offsets):
                    ts_schema = schemas[offset]
                    row = {k: window[pos][k] for k in ts_schema.fields if k in window[pos]}
                    sample[offset] = ts_schema.make_namedtuple_from_dict(row)
                out.append(sample)
                i += length if not self._timestamp_overlap else 1
            else:
                i += 1
        return out

    # ------------------------------------------------------- dense assembly
    def _window_starts(self, timestamps) -> List[int]:
        """Accepted window starts over timestamp-sorted rows: the acceptance
        walk of :meth:`form_ngram` (reject -> advance by 1; accept -> advance
        by 1 or ``length``), with the per-window delta check vectorized."""
        n = len(timestamps)
        length = self.length
        if n < length:
            return []
        ts = np.asarray(timestamps)
        # bad[j]: the gap between rows j and j+1 is too large; the window
        # starting at i is valid iff bad[i : i+length-1] has no True.
        if length == 1:
            valid = np.ones(n, bool)
        else:
            thr = self._delta_threshold
            if isinstance(thr, decimal.Decimal):
                thr = float(thr)   # numpy compares numeric arrays with floats only
            bad = np.diff(ts) > thr
            csum = np.concatenate(([0], np.cumsum(bad)))
            valid = csum[length - 1:] == csum[:n - length + 1]
        starts = []
        i = 0
        while i + length <= n:
            if valid[i]:
                starts.append(i)
                i += 1 if self._timestamp_overlap else length
            else:
                i += 1
        return starts

    def form_ngram_dense(self, cols: Dict[str, object], order) -> List[Dict[str, object]]:
        """Column-major window assembly for ``dense=True``: ``cols`` maps
        field name -> per-row column, ``order`` is the index array that
        timestamp-sorts it. Returns ``[{name: (length, *shape) array}]``."""
        names = self.get_field_names_at_timestep(min(self._fields))
        ts_sorted = np.asarray(cols[self.timestamp_field_name])[order]
        starts = self._window_starts(ts_sorted)
        if not starts:
            return []
        length = self.length
        sorted_cols = {name: np.asarray(cols[name])[order] for name in names}
        # .copy() detaches each window from the row-group-sized buffer, so a
        # retained window never pins the whole group.
        return [{name: col[i:i + length].copy() for name, col in sorted_cols.items()}
                for i in starts]

    def densify_windows(self, windows: List[Dict[int, object]]) -> List[Dict[str, object]]:
        """:meth:`form_ngram` output in the dense representation: the
        fallback when a field needs per-cell codec decode."""
        offsets = sorted(self._fields)
        names = self.get_field_names_at_timestep(offsets[0])
        return [{name: np.stack([np.asarray(getattr(w[off], name)) for off in offsets])
                 for name in names}
                for w in windows]


__all__ = ["NGram"]
