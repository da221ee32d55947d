"""Row predicates, evaluated inside the reader's workers.

A predicate names the fields it reads (``get_fields``) and decides for one
row (``do_include``) or, where it can do so with exactly the same answers,
for a whole row group at once (``do_include_batch``). The workers read the
predicate's columns first and the others only for the rows that pass;
where every predicate field is a hive partition key, the reader decides
at planning time and skips whole row groups. :meth:`PredicateBase.intervals`
and :class:`FieldDomain` describe, as an over-approximation, the values a
predicate can accept.

The same classes as the JAX package's ``petastorm_tpu.predicates``
(``in_pseudorandom_split`` puts every value in the same md5 bucket), with
its row mask, :func:`evaluate_predicate_mask`. This module imports neither
torch nor the JAX package, so a spawned worker unpickles a predicate
cheaply.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def _is_nan(v) -> bool:
    try:
        return isinstance(v, float) and math.isnan(v)
    except TypeError:  # pragma: no cover - defensive
        return False


def _lt(a, b) -> Optional[bool]:
    """``a < b`` with three-valued logic: ``None`` when the comparison is
    meaningless (mixed types, NaN) — callers treat ``None`` as "cannot
    prove", never as an exclusion."""
    if _is_nan(a) or _is_nan(b):
        return None
    try:
        return bool(a < b)
    except TypeError:
        return None


class FieldDomain:
    """Over-approximation of the values one field may take in any row a
    predicate accepts. Either (or both) of:

    * ``values`` — a discrete set of accepted non-null values;
    * ``intervals`` — ``((lo, hi, include_lo, include_hi), ...)`` accepted
      ranges, ``None`` bounds meaning unbounded;

    plus ``include_null`` — whether a null cell may be accepted.

    The only consumer-facing question is :meth:`admits_stats`: given one
    row group's column statistics, *might* any row match? Every unprovable
    comparison (missing stats, NaN bounds, cross-type ordering) answers
    "yes" — pruning must never be wrong, only incomplete.
    """

    __slots__ = ("values", "intervals", "include_null")

    def __init__(self, values=None, intervals=(), include_null=False):
        self.values = None if values is None else frozenset(values)
        self.intervals = tuple(intervals)
        self.include_null = bool(include_null)

    def __repr__(self):
        return (f"FieldDomain(values={self.values}, "
                f"intervals={self.intervals}, "
                f"include_null={self.include_null})")

    @property
    def unconstrained(self) -> bool:
        """No non-null constraint at all: this domain admits any value
        (the :meth:`admits_stats` fallback)."""
        return self.values is None and not self.intervals

    def union(self, other: "FieldDomain") -> "FieldDomain":
        """Domain accepting anything either side accepts (for OR-composed
        predicates). An unconstrained side makes the union unconstrained —
        merging its (absent) value set with the other side's would
        under-approximate and let the pruner drop matching rows."""
        include_null = self.include_null or other.include_null
        if self.unconstrained or other.unconstrained:
            return FieldDomain(include_null=include_null)
        if self.values is None or other.values is None:
            values = self.values if other.values is None else other.values
        else:
            values = self.values | other.values
        return FieldDomain(values=values,
                           intervals=self.intervals + other.intervals,
                           include_null=include_null)

    # ------------------------------------------------------------- pruning
    def _value_possible(self, v, stats) -> bool:
        """Could any row of a group with ``stats`` hold value ``v``?"""
        if not stats.has_min_max:
            return True
        below = _lt(v, stats.min)
        above = _lt(stats.max, v)
        if below is None or above is None:
            return True  # unprovable comparison: assume possible
        return not (below or above)

    def _interval_possible(self, interval, stats) -> bool:
        lo, hi, inc_lo, inc_hi = interval
        if not stats.has_min_max:
            return True
        if hi is not None:
            below = _lt(hi, stats.min)
            if below is None:
                return True
            if below or (not inc_hi and hi == stats.min):
                return False
        if lo is not None:
            above = _lt(stats.max, lo)
            if above is None:
                return True
            if above or (not inc_lo and lo == stats.max):
                return False
        return True

    def admits_stats(self, stats) -> bool:
        """True when a row group with these column ``stats`` (an object
        with ``has_min_max``, ``min``, ``max``, ``null_count`` and
        ``num_rows``) might contain a matching row; False only when
        provably empty."""
        if self.include_null and (stats.null_count is None
                                  or stats.null_count > 0):
            return True
        all_null = (stats.null_count is not None and stats.num_rows is not None
                    and stats.null_count >= stats.num_rows
                    and stats.num_rows > 0)
        if all_null:
            # Every cell is null and nulls are not accepted.
            return False
        if self.values is not None \
                and any(self._value_possible(v, stats) for v in self.values):
            return True
        if any(self._interval_possible(iv, stats) for iv in self.intervals):
            return True
        if self.values is None and not self.intervals:
            # No non-null constraint recorded: anything may match.
            return True
        return False


_NUMERIC_SCALARS = (bool, int, float, np.bool_, np.integer, np.floating)


def _batch_column(values):
    """Normalize one predicate column to an ndarray the vectorized mask
    kernels can reason about; ``None`` when it cannot be vectorized with
    semantics identical to the per-row path (object dtype — mixed types,
    ``None`` cells, memoryviews — keeps the exact scalar ``do_include``)."""
    arr = values if isinstance(values, np.ndarray) else np.asarray(values)
    if arr.dtype == object or arr.ndim != 1:
        return None
    return arr


class PredicateBase:
    def get_fields(self) -> set:
        """Names of the fields ``do_include`` reads."""
        raise NotImplementedError

    def do_include(self, values: dict) -> bool:
        """Decide inclusion given ``{field_name: value}`` for one row."""
        raise NotImplementedError

    def do_include_batch(self, columns: dict) -> Optional[np.ndarray]:
        """Vectorized row mask over whole columns. ``columns`` maps each
        ``get_fields()`` name to a per-row sequence (decoded values, one
        entry per row); the return is a boolean ndarray with ``mask[i] ==
        do_include(row_i)`` for EVERY row, or ``None`` when no vectorized
        evaluation with exactly those semantics exists (the base default,
        and the only honest answer for ``in_lambda``). ``None`` falls back
        to the per-row loop with zero behavior change — a kernel that is
        ever *almost* right silently changes which rows a seeded epoch
        delivers, so subclasses must return ``None`` on any doubt."""
        return None

    def intervals(self) -> Optional[list]:
        """Conjunctive ``[(field_name, FieldDomain), ...]`` constraints
        over-approximating the rows ``do_include`` can accept — a row can
        only match if EVERY listed constraint admits its field value.

        ``None`` (the default) means "unknown": the predicate falls back to
        fetch-then-filter with zero behavior change. Subclasses overriding
        this MUST keep it an over-approximation — claiming a value
        impossible that ``do_include`` would accept silently drops data."""
        return None


class in_set(PredicateBase):
    """Include rows whose ``predicate_field`` value is in ``inclusion_values``."""

    def __init__(self, inclusion_values, predicate_field: str):
        self._values = set(inclusion_values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return values[self._field] in self._values

    def do_include_batch(self, columns):
        col = _batch_column(columns[self._field])
        if col is None:
            return None
        # Only same-kind reference values can ever match a typed column
        # (set membership hashes across int/float/bool but never across
        # numeric/string), so cross-kind values drop from the reference —
        # exactly the rows-never-match outcome of the scalar path.
        vals = [v for v in self._values if v is not None]
        try:
            if col.dtype.kind in "biuf":
                vals = [v for v in vals if isinstance(v, _NUMERIC_SCALARS)]
                if not vals:
                    return np.zeros(len(col), dtype=bool)
                ref = np.asarray(vals)
                if col.dtype.kind in "iu" and ref.dtype.kind == "f":
                    # Exactness guard: int-column cells compare equal only
                    # to integral floats, and routing through float64 would
                    # alias ints past 2**53 — compare in int64 instead.
                    vals = [int(v) for v in vals if float(v).is_integer()]
                    if not vals:
                        return np.zeros(len(col), dtype=bool)
                    ref = np.asarray(vals, dtype=np.int64)
                elif col.dtype.kind == "f" and ref.dtype.kind in "iu":
                    # Symmetric exactness guard: a float cell can only
                    # equal an int reference the float type represents
                    # EXACTLY — np.isin's int->float64 promotion would
                    # alias refs past 2**53 and wrongly match. Keep the
                    # exactly-representable refs (as float64, lossless);
                    # the rest can never equal any float64 cell.
                    vals = [v for v in vals if float(v) == v]
                    if not vals:
                        return np.zeros(len(col), dtype=bool)
                    ref = np.asarray(vals, dtype=np.float64)
                if ref.dtype == object or ref.dtype.kind not in "biuf":
                    return None
                return np.isin(col, ref)
            if col.dtype.kind == "U":
                vals = [v for v in vals if isinstance(v, (str, np.str_))]
                if not vals:
                    return np.zeros(len(col), dtype=bool)
                return np.isin(col, np.asarray(vals))
        except (TypeError, ValueError, OverflowError):
            return None
        # datetimes/bytes/...: per-row semantics are subtler (an S-dtype
        # array even strips trailing NULs, so bytes can't ride np.isin).
        return None

    def intervals(self):
        return [(self._field,
                 FieldDomain(values={v for v in self._values if v is not None},
                             include_null=None in self._values))]


class in_range(PredicateBase):
    """Include rows whose ``predicate_field`` value lies in
    ``[lower, upper)`` (half-open by default, matching slicing convention;
    both bounds optional and inclusivity overridable). Null cells never
    match. :meth:`intervals` describes the range."""

    def __init__(self, predicate_field: str, lower=None, upper=None,
                 include_lower: bool = True, include_upper: bool = False):
        if lower is None and upper is None:
            raise ValueError("in_range needs at least one bound")
        if lower is not None and upper is not None:
            if _lt(upper, lower) or (upper == lower and
                                     not (include_lower and include_upper)):
                raise ValueError(f"empty range: [{lower!r}, {upper!r}] with "
                                 f"include_lower={include_lower}, "
                                 f"include_upper={include_upper}")
        self._field = predicate_field
        self._lower, self._upper = lower, upper
        self._include_lower, self._include_upper = include_lower, include_upper

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        v = values[self._field]
        if v is None or _is_nan(v):
            return False
        if self._lower is not None:
            if v < self._lower or (v == self._lower
                                   and not self._include_lower):
                return False
        if self._upper is not None:
            if v > self._upper or (v == self._upper
                                   and not self._include_upper):
                return False
        return True

    def do_include_batch(self, columns):
        col = _batch_column(columns[self._field])
        if col is None:
            return None
        kind = col.dtype.kind
        bounds = [b for b in (self._lower, self._upper) if b is not None]
        if kind in "biuf":
            if not all(isinstance(b, _NUMERIC_SCALARS) for b in bounds):
                return None
        elif kind == "U":
            if not all(isinstance(b, (str, np.str_)) for b in bounds):
                return None
        else:
            # bytes ('S') columns excluded like datetimes: numpy S-arrays
            # strip trailing NULs and cross-compare with str differently
            # than the scalar path would.
            return None
        mask = np.ones(len(col), dtype=bool)
        # Mirror the scalar path as NEGATED EXCLUSIONS, not inclusions:
        # do_include tests ``v < lower`` etc. and a NaN cell fails every
        # comparison, so the scalar path KEEPS non-float64 NaNs (np.float32
        # is not a ``float`` subclass, so _is_nan never fires for it) —
        # ``mask &= col >= lo`` would silently drop them instead.
        try:
            if self._lower is not None:
                mask &= ~(col < self._lower if self._include_lower
                          else col <= self._lower)
            if self._upper is not None:
                mask &= ~(col > self._upper if self._include_upper
                          else col >= self._upper)
        except TypeError:
            return None
        if col.dtype == np.float64:
            # Only float64 cells reach the scalar _is_nan exclusion
            # (np.float64 subclasses float); narrower floats keep NaNs
            # through the negated comparisons above, exactly like the
            # scalar path.
            mask &= ~np.isnan(col)
        return mask

    def intervals(self):
        return [(self._field,
                 FieldDomain(intervals=((self._lower, self._upper,
                                         self._include_lower,
                                         self._include_upper),)))]


class in_intersection(PredicateBase):
    """Include rows whose iterable ``predicate_field`` intersects
    ``inclusion_values``."""

    def __init__(self, inclusion_values, predicate_field: str):
        self._values = set(inclusion_values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return bool(self._values.intersection(values[self._field]))


class in_lambda(PredicateBase):
    """Arbitrary predicate: ``predicate_func(values_dict [, state])``."""

    def __init__(self, predicate_fields: Sequence[str], predicate_func: Callable,
                 state=None):
        self._fields = set(predicate_fields)
        self._func = predicate_func
        self._state = state

    def get_fields(self):
        return self._fields

    def do_include(self, values):
        if self._state is not None:
            return self._func(values, self._state)
        return self._func(values)


class in_negate(PredicateBase):
    def __init__(self, predicate: PredicateBase):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)

    def do_include_batch(self, columns):
        mask = self._predicate.do_include_batch(columns)
        return None if mask is None else ~mask


class in_reduce(PredicateBase):
    """Combine predicates with a reduce function (e.g. ``all``/``any`` over
    the list of member decisions)."""

    def __init__(self, predicate_list: Sequence[PredicateBase], reduce_func: Callable):
        self._predicates = list(predicate_list)
        self._reduce = reduce_func

    def get_fields(self):
        fields = set()
        for p in self._predicates:
            fields |= p.get_fields()
        return fields

    def do_include(self, values):
        return self._reduce([p.do_include(values) for p in self._predicates])

    def do_include_batch(self, columns):
        """``all``/``any`` compose member masks with vectorized and/or
        (the reduce sees a full member-decision list per row either way, so
        the composition is exact); any member without a kernel — or an
        opaque reduce function — falls the whole predicate back."""
        if self._reduce not in (all, any) or not self._predicates:
            return None
        masks = []
        for p in self._predicates:
            m = p.do_include_batch(columns)
            if m is None:
                return None
            masks.append(m)
        if self._reduce is all:
            return np.logical_and.reduce(masks)
        return np.logical_or.reduce(masks)

    def intervals(self):
        """AND-composition (``reduce_func is all``) concatenates member
        constraints — every member must pass, so each member's constraints
        hold independently (members without ``intervals()`` simply
        contribute none). OR-composition (``reduce_func is any``) unions
        per-field domains, valid only when EVERY member constrains that
        field. Any other reduce function is opaque: no pruning."""
        if self._reduce is all:
            out = []
            for p in self._predicates:
                out.extend(p.intervals() or [])
            return out or None
        if self._reduce is any:
            if not self._predicates:
                return None
            per_member = []
            for p in self._predicates:
                ivs = p.intervals()
                if ivs is None:
                    return None  # an unconstrained alternative admits anything
                per_member.append(ivs)
            # Fields constrained by every alternative: union their domains.
            common = set.intersection(*[{f for f, _ in ivs}
                                        for ivs in per_member])
            out = []
            for field in sorted(common):
                domain = None
                for ivs in per_member:
                    # AND-conjunct within one member: any one constraint is a
                    # valid over-approximation of that member; unioning every
                    # conjunct keeps it one for the disjunction.
                    for f, d in ivs:
                        if f == field:
                            domain = d if domain is None else domain.union(d)
                out.append((field, domain))
            return out or None
        return None


def _hash_bucket(value, num_buckets: int) -> int:
    """Stable md5 bucketing of a value's string form."""
    digest = hashlib.md5(str(value).encode("utf-8")).hexdigest()
    return int(digest, 16) % num_buckets


class in_pseudorandom_split(PredicateBase):
    """Deterministic train/val/test splitting by hashing an id field.

    The buckets are petastorm's and the JAX package's
    (``md5(str(value)) % sys.maxsize`` against ``fraction * (sys.maxsize-1)``
    bounds), so a split defined with either selects the same rows here.

    :param fraction_list: split fractions summing to <= 1.0
    :param subset_index: which split this predicate selects
    :param predicate_field: the id field hashed for bucketing
    """

    def __init__(self, fraction_list, subset_index: int, predicate_field: str):
        import sys
        if subset_index >= len(fraction_list):
            raise ValueError("subset_index out of range")
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError(f"fractions sum to {sum(fraction_list)} > 1")
        self._field = predicate_field
        high_borders = [sum(fraction_list[:i + 1]) for i in range(len(fraction_list))]
        fraction_low = high_borders[subset_index - 1] if subset_index else 0.0
        self._bucket_low = fraction_low * (sys.maxsize - 1)
        self._bucket_high = high_borders[subset_index] * (sys.maxsize - 1)
        self._maxsize = sys.maxsize

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        if self._field not in values:
            raise ValueError(f"Tested values do not have split key {self._field!r}")
        bucket = _hash_bucket(values[self._field], self._maxsize)
        return self._bucket_low <= bucket < self._bucket_high


def evaluate_predicate_mask(predicate, columns: Dict[str, object],
                            num_rows: int) -> np.ndarray:
    """Boolean inclusion mask of ``num_rows`` rows of decoded predicate
    ``columns``: one ``do_include_batch`` call where the predicate has one,
    else ``do_include`` row by row, with the same answers. The mask lines
    up with the columns' positions."""
    mask = predicate.do_include_batch(columns)
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (num_rows,):
            raise ValueError(
                f"{type(predicate).__name__}.do_include_batch returned a "
                f"mask of shape {mask.shape} for {num_rows} rows; the "
                f"mask must answer for every row")
        return mask
    names = list(columns)
    out = np.empty(num_rows, dtype=bool)
    for i in range(num_rows):
        out[i] = bool(predicate.do_include({n: columns[n][i] for n in names}))
    return out
