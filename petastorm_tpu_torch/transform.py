"""Transforms that run inside the reader's workers.

A :class:`TransformSpec` runs the user's preprocessing (crop, recast,
tokenize) on the worker side, in parallel, before the rows reach the
consumer, and declares how it changes the schema, so the reader's
``schema`` and the loaders' batches describe what the transform returns.

The same classes as the JAX package's ``petastorm_tpu.transform``
(``TransformSpec``, ``transform_schema``); this module imports neither
torch nor the JAX package, so a spawned worker unpickles a spec cheaply.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec:
    """A worker-side transform.

    :param func: applied to each row dict (``make_reader``) or to each row
        group's pandas DataFrame (``make_batch_reader``), and returns the
        transformed object; ``None`` for schema edits alone. On a process
        reader it must pickle: a module-level function, not a lambda or a
        closure
    :param edit_fields: fields ``func`` adds or retypes, as
        :class:`UnischemaField` or ``(name, numpy_dtype, shape, nullable)``
        tuples
    :param removed_fields: names ``func`` deletes
    :param selected_fields: when set, the output schema is exactly these
        names (after the edits and removals)
    :param batched: ``func`` takes one ``{column: per-row values}`` dict for
        the whole row group and returns the same form, instead of one call
        a row (``make_reader``) or a DataFrame (``make_batch_reader``).
        Every returned column keeps one entry per row
    """

    def __init__(self,
                 func: Optional[Callable] = None,
                 edit_fields: Optional[Sequence] = None,
                 removed_fields: Optional[Sequence[str]] = None,
                 selected_fields: Optional[Sequence[str]] = None,
                 batched: bool = False):
        self.func = func
        self.batched = bool(batched)
        self.edit_fields: List[UnischemaField] = [
            f if isinstance(f, UnischemaField) else self._field_from_tuple(f)
            for f in (edit_fields or [])
        ]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None

    @staticmethod
    def _field_from_tuple(t) -> UnischemaField:
        # (name, numpy_dtype, shape, nullable), or with a codec fifth.
        if len(t) == 4:
            name, numpy_dtype, shape, nullable = t
            return UnischemaField(name, numpy_dtype, shape, None, nullable)
        return UnischemaField(*t)


def transform_schema(schema: Unischema, transform_spec: TransformSpec) -> Unischema:
    """The output schema of ``transform_spec`` applied to rows of ``schema``:
    removals, then edits, then the selection. Raises ``ValueError`` when a
    selected field does not exist after the edits."""
    fields = dict(schema.fields)
    for name in transform_spec.removed_fields:
        fields.pop(name, None)
    for f in transform_spec.edit_fields:
        fields[f.name] = f
    if transform_spec.selected_fields is not None:
        missing = [n for n in transform_spec.selected_fields if n not in fields]
        if missing:
            raise ValueError(f"selected_fields not present after transform: {missing}")
        fields = {n: fields[n] for n in transform_spec.selected_fields}
    return Unischema(schema.name + "_transformed", list(fields.values()))
