"""Dataset schema: one declaration rendered to numpy rows and Arrow storage.

A :class:`Unischema` declares the logical record type of a dataset — field
names, numpy dtypes, tensor shapes (``None`` marks a variable dimension),
per-field storage codecs and nullability. The JSON form written by
:meth:`Unischema.to_dict` is the one the JAX package writes, so a store
written by either package is read by the other.
"""
from __future__ import annotations

import copyreg
import re
import warnings
from collections import OrderedDict, namedtuple
from dataclasses import dataclass
from decimal import Decimal
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from petastorm_tpu_torch.errors import SchemaError


def _shape_tuple(shape) -> Tuple[Optional[int], ...]:
    if shape is None:
        return ()
    if isinstance(shape, (list, tuple)):
        return tuple(shape)
    raise ValueError(f"shape must be a tuple/list/None, got {shape!r}")


@dataclass(frozen=True)
class UnischemaField:
    """A single field declaration.

    :param name: field name (a valid identifier: rows render as namedtuples)
    :param numpy_dtype: the decoded, in-memory dtype (numpy dtype, numpy
        scalar type, ``Decimal`` or ``str``/``bytes``)
    :param shape: tensor shape of one record's value; ``()`` for scalars;
        ``None`` dimensions are variable
    :param codec: storage codec (see :mod:`petastorm_tpu_torch.codecs`);
        ``None`` selects scalar passthrough for scalars, ndarray bytes
        otherwise
    :param nullable: whether nulls are permitted
    """
    name: str
    numpy_dtype: Any
    shape: Tuple[Optional[int], ...] = ()
    codec: Any = None
    nullable: bool = False

    def __init__(self, name, numpy_dtype, shape=(), codec=None, nullable=False):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "numpy_dtype", numpy_dtype)
        object.__setattr__(self, "shape", _shape_tuple(shape))
        object.__setattr__(self, "codec", codec)
        object.__setattr__(self, "nullable", bool(nullable))

    @property
    def is_scalar(self) -> bool:
        return len(self.shape) == 0

    def __repr__(self):
        return (f"UnischemaField({self.name!r}, {_dtype_name(self.numpy_dtype)}, "
                f"{self.shape}, codec={self.codec!r}, nullable={self.nullable})")

    # Equality/hash must tolerate unhashable codec instances and dtype aliases.
    def __eq__(self, other):
        if not isinstance(other, UnischemaField):
            return NotImplemented
        return (self.name == other.name
                and _dtype_name(self.numpy_dtype) == _dtype_name(other.numpy_dtype)
                and self.shape == other.shape
                and type(self.codec) is type(other.codec)
                and self.nullable == other.nullable)

    def __hash__(self):
        return hash((self.name, _dtype_name(self.numpy_dtype), self.shape,
                     type(self.codec), self.nullable))


def _dtype_name(numpy_dtype) -> str:
    if numpy_dtype is Decimal:
        return "decimal"
    if numpy_dtype is str:
        return "str"
    if numpy_dtype is bytes:
        return "bytes"
    return np.dtype(numpy_dtype).name


def _dtype_from_name(name: str):
    if name == "decimal":
        return Decimal
    if name == "str":
        return str
    if name == "bytes":
        return bytes
    return np.dtype(name)


def _rebuild_view_row(parent_name, field_names, values):
    """Unpickle a schema-view row through the cache of the receiving
    process: the namedtuple types are made at run time and are no module
    attributes, so pickle cannot find them by name (NGram windows cross a
    process pool as ``{offset: namedtuple}``)."""
    return _NamedtupleCache.get(parent_name, field_names)(*values)


class _NamedtupleCache:
    """Process-wide cache of row namedtuple types keyed by (schema name,
    fields): recreating the type per row would defeat ``isinstance`` checks
    and cost an allocation in the hot loop."""
    _cache: dict = {}

    @classmethod
    def get(cls, parent_name: str, field_names: Sequence[str]):
        key = (parent_name, tuple(field_names))
        if key not in cls._cache:
            nt = namedtuple(parent_name + "_view", field_names)
            copyreg.pickle(nt, lambda row, _p=parent_name, _f=key[1]:
                           (_rebuild_view_row, (_p, _f, tuple(row))))
            cls._cache[key] = nt
        return cls._cache[key]


class Unischema:
    """An ordered (by name) collection of :class:`UnischemaField`.

    Fields are accessible as attributes (``schema.my_field``) and through the
    ``fields`` ordered mapping.
    """

    def __init__(self, name: str, fields: Sequence[UnischemaField]):
        self._name = name
        self._fields = OrderedDict((f.name, f) for f in sorted(fields, key=lambda f: f.name))
        if len(self._fields) != len(fields):
            names = [f.name for f in fields]
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"Duplicate field names in schema {name!r}: {dupes}")

    def __getattr__(self, item):
        fields = self.__dict__.get("_fields")
        if fields is not None and item in fields:
            return fields[item]
        raise AttributeError(f"{type(self).__name__!s} has no attribute/field {item!r}")

    @property
    def name(self) -> str:
        return self._name

    @property
    def fields(self) -> "OrderedDict[str, UnischemaField]":
        return self._fields

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self):
        return len(self._fields)

    def __repr__(self):
        lines = ",\n  ".join(repr(f) for f in self._fields.values())
        return f"Unischema({self._name!r}, [\n  {lines}\n])"

    def __eq__(self, other):
        if not isinstance(other, Unischema):
            return NotImplemented
        return list(self._fields.values()) == list(other._fields.values())

    def __hash__(self):
        return hash(tuple(self._fields.values()))

    def create_schema_view(self, fields) -> "Unischema":
        """Sub-schema of the requested fields: UnischemaField instances,
        exact names, or regex patterns (``re.fullmatch`` on the name)."""
        selected: "OrderedDict[str, UnischemaField]" = OrderedDict()
        for spec in fields:
            if isinstance(spec, UnischemaField):
                if spec.name not in self._fields:
                    raise ValueError(f"Field {spec.name!r} does not belong to schema {self._name!r}")
                selected[spec.name] = self._fields[spec.name]
            elif isinstance(spec, str):
                matched = match_unischema_fields(self, [spec])
                if not matched:
                    raise ValueError(f"Field pattern {spec!r} matched no fields in schema {self._name!r}")
                for f in matched:
                    selected[f.name] = f
            else:
                raise TypeError(f"Expected UnischemaField or str, got {type(spec)}")
        return Unischema(self._name + "_view", list(selected.values()))

    @property
    def namedtuple(self):
        return _NamedtupleCache.get(self._name, list(self._fields.keys()))

    def make_namedtuple(self, **kwargs):
        """One row namedtuple from keyword values (a missing field raises
        ``KeyError``; extra keywords are ignored)."""
        tt = self.namedtuple
        return tt(**{k: kwargs[k] for k in tt._fields})

    def make_namedtuple_tf(self, *args, **kwargs):
        """The row namedtuple type applied to any positional or keyword
        values (tf tensors, say)."""
        return self.namedtuple(*args, **kwargs)

    def make_namedtuple_from_dict(self, row: dict):
        tt = self.namedtuple
        return tt(**{k: row.get(k) for k in tt._fields})

    @property
    def decode_plan(self):
        """Cached ``[(name, field, resolved_codec)]`` for the decode loop."""
        plan = self.__dict__.get("_decode_plan")
        if plan is None:
            plan = [(name, f, f.codec or _default_codec(f))
                    for name, f in self._fields.items()]
            self.__dict__["_decode_plan"] = plan
        return plan

    # ------------------------------------------------------------- renderers
    def as_arrow_schema(self):
        """The storage schema (post-codec-encode) as a ``pyarrow.Schema``."""
        import pyarrow as pa
        pa_fields = []
        for f in self._fields.values():
            codec = f.codec or _default_codec(f)
            pa_fields.append(pa.field(f.name, codec.arrow_type(f), nullable=f.nullable))
        return pa.schema(pa_fields)

    def as_spark_schema(self):
        """The storage schema as a Spark ``StructType``: each codec's
        ``spark_type`` and the field's nullability (imports pyspark)."""
        try:
            from pyspark.sql.types import StructField, StructType
        except ImportError as e:
            raise ImportError("as_spark_schema() requires pyspark") from e
        return StructType([StructField(f.name, (f.codec or _default_codec(f)).spark_type(f),
                                       f.nullable)
                           for f in self._fields.values()])

    def as_tensor_specs(self, batch_size: Optional[int] = None,
                        variable_dim: Optional[int] = None) -> dict:
        """``{name: torch.empty(shape, dtype=..., device="meta")}``: the
        shape and dtype of each field as the loaders deliver it under
        ``DEFAULT_POLICY`` (the JAX package's ``as_shape_dtype_structs``).
        ``batch_size`` prepends a batch dimension; ``variable_dim``
        substitutes ``None`` dimensions, which otherwise raise. Fields that
        stay on the host (strings, bytes, ``Decimal``, uint64) are left
        out."""
        import torch

        from petastorm_tpu_torch.loader.dtypes import DEFAULT_POLICY, sanitize_array

        out = {}
        for f in self._fields.values():
            if f.numpy_dtype in (str, bytes, Decimal, np.str_, np.bytes_, np.object_):
                continue
            delivered = sanitize_array(np.empty(0, np.dtype(f.numpy_dtype)), DEFAULT_POLICY)
            if delivered is None:
                continue
            shape = list(f.shape)
            for i, d in enumerate(shape):
                if d is None:
                    if variable_dim is None:
                        raise ValueError(f"Field {f.name!r} has a variable dimension; pass "
                                         f"variable_dim= to fix it")
                    shape[i] = variable_dim
            if batch_size is not None:
                shape = [batch_size] + shape
            dtype = (delivered.dtype if isinstance(delivered, torch.Tensor)
                     else torch.from_numpy(delivered).dtype)
            out[f.name] = torch.empty(tuple(shape), dtype=dtype, device="meta")
        return out

    # ------------------------------------------------------------- inference
    @classmethod
    def from_arrow_schema(cls, arrow_schema, omit_unsupported_fields: bool = False) -> "Unischema":
        """A Unischema inferred from a ``pyarrow.Schema`` (or an object with a
        ``schema``, such as a ``ParquetDataset``): a plain column becomes a
        scalar field, a ``FixedSizeList`` a ``(list_size,)`` field and a
        variable list a ``(None,)`` field, none with a codec. A column of a
        type numpy has no counterpart for raises ``ValueError``, or is left
        out with a warning when ``omit_unsupported_fields``."""
        import pyarrow as pa
        if hasattr(arrow_schema, "schema"):
            arrow_schema = arrow_schema.schema
        if hasattr(arrow_schema, "to_arrow_schema"):
            arrow_schema = arrow_schema.to_arrow_schema()
        fields = []
        for name in arrow_schema.names:
            pa_field = arrow_schema.field(name)
            if isinstance(pa_field.type, pa.lib.FixedSizeListType):
                value_type, shape = pa_field.type.value_type, (pa_field.type.list_size,)
            elif isinstance(pa_field.type, pa.lib.ListType):
                value_type, shape = pa_field.type.value_type, (None,)
            else:
                value_type, shape = pa_field.type, ()
            np_dtype = _numpy_from_arrow_type(value_type, name, omit_unsupported_fields)
            if np_dtype is not None:
                fields.append(UnischemaField(name, np_dtype, shape, None, pa_field.nullable))
        return cls("inferred", fields)

    # ---------------------------------------------------------- (de)serialize
    def to_dict(self) -> dict:
        """JSON-able schema document (no pickle), as stored in metadata."""
        from petastorm_tpu_torch.codecs import codec_to_dict
        return {
            "name": self._name,
            "fields": [
                {
                    "name": f.name,
                    "numpy_dtype": _dtype_name(f.numpy_dtype),
                    "shape": list(f.shape),
                    "codec": codec_to_dict(f.codec),
                    "nullable": f.nullable,
                } for f in self._fields.values()
            ],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Unischema":
        from petastorm_tpu_torch.codecs import codec_from_dict
        fields = [UnischemaField(fd["name"], _dtype_from_name(fd["numpy_dtype"]),
                                 tuple(fd["shape"]), codec_from_dict(fd["codec"]),
                                 fd["nullable"])
                  for fd in doc["fields"]]
        return cls(doc["name"], fields)


_ARROW_TO_NUMPY = None


def _numpy_from_arrow_type(arrow_type, field_name, omit_unsupported):
    """The numpy dtype of an Arrow type, or None to leave the field out."""
    import pyarrow as pa
    global _ARROW_TO_NUMPY
    if _ARROW_TO_NUMPY is None:
        _ARROW_TO_NUMPY = {
            pa.bool_(): np.bool_,
            pa.int8(): np.int8, pa.int16(): np.int16, pa.int32(): np.int32, pa.int64(): np.int64,
            pa.uint8(): np.uint8, pa.uint16(): np.uint16, pa.uint32(): np.uint32,
            pa.uint64(): np.uint64,
            pa.float16(): np.float16, pa.float32(): np.float32, pa.float64(): np.float64,
            pa.string(): str, pa.large_string(): str,
            pa.binary(): bytes, pa.large_binary(): bytes,
            pa.date32(): np.datetime64, pa.date64(): np.datetime64,
        }
    if arrow_type in _ARROW_TO_NUMPY:
        return _ARROW_TO_NUMPY[arrow_type]
    if isinstance(arrow_type, pa.lib.TimestampType):
        return np.datetime64
    if isinstance(arrow_type, pa.lib.Decimal128Type):
        return Decimal
    if omit_unsupported:
        warnings.warn(f"Field {field_name!r} has unsupported Arrow type {arrow_type}; omitting.")
        return None
    raise ValueError(f"Cannot map Arrow type {arrow_type} of field {field_name!r} to numpy "
                     f"(pass omit_unsupported_fields=True to skip).")


def _default_codec(field: UnischemaField):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    if field.is_scalar:
        return ScalarCodec(field.numpy_dtype)
    return NdarrayCodec()


# ---------------------------------------------------------------------- rows
def dict_to_encoded_row(schema: Unischema, row: dict) -> dict:
    """Validate and codec-encode one row dict for storage: rejects
    unexpected fields, inserts explicit nulls for absent nullable fields,
    and runs each field's codec ``encode`` (which checks shape and dtype)."""
    if not isinstance(row, dict):
        raise TypeError(f"row must be a dict, got {type(row)}")
    unexpected = set(row.keys()) - set(schema.fields.keys())
    if unexpected:
        raise ValueError(f"Fields not in schema {schema.name!r}: {sorted(unexpected)}")

    full_row = dict(row)
    insert_explicit_nulls(schema, full_row)

    encoded = {}
    for name, field in schema.fields.items():
        value = full_row[name]
        if value is None:
            if not field.nullable:
                raise SchemaError(f"Field {name!r} is not nullable but got None")
            encoded[name] = None
            continue
        codec = field.codec or _default_codec(field)
        encoded[name] = codec.encode(field, value)
    return encoded


def insert_explicit_nulls(schema: Unischema, row: dict) -> None:
    """Add ``None`` entries for absent nullable fields; raise on absent
    non-nullable fields."""
    for name, field in schema.fields.items():
        if name not in row:
            if field.nullable:
                row[name] = None
            else:
                raise SchemaError(f"Field {name!r} is required (nullable=False) but missing from row")


def match_unischema_fields(schema: Unischema, field_regexes: Sequence[str]):
    """Fields whose names fully match any of the given regexes."""
    if not field_regexes:
        return []
    compiled = [re.compile(p) for p in field_regexes]
    return [f for f in schema.fields.values() if any(c.fullmatch(f.name) for c in compiled)]
