"""Reading reference-petastorm metadata pickles, safely.

A store written by petastorm carries its ``Unischema`` **pickled** under the
``dataset-toolkit.unischema.v1`` key of ``_common_metadata``. This module
reads such a pickle without petastorm and without running arbitrary code:
:class:`RestrictedUnpickler`'s ``find_class`` resolves only an allowlist of
names, which maps petastorm's classes (under their ``petastorm.*`` and older
``dataset_toolkit.*`` module names) onto this package's and pyspark's type
objects onto small stubs; any other global raises
``pickle.UnpicklingError``. The same allowlist reads the row-group index
pickles (:mod:`.rowgroup_indexing`): petastorm's, the JAX package's and this
package's indexer names all resolve to this package's indexer classes.

It imports neither torch nor the JAX package: spawned reader workers
unpickle the schemas it makes.
"""
from __future__ import annotations

import copyreg
import io
import pickle
import warnings
from collections import OrderedDict, defaultdict, namedtuple
from decimal import Decimal

import numpy as np

from petastorm_tpu_torch import codecs as _codecs
from petastorm_tpu_torch.etl import rowgroup_indexers as _indexers
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class _SparkTypeStub:
    """Stands in for a pyspark ``DataType`` inside a ``ScalarCodec`` pickle;
    its class carries the numpy type the Spark type implies (``_np``)."""

    def __reduce__(self):   # the stubs stay picklable for the caches
        return (type(self), ())


def _spark_stub(name, np_dtype):
    return type(name, (_SparkTypeStub,), {"_np": np_dtype})


_SPARK_TYPE_STUBS = {
    "StringType": _spark_stub("StringType", str),
    "BinaryType": _spark_stub("BinaryType", bytes),
    "BooleanType": _spark_stub("BooleanType", np.bool_),
    "ByteType": _spark_stub("ByteType", np.int8),
    "ShortType": _spark_stub("ShortType", np.int16),
    "IntegerType": _spark_stub("IntegerType", np.int32),
    "LongType": _spark_stub("LongType", np.int64),
    "FloatType": _spark_stub("FloatType", np.float32),
    "DoubleType": _spark_stub("DoubleType", np.float64),
    "DecimalType": _spark_stub("DecimalType", Decimal),
    "TimestampType": _spark_stub("TimestampType", np.datetime64),
    "DateType": _spark_stub("DateType", np.datetime64),
}


class _LegacyScalarCodec(_codecs.ScalarCodec):
    """A ``ScalarCodec`` whose pickled state holds a Spark type (a stub)."""

    def __setstate__(self, state):
        spark_type = state.get("_spark_type") or state.get("spark_type")
        self.storage_dtype = getattr(spark_type, "_np", None) if spark_type is not None else None


class _LegacyCompressedImageCodec(_codecs.CompressedImageCodec):
    """petastorm pickles the OpenCV extension (``'.png'``, ``'.jpg'``)
    under ``_image_codec``; it is normalised to this package's attributes,
    so encoding works after a migration (decoding never depended on it:
    the decoder reads the container's format)."""

    def __setstate__(self, state):
        ext = str(state.get("_image_codec") or state.get("image_codec")
                  or ".png").lstrip(".").lower()
        if ext in ("jpg", "jpeg"):
            codec = "jpeg"
        elif ext == "png":
            codec = "png"
        else:
            # jp2, bmp, tiff, webp...: reads still work, but a re-encode
            # stores lossless png, never a silently lossy substitute.
            warnings.warn(f"Legacy image codec {ext!r} is not supported for re-encoding; "
                          f"reads are unaffected, re-encodes will store lossless png instead")
            codec = "png"
        _codecs.CompressedImageCodec.__init__(
            self, codec, int(state.get("_quality", state.get("quality", 80))))


class _LegacyUnischema(Unischema):
    """A ``Unischema`` rebuilt from a petastorm pickle's instance dict."""

    def __init__(self):   # the state arrives through __setstate__
        pass

    def __setstate__(self, state):
        Unischema.__init__(self, state.get("_name", "legacy"),
                           list(state.get("_fields", {}).values()))


class _LegacyUnischemaField(UnischemaField):
    """petastorm's ``UnischemaField`` is a NamedTuple ``(name, numpy_dtype,
    shape, codec, nullable)``; its pickle rebuilds through
    ``cls.__new__(cls, *args)``, so ``__new__`` does the work."""

    def __new__(cls, name, numpy_dtype, shape, codec=None, nullable=False):
        obj = object.__new__(cls)
        UnischemaField.__init__(obj, name, numpy_dtype, shape, codec, nullable)
        return obj


#: The indexer classes' module names: the JAX package's (the name this
#: package stores), petastorm's, petastorm's oldest, and this package's own.
INDEXER_MODULES = ("petastorm_tpu.etl.rowgroup_indexers", "petastorm.etl.rowgroup_indexers",
                   "dataset_toolkit.etl.rowgroup_indexers", _indexers.__name__)

#: Every (module, name) a pickle of a schema or of a row-group index may
#: name, and what it resolves to.
_ALLOWED = {
    **{(f"{package}.unischema", "Unischema"): _LegacyUnischema
       for package in ("petastorm", "dataset_toolkit")},
    **{(f"{package}.unischema", "UnischemaField"): _LegacyUnischemaField
       for package in ("petastorm", "dataset_toolkit")},
    **{(f"{package}.codecs", name): cls
       for package in ("petastorm", "dataset_toolkit")
       for name, cls in (("ScalarCodec", _LegacyScalarCodec),
                         ("NdarrayCodec", _codecs.NdarrayCodec),
                         ("CompressedNdarrayCodec", _codecs.CompressedNdarrayCodec),
                         ("CompressedImageCodec", _LegacyCompressedImageCodec))},
    **{(module, name): getattr(_indexers, name)
       for module in INDEXER_MODULES for name in ("SingleFieldIndexer", "FieldNotNullIndexer")},
    ("collections", "OrderedDict"): OrderedDict,
    ("collections", "defaultdict"): defaultdict,
    ("decimal", "Decimal"): Decimal,
    **{("builtins", t.__name__): t
       for t in (str, bytes, int, float, bool, set, frozenset, object, list, tuple, dict)},
}

_ALLOWED_NUMPY = {"dtype", "ndarray", "int8", "int16", "int32", "int64", "uint8", "uint16",
                  "uint32", "uint64", "float16", "float32", "float64", "bool_", "str_",
                  "bytes_", "datetime64", "object_"}

#: numpy aliases that old pickles name and numpy 1.20 / 2.0 removed.
_NUMPY_ALIASES = {"unicode_": np.str_, "string_": np.bytes_, "float": np.float64,
                  "int": np.int64, "bool": np.bool_, "object": np.object_, "long": np.int64}


def _legacy_reconstructor(cls, base, state):
    """``copyreg._reconstructor`` for old pickles: the oldest
    ``UnischemaField`` pickles were plain namedtuples (tuple subclasses),
    which this package's field is not, so it is constructed directly."""
    if base is tuple and issubclass(cls, UnischemaField):
        return cls(*state)
    return copyreg._reconstructor(cls, base, state)


def _pyspark_restore(name, fields, values):
    """pyspark rewrites namedtuple pickling into ``_restore(name, fields,
    values)``; schemas pickled inside a Spark job carry it."""
    if name == "UnischemaField":
        kwargs = dict(zip(fields, values))
        return _LegacyUnischemaField(kwargs["name"], kwargs["numpy_dtype"], kwargs["shape"],
                                     kwargs.get("codec"), kwargs.get("nullable", False))
    return namedtuple(name, fields)(*values)


def _numpy_global(module: str, name: str):
    if name in _NUMPY_ALIASES:
        return _NUMPY_ALIASES[name]
    if name in ("_reconstruct", "scalar"):
        try:
            from numpy._core import multiarray
        except ImportError:   # numpy < 2
            from numpy.core import multiarray
        return getattr(multiarray, name)
    if name in _ALLOWED_NUMPY:
        return getattr(np, name)
    return None


class RestrictedUnpickler(pickle.Unpickler):
    """Resolves only the allowlisted globals; any other raises
    ``pickle.UnpicklingError``. It never imports the module a pickle names."""

    def find_class(self, module, name):
        # Python 2 era pickles (the oldest petastorm stores).
        if module == "__builtin__":
            module = "builtins"
        elif module == "copy_reg":
            module = "copyreg"
        if (module, name) == ("copyreg", "_reconstructor"):
            return _legacy_reconstructor
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if module in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray"):
            found = _numpy_global(module, name)
            if found is not None:
                return found
        if module == "pyspark.sql.types" and name in _SPARK_TYPE_STUBS:
            return _SPARK_TYPE_STUBS[name]
        if (module, name) == ("pyspark.serializers", "_restore"):
            return _pyspark_restore
        raise pickle.UnpicklingError(
            f"Legacy metadata pickle references disallowed class {module}.{name}")


def restricted_loads(data: bytes):
    """``pickle.loads`` through :class:`RestrictedUnpickler`."""
    return RestrictedUnpickler(io.BytesIO(data)).load()


def depickle_legacy_unischema(pickled: bytes) -> Unischema:
    """A petastorm-pickled ``Unischema`` as this package's, rebuilt from
    plain classes (no ``_Legacy*`` type is left in it)."""
    obj = restricted_loads(pickled)
    if not isinstance(obj, Unischema):
        raise pickle.UnpicklingError(
            f"Legacy unischema pickle decoded to unexpected type {type(obj)}")
    return Unischema(obj.name, [UnischemaField(f.name, f.numpy_dtype, f.shape,
                                               _plain_codec(f.codec), f.nullable)
                                for f in obj.fields.values()])


def _plain_codec(codec):
    """A shim codec as its plain class, so a depickled schema equals one
    declared afresh or migrated (the schema equality of the mixer and the
    converter compares codec types)."""
    if isinstance(codec, _LegacyScalarCodec):
        return _codecs.ScalarCodec(codec.storage_dtype)
    if isinstance(codec, _LegacyCompressedImageCodec):
        return _codecs.CompressedImageCodec(codec.image_codec, codec.quality)
    return codec
