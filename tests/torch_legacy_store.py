"""Stores in petastorm's own metadata format, made without petastorm.

petastorm keeps a store's ``Unischema`` pickled under
``dataset-toolkit.unischema.v1`` in ``_common_metadata``, beside a JSON map
of each data file's row groups under
``dataset-toolkit.num_row_groups_per_file.v1``. :func:`reference_unischema_pickle`
makes such a pickle: while it runs, modules named ``petastorm.unischema``,
``petastorm.codecs`` and ``pyspark.sql.types`` hold classes with
petastorm's names and instance attributes, so the pickle's globals are
petastorm's; the modules are removed again before it returns.
:func:`link_reference_store` gives existing Parquet data files (hard links,
or copies where linking fails) such a ``_common_metadata``, with no other
key: no byte of the data is re-encoded. :class:`DataFileOpenCounter`
counts the data files a planning source opens.

Imports neither JAX nor torch: ``chip_smoke.py`` and the tests use it.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import sys
import types
import typing
from collections import OrderedDict

import pyarrow.parquet as pq

LEGACY_UNISCHEMA_KEY = b"dataset-toolkit.unischema.v1"
LEGACY_ROW_GROUPS_PER_FILE_KEY = b"dataset-toolkit.num_row_groups_per_file.v1"


class _UnischemaField(typing.NamedTuple):
    name: str
    numpy_dtype: object
    shape: tuple
    codec: object = None
    nullable: bool = False


class _Unischema:
    def __init__(self, name, fields):
        self._name = name
        self._fields = OrderedDict((f.name, f) for f in fields)


class _ScalarCodec:
    def __init__(self, spark_type):
        self._spark_type = spark_type


class _CompressedImageCodec:
    def __init__(self, image_codec="png", quality=80):
        self._image_codec = "." + image_codec
        self._quality = quality


class _NdarrayCodec:
    pass


class _CompressedNdarrayCodec:
    pass


_SPARK_TYPES = ("LongType", "IntegerType", "ShortType", "ByteType", "BooleanType", "FloatType",
                "DoubleType", "StringType", "BinaryType")

#: petastorm's module and class name of each stand-in class.
_NAMES = {_Unischema: ("petastorm.unischema", "Unischema"),
          _UnischemaField: ("petastorm.unischema", "UnischemaField"),
          _ScalarCodec: ("petastorm.codecs", "ScalarCodec"),
          _CompressedImageCodec: ("petastorm.codecs", "CompressedImageCodec"),
          _NdarrayCodec: ("petastorm.codecs", "NdarrayCodec"),
          _CompressedNdarrayCodec: ("petastorm.codecs", "CompressedNdarrayCodec")}


@contextlib.contextmanager
def _petastorm_names():
    """petastorm's and pyspark's module names, holding the stand-ins under
    petastorm's class names, for the duration of a pickling; the previous
    ``sys.modules`` entries and class names are restored after it."""
    spark_types = {name: type(name, (), {"__module__": "pyspark.sql.types"})
                   for name in _SPARK_TYPES}
    modules = {name: types.ModuleType(name)
               for name in ("petastorm", "petastorm.unischema", "petastorm.codecs", "pyspark",
                            "pyspark.sql", "pyspark.sql.types")}
    for cls, (module, name) in _NAMES.items():
        setattr(modules[module], name, cls)
    for name, cls in spark_types.items():
        setattr(modules["pyspark.sql.types"], name, cls)
    saved_modules = {name: sys.modules.get(name) for name in modules}
    saved_names = {cls: (cls.__module__, cls.__name__, cls.__qualname__) for cls in _NAMES}
    sys.modules.update(modules)
    for cls, (module, name) in _NAMES.items():
        cls.__module__, cls.__name__, cls.__qualname__ = module, name, name
    try:
        yield spark_types
    finally:
        for cls, (module, name, qualname) in saved_names.items():
            cls.__module__, cls.__name__, cls.__qualname__ = module, name, qualname
        for name, module in saved_modules.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def reference_unischema_pickle(name: str, fields) -> bytes:
    """petastorm's pickle of a ``Unischema`` called ``name`` with
    ``fields``: ``(name, numpy dtype, shape, codec, nullable)`` each, the
    codec one of ``("scalar", "<Spark type name>")``, ``("image", "png" or
    "jpeg", quality)``, ``("ndarray",)`` or ``("compressed_ndarray",)``."""
    with _petastorm_names() as spark_types:
        def codec_of(spec):
            kind = spec[0]
            if kind == "scalar":
                return _ScalarCodec(spark_types[spec[1]]())
            if kind == "image":
                return _CompressedImageCodec(spec[1], spec[2])
            if kind == "ndarray":
                return _NdarrayCodec()
            if kind == "compressed_ndarray":
                return _CompressedNdarrayCodec()
            raise ValueError(f"unknown codec {spec!r}")

        schema = _Unischema(name, [_UnischemaField(n, dtype, tuple(shape), codec_of(codec),
                                                   nullable)
                                   for n, dtype, shape, codec, nullable in fields])
        return pickle.dumps(schema, protocol=2)


def link_reference_store(data_files, root: str, schema_pickle: bytes) -> list:
    """Parquet ``data_files`` hard-linked (copied where linking fails) into
    the new directory ``root``, in order, beside a ``_common_metadata`` that
    holds only petastorm's two keys: ``schema_pickle`` and the row-group
    count of each file. -> the paths of the files in ``root``."""
    os.makedirs(root)
    paths, per_file = [], {}
    for src in data_files:
        dst = os.path.join(root, os.path.basename(src))
        try:
            os.link(src, dst)
        except OSError:
            shutil.copyfile(src, dst)
        paths.append(dst)
        per_file[os.path.basename(dst)] = pq.ParquetFile(dst).metadata.num_row_groups
    schema = pq.read_schema(paths[0]).with_metadata({
        LEGACY_UNISCHEMA_KEY: schema_pickle,
        LEGACY_ROW_GROUPS_PER_FILE_KEY: json.dumps(per_file).encode("utf-8")})
    pq.write_metadata(schema, os.path.join(root, "_common_metadata"))
    return paths


def image_store_fields(image_shape, quality: int = 90) -> list:
    """The fields of an image store (``materialize_dataset_local``'s
    ``id`` int64 scalar and ``image`` uint8 JPEG) as petastorm declares
    them: ``ScalarCodec(LongType())`` and ``CompressedImageCodec('jpeg',
    quality)``."""
    import numpy as np
    return [("id", np.int64, (), ("scalar", "LongType"), False),
            ("image", np.uint8, tuple(image_shape), ("image", "jpeg", quality), False)]


class DataFileOpenCounter:
    """A filesystem proxy that counts the opens of data files (a sidecar's
    name starts with ``_``)."""

    def __init__(self, inner):
        self._inner = inner
        self.data_file_opens = 0

    def open(self, path, *args, **kwargs):
        if not os.path.basename(path).startswith("_"):
            self.data_file_opens += 1
        return self._inner.open(path, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)
