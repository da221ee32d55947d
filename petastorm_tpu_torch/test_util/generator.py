"""Random rows for a Unischema (the JAX package's ``test_util/generator.py``)."""
from __future__ import annotations

from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.unischema import Unischema


def random_value_for_field(field, rng: np.random.Generator):
    """A random value of ``field``'s type and shape (a ``None`` dimension
    draws a size in 1..4)."""
    dtype = field.numpy_dtype
    shape = tuple(d if d is not None else int(rng.integers(1, 5)) for d in field.shape)
    if dtype in (str, np.str_):
        return "s" + str(rng.integers(0, 1 << 30))
    if dtype in (bytes, np.bytes_):
        return bytes(rng.integers(0, 255, 8).astype(np.uint8))
    if dtype is Decimal:
        return Decimal(int(rng.integers(0, 1000))) / Decimal(100)
    npdt = np.dtype(dtype)
    if npdt.kind == "M":
        return np.datetime64("2020-01-01") + np.timedelta64(int(rng.integers(0, 10000)), "m")
    if npdt.kind == "b":
        value = rng.integers(0, 2, shape).astype(npdt)
    elif npdt.kind in "iu":
        info = np.iinfo(npdt)
        lo, hi = max(info.min, -1000), min(info.max, 1000)
        value = rng.integers(lo, hi, shape).astype(npdt)
    else:
        value = rng.normal(size=shape).astype(npdt)
    return value if shape else npdt.type(value)


def random_row_for_schema(schema: Unischema, rng: np.random.Generator) -> dict:
    return {name: random_value_for_field(f, rng) for name, f in schema.fields.items()}
