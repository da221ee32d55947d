"""Module-level transforms and predicates that a spawned reader worker can
unpickle (a lambda, a closure or a function of ``__main__`` cannot cross
into one): the center crop and the pandas column that ``chip_smoke.py``'s
selection phase applies, and the tests' transforms. Imports numpy only."""
import numpy as np


def center_crop(row: dict, field: str, size: int) -> dict:
    """``row`` with ``row[field]`` (an ``(H, W, ...)`` image) cut to its
    central ``size`` x ``size``, as a contiguous copy."""
    image = row[field]
    top, left = (image.shape[0] - size) // 2, (image.shape[1] - size) // 2
    return {**row, field: np.ascontiguousarray(image[top:top + size, left:left + size])}


def add_sum_column(df, name: str, left: str, right: str):
    """A pandas DataFrame with ``name = left + right`` added."""
    df[name] = df[left] + df[right]
    return df


def int_field_equals(values: dict, state) -> bool:
    """An ``in_lambda`` function: ``int(values[field]) == value`` for
    ``state = (field, value)`` (hive partition values arrive as strings)."""
    field, value = state
    return int(values[field]) == value


def double_as_matrix(df, name: str, source: str, shape):
    """A pandas DataFrame with ``name``: each ``source`` cell doubled and
    reshaped to ``shape`` (a multi-dimensional cell)."""
    df[name] = [np.asarray(v).reshape(shape) * 2 for v in df[source]]
    return df


def scale_and_drop(cols: dict, name: str, factor, drop: str) -> dict:
    """A batched transform: ``cols[name]`` times ``factor`` as float32 and
    ``drop`` left out."""
    out = {k: v for k, v in cols.items() if k != drop}
    out[name] = (np.asarray(cols[name]) * factor).astype(np.float32)
    return out
