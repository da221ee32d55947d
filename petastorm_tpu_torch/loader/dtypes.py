"""Type sanitization of numpy batch columns before they become tensors.

PyTorch has no full uint16/uint32/uint64 types, so those widen to the next
signed type that holds every value (uint16 -> int32, uint32 -> int64), as
the reference torch adapter does; uint64 has no such type and stays on the
host. ``Decimal`` becomes float64 and ``datetime64`` int64 nanoseconds.
Strings, bytes and ragged object columns stay host-side numpy arrays.
"""
from __future__ import annotations

from decimal import Decimal
from typing import Dict, Optional, Tuple

import numpy as np


def sanitize_array(arr: np.ndarray) -> Optional[np.ndarray]:
    """A tensor-ready version of one batch column, or ``None`` when the
    column must stay on the host."""
    if arr.dtype == object:
        first = next((x for x in arr.flat if x is not None), None)
        if isinstance(first, Decimal):
            return np.asarray([float(x) if x is not None else np.nan for x in arr.flat],
                              dtype=np.float64).reshape(arr.shape)
        return None
    if arr.dtype.kind in ("U", "S"):
        return None
    if arr.dtype.kind == "M":
        return arr.astype("datetime64[ns]").astype(np.int64)
    if arr.dtype == np.uint16:
        return arr.astype(np.int32)
    if arr.dtype == np.uint32:
        return arr.astype(np.int64)
    if arr.dtype == np.uint64:
        return None
    return arr


def sanitize_batch(batch: dict) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Split a ``{name: ndarray}`` batch into (tensor columns, host columns)."""
    device, host = {}, {}
    for name, arr in batch.items():
        arr = np.asarray(arr)
        clean = sanitize_array(arr)
        if clean is None:
            host[name] = arr
        else:
            device[name] = clean
    return device, host
