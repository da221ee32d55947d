"""Type sanitization of numpy batch columns before they become tensors.

:class:`DTypePolicy` has the JAX package's fields:

* ``Decimal`` -> float64 (``decimal_to="float64"``), float32, or kept on
  the host as objects (``"str"``);
* ``datetime64[*]`` -> int64 nanoseconds (``datetime_to_int64_ns``), else
  kept on the host;
* ``float64_to_float32`` narrows float64 columns;
* ``cast_floats_to_bfloat16`` makes every floating column a
  ``torch.bfloat16`` tensor (numpy has no bfloat16, so such a column leaves
  this module as a CPU tensor);
* ``promote_unsigned`` is kept for the JAX package's signature, but PyTorch
  has no full uint16/uint32/uint64 types, so those always widen to the next
  signed type that holds every value (uint16 -> int32, uint32 -> int64), as
  the reference torch adapter does; uint64 has no such type and stays on
  the host.

Strings, bytes and ragged object columns stay host-side numpy arrays. The
default policy is the behaviour the loader always had.
"""
from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


@dataclass(frozen=True)
class DTypePolicy:
    decimal_to: str = "float64"          # 'float64' | 'float32' | 'str'
    datetime_to_int64_ns: bool = True
    float64_to_float32: bool = False
    promote_unsigned: bool = False       # torch always widens uint16/uint32
    cast_floats_to_bfloat16: bool = False


DEFAULT_POLICY = DTypePolicy()


def sanitize_array(arr: np.ndarray, policy: DTypePolicy = DEFAULT_POLICY
                   ) -> Optional[Union[np.ndarray, torch.Tensor]]:
    """A tensor-ready version of one batch column (a numpy array, or a CPU
    ``torch.bfloat16`` tensor under ``cast_floats_to_bfloat16``), or
    ``None`` when the column must stay on the host."""
    if arr.dtype == object:
        first = next((x for x in arr.flat if x is not None), None)
        if isinstance(first, Decimal):
            if policy.decimal_to == "str":
                return None
            return np.asarray([float(x) if x is not None else np.nan for x in arr.flat],
                              dtype=policy.decimal_to).reshape(arr.shape)
        return None
    if arr.dtype.kind in ("U", "S"):
        return None
    if arr.dtype.kind == "M":
        if policy.datetime_to_int64_ns:
            return arr.astype("datetime64[ns]").astype(np.int64)
        return None
    if arr.dtype == np.uint16:
        return arr.astype(np.int32)
    if arr.dtype == np.uint32:
        return arr.astype(np.int64)
    if arr.dtype == np.uint64:
        return None
    out = arr
    if policy.float64_to_float32 and out.dtype == np.float64:
        out = out.astype(np.float32)
    if policy.cast_floats_to_bfloat16 and out.dtype.kind == "f":
        return torch.tensor(out, dtype=torch.bfloat16)
    return out


def sanitize_batch(batch: dict, policy: DTypePolicy = DEFAULT_POLICY
                   ) -> Tuple[Dict[str, Union[np.ndarray, torch.Tensor]], Dict[str, np.ndarray]]:
    """Split a ``{name: ndarray}`` batch into (tensor columns, host columns)."""
    device, host = {}, {}
    for name, arr in batch.items():
        arr = np.asarray(arr)
        clean = sanitize_array(arr, policy)
        if clean is None:
            host[name] = arr
        else:
            device[name] = clean
    return device, host
