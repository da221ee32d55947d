"""Batched gather: looked-up rows -> one tensor a field on the device (the
JAX package's ``petastorm_tpu/index/gather.py``).

Each field's cells are stacked once, straight into its typed view of one
pinned host buffer (each field at a 64-byte aligned offset), and the buffer
goes to the device in one transfer; each field is a typed view of the
device copy. The device is the one
:func:`~petastorm_tpu_torch.loader.loader.resolve_device` picks: the card by
default, the CPU only when ``device="cpu"`` is asked (then the stacked
arrays are the tensors' memory, no pinned buffer).

Lifetime: the tensors alias no cache entry, no Arrow buffer and no looked-up
row (the stack copies), so a gathered batch pins nothing upstream: the
cache may evict and the reader may stop.

Imports without torch (``to_device=False`` needs none).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["gather_rows"]

#: Byte alignment of each field in the pinned buffer.
GATHER_ALIGN = 64


def gather_rows(rows: Sequence[dict], fields: Optional[Sequence[str]] = None,
                to_device: bool = True, telemetry=None, device="cuda") -> dict:
    """Stack ``rows`` (``lookup``'s or a ``DatasetView``'s) into one array a
    field.

    ``fields=None`` takes the fields that stack: numeric scalars and
    fixed-shape arrays (strings, decimals and ragged cells are skipped with
    a debug log; naming such a field in ``fields=`` raises ``TypeError``).
    ``to_device=False`` returns the numpy columns; else one tensor a field
    on ``device`` (``None`` rows, a quarantined group's, are dropped)."""
    rows = [r for r in rows if r is not None]
    if not rows:
        return {}
    explicit = fields is not None
    names = list(fields) if explicit else list(rows[0].keys())
    cols: Dict[str, tuple] = {}
    for name in names:
        try:
            cells = [np.asarray(r[name]) for r in rows]
            shape = cells[0].shape
            if any(c.shape != shape for c in cells):
                raise ValueError("all input arrays must have the same shape")
            dtype = np.result_type(*cells)
        except (ValueError, TypeError, KeyError) as e:
            if explicit:
                raise TypeError(f"field {name!r} does not stack into a uniform array ({e}); "
                                f"gather needs fixed-shape numeric fields") from e
            continue
        if dtype == object or dtype.kind in "USmM":
            if explicit:
                raise TypeError(f"field {name!r} stacks to dtype {dtype}, which no "
                                f"tensor holds; drop it from fields=")
            logger.debug("gather: skipping the field %r (%s)", name, dtype)
            continue
        cols[name] = (cells, dtype, (len(cells),) + shape)
    if telemetry is not None:
        telemetry.counter("index.gather_rows_total").add(len(rows))
    if to_device:
        return _to_device(cols, device)
    return {k: np.stack(cells) for k, (cells, _, _) in cols.items()}


def _to_device(cols: Dict[str, tuple], device) -> dict:
    """The columns ``{name: (cells, dtype, shape)}`` as tensors on
    ``device``: each stacked into its view of one pinned host buffer, one
    transfer, a typed view a field."""
    import torch

    from petastorm_tpu_torch.loader.loader import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {k: torch.from_numpy(np.stack(cells)) for k, (cells, _, _) in cols.items()}
    layout, pos = [], 0
    for k, (cells, dtype, shape) in cols.items():
        nbytes = int(np.prod(shape)) * dtype.itemsize
        layout.append((k, cells, dtype, shape, pos, nbytes))
        pos += -(-nbytes // GATHER_ALIGN) * GATHER_ALIGN
    host = torch.empty(max(pos, 1), dtype=torch.uint8, pin_memory=True)
    host_np = host.numpy()
    for k, cells, dtype, shape, off, nbytes in layout:
        np.stack(cells, out=host_np[off:off + nbytes].view(dtype).reshape(shape))
    on_device = host.to(dev)
    return {k: on_device[off:off + nbytes].view(torch.from_numpy(np.empty(0, dtype)).dtype)
            .view(shape) for k, cells, dtype, shape, off, nbytes in layout}
