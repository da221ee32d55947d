"""The reference's torch adapter (``petastorm.pytorch``) over this package's
loaders: :class:`DataLoader`, :class:`BatchedDataLoader` and
:class:`InMemBatchedDataLoader` are the loaders of
:mod:`petastorm_tpu_torch.loader` with the adapter's rules, the JAX
package's ``petastorm_tpu.pytorch`` ones:

* ``torch_device=`` names where batches go; it defaults to the card
  (``"cuda"``), as every loader of this package does;
* the adapter's type rules: bool -> uint8, uint16 -> int32, uint32 -> int64,
  datetime64 -> int64 nanoseconds, Decimal -> float64; strings and other
  objects stay numpy. The package's own loaders keep bool as bool; only the
  bool rule is the adapter's own;
* ``transform_fn=`` (batched loaders) replaces the conversion of each column:
  the batch holds ``transform_fn(column)`` of each numpy column, on the host;
* ``collate_fn=`` (:class:`DataLoader`) builds each batch from the row dicts
  instead, e.g. :func:`decimal_friendly_collate`; the ragged last batch is
  kept unless ``drop_last`` is passed.
"""
from __future__ import annotations

from decimal import Decimal
from typing import Optional

import numpy as np

from petastorm_tpu_torch.loader.loader import (BatchedDataLoader as _BatchedDataLoader,
                                               DataLoader as _DataLoader,
                                               InMemBatchedDataLoader as _InMemBatchedDataLoader)


def _with_device(kwargs: dict, torch_device) -> dict:
    if "device" in kwargs:
        raise TypeError("the adapter's loaders take torch_device=, not device=")
    return dict(kwargs, device="cuda" if torch_device is None else torch_device)


def _bool_as_uint8(arr):
    arr = np.asarray(arr)
    return arr.astype(np.uint8) if arr.dtype == np.bool_ else arr


class _AdapterStaging:
    """The adapter's column rules, on top of a loader's staging."""

    _transform_fn = None

    def _split_batch(self, host_batch: dict):
        if self._transform_fn is not None:
            return {}, {name: self._transform_fn(np.asarray(arr))
                        for name, arr in host_batch.items()}
        return super()._split_batch({name: _bool_as_uint8(arr)
                                     for name, arr in host_batch.items()})


class DataLoader(_AdapterStaging, _DataLoader):
    """Batches of a ``make_reader`` reader as torch tensors on
    ``torch_device`` (the card by default).

    ``collate_fn(rows)`` (a list of row dicts) builds each batch instead of
    the staged column path: such a loader stages nothing, so it refuses
    ``torch_device``, ``steps_per_epoch``, ``pad_last``, ``echo`` and NGram
    readers, and ``state_dict()``. The other arguments are
    :class:`petastorm_tpu_torch.loader.DataLoader`'s.
    """

    def __init__(self, reader, batch_size: int, torch_device=None, collate_fn=None,
                 drop_last: Optional[bool] = None, **kwargs):
        # None = the caller did not choose: the staged path drops the short
        # last batch, the collate path keeps it.
        self._explicit_drop_last = drop_last is not None
        if drop_last is not None:
            kwargs["drop_last"] = drop_last
        if collate_fn is not None:
            if torch_device is not None:
                raise ValueError("torch_device is not supported with collate_fn; move tensors "
                                 "inside the collate (its output is opaque to the loader)")
            for name, default in (("steps_per_epoch", None), ("pad_last", False), ("echo", 1)):
                if kwargs.get(name, default) != default:
                    raise ValueError(f"{name} is not supported with collate_fn; use the staged "
                                     f"column path")
            if getattr(reader, "ngram", None) is not None:
                raise TypeError("collate_fn does not support NGram readers; the staged path "
                                "collates windows into a dense sequence axis")
        # A collate loader stages nothing: it needs no device.
        kwargs = _with_device(kwargs, "cpu" if collate_fn is not None else torch_device)
        super().__init__(reader, batch_size, **kwargs)
        self._collate_fn = collate_fn

    def __iter__(self):
        if self._collate_fn is None:
            yield from super().__iter__()
            return
        if self._in_iter:
            raise RuntimeError("Loader is already being iterated")
        self._in_iter = True
        try:
            drop_tail = self._drop_last if self._explicit_drop_last else False
            rows = []
            for row in self._row_iterator():
                rows.append(row._asdict())
                if len(rows) == self._batch_size:
                    yield self._collate_fn(rows)
                    rows = []
            if rows and not drop_tail:
                yield self._collate_fn(rows)
        finally:
            self._in_iter = False

    def state_dict(self):
        if self._collate_fn is not None:
            raise ValueError("state_dict() is not supported with collate_fn; use the staged "
                             "column path for a loader that checkpoints")
        return super().state_dict()


class BatchedDataLoader(_AdapterStaging, _BatchedDataLoader):
    """Batches of a ``make_batch_reader`` reader as torch tensors on
    ``torch_device`` (the card by default); ``transform_fn`` replaces the
    conversion of each column. The other arguments are
    :class:`petastorm_tpu_torch.loader.BatchedDataLoader`'s."""

    def __init__(self, reader, batch_size: int, torch_device=None, transform_fn=None,
                 **kwargs):
        super().__init__(reader, batch_size, **_with_device(kwargs, torch_device))
        self._transform_fn = transform_fn


class InMemBatchedDataLoader(_AdapterStaging, _InMemBatchedDataLoader):
    """A reader read once into memory, then served for ``num_epochs``, as
    torch tensors on ``torch_device`` (the card by default);
    ``transform_fn`` as in :class:`BatchedDataLoader`. The other arguments
    are :class:`petastorm_tpu_torch.loader.InMemBatchedDataLoader`'s."""

    def __init__(self, reader, batch_size: int, torch_device=None, transform_fn=None,
                 **kwargs):
        super().__init__(reader, batch_size, **_with_device(kwargs, torch_device))
        self._transform_fn = transform_fn


def decimal_friendly_collate(batch):
    """A ``collate_fn`` that takes Decimals: a list of row dicts becomes a
    dict of columns; Decimals become their strings, numpy rows a stacked
    tensor, numbers a tensor; anything else stays a list."""
    import torch
    if not isinstance(batch, (list, tuple)) or not batch:
        return batch
    first = batch[0]
    if isinstance(first, Decimal):
        return [str(x) for x in batch]
    if isinstance(first, dict):
        return {k: decimal_friendly_collate([b[k] for b in batch]) for k in first}
    if isinstance(first, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(first, (int, float, np.integer, np.floating)):
        return torch.tensor(batch)
    return batch
